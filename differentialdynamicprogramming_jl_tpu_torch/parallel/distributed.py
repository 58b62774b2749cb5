"""Multi-process execution on ``torch.distributed``.

Counterpart of ``differentialdynamicprogramming_jl_tpu/parallel/distributed.py``.
Scenario solves are independent, so several processes add nothing to a
solve's hot path: each process solves its own rows of the fleet, and the
only collective is the ``all_reduce(SUM)`` of a sharded entry's fleet
statistics (``reduce_stats=True``).

There is no global array in torch, so the design is the port's own:

- **one process per card.** :func:`init_distributed` joins the process
  group (NCCL where the devices are CUDA cards; on the CPU the
  ``cpu_collectives`` backend, gloo by default) and picks this process's
  card;
- **a mesh** (:class:`~.mesh.Mesh`) names the axis, the process group
  (None in one process), the rank, the world size and this process's
  devices, one shard each. Shards of one process run one after the other,
  each on its device; several CPU shards in one process stand in for the
  JAX tests' virtual devices;
- **rows.** The sharded entries take this process's rows and return this
  process's rows, batch-major. :func:`distribute_batch` splits them over
  the mesh's devices (:class:`Shards`), :func:`local_slice` joins them back
  as numpy.

A two-process run on one host (the CPU tests' pattern)::

    from differentialdynamicprogramming_jl_tpu_torch.parallel import (
        distributed as D)
    D.init_distributed("file:///tmp/ddp-store", num_processes=2,
                       process_id=rank)        # or "host:port", or no
    mesh = D.global_mesh()                     # arguments: the env://
    res, stats = ilqg_batch_sharded(model, None, local_x0s, local_u0s,
                                    ..., mesh=mesh, reduce_stats=True)
    # stats: the fleet-wide sums, the same on every process
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve

# this process's devices, as init_distributed picked them
_LOCAL: Optional[tuple] = None


class Shards(tuple):
    """This process's rows of one array, one tensor per device of a mesh
    (:func:`distribute_batch`), in row order."""


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     cpu_collectives: str = "gloo") -> None:
    """Join this process to the process group (JAX
    ``jax.distributed.initialize``'s arguments).

    - ``coordinator_address``: ``"host:port"`` of process 0, made
      ``tcp://host:port``; an address with a scheme (``"file:///path"``, a
      file store that needs no port) is used as it is; None reads the
      environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
      ``WORLD_SIZE``).
    - ``num_processes``: the world size; ``process_id``: this rank.
    - ``local_device_ids``: this process's CUDA cards (default: the current
      card). The backend is NCCL where a card is visible, else
      ``cpu_collectives`` (gloo; "mpi" where built). Nothing falls back
      from NCCL to gloo.
    """
    global _LOCAL
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    if torch.cuda.is_available():
        ids = (list(local_device_ids) if local_device_ids is not None
               else [torch.cuda.current_device()])
        torch.cuda.set_device(ids[0])
        backend, local = "nccl", tuple(torch.device("cuda", i) for i in ids)
    else:
        if local_device_ids is not None:
            raise ValueError("local_device_ids names CUDA cards, and no card "
                             "is visible")
        backend, local = cpu_collectives, (torch.device("cpu"),)
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init, **kwargs)
    _LOCAL = local


def local_devices() -> tuple:
    """This process's devices: those :func:`init_distributed` picked, else
    every CUDA card (raises without one, :mod:`..device`)."""
    if _LOCAL is not None and dist.is_initialized():
        return _LOCAL
    resolve()
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(axis: str = "b"):
    """The mesh over this process's devices in the process group: the
    sharded entries' default (:func:`~.mesh.make_mesh`)."""
    from .mesh import make_mesh
    return make_mesh(axis=axis)


def distribute_batch(local, mesh, axis: str = "b") -> Shards:
    """Split this process's (B_local, ...) rows evenly over ``mesh``'s
    devices: one tensor per device, in row order (a tensor keeps its dtype;
    numpy rows become tensors). B_local must divide over the devices."""
    local = local if isinstance(local, torch.Tensor) else torch.as_tensor(
        np.asarray(local))
    n = len(mesh.devices)
    if local.shape[0] % n:
        raise ValueError(f"batch {local.shape[0]} must divide over {n} "
                         "devices")
    return Shards(part.to(d) for part, d in
                  zip(local.chunk(n) if n > 1 else (local,), mesh.devices))


def replicate(value, mesh) -> Shards:
    """A (small) value on every device of the mesh."""
    value = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    return Shards(value.to(d) for d in mesh.devices)


def local_slice(global_arr) -> np.ndarray:
    """This process's rows as numpy: a tensor, or :class:`Shards` joined in
    row order (the inverse of :func:`distribute_batch`; the argument keeps
    JAX's name)."""
    if isinstance(global_arr, (tuple, list)):
        return np.concatenate([local_slice(a) for a in global_arr], axis=0)
    return global_arr.detach().cpu().numpy()
