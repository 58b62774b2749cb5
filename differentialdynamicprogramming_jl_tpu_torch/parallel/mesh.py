"""Batched and sharded solves.

Counterpart of ``differentialdynamicprogramming_jl_tpu/parallel/mesh.py``.
``ilqg_batched`` solves many problems in one call: the JAX package vmaps
its solver over a leading scenario axis; here the solver is written for a
batch (``solvers.ilqg.solve_batch``), so the call is direct.

The sharded entries split this process's rows over the devices of a
:class:`Mesh` and run the lock-step solve of each shard's rows on its
device, the shards one after the other. Nothing crosses between shards
during a solve; with ``reduce_stats=True`` the fleet's scalar statistics
are summed over the shards and then over the process group
(``all_reduce``), as JAX ``psum``s them over its mesh. Results are this
process's rows, batch-major, on the mesh's first device.
:mod:`.distributed` describes the design.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import as_tensor, like
from ..policy import GaussianPolicy
from ..problem import Problem
from ..solvers.ilqg import ILQGConfig, ILQGResult, solve_batch
from .distributed import Shards, distribute_batch, local_devices
from ..utils.aot import recorded


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the scenario axis: ``devices`` are this process's,
    one shard each; ``group`` is the process group (None in one process)
    of ``world_size`` processes, this one ``rank``."""

    axis_name: str
    devices: tuple
    group: Optional[object] = None
    rank: int = 0
    world_size: int = 1


def make_mesh(n_devices: Optional[int] = None, axis: str = "b",
              device=None) -> Mesh:
    """1-D mesh over the scenario axis: this process's first ``n_devices``
    devices (:func:`~.distributed.local_devices`: its card, or every card),
    in the process group where one is initialised. ``device`` (e.g.
    ``"cpu"``) instead puts ``n_devices`` shards (default 1) on that one
    device."""
    if device is not None:
        devs = (torch.device(device),) * (n_devices or 1)
    else:
        devs = local_devices()[:n_devices]
    if dist.is_initialized():
        return Mesh(axis, devs, dist.group.WORLD, dist.get_rank(),
                    dist.get_world_size())
    return Mesh(axis, devs)


def shard_rows(rows: dict, mesh: Mesh) -> dict:
    """Each named value as a list of per-shard values: None stays None on
    every shard, :class:`~.distributed.Shards` are taken as they are, a
    policy is split leaf by leaf, anything else is split by
    :func:`~.distributed.distribute_batch`."""
    n = len(mesh.devices)

    def split(v):
        if v is None:
            return [None] * n
        if isinstance(v, Shards):
            if len(v) != n:
                raise ValueError(f"{len(v)} shards for {n} devices")
            return list(v)
        if isinstance(v, GaussianPolicy):
            return [GaussianPolicy(*leaves) for leaves in
                    zip(*(split(a) for a in v))]
        return list(distribute_batch(v, mesh))

    return {name: split(v) for name, v in rows.items()}


def concat_results(parts, device):
    """Join per-shard results (NamedTuples of batch-major tensors, None
    fields kept) along the batch axis on ``device``."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(concat_results([p[i] for p in parts], device)
                             for i in range(len(first))))
    return torch.cat([p.to(device) for p in parts])


def _rows(v) -> int:
    """This process's row count of a value (tensor, numpy or Shards)."""
    if isinstance(v, Shards):
        return sum(a.shape[0] for a in v)
    if isinstance(v, GaussianPolicy):
        return _rows(v.k)
    return v.shape[0]


def _sharded(mesh: Mesh, rows: dict, solve, stats=None):
    """Solve each shard's rows with ``solve(**rows_j)`` on its device; with
    ``stats(res) -> (3,) tensor`` also return their sum over the shards and
    the process group."""
    n_dev = len(mesh.devices)
    B = _rows(next(v for v in rows.values() if v is not None))
    assert B % n_dev == 0, f"batch {B} must divide over {n_dev} devices"
    per = shard_rows(rows, mesh)
    parts = [solve(**{name: v[j] for name, v in per.items()})
             for j in range(n_dev)]
    res = concat_results(parts, mesh.devices[0])
    if stats is None:
        return res
    total = sum(stats(p).to(mesh.devices[0]) for p in parts)
    if mesh.group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return res, total


def _solved(reason):
    return (reason == 1) | (reason == 2)


@recorded
def ilqg_batched(problem: Problem, x0s, u0s, lims=None,
                 cfg: ILQGConfig = ILQGConfig(), cost0=None, lam0=None,
                 dlam0=None, accepted0=None) -> ILQGResult:
    """Solve B problems that share ``problem``: ``x0s`` (B, n), or
    pre-rolled (B, T, n) trajectories with optional per-step ``cost0``
    (B, T) or (B, T+1); ``u0s`` (B, T, m). Each scenario keeps its own
    λ/α/termination state and runs until its own exit, as under
    ``jax.vmap``: lane b's result is that of ``ilqg`` on lane b alone.

    ``lam0``/``dlam0``/``accepted0`` (B,) resume the λ schedule and the
    iteration budget from a prior result (``src/iLQG.jl:85-87,193-197``).
    ``lims`` is fleet-wide (m, 2) or per scenario (B, m, 2).

    ``u0s`` keeps its device if it is a tensor, else goes to the CUDA card;
    the other inputs follow it. Results carry a leading (B,)."""
    u0s = as_tensor(u0s)
    B = u0s.shape[0]

    def lane(v, dtype=None):
        return None if v is None else like(v, u0s, dtype).expand(B)

    return solve_batch(problem, like(x0s, u0s), u0s, lims, cfg,
                       None if cost0 is None else like(cost0, u0s),
                       lane(lam0), lane(dlam0), lane(accepted0, torch.int32))


def ilqg_sharded(problem: Problem, x0s, u0s, lims=None,
                 cfg: ILQGConfig = ILQGConfig(), mesh: Optional[Mesh] = None,
                 axis: str = "b", reduce_stats: bool = False, cost0=None,
                 lam0=None, dlam0=None, accepted0=None):
    """:func:`ilqg_batched` on each shard of ``mesh`` (default
    :func:`make_mesh`): this process's rows in, its rows out. ``lims`` is
    fleet-wide (m, 2), given to every shard, or per scenario (B, m, 2),
    split with the rows like the warm-start and resume inputs. With
    ``reduce_stats=True`` returns ``(result, stats)``: the sums over the
    whole fleet of the total costs, the iterations and the solved (exit 1
    or 2) scenarios, in the costs' dtype (JAX ``mesh.py:131-139``).
    The batch must divide over the mesh's devices."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    per_lims = lims is not None and (
        lims.ndim if hasattr(lims, "ndim") else np.ndim(lims)) == 3
    rows = dict(x0s=x0s, u0s=u0s, cost0=cost0, lam0=lam0, dlam0=dlam0,
                accepted0=accepted0, lims=lims if per_lims else None)
    fleet_lims = None if per_lims else lims

    def solve(x0s, u0s, lims, **kw):
        if fleet_lims is not None:      # on the device of the shard's rows
            lims = (fleet_lims.to(x0s.device)
                    if isinstance(fleet_lims, torch.Tensor) else fleet_lims)
        return ilqg_batched(problem, x0s, u0s, lims=lims, cfg=cfg, **kw)

    stats = (lambda r: torch.stack([
        r.cost.sum(-1).sum(), r.n_iters.sum().to(r.cost.dtype),
        _solved(r.reason).sum().to(r.cost.dtype)])) if reduce_stats else None
    return _sharded(mesh, rows, solve, stats)


def ilqg_batch_sharded(model, packed_derivs, x0s, u0s, lims=None,
                       cfg: Optional[ILQGConfig] = None,
                       mesh: Optional[Mesh] = None, axis: str = "b",
                       reduce_stats: bool = False, derivs_tiles=None,
                       kt_backward: int = 25, kt_forward: int = 10,
                       interpret: bool = False):
    """:func:`~..solvers.batch.ilqg_batch_lanes` (the kernels' fleet path)
    on each shard of ``mesh``: each shard's rows solved in lock-step to
    ``cfg.cap()``, this process's rows returned. ``lims``: static
    ``((lo, hi),) * m``, per scenario (B, m, 2), split with the rows, or
    None. With ``reduce_stats=True`` returns ``(result, stats)``: the fleet
    sums of ``cost_total``, ``n_iters`` and the solved (exit 1 or 2)
    scenarios, f32. The TPU switches ``kt_*`` and ``interpret`` have no
    effect."""
    from ..solvers.batch import ilqg_batch_lanes, split_lims
    if cfg is None:
        cfg = ILQGConfig()
    if mesh is None:
        mesh = make_mesh(axis=axis)
    lims_s, lims_b = split_lims(lims)
    rows = dict(x0s=x0s, u0s=u0s, lims=lims_b)

    def solve(x0s, u0s, lims):
        return ilqg_batch_lanes(model, packed_derivs, x0s, u0s,
                                lims=lims_s if lims is None else lims,
                                cfg=cfg, derivs_tiles=derivs_tiles,
                                max_steps=cfg.cap() - 1)

    stats = (lambda r: torch.stack([
        r.cost_total.sum(), r.n_iters.sum().to(torch.float32),
        _solved(r.reason).sum().to(torch.float32)])) if reduce_stats else None
    return _sharded(mesh, rows, solve, stats)


def ilqgkl_batch_sharded(model, derivs_tiles, x0s, traj_prev, fx_model,
                         cost0, lims=None, cfg=None, r1=None, kt: int = 16,
                         mesh: Optional[Mesh] = None, axis: str = "b",
                         reduce_stats: bool = False,
                         record_trace: bool = False,
                         interpret: bool = False):
    """:func:`~..solvers.batch_kl.ilqgkl_batch_lanes` (the fleet ``iLQGkl``,
    ``src/iLQGkl.jl:25-252``) on each shard of ``mesh``: this process's rows
    of ``x0s`` (B, T, n), ``traj_prev`` (leaves (B, T, ...)), ``fx_model``
    (B, T, n, n), ``cost0`` (B,) and per-scenario ``lims`` in, its rows out.
    With ``reduce_stats=True`` returns ``(result, stats)``: the fleet sums
    of ``cost_total``, ``n_iters`` and the satisfied scenarios, f32. ``kt``
    and ``interpret`` have no effect."""
    from ..solvers.batch import split_lims
    from ..solvers.batch_kl import ilqgkl_batch_lanes
    from ..solvers.ilqgkl import ILQGKLConfig
    if cfg is None:
        cfg = ILQGKLConfig()
    if mesh is None:
        mesh = make_mesh(axis=axis)
    lims_s, lims_b = split_lims(lims)
    rows = dict(x0s=x0s, traj_prev=traj_prev, fx_model=fx_model,
                cost0=cost0, lims=lims_b)

    def solve(x0s, traj_prev, fx_model, cost0, lims):
        return ilqgkl_batch_lanes(model, derivs_tiles, x0s, traj_prev,
                                  fx_model, cost0,
                                  lims=lims_s if lims is None else lims,
                                  cfg=cfg, r1=r1, record_trace=record_trace)

    stats = (lambda r: torch.stack([
        r.cost_total.sum(), r.n_iters.sum().to(torch.float32),
        r.satisfied.sum().to(torch.float32)])) if reduce_stats else None
    return _sharded(mesh, rows, solve, stats)
