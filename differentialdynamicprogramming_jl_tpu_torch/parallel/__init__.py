"""Parallel execution layer.

- :mod:`.mesh` — batched solves (``ilqg_batched``) and the sharded entries
  over a :class:`~.mesh.Mesh` of this process's devices, one shard each.
- :mod:`.distributed` — several processes on ``torch.distributed``: the
  process group, the mesh over it, and this process's rows split over its
  devices and joined back.
"""
from .mesh import (Mesh, make_mesh, ilqg_batched,  # noqa: F401
                   ilqg_sharded, ilqg_batch_sharded, ilqgkl_batch_sharded)
from .distributed import (init_distributed, is_multiprocess,  # noqa: F401
                          global_mesh, distribute_batch, replicate,
                          local_slice)

__all__ = [
    "Mesh", "make_mesh", "ilqg_batched", "ilqg_sharded",
    "ilqg_batch_sharded", "ilqgkl_batch_sharded",
    "init_distributed", "is_multiprocess", "global_mesh",
    "distribute_batch", "replicate", "local_slice",
]
