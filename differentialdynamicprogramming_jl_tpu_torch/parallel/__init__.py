"""Batched execution of the PyTorch port.

- :mod:`.mesh` — ``ilqg_batched``: many independent iLQG solves in one call
  (the JAX package's vmapped entry). The device meshes, the sharded entries
  and the multi-host layer of the JAX package are not ported.
"""
from .mesh import ilqg_batched  # noqa: F401

__all__ = ["ilqg_batched"]
