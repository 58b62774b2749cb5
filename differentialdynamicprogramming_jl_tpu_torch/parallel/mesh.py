"""Many independent iLQG solves in one call.

Counterpart of ``ilqg_batched`` in
``differentialdynamicprogramming_jl_tpu/parallel/mesh.py:35-65``: the JAX
package vmaps its solver over a leading scenario axis; here the solver is
written for a batch (``solvers.ilqg.solve_batch``), so the call is direct.
The mesh and the sharded entries of that module are not ported.
"""
from __future__ import annotations

import torch

from ..device import as_tensor, like
from ..problem import Problem
from ..solvers.ilqg import ILQGConfig, ILQGResult, solve_batch


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
