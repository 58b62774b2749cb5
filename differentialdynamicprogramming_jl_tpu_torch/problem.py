"""Problem definition: the user-facing contract of the framework.

Counterpart of ``differentialdynamicprogramming_jl_tpu/problem.py``: the
reference's three callbacks ``f, costfun, df`` (``src/iLQG.jl:63-92``) as
functions on tensors. In this port the functions broadcast over leading
batch dimensions, so one call evaluates a whole fleet: ``derivs`` takes
``x_traj`` (..., T, n) and ``u_traj`` (..., T, m).

Autodiff derivatives (``derivs=None``) are not part of this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Problem:
    """A finite-horizon optimal-control problem (``src/iLQG.jl:58-61``).

    - ``dynamics(x, u, t) -> x_next``: one step on (..., n), (..., m).
    - ``cost(x, u, t) -> (...)``: running cost per step.
    - ``derivs(x_traj, u_traj) -> Derivs``: derivative stack along
      trajectories, leaves (..., T, ...); None selects autodiff.
    - ``traj_cost(x_traj, u_traj) -> (..., T+1)``: per-step costs with an
      appended terminal term, for models whose reference cost has one
      (``src/system_pendcart.jl:97-106``).

    The JAX class's ``diff`` (state difference of the feedback term) and
    ``second_order`` (full DDP derivatives) are not fields here: no ported
    path reads them.
    """

    dynamics: Callable
    cost: Callable
    derivs: Optional[Callable] = None
    traj_cost: Optional[Callable] = None

    def make_derivs(self) -> Callable:
        """Return a ``(x_traj, u_traj) -> Derivs`` function."""
        if self.derivs is not None:
            return self.derivs
        raise NotImplementedError(
            "autodiff derivatives (derivs=None) are not ported yet")

    def trajectory_cost(self, x_traj: torch.Tensor,
                        u_traj: torch.Tensor) -> torch.Tensor:
        """Per-step costs along trajectories (``src/forward_pass.jl:30``)."""
        if self.traj_cost is not None:
            return self.traj_cost(x_traj, u_traj)
        T = u_traj.shape[-2]
        return torch.stack([self.cost(x_traj[..., t, :], u_traj[..., t, :], t)
                            for t in range(T)], dim=-1)
