"""Problem definition: the user-facing contract of the framework.

Counterpart of ``differentialdynamicprogramming_jl_tpu/problem.py``: the
reference's three callbacks ``f, costfun, df`` (``src/iLQG.jl:63-92``) as
functions on tensors. In this port the functions broadcast over leading
batch dimensions, so one call evaluates a whole fleet: ``derivs`` takes
``x_traj`` (..., T, n) and ``u_traj`` (..., T, m).

Autodiff derivatives (``derivs=None``) are not part of this slice.
:func:`broadcast_derivs` materialises time-invariant derivatives, as the
LTI problem's analytic derivatives use it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .device import as_tensor
from .policy import Derivs


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


def broadcast_derivs(T: int, fx, fu, cx, cu, cxx, cxu, cuu, fxx=None,
                     fxu=None, fuu=None) -> Derivs:
    """Materialise possibly time-invariant derivative tensors to
    ``(T, ...)`` (JAX ``problem.py:121-143``): a tensor of its core rank
    (fx, fu, cxx, cxu, cuu and the second-order terms' ranks 2 and 3, cx and
    cu rank 1) gains a leading T axis as a broadcast view; one that has it
    already must have T rows. Tensors keep their device, anything else goes
    to the CUDA card (:mod:`.device`)."""
    def bc(a, core_ndim):
        if a is None:
            return None
        a = as_tensor(a)
        if a.ndim == core_ndim:
            return a.expand((T,) + tuple(a.shape))
        if a.shape[0] != T:
            raise ValueError(f"leading axis must be T={T}, got "
                             f"{tuple(a.shape)}")
        return a

    return Derivs(fx=bc(fx, 2), fu=bc(fu, 2), cx=bc(cx, 1), cu=bc(cu, 1),
                  cxx=bc(cxx, 2), cxu=bc(cxu, 2), cuu=bc(cuu, 2),
                  fxx=bc(fxx, 3), fxu=bc(fxu, 3), fuu=bc(fuu, 3))
