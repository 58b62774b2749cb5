"""Problem definition: the user-facing contract of the framework.

Counterpart of ``differentialdynamicprogramming_jl_tpu/problem.py``: the
reference's three callbacks ``f, costfun, df`` (``src/iLQG.jl:63-92``) as
functions on tensors. In this port the functions broadcast over leading
batch dimensions, so one call evaluates a whole fleet: ``derivs`` takes
``x_traj`` (..., T, n) and ``u_traj`` (..., T, m).

``derivs=None`` selects autodiff (:func:`make_autodiff_derivs`, with the
second-order terms of full DDP when ``second_order`` is set).
:func:`broadcast_derivs` materialises time-invariant derivatives, as the
LTI problem's analytic derivatives use it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import grad, jacfwd, vmap

from .device import as_tensor
from .ops.tie_rules import jax_ties
from .policy import Derivs


def _default_diff(x_new, x_old):
    return x_new - x_old


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
    - ``diff(x_new, x_old) -> dx``: state difference of the forward pass's
      feedback term (reference ``diff_fun``, ``src/iLQG.jl:131``), on
      (..., n).
    - ``second_order``: autodiff also builds ``fxx/fxu/fuu`` → full DDP
      (the reference's empty-array sentinels, ``src/iLQG.jl:231``).
    """

    dynamics: Callable
    cost: Callable
    derivs: Optional[Callable] = None
    traj_cost: Optional[Callable] = None
    diff: Callable = _default_diff
    second_order: bool = False

    def make_derivs(self) -> Callable:
        """Return a ``(x_traj, u_traj) -> Derivs`` function."""
        if self.derivs is not None:
            return self.derivs
        return make_autodiff_derivs(self.dynamics, self.cost,
                                    second_order=self.second_order)

    def trajectory_cost(self, x_traj: torch.Tensor,
                        u_traj: torch.Tensor) -> torch.Tensor:
        """Per-step costs along trajectories (``src/forward_pass.jl:30``)."""
        if self.traj_cost is not None:
            return self.traj_cost(x_traj, u_traj)
        T = u_traj.shape[-2]
        return torch.stack([self.cost(x_traj[..., t, :], u_traj[..., t, :], t)
                            for t in range(T)], dim=-1)


def make_autodiff_derivs(dynamics: Callable, cost: Callable,
                         second_order: bool = False) -> Callable:
    """The derivative stack by autodiff (JAX ``problem.py:79-119``): fx, fu
    by ``torch.func.jacfwd`` of the dynamics, cx, cu by ``torch.func.grad``
    of the cost, and cxx, cxu, cuu by ``jacfwd`` of that gradient, per step
    on vectors (n,), (m,), under ``torch.func.vmap`` over the leading batch
    and time axes. The returned function takes ``x_traj`` (..., ≥T, n) and
    ``u_traj`` (..., T, m) and returns :class:`~.policy.Derivs` with leaves
    (..., T, ...); the step index t enters as a tensor.

    The functions run under JAX's rules at ties
    (:class:`~.ops.tie_rules.jax_ties`: abs, the clamps, maximum and
    minimum), as JAX differentiates them.

    ``second_order=True`` adds full DDP's fxx (n, n, n) ``[a, i, j]``, fxu
    (n, n, m) and fuu (n, m, m), by ``jacfwd`` of the Jacobians."""
    # each step is evaluated as a batch of one, which the functions
    # broadcast over: on 0-dim tensors PyTorch's tangent formulas would
    # promote an f32 tangent times a Python constant to f64
    def dyn1(x, u, t):
        with jax_ties():
            return dynamics(x[None], u[None], t)[0]

    def cost1(x, u, t):
        with jax_ties():
            return cost(x[None], u[None], t)[0]

    fx_fn = jacfwd(dyn1, argnums=0)
    fu_fn = jacfwd(dyn1, argnums=1)
    cx_fn = grad(cost1, argnums=0)
    cu_fn = grad(cost1, argnums=1)
    cxx_fn = jacfwd(cx_fn, argnums=0)
    cxu_fn = jacfwd(cx_fn, argnums=1)       # (n, m)
    cuu_fn = jacfwd(cu_fn, argnums=1)
    fns = [fx_fn, fu_fn, cx_fn, cu_fn, cxx_fn, cxu_fn, cuu_fn]
    if second_order:
        fns += [jacfwd(fx_fn, argnums=0),    # (n, n, n): [a, i, j]
                jacfwd(fx_fn, argnums=1),    # (n, n, m)
                jacfwd(fu_fn, argnums=1)]    # (n, m, m)

    def per_step(x, u, t):
        return tuple(f(x, u, t) for f in fns)

    def derivs(x_traj, u_traj):
        T, n, m = u_traj.shape[-2], x_traj.shape[-1], u_traj.shape[-1]
        lead = tuple(u_traj.shape[:-2])
        x = x_traj[..., :T, :].reshape(-1, n)
        u = u_traj.reshape(-1, m)
        t = torch.arange(T, device=u_traj.device).repeat(x.shape[0] // T)
        d = vmap(per_step)(x, u, t)
        return Derivs(*(a.reshape(lead + (T,) + tuple(a.shape[1:]))
                        for a in d))

    return derivs


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
