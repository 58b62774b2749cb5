"""Forward rollout, line search and covariance propagation.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/forward.py``:
``forward_pass`` (reference ``src/forward_pass.jl:9-33``), ``line_search``
(``src/iLQG.jl:266-281``) with every α candidate rolled out at once as a
leading batch dimension and the first acceptable one taken, and
``forward_covariance`` (``src/forward_pass.jl:37-56``).

The rollout is a host loop over t of the problem's functions, which
broadcast over leading batch dimensions: one call rolls out every problem
of a batch and every α candidate.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import as_tensor, like
from ..policy import GaussianPolicy
from ..problem import Problem
from . import _linalg as la


class Rollout(NamedTuple):
    x: torch.Tensor      # (..., T, n) — states visited (x[t] before u[t])
    u: torch.Tensor      # (..., T, m) — applied (possibly clamped) controls
    cost: torch.Tensor   # (..., T) or (..., T+1) — per-step costs


def forward_pass(problem: Problem, x0, u, x_old=None, alpha=1.0,
                 policy: Optional[GaussianPolicy] = None,
                 lims=None) -> Rollout:
    """Roll out ``u_t = u[t] + α k_t + K_t·diff(x_t, x_old[t])``, clamped to
    ``lims`` (``(m, 2)`` or ``(..., m, 2)``), through ``problem.dynamics``
    (``src/forward_pass.jl:16-30``). ``policy=None`` is the reference's
    empty-policy rollout of trajectory initialisation (``src/iLQG.jl:185``).

    ``x0`` (..., n), ``u`` (..., T, m), ``alpha`` a scalar or a tensor of
    leading dims; all leading dims broadcast. ``u`` keeps its device if it
    is a tensor, else goes to the CUDA card; the others follow it."""
    u = as_tensor(u)

    x0, alpha = like(x0, u), like(alpha, u)
    T, m = u.shape[-2:]
    n = x0.shape[-1]
    shapes = [x0.shape[:-1], u.shape[:-2], alpha.shape]
    if policy is not None:
        shapes.append(policy.k.shape[:-2])
        if x_old is not None:
            x_old = like(x_old, u)
            shapes.append(x_old.shape[:-2])
    lead = la.lead_shape(*shapes)
    if lims is not None:
        lims = like(lims, u)
        lo, hi = lims[..., 0], lims[..., 1]
    x = x0.expand(lead + (n,))
    # the per-step inputs as views made once; u + α·k for every step at once
    # (elementwise: the same values as step by step)
    if policy is not None:
        u_s = (u + alpha.reshape(alpha.shape + (1, 1)) * policy.k).unbind(-2)
        K_s = policy.K.unbind(-3)
        xo_s = (None if x_old is None else x_old.unbind(-2))
    else:
        u_s = u.unbind(-2)
    xs, us = [], []
    for t in range(T):
        u_new = u_s[t]
        if policy is not None:
            xo = torch.zeros_like(x) if xo_s is None else xo_s[t]
            u_new = u_new + la.mv(K_s[t], problem.diff(x, xo))
        if lims is not None:
            u_new = torch.clamp(u_new, lo, hi)
        u_new = u_new.expand(lead + (m,))
        xs.append(x)
        us.append(u_new)
        x = problem.dynamics(x, u_new, t)
    x_traj = torch.stack(xs, dim=-2)
    u_traj = torch.stack(us, dim=-2)
    return Rollout(x=x_traj, u=u_traj,
                   cost=problem.trajectory_cost(x_traj, u_traj))


class LineSearchOut(NamedTuple):
    done: torch.Tensor           # any α accepted
    alpha: torch.Tensor          # accepted α (NaN if none)
    x: torch.Tensor
    u: torch.Tensor
    cost: torch.Tensor           # per-step costs of the chosen candidate
    dcost: torch.Tensor          # Δcost = old - new
    expected: torch.Tensor       # -α(dV₁ + α dV₂)
    reduce_ratio: torch.Tensor


def line_search(problem: Problem, x0, u, x_old, cost_old_total, policy,
                dV, alphas, lims=None,
                reduce_ratio_min=0.0) -> LineSearchOut:
    """Backtracking line search (``src/iLQG.jl:267-281``): all α candidates
    roll out at once, as a leading dimension before the problems' own; the
    first (the reference's serial first success) with ``reduce_ratio >
    reduce_ratio_min`` is taken, per problem. ``x0`` (..., n), ``u`` and
    ``x_old`` (..., T, ·), ``cost_old_total`` (...), ``dV`` (..., 2)."""
    u = as_tensor(u)
    dtype, dev = u.dtype, u.device
    al = torch.as_tensor(alphas, dtype=dtype, device=dev)
    lead = la.lead_shape(u.shape[:-2], dV.shape[:-1])
    al_b = al.reshape(al.shape + (1,) * len(lead))
    ro = forward_pass(problem, x0, u, x_old, al_b, policy, lims)

    totals = ro.cost.sum(-1)                            # (A, ...)
    dcost = cost_old_total - totals
    expected = -al_b * (dV[..., 0] + al_b * dV[..., 1])
    # reference: a negative expected reduction "should not occur" → use
    # sign(Δcost) (src/iLQG.jl:271-276); jnp.sign keeps NaN, torch.sign
    # gives 0
    sign = torch.where(torch.isnan(dcost), dcost, torch.sign(dcost))
    ratio = torch.where(expected > 0, dcost / expected, sign)
    ok = ratio > reduce_ratio_min
    done = ok.any(0)
    idx = torch.argmax(ok.to(torch.uint8), dim=0)   # first True, as jnp

    def pick(a):
        i = idx.reshape((1,) + idx.shape + (1,) * (a.ndim - 1 - idx.ndim))
        return a.gather(0, i.expand((1,) + a.shape[1:]))[0]

    return LineSearchOut(
        done=done, alpha=torch.where(done, al[idx], float("nan")),
        x=pick(ro.x), u=pick(ro.u), cost=pick(ro.cost), dcost=pick(dcost),
        expected=pick(expected.expand(dcost.shape)),
        reduce_ratio=pick(ratio))


def forward_covariance(fx, R1, policy: GaussianPolicy) -> torch.Tensor:
    """Propagate the joint state-control covariance by a discrete Lyapunov
    iteration (``src/forward_pass.jl:37-56``):

        Σxx[0] = R1;  Σxx[t+1] = fx[t] Σxx[t] fx[t]' + R1
        Σux[t] = K Σxx[t];  Σuu[t] = K Σxx[t] K' + Σ

    ``fx`` (T, n, n), ``R1`` (n, n), ``policy`` with K (T, m, n) and sigma
    (T, m, m). Returns ``(T, n+m, n+m)``, the blocks
    [[Σxx, Σuxᵀ], [Σux, Σuu]] at each t;
    the last step's u-blocks are filled as at every other step (the
    reference leaves them undefined; only the xx block is consumed, by
    ``kl_div_wiki``, ``src/klutils.jl:77``).

    A plain loop over t in torch ops, on the inputs' device: tensors keep
    theirs, anything else goes to the CUDA card (:mod:`..device`). The
    fleet solver propagates Σxx alone, with the kernel K4
    (``ops/hopper/covariance_kernel.py``).
    """
    fx = as_tensor(fx)
    R1 = as_tensor(R1, fx.dtype)
    K = as_tensor(policy.K, fx.dtype)
    sig = as_tensor(policy.sigma, fx.dtype)
    S = R1
    out = []
    for t in range(fx.shape[0]):
        ux = K[t] @ S
        uu = ux @ K[t].T + sig[t]
        out.append(torch.cat([torch.cat([S, ux.T], dim=1),
                              torch.cat([ux, uu], dim=1)], dim=0))
        S = fx[t] @ S @ fx[t].T + R1
    return torch.stack(out)
