"""Parallel Riccati backward pass — log-depth in the horizon.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/riccati_scan.py``
(``parallel_riccati`` ``:81``, ``_combine`` ``:55``): the map from the value
function at a later time to that at an earlier one is a Riccati flow on
quadratics ``V(x) = ½xᵀJx − ηᵀx``, and such maps form a semigroup with
elements ``(A, b, C, η, J)`` and the associative combination (minimising
over the shared endpoint)

    A₁₂ = A₂ Z A₁             Z = (I + C₁ J₂)⁻¹
    b₁₂ = A₂ Z (b₁ + C₁ η₂) + b₂
    C₁₂ = A₂ Z C₁ A₂ᵀ + C₂
    η₁₂ = A₁ᵀ Zᵀ (η₂ − J₂ b₁) + η₁
    J₁₂ = A₁ᵀ Zᵀ J₂ A₁ + J₁

PyTorch has no public associative scan, so the suffix products are formed by
doubling (Hillis-Steele): ⌈log₂ T⌉ rounds, each one batched combination of
every element with the one 2^k steps later, with batched
``torch.linalg.solve_ex`` (NaN where a system is singular). That is
O(T log T) work in O(log T) rounds, where ``lax.associative_scan``'s tree
does O(T) work; the two trees combine in different orders, so the results
agree with the JAX package's to rounding, not bit for bit.

Scope as in the JAX package: the exact unregularised, unconstrained LQR
backward pass (λ=0, no limits, first-order dynamics, cross terms removed by
completion of squares), for any leading batch dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..policy import Derivs, GaussianPolicy, sym
from . import _linalg as la
from .backward import BackwardOut


class _Elem(NamedTuple):
    A: torch.Tensor    # (..., L, n, n)
    b: torch.Tensor    # (..., L, n)
    C: torch.Tensor    # (..., L, n, n)
    eta: torch.Tensor  # (..., L, n)
    J: torch.Tensor    # (..., L, n, n)


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """Associative combination: e1 the earlier segment, e2 the later."""
    n = e1.A.shape[-1]
    M = torch.eye(n, dtype=e1.A.dtype, device=e1.A.device) + e1.C @ e2.J
    # Z·[A1 | b1 + C1 η2 | C1] and Zᵀ·[η2 − J2 b1 | J2 A1], one solve each
    Z1 = la.solve(M, torch.cat([e1.A, (e1.b + la.mv(e1.C, e2.eta))[..., None],
                                e1.C], dim=-1))
    Zt = la.solve(M.mT, torch.cat([(e2.eta - la.mv(e2.J, e1.b))[..., None],
                                   e2.J @ e1.A], dim=-1))
    ZA1, Zb, ZC1 = Z1[..., :n], Z1[..., n], Z1[..., n + 1:]
    return _Elem(A=e2.A @ ZA1,
                 b=la.mv(e2.A, Zb) + e2.b,
                 C=e2.A @ ZC1 @ e2.A.mT + e2.C,
                 eta=la.mv(e1.A.mT, Zt[..., 0]) + e1.eta,
                 J=sym(e1.A.mT @ Zt[..., 1:] + e1.J))


def _suffix_scan(elems: _Elem, axis: int) -> _Elem:
    """Position t of the result holds e_t ∘ e_{t+1} ∘ … ∘ e_{L-1}: doubling
    over the time axis ``axis``."""
    L = elems.A.shape[axis]
    d = 1
    while d < L:
        head = _Elem(*(a.narrow(axis, 0, L - d) for a in elems))
        later = _Elem(*(a.narrow(axis, d, L - d) for a in elems))
        comb = _combine(head, later)
        elems = _Elem(*(torch.cat([c, a.narrow(axis, L - d, d)], dim=axis)
                        for c, a in zip(comb, elems)))
        d *= 2
    return elems


def parallel_riccati(derivs: Derivs, u: torch.Tensor) -> BackwardOut:
    """Unconstrained λ=0 backward pass by a log-depth scan, with the
    interface of :func:`~.backward.backward_pass`.

    ``derivs``: (..., T, ...) stacks; cross terms ``cxu`` are removed by the
    completion-of-squares reduction ũ = u + R⁻¹Nᵀx. ``diverged`` flags a
    non-PD ``Quu`` met pointwise, and ``diverge_idx`` is the largest failing
    step (the one the sequential recursion meets first)."""
    T, m = u.shape[-2:]
    n = derivs.cx.shape[-1]
    dtype, dev = u.dtype, u.device
    lead = la.lead_shape(u.shape[:-2], derivs.cx.shape[:-2])
    ax = len(lead)

    def run(a, core):
        return a.narrow(a.ndim - core - 1, 0, T - 1).expand(
            lead + (T - 1,) + tuple(a.shape[a.ndim - core:]))

    F, G, Q, R, N = (run(a, 2) for a in (derivs.fx, derivs.fu, derivs.cxx,
                                         derivs.cuu, derivs.cxu))
    q, r = run(derivs.cx, 1), run(derivs.cu, 1)

    # completion of squares: remove the cross terms
    RiNt = la.solve(R, N.mT)                           # (..., T-1, m, n)
    Rinv_r = la.solve_vec(R, r)
    elems = _Elem(A=F - G @ RiNt, b=-la.mv(G, Rinv_r),
                  C=G @ la.solve(R, G.mT), eta=-(q - la.mv(N, Rinv_r)),
                  J=Q - N @ RiNt)
    # terminal element: J = cxx_T, η = -cx_T, no transition
    zn = torch.zeros(lead + (1, n, n), dtype=dtype, device=dev)
    term = _Elem(A=zn, b=torch.zeros(lead + (1, n), dtype=dtype, device=dev),
                 C=zn,
                 eta=-derivs.cx[..., T - 1:, :].expand(lead + (1, n)),
                 J=derivs.cxx[..., T - 1:, :, :].expand(lead + (1, n, n)))
    elems = _Elem(*(torch.cat([a, b], dim=ax) for a, b in zip(elems, term)))
    suffix = _suffix_scan(elems, ax)
    J, eta = suffix.J, suffix.eta                      # (..., T, ·)

    # pointwise gains from V_{t+1}, batched over t
    J1, eta1 = J[..., 1:, :, :], eta[..., 1:, :]
    GtJ = G.mT @ J1
    Quu = R + GtJ @ G
    Qux = N.mT + GtJ @ F
    Qu = r + la.mv(G.mT, -eta1)
    chol = la.cholesky(sym(Quu))
    ok = torch.isfinite(chol).all(-1).all(-1)
    chol = torch.where(ok[..., None, None], chol,
                       torch.eye(m, dtype=dtype, device=dev))
    kK = -la.cho_solve(chol, torch.cat([Qu[..., None], Qux], dim=-1))
    k, K = kK[..., 0], kK[..., 1:]
    dv = torch.stack([(k * Qu).sum(-1),
                      0.5 * (k * la.mv(Quu, k)).sum(-1)], dim=-1)
    k = torch.cat([k, torch.zeros(lead + (1, m), dtype=dtype, device=dev)],
                  dim=ax)
    K = torch.cat([K, torch.zeros(lead + (1, m, n), dtype=dtype,
                                  device=dev)], dim=ax)
    Quu = torch.cat([Quu, derivs.cuu[..., T - 1:, :, :].expand(
        lead + (1, m, m))], dim=ax)

    diverged = ~ok.all(-1)
    steps = torch.arange(1, T, dtype=torch.int32, device=dev)
    bad = torch.where(~ok, steps, 0)
    diverge_idx = torch.where(diverged, bad.amax(-1), 0).to(torch.int32)
    policy = GaussianPolicy(K=K, k=k, sigma=la.inv(Quu), sigma_inv=Quu)
    return BackwardOut(diverged=diverged, diverge_idx=diverge_idx,
                       policy=policy, Vx=-eta, Vxx=sym(J), dV=dv.sum(-2))
