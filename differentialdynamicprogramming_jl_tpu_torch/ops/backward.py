"""Backward pass: regularised Riccati recursion with feedback gains.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/backward.py``:
one recursion for the reference's five ``back_pass`` variants
(``src/backward_pass.jl:81-252``) and the KL-augmented GPS variant
``back_pass_gps`` (``:259-350``) — time-invariant inputs broadcast to
``(T, ...)``, second-order terms on when ``fxx`` is given, GPS mode on when
``gps_mode`` is set, and a failed Cholesky factorisation a NaN flag latched
over the recursion instead of an exception.

The recursion over t is a host loop of batched torch operations: leading
dimensions of ``u`` (and of the derivative stack) are independent problems,
each with its own λ and limits, as ``jax.vmap(backward_pass)`` runs them. It
reads nothing back from the device inside the loop, except that the box QP
of m ≥ 2 with limits reads its own ``done`` (:mod:`.boxqp`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import as_tensor, like
from ..policy import Derivs, GaussianPolicy, sym
from . import _linalg as la
from .boxqp import boxqp, boxqp_1d


class KLTerms(NamedTuple):
    """KL cost-expansion terms from the previous policy (``∇kl``,
    ``src/klutils.jl:8-23``); ``cxu`` is Qux-shaped ``(T, m, n)`` exactly as
    the reference builds it (``src/klutils.jl:12,20``)."""

    cx: torch.Tensor    # (T, n)
    cu: torch.Tensor    # (T, m)
    cxx: torch.Tensor   # (T, n, n)
    cxu: torch.Tensor   # (T, m, n)
    cuu: torch.Tensor   # (T, m, m)


class BackwardOut(NamedTuple):
    """Results of one backward pass (reference return
    ``(diverge, GaussianPolicy, Vx, Vxx, dV)``, ``src/backward_pass.jl:128``),
    each with the problems' leading dimensions."""

    diverged: torch.Tensor      # bool: any timestep failed
    diverge_idx: torch.Tensor   # int32 1-based step of first failure (0 = ok)
    policy: GaussianPolicy      # k (T,m), K (T,m,n), Σ=Quu⁻¹, Σi=Quu
    Vx: torch.Tensor            # (T, n)
    Vxx: torch.Tensor           # (T, n, n)
    dV: torch.Tensor            # (2,) expected reduction [linear, quadratic]


def _col(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append ``ndim`` unit dims (a per-problem scalar against a vector or a
    matrix)."""
    return a.reshape(a.shape + (1,) * ndim)


def backward_pass(derivs: Derivs,
                  u,
                  lam=0.0,
                  reg_type: int = 1,
                  lims=None,
                  use_limits: bool = False,
                  eta=None,
                  kl_terms: Optional[KLTerms] = None,
                  qp_max_iter: int = 100,
                  gps_mode: bool = False) -> BackwardOut:
    """Run the backward recursion over a ``(..., T, ...)`` derivative stack
    along controls ``u`` (..., T, m).

    - ``lam``, ``reg_type``: Levenberg-Marquardt regularisation, a scalar or
      one per problem; type 1 adds ``λI`` to ``Quu``, type 2 to ``Vxx``
      (``src/backward_pass.jl:119-122``).
    - ``lims``: ``(m, 2)`` or per problem ``(..., m, 2)`` control limits
      (the boxQP gain solve, ``src/backward_pass.jl:43-61``) when
      ``use_limits=True``.
    - ``eta`` + ``kl_terms``: GPS mode (``gps_mode=True``), ``eta`` scalar,
      ``(T,)`` or ``(..., T)`` (``src/backward_pass.jl:262-263,293-299``).

    ``u`` keeps its device if it is a tensor, else goes to the CUDA card."""
    u = as_tensor(u)
    T, m = u.shape[-2:]
    n = derivs.cx.shape[-1]
    dtype, dev = u.dtype, u.device
    lead = la.lead_shape(u.shape[:-2], derivs.cx.shape[:-2])
    second_order = derivs.fxx is not None

    if gps_mode:
        if eta is None or kl_terms is None:
            raise ValueError("gps_mode needs eta and kl_terms")
        eta = like(eta, u)
        eta_vec = eta.expand(T) if eta.ndim == 0 else eta
    lam = like(lam, u)
    I_n = torch.eye(n, dtype=dtype, device=dev)
    I_m = torch.eye(m, dtype=dtype, device=dev)
    # formed once, outside the recursion: λI and the QP's bounds at every
    # step
    lamI = _col(lam, 2) * (I_n if reg_type == 2 else I_m)

    def steps(a, core=2):
        """The per-step views of a (..., T, core dims) stack, made once
        (a view a step and input costs the host as much as a launch)."""
        return a.unbind(a.ndim - core - 1)

    if use_limits:
        lims = like(lims, u)
        lower_s = steps(lims[..., None, :, 0] - u, 1)
        upper_s = steps(lims[..., None, :, 1] - u, 1)
    fx_s, fu_s, cxx_s, cuu_s = (steps(a) for a in (
        derivs.fx, derivs.fu, derivs.cxx, derivs.cuu))
    fxT_s, fuT_s, cxuT_s = (steps(a.mT) for a in (
        derivs.fx, derivs.fu, derivs.cxu))
    cx_s, cu_s = steps(derivs.cx, 1), steps(derivs.cu, 1)
    if second_order:
        fxx_s, fxu_s, fuu_s = (steps(a, 3) for a in (
            derivs.fxx, derivs.fxu, derivs.fuu))
    if gps_mode:
        eta1_s, eta2_s = steps(eta_vec[..., None], 1), steps(
            eta_vec[..., None, None])
        klx_s, klu_s = steps(kl_terms.cx, 1), steps(kl_terms.cu, 1)
        klxx_s, klux_s, kluu_s = (steps(a) for a in (
            kl_terms.cxx, kl_terms.cxu, kl_terms.cuu))

    # boundary at t = T-1 (src/backward_pass.jl:97-99, 280-283): the last
    # control is not optimised (k, K stay zero)
    Vx = derivs.cx[..., T - 1, :].expand(lead + (n,))
    Vxx = derivs.cxx[..., T - 1, :, :].expand(lead + (n, n))
    Quu_T = derivs.cuu[..., T - 1, :, :]
    if gps_mode:
        Quu_T = Quu_T / _col(eta_vec[..., T - 1], 2) + kl_terms.cuu[
            ..., T - 1, :, :]
    Quu_T = Quu_T.expand(lead + (m, m))

    def solve_gains(Quu_gain, Qu, Qux_gain, t, k_warm):
        """Cholesky (no limits) or boxQP (limits), with the regularised
        matrices (``src/backward_pass.jl:28-62``)."""
        if not use_limits:
            # a failed factor counts as non-finite, as JAX's NaN factor
            chol, info = torch.linalg.cholesky_ex(sym(Quu_gain))
            ok = (info == 0) & torch.isfinite(chol).all(-1).all(-1)
            chol = torch.where(_col(ok, 2), chol, I_m)
            kK = -la.cho_solve(chol, torch.cat([Qu[..., None], Qux_gain],
                                               dim=-1))
            return kK[..., 0], kK[..., 1:], ok
        # projected-Newton QP warm-started with the t+1 step's k
        # (src/backward_pass.jl:49)
        if m == 1:
            qp = boxqp_1d(Quu_gain, Qu, lower_s[t], upper_s[t])
        else:
            qp = boxqp(Quu_gain, Qu, lower_s[t], upper_s[t], k_warm,
                       max_iter=qp_max_iter)
        ok = qp.result >= 1
        free = qp.free[..., None]
        chol = torch.where(torch.isfinite(qp.chol), qp.chol, I_m)
        K_free = -la.cho_solve(chol, Qux_gain * free.to(dtype))
        return qp.x, torch.where(free, K_free, 0.0), ok

    dV = torch.zeros(lead + (2,), dtype=dtype, device=dev)
    k_prev = torch.zeros(lead + (m,), dtype=dtype, device=dev)
    outs, oks = [], []
    for t in range(T - 2, -1, -1):
        fx, fu, fxT, fuT, cxuT = (fx_s[t], fu_s[t], fxT_s[t], fuT_s[t],
                                  cxuT_s[t])
        # Q expansions (src/backward_pass.jl:103-123)
        Qu = cu_s[t] + la.mv(fuT, Vx)
        Qx = cx_s[t] + la.mv(fxT, Vx)
        fuTV = fuT @ Vxx
        Qux = cxuT + fuTV @ fx
        Quu0 = cuu_s[t] + fuTV @ fu
        Qxx = cxx_s[t] + fxT @ Vxx @ fx
        Quu = Quu0
        if second_order:
            fxuVx = torch.einsum("...a,...aij->...ji", Vx, fxu_s[t])  # (m, n)
            fuuVx = torch.einsum("...a,...aij->...ij", Vx, fuu_s[t])  # (m, m)
            fxxVx = torch.einsum("...a,...aij->...ij", Vx, fxx_s[t])  # (n, n)
            Qux = Qux + fxuVx
            Quu = Quu + fuuVx
            Qxx = Qxx + fxxVx
        if gps_mode:
            # η is the only regulariser (src/iLQGkl.jl:99): Q terms over η
            # plus the KL expansion (src/backward_pass.jl:293-299)
            e1, e2 = eta1_s[t], eta2_s[t]
            Qu = Qu / e1 + klu_s[t]
            Qux = Qux / e2 + klux_s[t]
            Quu = sym(Quu / e2 + kluu_s[t])
            Qx = Qx / e1 + klx_s[t]
            Qxx = Qxx / e2 + klxx_s[t]
            Quu_gain, Qux_gain = Quu, Qux
        else:
            # LM regularisation (src/backward_pass.jl:119-123): the gains
            # use the regularised matrices, the value update the raw ones
            if reg_type == 2:
                fuTV = fuT @ (Vxx + lamI)
                Qux_gain = cxuT + fuTV @ fx
                Quu_gain = cuu_s[t] + fuTV @ fu
                if second_order:
                    Qux_gain = Qux_gain + fxuVx
            else:
                Qux_gain = Qux      # Vxx + 0: the same values
                Quu_gain = Quu0 + lamI
            if second_order:
                Quu_gain = Quu_gain + fuuVx
        k, K, ok = solve_gains(Quu_gain, Qu, Qux_gain, t, k_prev)

        # value update with the unregularised Q terms
        # (src/backward_pass.jl:63-72, 336-341)
        Quu_k = la.mv(Quu, k)
        KT = K.mT
        dV = dV + torch.stack([(k * Qu).sum(-1), 0.5 * (k * Quu_k).sum(-1)],
                              dim=-1)
        Vx = Qx + la.mv(KT, Quu_k) + la.mv(KT, Qu) + la.mv(Qux.mT, k)
        Vxx = sym(Qxx + KT @ Quu @ K + KT @ Qux + Qux.mT @ K)
        oks.append(ok)
        k_prev = k
        outs.append((k, K, Vx, Vxx, Quu.expand(lead + (m, m))))

    outs.reverse()
    oks.reverse()
    # the first failure met going backward (the largest failing step) is
    # the one latched, as the scan latches it
    if oks:
        bad = ~torch.stack(oks, dim=-1)                  # (..., T-1)
        steps = torch.arange(1, T, dtype=torch.int32, device=dev)
        diverged = bad.any(-1)
        div_idx = torch.where(bad, steps, 0).amax(-1)
    else:
        diverged = torch.zeros(lead, dtype=torch.bool, device=dev)
        div_idx = torch.zeros(lead, dtype=torch.int32, device=dev)
    zk = torch.zeros(lead + (m,), dtype=dtype, device=dev)
    zK = torch.zeros(lead + (m, n), dtype=dtype, device=dev)
    last = (zk, zK, derivs.cx[..., T - 1, :].expand(lead + (n,)),
            derivs.cxx[..., T - 1, :, :].expand(lead + (n, n)), Quu_T)
    k, K, Vx_s, Vxx_s, Quu_s = (torch.stack([o[i] for o in outs] + [last[i]],
                                            dim=len(lead))
                                for i in range(5))
    policy = GaussianPolicy(K=K, k=k, sigma=la.inv(Quu_s), sigma_inv=Quu_s)
    return BackwardOut(diverged=diverged, diverge_idx=div_idx.to(torch.int32),
                       policy=policy, Vx=Vx_s, Vxx=Vxx_s, dV=dV)
