"""KL-divergence machinery of the GPS-style trust-region solver.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/kl.py``
(reference ``src/klutils.jl``): the KL cost-expansion terms ``∇kl``
(``:8-23``), the closed-form Gaussian-policy KL ``kl_div_wiki``
(``:70-100``), ``entropy`` (``:104``), the dual bracketing ``calc_η``
(``:110-154``) and the ADAM optimiser of the per-step-η variant
(``:186-210``). All are batched over the time axis with plain torch
operations, no loops.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch

from ..device import resolve
from ..policy import GaussianPolicy
from .backward import KLTerms


def grad_kl(traj_prev: GaussianPolicy) -> KLTerms:
    """Q-term additions from the KL constraint w.r.t. the previous policy
    (``∇kl``, ``src/klutils.jl:8-23``):

        cx = K'Σ⁻¹k, cu = -Σ⁻¹k, cxx = K'Σ⁻¹K, cuu = Σ⁻¹, cxu = -Σ⁻¹K
    """
    K, k, Si = traj_prev.K, traj_prev.k, traj_prev.sigma_inv
    Sik = torch.einsum("...tij,...tj->...ti", Si, k)         # (T, m)
    SiK = torch.einsum("...tij,...tjn->...tin", Si, K)       # (T, m, n)
    return KLTerms(
        cx=torch.einsum("...tmn,...tm->...tn", K, Sik),
        cu=-Sik,
        cxx=torch.einsum("...tmi,...tmj->...tij", K, SiK),
        cxu=-SiK,
        cuu=Si,
    )


def _logdet(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.slogdet(A)[1]


def pd_ok(S: torch.Tensor) -> torch.Tensor:
    """Per-matrix PD flag of a (..., m, m) symmetric stack (smallest
    eigenvalue > 0), the stand-in for Julia's ``logdet`` DomainError
    (``src/klutils.jl:84``). A matrix with a NaN or an infinity is not PD
    (``jnp.linalg.eigvalsh`` gives NaN there; torch's raises)."""
    finite = torch.isfinite(S).all(-1).all(-1)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    S = torch.where(finite[..., None, None], S, eye)
    return finite & (torch.linalg.eigvalsh(S)[..., 0] > 0)


def kl_div_wiki(x_new, x_old, sigma_new, traj_new: GaussianPolicy,
                traj_prev: GaussianPolicy) -> torch.Tensor:
    """Closed-form per-step KL divergence between the new and the previous
    time-varying affine-Gaussian policies (``src/klutils.jl:70-100``):

        KL_t = ½(tr(Σp⁻¹Σn) + Δk'Σp⁻¹Δk - m + logdet Σp - logdet Σn)
             + ½(μ'ΔK'Σp⁻¹ΔK μ + tr(ΔK'Σp⁻¹ΔK Σxx))
             + Δk'Σp⁻¹ΔK μ,   clipped at 0

    where μ = x_new - x_old and Σxx the state block of ``sigma_new``."""
    m, n = traj_new.m, traj_new.n
    mu = x_new - x_old                                      # (T, n)
    Sxx = sigma_new[..., :n, :n]                            # (T, n, n)
    k_diff = traj_prev.k - traj_new.k                       # (T, m)
    K_diff = traj_prev.K - traj_new.K                       # (T, m, n)
    Sip = traj_prev.sigma_inv
    Sp, Sn = traj_prev.sigma, traj_new.sigma

    tr_term = torch.einsum("...tij,...tji->...t", Sip, Sn)
    kk = torch.einsum("...ti,...tij,...tj->...t", k_diff, Sip, k_diff)
    ld = _logdet(Sp) - _logdet(Sn)
    kl = 0.5 * (tr_term + kk - m + ld)

    SipKd = torch.einsum("...tij,...tjn->...tin", Sip, K_diff)    # (T, m, n)
    KdSipKd = torch.einsum("...tmi,...tmj->...tij", K_diff, SipKd)
    kl = kl + 0.5 * (torch.einsum("...ti,...tij,...tj->...t", mu, KdSipKd,
                                  mu)
                     + torch.einsum("...tij,...tji->...t", KdSipKd, Sxx))
    kl = kl + torch.einsum("...ti,...tin,...tn->...t", k_diff, SipKd, mu)
    return torch.clamp_min(kl, 0.0)


def kl_div_gaussian(x_new, x_old, u_new, sigma_new, traj_new: GaussianPolicy,
                    traj_prev: GaussianPolicy) -> torch.Tensor:
    """The reference's alternative ``kl_div`` (``src/klutils.jl:39-65``),
    which can go negative and is clipped; the stacked mean is
    μ = [Δx; u_new]."""
    mu = torch.cat([x_new - x_old, u_new], dim=-1)           # (T, n+m)

    def mv(Si, K, k):
        # (src/klutils.jl:28-34): M = [[K'SiK, -K'Si], [-SiK, Si]],
        # v = [K'Sik; -Sik]
        KSi = torch.einsum("...tmn,...tmj->...tnj", K, Si)   # (T, n, m)
        M = torch.cat([
            torch.cat([torch.einsum("...tnm,...tmj->...tnj", KSi, K), -KSi],
                      dim=-1),
            torch.cat([-torch.einsum("...tij,...tjn->...tin", Si, K), Si],
                      dim=-1),
        ], dim=-2)
        Sik = torch.einsum("...tij,...tj->...ti", Si, k)
        v = torch.cat([torch.einsum("...tmn,...tm->...tn", K, Sik), -Sik],
                      dim=-1)
        return M, v

    kp = traj_prev.k
    kn = traj_new.k + kp   # src/klutils.jl:51
    Mp, vp = mv(traj_prev.sigma_inv, traj_prev.K, kp)
    Mn, vn = mv(traj_new.sigma_inv, traj_new.K, kn)
    cp = 0.5 * torch.einsum("...ti,...tij,...tj->...t", kp,
                            traj_prev.sigma_inv, kp)
    cn = 0.5 * torch.einsum("...ti,...tij,...tj->...t", kn,
                            traj_new.sigma_inv, kn)
    dM, dv = Mn - Mp, vn - vp
    kl = (-0.5 * torch.einsum("...ti,...tij,...tj->...t", mu, dM, mu)
          - torch.einsum("...ti,...ti->...t", mu, dv) - cn + cp
          - 0.5 * torch.einsum("...tij,...tij->...t", sigma_new, dM)
          - 0.5 * _logdet(traj_new.sigma) + 0.5 * _logdet(traj_prev.sigma))
    return torch.clamp_min(kl, 0.0)


def entropy(traj: GaussianPolicy) -> torch.Tensor:
    """Mean policy entropy (``src/klutils.jl:104``)."""
    return (torch.mean(_logdet(traj.sigma), dim=-1) / 2.0
            + traj.m * math.log(2.0 * math.pi) / 2.0)


def geom(bracket: torch.Tensor) -> torch.Tensor:
    """Geometric mean of the bracket endpoints (``src/klutils.jl:155-156``)."""
    return torch.sqrt(bracket[0] * bracket[2])


def calc_eta(divergence, eta_bracket: torch.Tensor,
             kl_step: Union[float, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual-variable bracket update (``calc_η``, ``src/klutils.jl:110-154``).

    ``eta_bracket``: ``[η_min, η, η_max]``, ``(3,)`` for one KL constraint or
    ``(3, T)`` per step; ``divergence``: the measured KL, scalar or ``(T,)``.
    Returns ``(new_bracket, satisfied)``. η too big (violation < 0): shrink
    from above — ``η_max ← η``, ``η ← max(√(η_min η_max), 0.1 η_max)``; too
    small: grow from below — ``η_min ← η``, ``η ← min(√(η_min η_max),
    10 η_min)``. Elements already satisfied stay frozen."""
    dtype, dev = eta_bracket.dtype, eta_bracket.device
    kl_step = torch.as_tensor(kl_step, dtype=dtype, device=dev)
    violation = divergence - kl_step
    satisfied_each = torch.abs(violation) < 0.1 * kl_step
    satisfied = satisfied_each.all() | (kl_step <= 0).all()

    too_big = violation < 0
    lo, mid, hi = eta_bracket[0], eta_bracket[1], eta_bracket[2]
    hi_b = mid
    mid_b = torch.maximum(torch.sqrt(lo * hi_b), 0.1 * hi_b)
    lo_s = mid
    mid_s = torch.minimum(torch.sqrt(lo_s * hi), 10.0 * lo_s)

    new_lo = torch.where(too_big, lo, lo_s)
    new_mid = torch.where(too_big, mid_b, mid_s)
    new_hi = torch.where(too_big, hi_b, hi)
    keep = satisfied_each | (kl_step <= 0)
    return torch.stack([torch.where(keep, lo, new_lo),
                        torch.where(keep, mid, new_mid),
                        torch.where(keep, hi, new_hi)]), satisfied


# ADAM (functional) — reference ADAMOptimizer (src/klutils.jl:186-210)

class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def adam_init(shape, dtype=torch.float32, device=None) -> AdamState:
    """Zero moments of ``shape``; ``device=None`` is the CUDA card."""
    dev = resolve(device)
    return AdamState(m=torch.zeros(shape, dtype=dtype, device=dev),
                     v=torch.zeros(shape, dtype=dtype, device=dev))


def adam_update(state: AdamState, theta: torch.Tensor, g: torch.Tensor, t,
                alpha: float = 0.005, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8):
    """One ADAM step, the reference update (``src/klutils.jl:203-210``);
    ``t`` is the 1-based iteration count. Returns ``(theta_new, state)``."""
    t = torch.as_tensor(t, dtype=theta.dtype, device=theta.device)
    m = beta1 * state.m + (1 - beta1) * g
    v = beta2 * state.v + (1 - beta2) * g ** 2
    m_hat = m / (1 - beta1 ** t)
    v_hat = v / (1 - beta2 ** t)
    return theta - alpha * m_hat / (torch.sqrt(v_hat) + eps), AdamState(m, v)
