"""Core result types of the PyTorch port.

Counterpart of ``differentialdynamicprogramming_jl_tpu/policy.py``: the
same fields and time-major layout ``(T, ...)``, holding ``torch.Tensor``
leaves. Batched results add a leading scenario axis ``(B, T, ...)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .device import resolve


class GaussianPolicy(NamedTuple):
    """Time-varying affine-Gaussian controller ``u_t = k_t + K_t @ dx_t + noise``
    (reference ``GaussianPolicy``, ``src/iLQG.jl:39-53``).

    - ``K``: feedback gains ``(T, m, n)``
    - ``k``: feedforward controls ``(T, m)``
    - ``sigma``: controller covariance ``Σ = Quu⁻¹``, ``(T, m, m)``
    - ``sigma_inv``: ``Σ⁻¹ = Quu``, ``(T, m, m)``
    """

    K: torch.Tensor
    k: torch.Tensor
    sigma: torch.Tensor
    sigma_inv: torch.Tensor

    @property
    def T(self) -> int:
        return self.k.shape[-2]

    @property
    def m(self) -> int:
        return self.k.shape[-1]

    @property
    def n(self) -> int:
        return self.K.shape[-1]

    @staticmethod
    def zeros(T: int, n: int, m: int, dtype=torch.float32,
              device=None) -> "GaussianPolicy":
        """Zero-gain unit-covariance policy (reference ctor ``src/iLQG.jl:51``);
        ``device=None`` is the CUDA card."""
        device = resolve(device)
        eye = torch.eye(m, dtype=dtype, device=device).expand(T, m, m)
        return GaussianPolicy(
            K=torch.zeros((T, m, n), dtype=dtype, device=device),
            k=torch.zeros((T, m), dtype=dtype, device=device),
            sigma=eye.clone(),
            sigma_inv=eye.clone(),
        )


class Derivs(NamedTuple):
    """Stacked derivatives of dynamics and cost along a trajectory
    (reference user-``df`` tuple, ``src/iLQG.jl:77-84``), time-major.

    - ``fx[t] (n, n)``, ``fu[t] (n, m)`` at ``(x_t, u_t)``
    - ``cx[t] (n,)``, ``cu[t] (m,)``, ``cxx[t] (n, n)``, ``cxu[t] (n, m)``,
      ``cuu[t] (m, m)``
    - second-order dynamics terms ``fxx (n, n, n)``, ``fxu (n, n, m)``,
      ``fuu (n, m, m)`` are ``None`` for iLQG.
    """

    fx: torch.Tensor
    fu: torch.Tensor
    cx: torch.Tensor
    cu: torch.Tensor
    cxx: torch.Tensor
    cxu: torch.Tensor
    cuu: torch.Tensor
    fxx: Optional[torch.Tensor] = None
    fxu: Optional[torch.Tensor] = None
    fuu: Optional[torch.Tensor] = None


class Trace(NamedTuple):
    """Fixed-shape per-iteration convergence record (reference ``MVHistory``
    trace keys, ``src/iLQG.jl:175-177, 325-330``; ``src/iLQGkl.jl:161-166``):
    tensors of length ``cap`` (``(..., cap)`` batched); entries past
    ``n_iters`` are zero (NaN for ``alpha``)."""

    lam: torch.Tensor           # λ per iteration
    dlam: torch.Tensor          # dλ
    alpha: torch.Tensor         # accepted line-search step (NaN when rejected)
    cost: torch.Tensor          # total trajectory cost
    grad_norm: torch.Tensor
    improvement: torch.Tensor   # Δcost
    reduce_ratio: torch.Tensor
    divergence: torch.Tensor    # KL divergence (iLQGkl) / 0
    eta: torch.Tensor           # η dual (iLQGkl) / 0
    accepted: torch.Tensor      # bool: step accepted

    @staticmethod
    def zeros(n: int, dtype=torch.float32, device=None,
              lead: tuple = ()) -> "Trace":
        """A record of ``n`` entries, with leading batch dims ``lead``;
        ``device=None`` is the CUDA card."""
        device = resolve(device)
        shape = tuple(lead) + (n,)

        def z():
            return torch.zeros(shape, dtype=dtype, device=device)

        return Trace(z(), z(), torch.full(shape, float("nan"), dtype=dtype,
                                          device=device),
                     z(), z(), z(), z(), z(), z(),
                     torch.zeros(shape, dtype=torch.bool, device=device))


def sym(A: torch.Tensor) -> torch.Tensor:
    """Symmetrize: the reference does this to ``Vxx`` and ``Quu``
    (``src/backward_pass.jl:71-72,301``)."""
    return 0.5 * (A + A.transpose(-1, -2))
