"""Tensor helpers of the generic tier.

Factorisations that return NaN where JAX's do, instead of raising:
``torch.linalg.cholesky``, ``inv`` and ``solve`` raise on a non-PD or
singular input, where ``jnp.linalg`` returns NaN. The ``*_ex`` forms report
the failure in ``info`` without a host sync; these fill each failed
matrix's result with NaN, which is what the solvers' divergence flags,
boxQP's result -1 and the λ escalation read. And the per-problem select
that freezes a finished problem of a batch, as a vmapped
``lax.while_loop`` does.
"""
from __future__ import annotations

import numpy as np
import torch


def _nan_where(out: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    bad = (info != 0).reshape(info.shape + (1,) * (out.ndim - info.ndim))
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., m, m); where A is not PD, NaN on and
    below the diagonal and 0 above it, as ``jnp.linalg.cholesky``."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


def inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., m, m); NaN where A is singular."""
    Ai, info = torch.linalg.inv_ex(A)
    return _nan_where(Ai, info)


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A⁻¹B for A (..., n, n), B (..., n, k); NaN where A is singular."""
    X, info = torch.linalg.solve_ex(A, B)
    return _nan_where(X, info)


def solve_vec(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹b for b (..., n)."""
    return solve(A, b[..., None])[..., 0]


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.linalg.cho_solve((L, True), b)``: (LLᵀ)⁻¹b for a lower
    factor L (..., m, m) and b (..., m) or (..., m, k)."""
    if b.ndim == L.ndim - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for A (..., p, q), x (..., q)."""
    return (A @ x[..., None])[..., 0]


def where_lanes(mask: torch.Tensor, new, old):
    """Per-problem select over (nested) tuples of tensors whose leading
    dims are ``mask``'s: ``new`` where ``mask`` is set, else ``old``; None
    leaves stay None."""
    if new is None:
        return None
    if isinstance(new, tuple):
        out = [where_lanes(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*out) if hasattr(new, "_fields") else tuple(out)
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def lead_shape(*shapes) -> torch.Size:
    """The broadcast of batch shapes (``torch.broadcast_shapes`` without
    its first call's import of the symbolic-shape machinery)."""
    return torch.Size(np.broadcast_shapes(*(tuple(a) for a in shapes)))
