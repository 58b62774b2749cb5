"""Carry parameters and state between the JAX package and this port, as numpy.

Nothing here imports ``jax``: fields are read with ``dataclasses.fields``
and ``getattr``, and arrays through ``numpy.asarray``, so any object with
the right fields converts. The parity tests feed both packages through
these functions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve
from .models.linear import LTISpec
from .models.pendcart import PendCartSpec
from .models.quadrotor import QuadrotorSpec
from .ops.backward import KLTerms
from .policy import Derivs, GaussianPolicy, Trace
from .solvers.ilqg import ILQGConfig, ILQGResult
from .solvers.ilqgkl import ILQGKLConfig

B_TILE = 1024   # scenarios per (8, 128) lane tile of the TPU layout


def _fields(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def spec_from_jax(spec) -> PendCartSpec:
    """Any object with PendCartSpec's fields → the port's PendCartSpec."""
    kw = _fields(PendCartSpec, spec)
    kw["Q"] = tuple(float(q) for q in kw["Q"])
    kw["goal"] = tuple(float(v) for v in kw["goal"])
    for name in ("R", "g", "l", "h", "d"):
        kw[name] = float(kw[name])
    return PendCartSpec(**kw)


def quadrotor_spec_from_jax(spec) -> QuadrotorSpec:
    """Any object with QuadrotorSpec's fields → the port's QuadrotorSpec."""
    kw = {name: float(v) if not isinstance(v, tuple)
          else tuple(float(a) for a in v)
          for name, v in _fields(QuadrotorSpec, spec).items()}
    return QuadrotorSpec(**kw)


def lti_spec_from_jax(spec, dtype=torch.float32, device=None) -> LTISpec:
    """Any object with fields A, B, Q, R, x0, u0 holding arrays (the JAX
    package's LTISpec) → the port's LTISpec, tensors of ``dtype`` on
    ``device`` (None: the CUDA card)."""
    device = resolve(device)
    return LTISpec(**{
        name: torch.tensor(np.asarray(getattr(spec, name)), dtype=dtype,
                           device=device)
        for name in LTISpec._fields})


def config_from_jax(cfg) -> ILQGConfig:
    """The JAX package's ILQGConfig (or any object with its fields) → the
    port's ILQGConfig."""
    kw = _fields(ILQGConfig, cfg)
    kw["alphas"] = tuple(float(a) for a in kw["alphas"])
    return ILQGConfig(**kw)


def kl_config_from_jax(cfg) -> ILQGKLConfig:
    """The JAX package's ILQGKLConfig (or any object with its fields) → the
    port's ILQGKLConfig."""
    kw = _fields(ILQGKLConfig, cfg)
    kw["eta_bracket"] = tuple(float(v) for v in kw["eta_bracket"])
    return ILQGKLConfig(**kw)


def policy_from_jax(policy, dtype=torch.float32, device=None
                    ) -> GaussianPolicy:
    """A (batched) JAX GaussianPolicy, or any object with fields K, k,
    sigma, sigma_inv holding arrays, → the port's GaussianPolicy with
    tensors of ``dtype`` on ``device`` (None: the CUDA card); the layout is
    kept ((B, T, ...))."""
    device = resolve(device)
    return GaussianPolicy(**{
        name: torch.tensor(np.asarray(getattr(policy, name)), dtype=dtype,
                           device=device)
        for name in GaussianPolicy._fields})


def _leaf(a, dtype, device):
    """An array as a tensor on ``device``: floats as ``dtype``, integers as
    int32, booleans as bool."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _tuple_from_jax(cls, obj, dtype, device, nested=None):
    """Any object with ``cls``'s fields → ``cls`` of tensors; ``nested``
    maps a field name to the NamedTuple class of that field."""
    device = resolve(device)
    nested = nested or {}
    out = {}
    for name in cls._fields:
        v = getattr(obj, name, None)
        if v is None:
            out[name] = None
        elif name in nested:
            out[name] = _tuple_from_jax(nested[name], v, dtype, device)
        else:
            out[name] = _leaf(v, dtype, device)
    return cls(**out)


def derivs_from_jax(derivs, dtype=torch.float32, device=None) -> Derivs:
    """A JAX ``Derivs`` (any object with its fields; the second-order ones
    may be None) → the port's ``Derivs`` on ``device`` (None: the card)."""
    return _tuple_from_jax(Derivs, derivs, dtype, device)


def kl_terms_from_jax(terms, dtype=torch.float32, device=None) -> KLTerms:
    """A JAX ``KLTerms`` → the port's ``KLTerms``."""
    return _tuple_from_jax(KLTerms, terms, dtype, device)


def trace_from_jax(trace, dtype=torch.float32, device=None) -> Trace:
    """A JAX ``Trace`` → the port's ``Trace`` (accepted stays bool)."""
    return _tuple_from_jax(Trace, trace, dtype, device)


def ilqg_result_from_jax(res, dtype=torch.float32, device=None
                         ) -> ILQGResult:
    """A JAX ``ILQGResult`` → the port's, e.g. to resume a JAX solve in the
    port (its x, cost, lam, dlam and n_accepted)."""
    return _tuple_from_jax(ILQGResult, res, dtype, device,
                           nested={"policy": GaussianPolicy,
                                   "trace": Trace})


def stream_from_lanes(a, B: int) -> np.ndarray:
    """TPU lane array (..., nB, 8, 128) → stream (..., B): e.g.
    (T, S, nB, 8, 128) → (T, S, B), or stats (4, nB, 8, 128) → (4, B)."""
    a = np.asarray(a)
    return a.reshape(a.shape[:-3] + (-1,))[..., :B].copy()


def stream_to_lanes(a) -> np.ndarray:
    """Stream (..., B) → TPU lane array (..., nB, 8, 128), zero-padded to a
    multiple of 1024 scenarios."""
    a = np.asarray(a)
    B = a.shape[-1]
    Bp = -(-B // B_TILE) * B_TILE
    pad = np.zeros(a.shape[:-1] + (Bp - B,), a.dtype)
    return np.concatenate([a, pad], axis=-1).reshape(
        a.shape[:-1] + (Bp // B_TILE, 8, 128))


def _to_numpy(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return result_to_numpy(v)
    return np.asarray(v)


def result_to_numpy(res) -> dict:
    """A result NamedTuple of either package (BatchILQGResult, the kernels'
    outputs, ...) → dict of numpy arrays, nested NamedTuples as dicts."""
    return {name: _to_numpy(getattr(res, name)) for name in res._fields}
