"""Forward state-covariance propagation (K4).

Counterpart of
``differentialdynamicprogramming_jl_tpu/ops/pallas/covariance_kernel.py``
(reference ``forward_covariance``, ``src/forward_pass.jl:37-56``): the
discrete Lyapunov iteration

    Σ[0] = R1;   Σ[t+1] = F[t]·Σ[t]·F[t]ᵀ + R1

per scenario, whose Σxx stream feeds the policy KL of the KL/GPS solve.

:func:`covariance_lanes` gives a CPU tensor to :func:`covariance_lanes_ref`,
the plain PyTorch version (vectorised over B and the matrix entries, Python
loop over t, in the kernel's sum order), and a CUDA tensor to the
hand-written kernel in ``csrc/covariance.cu`` with its launch plan
(:func:`.plan.covariance_plan`), or raises. n = 4, 6 and 10 are in the
kernel library; any other n up to ``plan.COV_MAX_N`` is a library of its
own, built at its first launch (:func:`._build.covariance_library`), and
beyond ``plan.COV_RING_MAX_N`` its kernel keeps Σ in device memory, R1 in
slot 0 of the output, which the wrapper fills before the launch. Launches
are counted in ``covariance_lanes.launches``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import _build, plan
from .forward_kernel import launch_args, launch_device

# state sizes the kernel library is instantiated for; any other n from 1 to
# plan.COV_MAX_N is built at its first launch
CUDA_N = (4, 6, 10)


def identity_r1(n: int):
    """The default prediction covariance R1 = I (JAX ``batch_kl.py:267-269``)."""
    return tuple(tuple(1.0 if i == j else 0.0 for j in range(n))
                 for i in range(n))


def covariance_lanes_ref(fx: torch.Tensor, *, n: int,
                         r1: Sequence[Sequence[float]]) -> torch.Tensor:
    """Plain version of :func:`covariance_lanes` (same arguments)."""
    T, _, B = fx.shape
    F_all = fx.reshape(T, n, n, B)
    R = torch.tensor(np.asarray(r1, np.float32), device=fx.device)[..., None]
    out = torch.empty((T, n, n, B), dtype=fx.dtype, device=fx.device)
    S = R.expand(n, n, B)
    for t in range(T):
        out[t] = S
        if t == T - 1:
            break
        F = F_all[t]
        # FS[i][c] = Σ_a F[i][a]·S[a][c], summed over a left to right
        FS = F[:, 0, None] * S[None, 0]
        for a in range(1, n):
            FS = FS + F[:, a, None] * S[None, a]
        # S'[i][j] = Σ_c FS[i][c]·F[j][c] + R1[i][j]
        Sn = FS[:, None, 0] * F[None, :, 0]
        for c in range(1, n):
            Sn = Sn + FS[:, None, c] * F[None, :, c]
        S = Sn + R
    return out.reshape(T, n * n, B)


def covariance_lanes(fx: torch.Tensor, *, n: int,
                     r1: Optional[Sequence[Sequence[float]]] = None
                     ) -> torch.Tensor:
    """Propagate Σxx along the horizon.

    ``fx``: per-scenario linearisations, a (T, n², B) stream (row-major
    n×n); ``r1``: static (n, n) prediction covariance (reference ``R1``,
    ``src/forward_pass.jl:40``), identity by default. Returns the Σxx stream
    (T, n², B) whose slot t holds Σxx[t] (Σxx[0] = R1).

    On CUDA tensors n may be 1 to ``plan.COV_MAX_N``; a larger n raises
    NotImplementedError naming that limit. The JAX signature's ``k_t`` and
    ``interpret`` are TPU switches and are not taken here.
    """
    r1 = identity_r1(n) if r1 is None else r1
    T, nn, B = fx.shape
    if nn != n * n or T < 1 or np.shape(r1) != (n, n):
        raise ValueError(f"covariance_lanes: fx {tuple(fx.shape)} for n={n}, "
                         f"r1 of shape {np.shape(r1)}")
    if fx.device.type == "cpu":
        return covariance_lanes_ref(fx, n=n, r1=r1)
    shape = plan.cov_shape(n)        # raises beyond plan.COV_MAX_N
    if n in CUDA_N:
        lib, dev, stream = launch_args("covariance_lanes", fx)
    else:
        dev, stream = launch_device("covariance_lanes", fx)
        lib = _build.covariance_library(n)
    out = torch.empty_like(fx)
    r1_host = np.ascontiguousarray(r1, np.float32)
    if shape.sigma == plan.COV_GLOBAL:
        # Σ[0] = R1 in every scenario's column: the kernel reads R1 there
        out[0] = torch.from_numpy(r1_host.reshape(n * n, 1)).to(fx.device)
    p = plan.covariance_plan(n, T, B)
    rc = lib.ddp_covariance_lanes(fx.data_ptr(), out.data_ptr(), T, B, n,
                                  r1_host.ctypes.data, shape.warps,
                                  shape.sigma, *p.launcher_args(), dev,
                                  stream)
    _build.check(lib, rc, "covariance_lanes")
    covariance_lanes.launches += 1
    return out


covariance_lanes.launches = 0
