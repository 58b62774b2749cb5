"""Forward-pass operators of the generic tier.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/forward.py``; this
slice has :func:`forward_covariance` (``:119-144``). The rollout and the line
search of the generic tier are not ported yet.
"""
from __future__ import annotations

import torch

from ..device import as_tensor
from ..policy import GaussianPolicy


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
