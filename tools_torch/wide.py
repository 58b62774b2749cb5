"""Sizes past the lane design of K1, shared by ``tests/test_torch_cuda.py``,
``tests/test_torch_wide_sizes.py`` and ``chip_smoke.py``'s humanoid group.

- :data:`HUMANOID`: the DeepMind Control Suite humanoid's linearisation
  (``dm_control/suite/humanoid.xml``: 21 actuators, 27 velocity dofs, so 54
  tangent-space states), for the LTI family (``random_lti``).
- :data:`CHECKS`: the smallest sizes at which ``plan.backward_plan`` picks
  K1's wide design, each with the emissions (and GPS mode) checked there:
  ⟨30,2⟩ in ``full`` (its ``gains`` keeps the lane design), ⟨28,8⟩ in
  every mode.
- :data:`CEILING`: ``plan.MAX_STATES``, ``plan.MAX_CONTROLS``.
- :func:`k1_inputs`: a trajectory stream, λ and the previous policy of GPS
  mode for K1 at any size; :func:`k23_inputs`: K3's and K2's inputs.
- :func:`sparse_lti`: a banded LTI at any size, whose lowering (which
  skips zero coefficients) is a few hundred operations where a dense one's
  at the ceiling is 12k (14 s to trace, 99 s of nvcc): K2's and K3's
  checks at the ceiling test their ring, not the model.

Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

HUMANOID = (54, 21)
BOX = 0.6
# (n, m): the (GPS mode, emission) pairs checked there
CHECKS = {(30, 2): ((False, "full"),),
          (28, 8): ((False, "gains"), (False, "full"), (False, "policy"),
                    (True, "full"), (True, "policy"))}
CEILING = (64, 32)


def sparse_lti(spec_cls, n: int, m: int, T: int, dev):
    """An LTI ``spec_cls`` (the port's LTISpec) at (n, m): A = I plus 0.01
    on the superdiagonal, B with control j on states 2j mod n and 2j+1 mod
    n (±0.01), Q = 0.01·I, R = 0.001·I, x0 = 1, u0 = 0."""
    f32 = dict(dtype=torch.float32, device=dev)
    A = torch.eye(n, **f32) + 0.01 * torch.diag(torch.ones(n - 1, **f32), 1)
    Bm = torch.zeros((n, m), **f32)
    for j in range(m):
        Bm[(2 * j) % n, j] = 0.01
        Bm[(2 * j + 1) % n, j] = -0.01
    return spec_cls(A=A, B=Bm, Q=0.01 * torch.eye(n, **f32),
                    R=0.001 * torch.eye(m, **f32), x0=torch.ones(n, **f32),
                    u0=torch.zeros((T, m), **f32))


def k1_inputs(n: int, m: int, T: int, B: int, seed: int, dev):
    """K1's inputs from numpy seed ``seed``: a trajectory stream (T, n+m, B)
    (x ~ N(0,1), u ~ 0.3·N(0,1)), λ (B,) = 10^U(-3, 1) with every eighth
    λ 0, and GPS mode's previous policy (T, m+m·n+m², B) [k, K, an SPD Σ⁻¹]
    and per-step η (T, B) in [0.1, 10]."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    traj = np.concatenate([rng.standard_normal((T, n, B)),
                           0.3 * rng.standard_normal((T, m, B))], axis=1)
    lam = 10.0 ** rng.uniform(-3, 1, B)
    lam[::8] = 0.0
    a = rng.standard_normal((T, B, m, m)) / np.sqrt(m)
    si = np.einsum("tbij,tbkj->tbik", a, a) + 0.5 * np.eye(m)
    prev = np.concatenate([rng.standard_normal((T, m, B)),
                           0.5 * rng.standard_normal((T, m * n, B)),
                           np.moveaxis(si.reshape(T, B, m * m), 1, 2)],
                          axis=1)
    eta = 10.0 ** rng.uniform(-1, 1, (T, B))
    return (torch.tensor(traj, **f32), torch.tensor(lam, **f32),
            torch.tensor(prev, **f32), torch.tensor(eta, **f32))


def k23_inputs(n: int, m: int, T: int, B: int, seed: int, dev):
    """K3's and K2's inputs from numpy seed ``seed``: a [x, u, c] stream
    (T, n+m+1, B), gains (T, m+m·n, B) with k ~ 0.5·N(0,1) and K ~
    0.05·N(0,1), x0 (n, B), and K2's sel (4, B) [dV1 < 0, dV2 > 0, cost,
    allow on every other lane]."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    traj = rng.standard_normal((T, n + m + 1, B))
    gains = np.concatenate([0.5 * rng.standard_normal((T, m, B)),
                            0.05 * rng.standard_normal((T, m * n, B))],
                           axis=1)
    x0 = rng.standard_normal((n, B))
    sel = np.stack([-np.abs(rng.standard_normal(B)),
                    np.abs(rng.standard_normal(B)),
                    rng.uniform(50.0, 100.0, B),
                    (np.arange(B) % 2 == 0).astype(np.float64)])
    return tuple(torch.tensor(v, **f32) for v in (traj, gains, x0, sel))
