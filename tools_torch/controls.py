"""Models at many controls, shared by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s controls group.

- :data:`SIZES`: the (n, m) at which K1, K2 and K3 are checked against
  their plain versions beyond the kernel library's m ≤ 4, up to the
  ceiling ``plan.MAX_CONTROLS`` = 16.
- :data:`ARM`: the 7-joint arm's shape, n = 14 (angle and rate of each
  joint), m = 7 (a torque each), for the LTI family (``random_lti``).
- :func:`so_tiles`: second-order tiles of a model whose dynamics are
  linear, the first-order tiles plus zero ``fxx``, ``fxu`` and ``fuu``, so
  that a user's second-order tiles (``LoweredTiles`` with
  ``SECOND_ORDER``) run at any (n, m).
- :func:`lti_inputs`: a K3 rollout's inputs for an LTI at any size.

Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

SIZES = ((6, 5), (10, 8), (16, 16))
ARM = (14, 7)
BOX = 0.6


def so_tiles(tiles_cls, first, n: int, m: int):
    """A ``tiles_cls`` (the port's DerivsTiles) without a descriptor whose
    function returns ``first``'s tiles and the dynamics Hessians, zero:
    fxx[a][i][j], fxu[a][j][mi], fuu[a][mi][mj]."""
    fn = getattr(first, "fn", first)

    def tiles(x, u, t):
        d = dict(fn(x, u, t))
        z = torch.zeros_like(x[0])
        d["fxx"] = [[[z] * n for _ in range(n)] for _ in range(n)]
        d["fxu"] = [[[z] * m for _ in range(n)] for _ in range(n)]
        d["fuu"] = [[[z] * m for _ in range(m)] for _ in range(n)]
        return d

    return tiles_cls(fn=tiles)


def lti_inputs(n: int, m: int, T: int, B: int, seed: int, dev):
    """x0 (n, B) around linspace(0.5, 2) and a gains stream (T, m+m·n, B)
    with k ~ 2·N(0,1) and zero K, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(np.linspace(0.5, 2.0, B)[None, :]
                      + 0.3 * rng.standard_normal((n, B)), **f32)
    gains = torch.cat([torch.tensor(2.0 * rng.standard_normal((T, m, B)),
                                    **f32),
                       torch.zeros((T, m * n, B), **f32)], dim=1)
    return x0, gains

