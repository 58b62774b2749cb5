#!/usr/bin/env python3
"""The JAX package's outcome of ``demo_quadrotor``'s solve at its CPU cut
(B=8, T=12, 3 iterations; JAX ``demos.py:277-283``) on the port's inputs
(``differentialdynamicprogramming_jl_tpu_torch.demos._quad_inputs``),
written to ``tools_torch/demo_outcomes.npz`` for
``tests/test_torch_demos_parity.py``: the interpret-mode lane solve of the
quadrotor costs minutes to trace, too long for a tier-1 test.

Run from the root of a checkout with JAX on the CPU: ``python3
tools_torch/make_demo_outcomes.py`` (several minutes).
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from differentialdynamicprogramming_jl_tpu.models.quadrotor import (  # noqa: E402
    QuadrotorSpec, quadrotor_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (  # noqa: E402
    autodiff_derivs_tiles)
from differentialdynamicprogramming_jl_tpu.solvers.batch import (  # noqa: E402
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (  # noqa: E402
    ILQGConfig)
from differentialdynamicprogramming_jl_tpu_torch import demos  # noqa: E402

B, T, ITERS = 8, 12, 3
OUT = os.path.join(ROOT, "tools_torch", "demo_outcomes.npz")


def main() -> None:
    x0s, u0s = demos._quad_inputs(B, T, torch.float32, "cpu")
    pc = demos._quad_cfg(ITERS)
    cfg = ILQGConfig(alphas=pc.alphas, reg_type=pc.reg_type,
                     lam_max=pc.lam_max, max_iter=pc.max_iter,
                     iter_cap=pc.iter_cap)
    spec = QuadrotorSpec()
    model = quadrotor_lanes(spec)
    res = ilqg_batch_lanes(model, None, jnp.asarray(x0s.numpy()),
                           jnp.asarray(u0s.numpy()), lims=spec.lims, cfg=cfg,
                           derivs_tiles=autodiff_derivs_tiles(model),
                           interpret=True, kt_backward=3, kt_forward=3)
    out = {f"quad_{k}": np.asarray(getattr(res, k)) for k in (
        "cost_total", "reason", "n_accepted", "n_iters", "u", "x")}
    out["quad_x0s"] = x0s.numpy()
    np.savez(OUT, **out)
    print({k: v.tolist() if v.size < 10 else v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
