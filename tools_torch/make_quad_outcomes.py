#!/usr/bin/env python3
"""Write ``tools_torch/quad_outcomes.npz``: the JAX package's outcomes of the
quadrotor fleet solve on a lane subset, for ``chip_smoke.py``'s quad-jax
phase (the card's machine has no JAX).

The lanes are the first ``LANES`` of ``chip_smoke.py``'s quadrotor x0 draws
(``default_x0 + 0.3·N(0,1)·[1, 0, 1, 0, 0.5, 0]`` from numpy seed 11 over
B=4096 lanes), u0 = the hover thrust, T=400, the thrust box (0, 5), the 6-α
ladder, reg_type 2, λ_max 1e15 and a budget of 20 iterations (JAX
``bench.py:215-254``). The file keeps each lane's outcome and its
per-iteration cost and accepted α (``record_trace``). The solve is JAX's
``ilqg_batch_lanes`` with its Pallas kernels in interpret mode (k_t=2) and
autodiff derivative tiles, in f32 on the CPU, as the JAX package's own
tests run it there: ≈2 min of compilation and then ≈1.5 min an iteration at
T=400 (1961-1996 s in all on an 8-core host shared with other work).
JAX's XLA tier is no substitute here: ``ilqg_batched`` on
``make_quadrotor_problem`` in f32 ends every one of these lanes at exit 3
(λ above λ_max) after 1-3 iterations, where the lane tier accepts nearly every iteration (its m=2 box
QP takes a lane with both rotors clamped as solved whatever Quu is, the
generic box QP reports such a Quu as not positive definite).

Run from the root of a checkout with JAX installed (≈30 min on a CPU):
``python3 tools_torch/make_quad_outcomes.py``.
"""
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import differentialdynamicprogramming_jl_tpu as J  # noqa: E402
from differentialdynamicprogramming_jl_tpu.models import quadrotor as jq  # noqa: E402,E501
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (  # noqa: E402,E501
    autodiff_derivs_tiles)

OUT = os.path.join(ROOT, "tools_torch", "quad_outcomes.npz")
LANES, B_DRAW, T, ITERS, SEED = 64, 4096, 400, 20, 11


def lanes_x0() -> np.ndarray:
    """chip_smoke.py's quadrotor x0 draws (quad_x0), first LANES."""
    rng = np.random.default_rng(SEED)
    # default_x0 in f64 (JAX's, without x64, would round it to f32 first)
    x0 = np.array([1.0, 0.0, 0.0, 0.0, 0.3, 0.0])[None, :] + (
        0.3 * rng.standard_normal((B_DRAW, 6)) * np.array([1, 0, 1, 0, 0.5,
                                                           0]))
    return x0[:LANES].astype(np.float32)


def main() -> int:
    spec = jq.QuadrotorSpec()
    model = jq.quadrotor_lanes(spec)
    cfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 6), reg_type=2,
                       lam_max=1e15, max_iter=ITERS)
    x0 = lanes_x0()
    u0 = np.full((LANES, T, 2), spec.u_hover, np.float32)
    t0 = time.perf_counter()
    r = J.ilqg_batch_lanes(model, None, jnp.asarray(x0), jnp.asarray(u0),
                           lims=spec.lims, cfg=cfg,
                           derivs_tiles=autodiff_derivs_tiles(model),
                           kt_backward=2, kt_forward=2, record_trace=True,
                           interpret=True)
    cost = np.asarray(r.cost_total)
    seconds = time.perf_counter() - t0
    np.savez_compressed(
        OUT, x0=x0, cost_total=cost, reason=np.asarray(r.reason),
        n_accepted=np.asarray(r.n_accepted),
        n_iters=np.asarray(r.n_iters), trace_cost=np.asarray(r.trace.cost),
        trace_alpha=np.asarray(r.trace.alpha), T=T, max_iter=ITERS,
        seed=SEED,
        solver=np.asarray("JAX ilqg_batch_lanes, interpret=True, "
                          "kt_backward=2, kt_forward=2, f32, CPU"),
        seconds=seconds)
    print(f"{LANES} lanes, T={T}, {ITERS} iterations: {seconds:.1f} s; "
          f"cost median {np.median(cost):.6g}; reasons "
          f"{dict(zip(*np.unique(np.asarray(r.reason), return_counts=True)))}"
          f" -> {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
