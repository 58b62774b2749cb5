#!/usr/bin/env python3
"""Host-side diagnostics of ``chip_smoke.py``'s m3 group, on CPU tensors
with the plain versions (no card, no JAX).

Run from the root of a checkout: ``python3 tools_torch/m3_diagnose.py``
(≈13 min on 4 threads of a shared host). It prints:

1. the share of f32 inputs on which PyTorch's CPU ``sqrt`` differs from the
   root rounded to nearest (why the plain Cholesky takes its roots in f64,
   ``backward_kernel._sqrt_rn``);
2. the largest |u| of unconstrained solves of the m3 fleet's spec at short
   horizons (whether the ±0.6 box binds);
3. the causes of K1's m > 2 box-QP failures in the constrained solve of a
   lane subset of the m3 fleet: a masked factorisation that is not
   positive definite, or the "no descent" test (the last iteration took
   none of its three step lengths while the free gradient is off the KKT
   point), with K1's launches and the solve's iterations.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from differentialdynamicprogramming_jl_tpu_torch.models.linear import (  # noqa
    lti_derivs_tiles, lti_lanes)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (  # noqa
    backward_kernel as bk)
from differentialdynamicprogramming_jl_tpu_torch.solvers import (  # noqa
    batch)


def sqrt_share(n: int = 1_000_000, seed: int = 0) -> float:
    x = torch.tensor(np.random.default_rng(seed).uniform(0.0, 10.0, n),
                     dtype=torch.float32)
    return (torch.sqrt(x) != bk._sqrt_rn(x)).float().mean().item()


def unconstrained_max_u(lanes: int, T: int) -> list:
    spec, x0s, cfg = cs.m3_fleet("cpu")
    idx = torch.linspace(0, cs.B - 1, lanes).long()
    r = batch.ilqg_batch_lanes(
        lti_lanes(spec), None, x0s[idx],
        spec.u0[:T].expand(lanes, T, cs.M3_M).contiguous(), lims=None,
        cfg=cfg, derivs_tiles=lti_derivs_tiles(spec))
    return r.u.abs().amax(dim=(1, 2)).tolist()


def qp_failures(lanes: int, T: int, steps: int) -> dict:
    """The first ``steps`` iterations of the constrained solve, with K1's
    box QP and factorisations counted."""
    counts = dict(k1_launches=0, qp_solves=0, factorisation=0,
                  no_descent=0)
    chol, qp, k1 = bk._tiny_chol, bk._boxqp_masked, batch.backward_lanes
    seen = []

    def counted_chol(Q, mm):
        L, ok = chol(Q, mm)
        seen.append(ok)
        return L, ok

    def counted_qp(*args):
        seen.clear()
        x, free, L, ok = qp(*args)
        chol_ok = torch.stack(seen).all(dim=0)
        counts["qp_solves"] += ok.numel()
        counts["factorisation"] += int((~chol_ok).sum())
        counts["no_descent"] += int((~ok & chol_ok).sum())
        return x, free, L, ok

    def counted_k1(*args, **kw):
        counts["k1_launches"] += 1
        return k1(*args, **kw)

    bk._tiny_chol, bk._boxqp_masked = counted_chol, counted_qp
    batch.backward_lanes = counted_k1
    try:
        spec, x0s, cfg = cs.m3_fleet("cpu")
        idx = torch.linspace(0, cs.B - 1, lanes).long()
        r = batch.ilqg_batch_lanes(
            lti_lanes(spec), None, x0s[idx],
            spec.u0[:T].expand(lanes, T, cs.M3_M).contiguous(),
            lims=cs.M3_LIMS, cfg=cfg, derivs_tiles=lti_derivs_tiles(spec),
            max_steps=steps)
    finally:
        bk._tiny_chol, bk._boxqp_masked = chol, qp
        batch.backward_lanes = k1
    counts.update(iterations=int(r.n_iters.max()),
                  reasons=dict(zip(*(v.tolist() for v in torch.unique(
                      r.reason, return_counts=True)))))
    return counts


def main() -> int:
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    print(f"CPU sqrt not rounded to nearest on a share "
          f"{sqrt_share():.6f} of f32 inputs in [0, 10)")
    print(f"unconstrained m=3 solves, 4 lanes, T=60: max |u| per lane "
          f"{[round(v, 4) for v in unconstrained_max_u(4, 60)]}")
    lanes, T, steps = 8, 300, 10
    c = qp_failures(lanes, T, steps)
    print(f"constrained (±0.6) m=3 solve, {lanes} lanes, T={T}, {steps} "
          f"iterations: {c}; "
          f"failing share of the QP solves "
          f"{(c['factorisation'] + c['no_descent']) / c['qp_solves']:.6f}")
    print(f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
