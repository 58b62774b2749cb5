#!/usr/bin/env python3
"""Where the port's quadrotor solve parts from the JAX package's, iteration
by iteration, on the lanes of ``tools_torch/quad_outcomes.npz``.

The port solves the file's 64 lanes (T=400, 20 iterations) with
``record_trace=True`` and holds each iteration's lane costs and accepted
α against JAX's trace in the file: the largest and the median relative
cost difference, the share of lanes within 1e-3, and the share of lanes
whose α so far equals JAX's at every iteration. It imports no JAX, so it
runs on the host (the plain versions, ≈15 min) or on a card (``--card``,
the kernels), and writes the port's trace to ``--out`` for the other side
to compare with (``--other``); ``--load`` compares a written trace
instead of solving:

    python3 tools_torch/quad_jax_diagnose.py --out host.npz
    python3 tools_torch/quad_jax_diagnose.py --card --other host.npz
    python3 tools_torch/quad_jax_diagnose.py --load host.npz
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from differentialdynamicprogramming_jl_tpu_torch import (  # noqa: E402
    autodiff_derivs_tiles)
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq  # noqa: E402,E501
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (  # noqa: E402,E501
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (  # noqa: E402,E501
    ILQGConfig, default_alphas)


QUARTILES = (25, 50, 75)


def compare(what: str, cost, alpha, ref_cost, ref_alpha) -> None:
    """Per iteration: cost differences and the share of lanes on the
    reference's path (the same α at every iteration so far; iteration 0 is
    the initial rollout, which takes none)."""
    same_path = np.ones(cost.shape[0], bool)
    for i in range(cost.shape[1]):
        rel = np.abs(cost[:, i] - ref_cost[:, i]) / np.abs(ref_cost[:, i])
        if i:
            same_path &= alpha[:, i] == ref_alpha[:, i]
        on = rel[same_path] if same_path.any() else np.full(1, np.nan)
        print(f"{what} iteration {i}: cost rel diff max {rel.max():.3e}, "
              f"median {np.median(rel):.3e}, within 1e-3 "
              f"{np.mean(rel <= 1e-3):.3f}; on its path "
              f"{same_path.mean():.3f} (their max {on.max():.3e}); the "
              f"fleet's {fleet_spread(cost[:, i], ref_cost[:, i])}")


def fleet_spread(cost, ref_cost) -> str:
    """The fleet's cost quartiles and mean against the reference's, as
    relative differences (chip_smoke.py's quad-jax bounds)."""
    q = np.percentile(cost, QUARTILES)
    rq = np.percentile(ref_cost, QUARTILES)
    return (f"quartiles rel diff {np.abs(q - rq) / rq}, mean rel diff "
            f"{abs(cost.mean() / ref_cost.mean() - 1):.3e}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--other")
    ap.add_argument("--load")
    a = ap.parse_args()
    ref = np.load(os.path.join(ROOT, "tools_torch", "quad_outcomes.npz"))
    dev = torch.device("cuda", 0) if a.card else torch.device("cpu")
    spec = tq.QuadrotorSpec()
    model = tq.quadrotor_lanes(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=int(ref["max_iter"]))
    if a.load:
        own = np.load(a.load)
        cost, alpha = own["cost"], own["alpha"]
    else:
        x0 = torch.tensor(ref["x0"], device=dev)
        u0 = torch.full((x0.shape[0], int(ref["T"]), 2), spec.u_hover,
                        device=dev)
        torch.set_num_threads(4)
        r = ilqg_batch_lanes(model, None, x0, u0, lims=spec.lims, cfg=cfg,
                             derivs_tiles=autodiff_derivs_tiles(model),
                             record_trace=True)
        cost = r.trace.cost.cpu().numpy()
        alpha = r.trace.alpha.cpu().numpy()
        reason, acc = r.reason.cpu().numpy(), r.n_accepted.cpu().numpy()
        print(f"port on {dev}: reasons equal "
              f"{np.mean(reason == ref['reason']):.3f}, accepted counts "
              f"equal {np.mean(acc == ref['n_accepted']):.3f}")
    k = int(ref["max_iter"]) + 1           # the trace's iterations 0..max
    cost, alpha = cost[:, :k], alpha[:, :k]
    if "trace_cost" in ref:
        compare("port vs JAX", cost, alpha, ref["trace_cost"][:, :k],
                ref["trace_alpha"][:, :k])
        # how far a solve that stalled early would sit from JAX's end state
        jc = ref["trace_cost"][:, :k]
        print("JAX's fleet above its final state, iteration: mean, median: "
              + ", ".join(f"{i} {jc[:, i].mean() / jc[:, -1].mean() - 1:.3f}"
                          f" {np.median(jc[:, i]) / np.median(jc[:, -1]) - 1:.3f}"
                          for i in range(k - 6, k - 1)))
    if a.other:
        o = np.load(a.other)
        compare(f"port vs {a.other}", cost, alpha, o["cost"][:, :k],
                o["alpha"][:, :k])
    if a.out:
        np.savez(a.out, cost=cost, alpha=alpha)
    return 0


if __name__ == "__main__":
    sys.exit(main())
