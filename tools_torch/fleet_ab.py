#!/usr/bin/env python3
"""The fleet scheduler's compacted batches padded to a kernel block's 32
scenarios (``solvers/fleet.py::LANE_PAD``) against compacted to exactly the
k scenarios still running, on one CUDA card.

Run from the root of a checkout: ``python3 tools_torch/fleet_ab.py``. It
builds the kernels, then solves ``chip_smoke.py``'s pendcart fleet (T=500,
±5, x0 spread 0.4 on angle and cart, max_iter 300) at B=4096 and at
B=65536 with JAX's first schedule (chunk_iters = the lock-step median of
n_iters, growth 8), padded and exact in the order padded, exact, exact,
padded; it prints each solve's ms (CUDA events after a warm-up), and
checks that the two give the same bits. ``--group`` first runs
``chip_smoke.py``'s fleet group (phases 33-36) alone.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("fleet_ab: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        pendcart as tpc)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, backward_kernel as bk, covariance_kernel as ck,
        forward_kernel as fk, probe_kernel as pk)
    from differentialdynamicprogramming_jl_tpu_torch.solvers import fleet
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)

    print(f"card: {cs.smi()}")
    dev = torch.device("cuda", 0)
    built = _build.build()
    print(f"nvcc build: {built.seconds:.1f} s")
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes, pk.probe_lanes)
    if "--group" in sys.argv[1:]:
        ph = cs.Phases()
        paths, out = cs.fleet_phases(ph, dev, counters)
        print(f"  phase walls: {ph.summary()}")
        print(f"paths: {paths}")

    spec = tpc.PendCartSpec()
    model, tiles = tpc.pendcart_lanes(spec), tpc.pendcart_derivs_tiles(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=cs.FLEET_ITERS)
    kw = dict(lims=cs.LIMS, cfg=cfg, derivs_tiles=tiles)
    rng = np.random.default_rng(33)
    x0_np = np.asarray(tpc.default_x0(device="cpu").numpy(), np.float64)[
        None, :] + cs.FLEET_PEND_SPREAD * rng.standard_normal(
            (cs.FLEET_B_BIG, 4)) * np.array([1.0, 1.0, 0, 0])
    x0_all = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    for b in (cs.B, cs.FLEET_B_BIG):
        x0s, u0s = x0_all[:b], torch.zeros((b, cs.T, 1), device=dev)
        ref = ilqg_batch_lanes(model, None, x0s, u0s, **kw)
        ci, gr = cs.fleet_schedules(ref.n_iters)[0]
        del ref
        results = {}
        for pad in (32, 1, 1, 32):
            fleet.LANE_PAD = pad
            fl, r = cs.fleet_run(lambda: fleet.ilqg_fleet(
                model, None, x0s, u0s, chunk_iters=ci, chunk_growth=gr,
                verbose=True, **kw), counters)
            print(f"B={b} ({ci}, {gr:g}) LANE_PAD={pad}: {r['ms']:.3f} ms, "
                  f"{r['chunks']} chunks of lanes {r['lanes']}, launches "
                  f"{r['launches']}")
            if pad in results:
                del fl
                continue
            results[pad] = fl
        cs.same_as_lockstep(f"B={b} exact k (against padded)", results[1],
                            results[32], cs.ILQG_FIELDS + ("n_iters",))
        del results
    fleet.LANE_PAD = 32
    return 0


if __name__ == "__main__":
    sys.exit(main())
