#!/usr/bin/env python3
"""``chip_smoke.py``'s ladder, demos and aot groups (phases 54-57) alone,
on one CUDA card.

Run from the root of a checkout: ``python3 tools_torch/ladder_group.py``.
It builds the kernel library, lowers the lowered group's models and builds
their libraries (the ladder checks run K2 and K3 of the lowered
quadrotor), starts the groups' CPU solves in a child process
(``chip_smoke.py --demos-cpu``), times the 6-α headline solve the ladder
fleet is printed beside, runs ladder-kernels, ladder-fleet, demos and aot,
and prints each new instance's record and the groups' launches.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def headline(dev, counters) -> dict:
    """The 6-α headline solve (chip_smoke's ilqg-path), timed: what the
    ladder fleet is compared with."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    spec = PendCartSpec()
    x0s = torch.tensor(cs.headline_x0(), dtype=torch.float32, device=dev)
    u0s = torch.zeros((cs.B, cs.T, 1), device=dev)

    def solve():
        return ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s,
                                lims=cs.LIMS, cfg=cs.headline_cfg(),
                                derivs_tiles=pendcart_derivs_tiles(spec),
                                max_steps=cs.ITERS)

    solve()
    ms = cs.cuda_ms(solve, 1)
    r, _ = cs.counted(counters, solve)
    iters = int(r.n_iters.max())
    print(f"6-α headline: {ms:.3f} ms, {ms / max(iters, 1):.4f} ms/iter")
    return dict(x0s=x0s, cost_total=r.cost_total,
                ms_iter=ms / max(iters, 1))


def main() -> int:
    if not torch.cuda.is_available():
        print("ladder_group: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, backward_kernel as bk, covariance_kernel as ck,
        forward_kernel as fk, probe_kernel as pk)
    t0 = time.perf_counter()
    print(f"card: {cs.smi()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    built = _build.build()
    print(f"nvcc build: {built.seconds:.1f} s")
    for line in cs.ptxas_summary(built.log):
        if "linesearch" in line or "forward_kernel" in line:
            print("  " + cs.with_plan(line))
    _build.library()
    models = cs.lowered_models()
    builds = (models, cs.start_lowered_builds(models))
    proc = cs.start_cpu_child("--demos-cpu")
    cs.CHILDREN.append(proc)
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes, pk.probe_lanes)
    rec = {}
    try:
        ilqg = headline(dev, counters)
        th, labels, box = builds[1]
        th.join()
        cs.check("error" not in box, f"lowered builds: {box.get('error')}")
        ph = cs.Phases()
        paths = cs.ladder_phases(ph, dev, rec, counters, ilqg, builds, proc)
        paths.update(cs.demos_phases(ph, dev, counters, proc))
        aot_paths, aot = cs.aot_phase(ph, dev, counters)
        paths.update(aot_paths)
        print(f"  phase walls: {ph.summary()}")
    finally:
        for child in cs.CHILDREN:
            if child.poll() is None:
                child.kill()
            child.wait()
        for th in cs.BUILD_THREADS:
            th.join()
    print(json.dumps({"paths": paths}))
    print(json.dumps({"aot": aot}))
    print(json.dumps({k: v for k, v in rec.items()},
                     default=lambda v: float(np.asarray(v))))
    print(f"group total {time.perf_counter() - t0:.1f} s")
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
