#!/usr/bin/env python3
"""``chip_smoke.py``'s sizes group (phases 58-61) alone, on one CUDA card.

Run from the root of a checkout: ``python3 tools_torch/sizes_group.py``.
It builds the kernel library (K4 n=4 on the rail's KL path), lowers the
group's Python-only models and starts their libraries' builds, with K4's
at every n and the packed K1's, in a thread, starts the group's CPU solves
in a child process (``chip_smoke.py --sizes-cpu``), runs the group
(sizes-build, rail with KL on it, lti8 with KL and the packed solve, ops)
and prints each instance's record and the group's launches.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("sizes_group: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, backward_kernel as bk, covariance_kernel as ck,
        forward_kernel as fk, probe_kernel as pk)
    print(f"card: {cs.smi()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    built = _build.build()
    print(f"nvcc build: {built.seconds:.1f} s")
    _build.library()
    models = cs.sizes_models()
    builds = (models, cs.start_sizes_builds(models))
    proc = cs.start_cpu_child("--sizes-cpu")
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes, pk.probe_lanes)
    rec = {"ptxas": cs.ptxas_summary(built.log)}
    try:
        ph = cs.Phases()
        paths = cs.sizes_phases(ph, dev, rec, counters, builds, proc)
        print(f"  phase walls: {ph.summary()}")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        for th in cs.BUILD_THREADS:
            th.join()
    sizes = rec.pop("sizes")
    for v in sizes["builds"]["libraries"].values():
        v.pop("ptxas")
    rec.pop("ptxas")
    print(json.dumps({"paths": paths}))
    print(json.dumps({"sizes": sizes}))
    print(json.dumps({k: v for k, v in rec.items() if k.startswith("k")}))
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
