#!/usr/bin/env python3
"""``chip_smoke.py``'s tiles group (phases 48-53) alone, on one CUDA card.

Run from the root of a checkout: ``python3 tools_torch/tiles_group.py``.
It builds the kernel library (the hand-written instances the group holds
the lowered ones to), lowers the group's Python-only models and a user's
derivative tiles and builds their libraries in a thread, starts the
group's CPU solves in a child process (``chip_smoke.py --tiles-cpu``),
runs the group (tiles-build, tiles-kernels, tiles-lti with KL on it,
lti-track, quad-track, tiles-so) and prints each instance's record and
the group's launches.
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
        print("tiles_group: no CUDA card visible to torch", file=sys.stderr)
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
    models = cs.tiles_models()
    builds = (models, cs.start_tiles_builds(models))
    proc = cs.start_cpu_child("--tiles-cpu")
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes, pk.probe_lanes)
    rec = {}
    try:
        ph = cs.Phases()
        paths = cs.tiles_phases(ph, dev, rec, counters, builds, proc)
        print(f"  phase walls: {ph.summary()}")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        for th in cs.BUILD_THREADS:
            th.join()
    print(json.dumps({"paths": paths}))
    print(json.dumps({"tiles": {"seconds": rec.pop("tiles")["seconds"],
                                "builds": rec.pop("tiles_builds")}}))
    print(json.dumps({k: v for k, v in rec.items() if k.startswith("k")}))
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
