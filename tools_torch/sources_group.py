#!/usr/bin/env python3
"""``chip_smoke.py``'s sources group (phases 71-76) alone, on one CUDA card.

Run from the root of a checkout: ``python3 tools_torch/sources_group.py``.
It builds the kernel library, starts the sources library's build and the
group's lowered libraries' (``k1_so_gps``, ``t1_so_gps``) in threads and
the group's CPU solves in a child process (``chip_smoke.py
--sources-cpu``), runs the group (sources-kernels, kl-ad, lti-ad,
hetero-ad, kl-ddp, sources-gpu-vs-cpu) and prints each new instance's
record, the group's record and its paths' launches.
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
        print("sources_group: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, backward_kernel as bk, covariance_kernel as ck,
        forward_kernel as fk, probe_kernel as pk)
    print(f"card: {cs.smi()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    proc = cs.start_cpu_child("--sources-cpu")
    built = _build.build()
    print(f"nvcc build: {built.seconds:.1f} s")
    for line in cs.ptxas_summary(built.log):
        print("  " + line)
    _build.library()
    models = cs.sources_models()
    builds = (models, cs.start_sources_builds(models),
              cs.start_source_library())
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes, pk.probe_lanes)
    rec = {}
    try:
        ph = cs.Phases()
        paths = cs.sources_phases(ph, dev, rec, counters, builds, proc)
        print(f"  phase walls: {ph.summary()}")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        for th in cs.BUILD_THREADS:
            th.join()
    print(json.dumps({"paths": paths}))
    print(json.dumps({"sources": rec.pop("sources")}))
    print(json.dumps({k: v for k, v in rec.items() if k.startswith("k")}))
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
