#!/usr/bin/env python3
"""``chip_smoke.py``'s humanoid group (phases 66-70) alone, on one CUDA
card.

Run from the root of a checkout: ``python3 tools_torch/humanoid_group.py``.
It builds the kernel library (K4 at n=54 is built at its first launch),
starts the group's libraries' builds (the wide K1, the lowered K2/K3 at
⟨54,21⟩ and ⟨64,32⟩) in a child process (``chip_smoke.py
--humanoid-build``) and the group's CPU solves in another (``chip_smoke.py
--humanoid-cpu``), runs the group (humanoid-build, wide-kernels, humanoid, humanoid-kl,
humanoid-gpu-vs-cpu) and prints each instance's record and the group's
launches.
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
        print("humanoid_group: no CUDA card visible to torch",
              file=sys.stderr)
        return 1
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, backward_kernel as bk, covariance_kernel as ck,
        forward_kernel as fk, probe_kernel as pk)
    print(f"card: {cs.smi()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    builds = (cs.humanoid_models(), cs.start_cpu_child("--humanoid-build"))
    proc = cs.start_cpu_child("--humanoid-cpu")
    built = _build.build()
    print(f"nvcc build: {built.seconds:.1f} s")
    _build.library()
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes, pk.probe_lanes)
    rec = {"ptxas": cs.ptxas_summary(built.log)}
    try:
        ph = cs.Phases()
        paths = cs.humanoid_phases(ph, dev, rec, counters, builds, proc)
        print(f"  phase walls: {ph.summary()}")
    finally:
        for child in (proc, builds[1]):
            if child.poll() is None:
                child.kill()
            child.wait()
    humanoid = rec.pop("humanoid")
    for v in humanoid["builds"]["libraries"].values():
        v.pop("ptxas", None)
    rec.pop("ptxas")
    print(json.dumps({"paths": paths}))
    print(json.dumps({"humanoid": humanoid}))
    print(json.dumps({k: v for k, v in rec.items() if k.startswith("k")}))
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
