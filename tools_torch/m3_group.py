#!/usr/bin/env python3
"""``chip_smoke.py``'s m3 group (phases 37-41) alone, on one CUDA card.

Run from the root of a checkout: ``python3 tools_torch/m3_group.py``. It
builds the kernels, prints the LTI ⟨10,3⟩ instances' registers, stack and
launch plans, starts the group's CPU solves in a child process
(``chip_smoke.py --m3-cpu``), runs the group (K1 ⟨10,3⟩ with the masked
box QP, K2 and K3 against their plain versions; the converged m=3 LTI
fleet solve, ``ilqg_fleet``, the KL solve; the card against the CPU) and
prints each ⟨10,3⟩ instance's record and the group's launches.
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
        print("m3_group: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, backward_kernel as bk, covariance_kernel as ck,
        forward_kernel as fk, probe_kernel as pk)
    print(f"card: {cs.smi()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    built = _build.build()
    print(f"nvcc build: {built.seconds:.1f} s")
    rec = {"ptxas": cs.ptxas_summary(built.log)}
    proc = cs.start_cpu_child("--m3-cpu")
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes, pk.probe_lanes)
    try:
        ph = cs.Phases()
        paths = cs.m3_phases(ph, dev, rec, counters, proc)
        print(f"  phase walls: {ph.summary()}")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    print(json.dumps({"paths": paths}))
    print(json.dumps({key: rec[key] for key in
                      ("k1_lti3", "k1_lti3_gps", "k2_lti3", "k3_lti3", "m3")}))
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
