#!/usr/bin/env python3
"""Time K2 (``linesearch_lanes``) with a fresh output and in place, for
every model instance of the PyTorch port, on one CUDA card.

Usage: ``python3 tools_torch/k2_alias_ab.py <checkout root> [label]``

Imports ``differentialdynamicprogramming_jl_tpu_torch`` from the given
checkout (building its kernels there), so that two checkouts can be
compared on one card back to back: run it on each, in the order a, b, b,
a. Each case feeds K2 a stream rolled out by K3 and a selector that allows
no lane to accept, so every launch re-rolls α=0 and the in-place launch
rewrites its input with the same bits; that is checked, against the fresh
output too. Each variant's time is the median over 5 rounds of 20
launches between CUDA events, the two variants alternating by round.

Cases: pendcart ⟨4,1⟩ at the iLQG headline's shapes (B=4096, T=500, 6 α,
±5) and the MPC tier's (T=300, 4 α, ±10); the parametrised pendcart with
per-scenario [l, d] and limits (T=500, 6 α); LTI ⟨10,2⟩ (T=1000, 6 α,
±0.6); the quadrotor ⟨6,2⟩ (T=400, 6 α, thrust box (0, 5)).

Prints one line per case and, last, one JSON object with the build's
seconds and every case's times.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, ROUNDS, REPS = 4096, 5, 20


def cases(dev):
    """(name, model, T, alphas, static lims, x0 (n, B), k (T, m, B),
    params, lims_lanes) for each case."""
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear, pendcart, quadrotor)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        default_alphas)
    rng = np.random.default_rng(0)
    f32 = torch.float32

    def t(a):
        return torch.tensor(np.asarray(a), dtype=f32, device=dev)

    a6, a4 = default_alphas(0.2, -3.0, 6), default_alphas(0.2, -3.0, 4)
    spec = pendcart.PendCartSpec()
    x0p = t(np.array([np.pi - 0.6, 0, 0, 0])[:, None]
            + 0.2 * rng.standard_normal((4, B)) * np.array([[1], [1], [0],
                                                             [0]]))
    yield ("pendcart A=6 T=500", pendcart.pendcart_lanes(spec), 500, a6,
           ((-5.0, 5.0),), x0p, t(2.0 * rng.standard_normal((500, 1, B))),
           None, None)
    yield ("pendcart A=4 T=300", pendcart.pendcart_lanes(spec), 300, a4,
           ((-10.0, 10.0),), x0p, t(2.0 * rng.standard_normal((300, 1, B))),
           None, None)
    par = t(np.stack([rng.uniform(0.25, 0.55, B), rng.uniform(0.5, 1.5, B)]))
    hi = rng.uniform(0.8, 6.0, B)
    yield ("PendCartParam A=6 T=500", pendcart.pendcart_lanes_param(spec),
           500, a6, None, x0p, t(2.0 * rng.standard_normal((500, 1, B))),
           par, t(np.stack([-hi, hi])))
    lspec = linear.random_lti(0, n=10, m=2, T=1000, device=dev)
    yield ("LTI <10,2> A=6 T=1000", linear.lti_lanes(lspec), 1000, a6,
           ((-0.6, 0.6), (-0.6, 0.6)),
           t(np.ones((10, B)) * np.linspace(0.5, 2.0, B)[None, :]),
           lspec.u0.reshape(1000, 2, 1).expand(1000, 2, B).contiguous(), None,
           None)
    qspec = quadrotor.QuadrotorSpec()
    x0q = (quadrotor.default_x0(torch.float64, device="cpu").numpy()[:, None]
           + 0.3 * rng.standard_normal((6, B))
           * np.array([[1], [0], [1], [0], [0.5], [0]]))
    yield ("quadrotor <6,2> A=6 T=400", quadrotor.quadrotor_lanes(qspec), 400,
           a6, qspec.lims, t(x0q),
           t(qspec.u_hover + 1.5 * rng.standard_normal((400, 2, B))), None,
           None)


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    label = sys.argv[2] if len(sys.argv) > 2 else str(root)
    sys.path.insert(0, str(root))
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, forward_kernel as fk)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    assert Path(fk.__file__).resolve().is_relative_to(root), fk.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{label}: {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    build = _build.build()
    print(f"  build: {build.seconds:.1f} s ({time.perf_counter() - t0:.1f} s "
          f"wall; 0 when the library was already built)")
    dev = torch.device("cuda")
    result = dict(label=label, card=smi, build_s=build.seconds, cases={})
    for name, model, T, alphas, lims, x0, k, par, lanes in cases(dev):
        n, m = model.n, model.m
        gains = torch.cat([k, torch.zeros((T, m * n, B), device=dev)], dim=1)
        ro = fk.forward_lanes(torch.zeros((T, n + m, B), device=dev), gains,
                              x0, torch.ones((1, B), device=dev), par, lanes,
                              model=model, lims=lims, emit_traj=True)
        traj = ro.traj
        sel = torch.stack([torch.full((B,), -1.0, device=dev),
                           torch.full((B,), 0.5, device=dev), ro.totals[0],
                           torch.zeros((B,), device=dev)])
        buf = traj.clone()

        def ls(src, in_place):
            return fk.linesearch_lanes(src, gains, x0, sel, par, lanes,
                                       model=model, alphas=alphas, lims=lims,
                                       gk=0, gK=m, in_place=in_place)

        fresh, inp = ls(traj, False), ls(buf, True)
        same = (inp.traj.data_ptr() == buf.data_ptr()
                and torch.equal(buf, fresh.traj)
                and torch.equal(fresh.traj, traj)
                and torch.equal(inp.ls, fresh.ls))
        times = {"fresh": [], "in_place": []}
        for _ in range(ROUNDS):
            for key, src, flag in (("fresh", traj, False),
                                   ("in_place", buf, True)):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(REPS):
                    ls(src, flag)
                e.record()
                torch.cuda.synchronize()
                times[key].append(s.elapsed_time(e) / REPS)
        same = same and torch.equal(buf, traj)
        ms = {key: statistics.median(v) for key, v in times.items()}
        print(f"  {name}: fresh {ms['fresh']:.4f} ms, in place "
              f"{ms['in_place']:.4f} ms; in place bit-equal to fresh and "
              f"to the input: {same}")
        result["cases"][name] = dict(ms=ms, rounds=times, bit_equal=same)
        if not same:
            print(json.dumps(result))
            return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
