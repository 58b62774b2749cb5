#!/usr/bin/env python3
"""Time K1 (``backward_lanes``), K2 (``linesearch_lanes``), K3
(``forward_lanes``), K4 (``covariance_lanes``) and K5 (``probe_lanes``) of
two checkouts of the PyTorch port on one CUDA card, in the order a, b, b,
a.

Usage::

    python3 tools_torch/kernel_ab.py <root a> <root b> [--out DIR]
        [--only PREFIX]
    python3 tools_torch/kernel_ab.py --run <root> <label> [--out DIR]
        [--only PREFIX] [--set NAME=VALUE ...]

The first form runs the second once per turn, each in its own process,
which imports ``differentialdynamicprogramming_jl_tpu_torch`` from that
checkout (building its kernels there), times every case and writes
``<label>.json`` to DIR (default ``chiprun_out/kernel_ab``). It then checks
that every turn's outputs have the same bits (a SHA-256 of each case's
outputs) and prints each case's four medians and the ratio b/a. ``--only``
keeps the cases whose name starts with PREFIX (e.g. ``K3``); ``--set``
sets an integer constant of that checkout's ``ops/hopper/plan.py`` (e.g.
``K3_PRODUCERS=1``, the producer warps of a K3 block), or an entry of a
dict of them (``COV_WARPS[10]=5``), to time two launch plans of one kernel
against each other. A case that one checkout has no instance for (K4 at
n=6 before it was built) runs on the other alone.

Cases, at B=4096 and the shapes of the paths that launch them: K1 pendcart
``gains``/``full`` (iLQG headline T=500 ±5; MPC T=300 ±10), pendcart GPS
``policy`` (KL, T=500), PendCartParam ``gains``/``full`` with per-scenario
limits (heterogeneous fleet T=500, MPC T=300), Autodiff<PendCart>
``gains``/``full`` (T=500), LTI ⟨10,2⟩ ``gains``/``full`` (T=1000 ±0.6)
and GPS ``policy`` (KL on LTI), Autodiff<Quadrotor> ``gains``/``full``
(T=400, thrust box (0, 5)); K2 fresh and in place for pendcart (A=6 T=500,
A=4 T=300), PendCartParam (the same two), LTI (A=6 T=1000) and the
quadrotor (A=6 T=400); K3 as the solvers call it (the stream zero, k := the
controls, K := 0): the α sweep (A=6, no emitted stream) and the rollout
(A=1, emitted stream) for pendcart T=500 ±5, PendCartParam T=500 with
per-scenario limits, LTI T=1000 ±0.6 and unclamped, the quadrotor T=400,
and the rollout alone for pendcart and PendCartParam at T=300 (MPC) and
pendcart T=500 unclamped (the KL pre-roll); K4 at n=4 on the Euler fx of
that pre-roll (T=500, ``chip_smoke.py``'s KL-tier inputs), at n=10 on the
LTI fleet's A (T=1000) and at n=6 on a seeded contractive fx (T=400, the
quadrotor's horizon), R1 = I; K5 ``copy``, ``light`` and
``full`` over a (500, 47, 4096) stream, and beside them the PyTorch call
that computes copy, ``x[:, :27].clone()``; and end to end, the iLQG
headline solve as ``chip_smoke.py`` runs it (pendcart, 20 iterations, its
host loop and syncs included). Each trajectory is a K3 rollout
of random controls from numpy seeds; K2's gains and dV come from K1 on it.
The fresh K2 launch lets every lane accept; the in-place one (x0 a view of
the stream) lets none, so each launch re-rolls α=0 and writes the stream's
own bits back. A time is the median over 5 rounds of 20 launches between
CUDA events.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, ROUNDS, REPS = 4096, 5, 20


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cuda_ms(fn) -> list:
    out = []
    for _ in range(ROUNDS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(REPS):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / REPS)
    return out


def instances(dev):
    """(name, model, tiles, T, lims, lanes, params, x0 (n, B), u (T, m, B),
    K1 emissions, GPS, K2 ladders, K3 cases (A, emit)) for each instance
    and path."""
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear, pendcart, quadrotor)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles import (  # noqa: E501
        autodiff_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        default_alphas)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    a6, a4 = default_alphas(0.2, -3.0, 6), default_alphas(0.2, -3.0, 4)
    spec = pendcart.PendCartSpec()
    pc, pt = pendcart.pendcart_lanes(spec), pendcart.pendcart_derivs_tiles(
        spec)
    x0p = t(np.array([np.pi - 0.6, 0, 0, 0])[:, None]
            + 0.2 * rng.standard_normal((4, B)) * np.array([[1], [1], [0],
                                                             [0]]))
    up = {T: t(2.0 * rng.standard_normal((T, 1, B))) for T in (500, 300)}
    sweep = ((6, False), (1, True))
    yield ("pendcart T=500", pc, pt, 500, ((-5.0, 5.0),), None, None, x0p,
           up[500], ("gains", "full"), False, (a6,), sweep)
    yield ("pendcart T=300", pc, pt, 300, ((-10.0, 10.0),), None, None, x0p,
           up[300], ("gains", "full"), False, (a4,), ((1, True),))
    yield ("pendcart GPS T=500", pc, pt, 500, None, None, None, x0p,
           up[500], ("policy",), True, (), ((1, True),))
    yield ("Autodiff<PendCart> T=500", pc, autodiff_derivs_tiles(pc), 500,
           ((-5.0, 5.0),), None, None, x0p, up[500], ("gains", "full"),
           False, (), ())
    par = t(np.stack([rng.uniform(0.25, 0.55, B), rng.uniform(0.5, 1.5, B)]))
    hi = rng.uniform(0.8, 6.0, B)
    lanes = t(np.stack([-hi, hi]))
    pp = pendcart.pendcart_lanes_param(spec)
    ppt = pendcart.pendcart_derivs_tiles_param(spec)
    for T, ladder, k3 in ((500, a6, sweep), (300, a4, ((1, True),))):
        yield (f"PendCartParam T={T}", pp, ppt, T, None, lanes, par, x0p,
               up[T], ("gains", "full"), False, (ladder,), k3)
    lspec = linear.random_lti(0, n=10, m=2, T=1000, device=dev)
    xl = t(np.ones((10, B)) * np.linspace(0.5, 2.0, B)[None, :])
    ul = lspec.u0.reshape(1000, 2, 1).expand(1000, 2, B).contiguous()
    lm, lt = linear.lti_lanes(lspec), linear.lti_derivs_tiles(lspec)
    yield ("LTI T=1000", lm, lt, 1000, ((-0.6, 0.6),) * 2, None, None, xl,
           ul, ("gains", "full"), False, (a6,), sweep)
    yield ("LTI GPS T=1000", lm, lt, 1000, None, None, None, xl, ul,
           ("policy",), True, (), sweep)
    qspec = quadrotor.QuadrotorSpec()
    qm = quadrotor.quadrotor_lanes(qspec)
    x0q = (quadrotor.default_x0(torch.float64, device="cpu").numpy()[:, None]
           + 0.3 * rng.standard_normal((6, B))
           * np.array([[1], [0], [1], [0], [0.5], [0]]))
    yield ("Autodiff<Quadrotor> T=400", qm, autodiff_derivs_tiles(qm), 400,
           qspec.lims, None, None, t(x0q),
           t(qspec.u_hover + 1.5 * rng.standard_normal((400, 2, B))),
           ("gains", "full"), False, (a6,), sweep)


def gps_inputs(n, m, T, dev):
    """A previous policy with Σ⁻¹ positive definite, η = 1."""
    rng = np.random.default_rng(5)
    G = rng.standard_normal((T, B, m, m)).astype(np.float32)
    Si = np.einsum("tbij,tbkj->tbik", G, G) + 0.5 * np.eye(m)
    prev = np.concatenate([rng.standard_normal((T, m, B)),
                           0.05 * rng.standard_normal((T, m * n, B)),
                           np.moveaxis(Si.reshape(T, B, m * m), 1, 2)],
                          axis=1)
    return (torch.tensor(prev, dtype=torch.float32, device=dev),
            torch.ones((T, B), device=dev))


def run(root: Path, label: str, out_dir: Path, only: str = "",
        settings=()) -> int:
    sys.path.insert(0, str(root))
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, backward_kernel as bk, forward_kernel as fk, plan,
        probe_kernel as pk)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    assert Path(fk.__file__).resolve().is_relative_to(root), fk.__file__
    for setting in settings:
        name, value = setting.split("=")
        name, _, key = name.rstrip("]").partition("[")
        assert hasattr(plan, name), (plan.__file__, name)
        if key:
            getattr(plan, name)[int(key)] = int(value)
        else:
            setattr(plan, name, int(value))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    build = _build.build()
    print(f"{label}: {smi}; build {build.seconds:.1f} s "
          f"({time.perf_counter() - t0:.1f} s wall)", flush=True)
    dev = torch.device("cuda")
    res = dict(label=label, root=str(root), card=smi, build_s=build.seconds,
               cases={})

    def case(key, fn, outputs, **extra):
        """Time fn (one launch) unless --only leaves it out; record the
        median and the digest of outputs(fn's result)."""
        if not key.startswith(only):
            return None
        o = fn()
        ms = cuda_ms(fn)
        res["cases"][key] = dict(rounds=ms, ms=statistics.median(ms),
                                 sha=digest(*outputs(o)), **extra)
        print(f"  {key}: {statistics.median(ms):.4f} ms", flush=True)
        return o

    for (name, model, tiles, T, lims, lanes, par, x0, u, emits, gps,
         ladders, k3) in instances(dev):
        n, m = model.n, model.m
        gains0 = torch.cat([u, torch.zeros((T, m * n, B), device=dev)], 1)
        traj0 = torch.zeros((T, n + m, B), device=dev)
        ro = fk.forward_lanes(traj0, gains0, x0, torch.ones((1, B),
                                                            device=dev),
                              par, lanes, model=model, lims=lims,
                              emit_traj=True)
        traj = ro.traj
        for A, emit in k3:
            # as the solvers call it: the α sweep over the stream zero with
            # k := the controls, or the rollout at one α
            al = (torch.tensor(plan_ladder(A), device=dev)[:, None]
                  .expand(A, B).contiguous() if A > 1
                  else torch.ones((1, B), device=dev))

            def k3_fn(al=al, emit=emit):
                return fk.forward_lanes(traj0, gains0, x0, al, par, lanes,
                                        model=model, lims=lims,
                                        emit_traj=emit)

            # K3 has no GPS mode and no autodiff; "free": no limits
            k3_name = (name.replace(" GPS", "")
                       .replace("Autodiff<Quadrotor>", "quadrotor")
                       + ("" if lims or lanes is not None else " free"))
            case(f"K3 {k3_name} A={A}{' emit' if emit else ''}", k3_fn,
                 lambda o: (o.totals, o.terminal)
                 + ((o.traj,) if o.traj is not None else ()))
        lam = torch.logspace(-3, 1, B, device=dev)
        prev, eta = gps_inputs(n, m, T, dev) if gps else (None, None)
        for emit in emits:
            kw = dict(n=n, m=m, reg_type=1 if gps else 2, lims=lims,
                      derivs_tiles=tiles, params=par, lims_lanes=lanes,
                      prev=prev, eta=eta, emit=emit)
            case(f"K1 {name} {emit}",
                 lambda kw=kw: bk.backward_lanes(traj, lam, **kw),
                 lambda o: (o.out, o.stats))
        # K2's gains come from K1: skipped with the K2 cases
        for ladder in ladders if "K2".startswith(only[:2]) else ():
            bo = bk.backward_lanes(traj, lam, n=n, m=m, reg_type=2,
                                   lims=lims, derivs_tiles=tiles,
                                   params=par, lims_lanes=lanes,
                                   emit="gains")
            ones = torch.ones((B,), device=dev)
            sel = torch.stack([bo.stats[0], bo.stats[1], ro.totals[0], ones])
            kw = dict(model=model, alphas=ladder, lims=lims)
            A = len(ladder)
            case(f"K2 {name} A={A} fresh",
                 lambda kw=kw, sel=sel, g=bo.out: fk.linesearch_lanes(
                     traj, g, x0, sel, par, lanes, **kw),
                 lambda o: (o.traj, o.ls))
            buf = traj.clone()
            sel0 = torch.stack([sel[0], sel[1], sel[2], 0 * ones])
            key = f"K2 {name} A={A} in place"
            o = case(key, lambda kw=kw, sel=sel0, g=bo.out:
                     fk.linesearch_lanes(buf, g, buf[0, :n], sel, par,
                                         lanes, in_place=True, **kw),
                     lambda o: (buf, o.ls))
            if o is None:
                continue
            same = (o.traj.data_ptr() == buf.data_ptr()
                    and torch.equal(buf, traj))
            res["cases"][key]["retrace"] = same
            print(f"  {key}: α=0 retrace bit-equal to its input: {same}",
                  flush=True)
            if not same:
                return 1
    if "K4".startswith(only[:2]):
        k4_cases(case, dev)
    # K5 over the probe's (500, 47, B) stream, and the PyTorch call that
    # computes copy
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (500, pk.S_IN, B), dtype=np.float32), device=dev)
    for mode in pk.MODES:
        case(f"K5 {mode}", lambda mode=mode: pk.probe_lanes(x, mode),
             lambda o: (o,))
    case("K5 copy's library call x[:, :27].clone()",
         lambda: x[:, :pk.S_OUT].clone(), lambda o: (o,))
    del x
    if "E2E".startswith(only[:3]):
        headline_solve(case, dev)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{label}.json").write_text(json.dumps(res, indent=1))
    return 0


def k4_fx(n: int, T: int, B: int, seed: int, dev) -> torch.Tensor:
    """A contractive fx stream (T, n², B): F = 0.6·I + 0.3·N(0,1)/√n per
    scenario-step, from a numpy seed (chip_smoke.py::k4_fx)."""
    rng = np.random.default_rng(seed)
    F = 0.6 * np.eye(n) + (0.3 / np.sqrt(n)) * rng.standard_normal(
        (T, n * n, B)).reshape(T, n, n, B).transpose(0, 3, 1, 2)
    return torch.tensor(F.transpose(0, 2, 3, 1).reshape(T, n * n, B),
                        dtype=torch.float32, device=dev)


def k4_cases(case, dev) -> None:
    """K4 at n=4 (the KL pre-roll's fx, T=500), n=10 (the LTI fleet's A,
    T=1000) and n=6 (k4_fx, T=400), as chip_smoke.py holds them."""
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear, pendcart)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        covariance_kernel as ck, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    T = 500
    rng = np.random.default_rng(1)      # chip_smoke.py's KL-tier inputs
    x0 = (pendcart.default_x0(device="cpu").numpy().astype(np.float64)
          [None, :] + 0.2 * rng.standard_normal((B, 4))
          * np.array([1.0, 1.0, 0, 0]))
    u0 = torch.tensor(0.2 * rng.standard_normal((B, T, 1)),
                      dtype=torch.float32, device=dev)
    spec = pendcart.PendCartSpec()
    pre = fk.forward_lanes(
        torch.zeros((T, 5, B), device=dev),
        torch.cat([to_streams(u0), torch.zeros((T, 4, B), device=dev)], 1),
        torch.tensor(x0.T.copy(), dtype=torch.float32, device=dev),
        torch.ones((1, B), device=dev), model=pendcart.pendcart_lanes(spec),
        lims=None, emit_traj=True).traj
    fx4 = to_streams(pendcart.make_pendcart_problem(
        spec, derivs="euler", device=dev).derivs(
            from_streams(pre[:, :4], (4,)), from_streams(pre[:, 4:5],
                                                         (1,))).fx)
    lspec = linear.random_lti(0, n=10, m=2, T=1000, device=dev)
    fx10 = to_streams(linear.SimpleLTVModel.from_lti(
        lspec.A, lspec.B, 1000).fx.expand(B, 1000, 10, 10))
    for n, fx in ((4, fx4), (10, fx10), (6, k4_fx(6, 400, B, 11, dev))):
        if n in ck.CUDA_N:
            case(f"K4 n={n} T={fx.shape[0]}",
                 lambda fx=fx, n=n: ck.covariance_lanes(fx, n=n),
                 lambda o: (o,))


def headline_solve(case, dev) -> None:
    """The iLQG headline of chip_smoke.py (phase ilqg-path): pendcart, ±5,
    reg_type 2, the 6-α ladder, x0 = default_x0 + 0.2·N(0,1) on θ, u0 = 0,
    20 iterations; timed whole, host loop included."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, default_x0, pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)
    spec = PendCartSpec()
    rng = np.random.default_rng(0)
    x0s = torch.tensor(
        default_x0(device="cpu").numpy()[None, :]
        + 0.2 * rng.standard_normal((B, 4)) * np.array([1.0, 0, 0, 0]),
        dtype=torch.float32, device=dev)
    u0s = torch.zeros((B, 500, 1), device=dev)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15)

    def solve():
        return ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s,
                                lims=((-5.0, 5.0),), cfg=cfg,
                                derivs_tiles=pendcart_derivs_tiles(spec),
                                max_steps=20)

    case("E2E iLQG headline solve, 20 iterations", solve,
         lambda o: (o.x, o.u, o.cost_total, o.n_iters, o.reason))


def plan_ladder(A: int) -> tuple:
    """The solvers' default α ladder of A values."""
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        default_alphas)
    return default_alphas(0.2, -3.0, A)


def main() -> int:
    args = sys.argv[1:]
    opts = {"--out": "chiprun_out/kernel_ab", "--only": ""}
    for opt in opts:
        if opt in args:
            i = args.index(opt)
            opts[opt] = args[i + 1]
            del args[i:i + 2]
    settings = []
    while "--set" in args:
        i = args.index("--set")
        settings.append(args[i + 1])
        del args[i:i + 2]
    out_dir = Path(opts["--out"])
    if args and args[0] == "--run":
        return run(Path(args[1]).resolve(), args[2], out_dir, opts["--only"],
                   settings)
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(a).resolve() for a in args]
    order = [("a", 0), ("b", 1), ("b", 2), ("a", 3)]
    labels = []
    for which, turn in order:
        label = f"{which}{turn}"
        labels.append(label)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--run", str(roots[0 if which == "a" else 1]),
                             label, "--out", str(out_dir), "--only",
                             opts["--only"]]).returncode
        if rc != 0:
            print(f"turn {label} failed ({rc})")
            return rc
    runs = [json.loads((out_dir / f"{lb}.json").read_text())
            for lb in labels]
    print(f"card: {runs[0]['card']}; a = {roots[0]}, b = {roots[1]}")
    print(f"{'case':48s} {'a0':>9s} {'b1':>9s} {'b2':>9s} {'a3':>9s} "
          f"{'b/a':>7s}  bits")
    ok = True
    summary = {}
    keys = dict.fromkeys(k for r in runs for k in r["cases"])
    for key in keys:
        ms = [r["cases"][key]["ms"] if key in r["cases"] else None
              for r in runs]
        shas = {r["cases"][key]["sha"] for r in runs if key in r["cases"]}
        ok = ok and len(shas) == 1
        ratio = ((ms[1] + ms[2]) / (ms[0] + ms[3]) if None not in ms
                 else None)
        summary[key] = dict(ms=ms, b_over_a=ratio, same_bits=len(shas) == 1)
        print(f"{key:48s} " + " ".join(
            f"{v:9.4f}" if v is not None else f"{'-':>9s}" for v in ms)
            + (f" {ratio:7.3f}" if ratio is not None else f"{'-':>8s}")
            + f"  {'same' if len(shas) == 1 else 'DIFFER'}")
    (out_dir / "summary.json").write_text(json.dumps(
        dict(card=runs[0]["card"], a=str(roots[0]), b=str(roots[1]),
             build_s=[r["build_s"] for r in runs], cases=summary), indent=1))
    print(json.dumps(dict(same_bits=ok, build_s=[r["build_s"]
                                                 for r in runs])))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
