#!/usr/bin/env python3
"""Drive the PyTorch port's fleet paths once on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA card with the CUDA toolkit (``nvcc``), and imports nothing of JAX.

Phases, each printing its own lines and its wall time; any failed check
ends the run with a non-zero exit and no result line:

1. device: torch/CUDA versions and the card's name and power limit;
2. build: the four kernels from ``ops/hopper/csrc`` with nvcc, one process
   per source;
3. iLQG kernels (K3, K1, K2) against their plain PyTorch versions on the
   card at the main path's shapes (B=4096, T=500), with errors and
   CUDA-event timings;
4. the iLQG main path: ``ilqg_batch_lanes`` on pendcart with the headline
   settings, with launch counts, cost statistics and ms per iteration, and
   the bit-exact α=0 retrace of rejected lanes;
5. the same solve on 64 scenarios with CUDA tensors and with CPU tensors;
6. KL kernels against their plain versions at B=4096, T=500 on a real
   pre-roll: K3 without limits, K4, K1 in GPS mode with policy emission;
7. the KL path: ``ilqgkl_batch_lanes`` at the JAX KL tier's settings
   (``bench.py:114-132``), with launch counts, ms per solve and quality;
8. ``gps_rollout_lanes``, 5 outer KL solves at the same size;
9. the KL solve on 64 scenarios with CUDA tensors and with CPU tensors;
10. the kernel record and the result line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B, T, ITERS = 4096, 500, 20
B_CPU = 64
LIMS = ((-5.0, 5.0),)
# kernel against plain version, both f32 on the card: max |a-b| over the
# output, divided by max |plain|. Kernel and plain version run the same
# operations in the same order (nvcc --fmad=false, one torch op per
# operation); only the card's sinf/cosf inside the kernel and PyTorch's
# elementwise sin/cos can differ in the last ulp, and 500 steps of the
# pendulum amplify such an ulp. 1e-4 of the output's scale bounds that.
KERNEL_TOL = 1e-4
# Quu⁻¹ (full emission): where Quu = cuu + fuᵀVxx·fu nearly cancels (the
# latch check's concave R), Quu⁻¹ is large and amplifies an ulp of Quu's
# terms; measured as ~1e-5 relative on the card at small shapes
QUU_INV_TOL = 1e-3
# K1 with latched lanes (concave R): a latched lane runs the recursion with
# K = 0, the uncontrolled pendulum's Riccati recursion, whose Vxx grows
# ~e^(2·5.3·h·t) over 500 steps and amplifies the ulp differences of the
# card's sinf/cosf and PyTorch's in fx; measured 5.4e-3 of the output's
# scale on an H100
LATCH_TOL = 1e-2
# GPU solve against CPU solve (section 5): the share of lanes whose costs
# agree to COST_RTOL, and whose reasons and accepted counts agree, must each
# reach AGREE_SHARE. The two run different sin/cos implementations; over
# T=500 and 20 iterations the f32 differences can flip one line-search
# decision of a lane, which then follows another path (measured on an H100:
# 2 to 3 of 64 lanes outside 1e-3, up to 5.9e-2 apart in cost), so lanes are
# compared by outcome, not bit for bit.
COST_RTOL = 1e-3
AGREE_SHARE = 0.9
# the KL path (JAX KL tier, bench.py:114-132): scalar η, no limits
KL_STEP, KL_ITERS, GPS_OUTER = 2.0, 10, 5
# K4 against its plain version: the same f32 products and sums in the same
# order and no transcendentals, so the two should agree bit for bit; Σ grows
# ~1e10-fold along the unstable pendcart linearisation, so each slot is held
# by its error relative to that slot's largest magnitude
COV_TOL = 1e-6
# K1 in GPS mode against its plain version, each of the k, K and Quu slots
# by its error over that slot's own largest magnitude, so that a small slot
# (k) is not judged on the scale of a large one (Quu). Same operations in
# the same order on both sides; the card's sinf/cosf against PyTorch's is
# what is left, measured ≤6e-7 over the whole output's scale on an H100
GPS_SLOT_TOL = 1e-5
# GPU KL solve against CPU KL solve (section 9), by outcome as in section 5:
# the share of lanes with the same `satisfied`, the same n_iters, and
# cost_total within COST_RTOL must each reach AGREE_SHARE. The η bracket
# moves by factors of 10 on decisions taken on an f32 mean KL; an iterate
# that leaves the swing-up amplifies the card's sinf/cosf ulps against the
# host's, which can flip one such decision on a lane and send it on
# another path.


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def err(a: torch.Tensor, b: torch.Tensor):
    """(max abs error, max abs error / max |b|), NaN in the same place
    counting as equal."""
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, 0.0, (a - b).abs())
    d = torch.where(torch.isnan(d), float("inf"), d)
    scale = torch.where(torch.isfinite(b), b.abs(), 0.0).max().item()
    mx = d.max().item()
    return mx, mx / max(scale, 1e-30)


def compare(name: str, pairs, tol=KERNEL_TOL) -> float:
    worst = 0.0
    for out, (a, b) in pairs.items():
        mx, rel = err(a, b)
        print(f"  {name} {out}: max_abs_err={mx:.3e} rel={rel:.3e} "
              f"(tol {tol:.0e})")
        check(rel <= tol, f"{name} {out}: rel error {rel:.3e} > {tol:.0e}")
        worst = max(worst, mx)
    return worst


def compare_slots(name: str, a: torch.Tensor, b: torch.Tensor,
                  tol: float) -> float:
    """Stream (T, S, B) against stream: max |a-b| over each slot's largest
    |b|, the worst slot checked against tol; returns the max abs error."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    scale = b.abs().amax(dim=(0, 2), keepdim=True).clamp_min(1e-30)
    rel = (d / scale).max().item()
    mx = d.max().item()
    exact = bool(torch.equal(a, b))
    print(f"  {name}: max_abs_err={mx:.3e}, max over slots of err/slot "
          f"scale={rel:.3e} (tol {tol:.0e}); bit-identical: {exact}")
    check(torch.isfinite(a).all().item(), f"{name}: non-finite values")
    check(rel <= tol, f"{name}: slot-relative error {rel:.3e} > {tol:.0e}")
    return mx


class Phases:
    """Wall time per phase, printed when the next phase starts."""

    def __init__(self):
        self.t0 = self.mark = time.perf_counter()
        self.name = None
        self.walls = {}

    def start(self, name: str, title: str = "") -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.walls[self.name] = now - self.mark
            print(f"  [{self.name}: {now - self.mark:.1f} s wall]")
        self.name, self.mark = name, now
        print(f"== {name}{': ' + title if title else ''}")

    def summary(self) -> str:
        self.start("record")
        return ", ".join(f"{k} {v:.1f} s" for k, v in self.walls.items()) + (
            f"; total {time.perf_counter() - self.t0:.1f} s")


def counted(counters, fn):
    """Run fn with every launch counter set to 0 just before; returns
    (result, {name: launches in that run})."""
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in counters}


def kl_phases(ph, dev, rec, counters, model, tiles, spec) -> None:
    """Phases 6-9: the KL/GPS path's kernels against their plain versions,
    the KL solve, the GPS rollout, and the KL solve against the CPU. Adds
    the KL measurements to ``rec``."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        default_x0, make_pendcart_problem)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        gps_rollout_lanes, ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)

    ph.start("kl-kernels", f"vs plain versions, B={B}, T={T}, no limits")
    # the KL tier's inputs (bench.py:121-131): x0 = default_x0 +
    # 0.2·N(0,1)·[1,1,0,0], u0 = 0.2·N(0,1), from numpy seeds
    rng = np.random.default_rng(1)
    x0_np = np.asarray(default_x0().numpy(), np.float64)[None, :] + (
        0.2 * rng.standard_normal((B, 4)) * np.array([1.0, 1.0, 0, 0]))
    u0_np = 0.2 * rng.standard_normal((B, T, 1))
    x0_l = torch.tensor(x0_np.T.copy(), dtype=torch.float32, device=dev)
    u0 = torch.tensor(u0_np, dtype=torch.float32, device=dev)
    # pre-roll by K3 at α=1 with k := u0, u_nom := 0; its totals are cost0
    zeros_traj = torch.zeros((T, 5, B), device=dev)
    gains_u0 = torch.cat([to_streams(u0), torch.zeros((T, 4, B),
                                                      device=dev)], dim=1)
    ones = torch.ones((1, B), device=dev)

    def pre_roll(plain):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(zeros_traj, gains_u0, x0_l, ones, model=model, lims=None,
                 emit_traj=True)

    k, p = pre_roll(False), pre_roll(True)
    e_k3 = compare("K3 pre-roll, no limits", {
        "totals": (k.totals, p.totals), "traj": (k.traj, p.traj)})
    traj_pre, cost0 = k.traj, k.totals[0]
    ms3 = cuda_ms(lambda: pre_roll(False), 20)
    plain_ms3 = cuda_ms(lambda: pre_roll(True), 3)
    print(f"  K3 pre-roll A=1, no limits: kernel {ms3:.3f} ms, plain "
          f"{plain_ms3:.1f} ms")
    x_pre = from_streams(traj_pre[:, :4], (4,))
    u_pre = from_streams(traj_pre[:, 4:5], (1,))
    problem = make_pendcart_problem(spec, derivs="euler", device=dev)
    fx = problem.derivs(x_pre, u_pre).fx                    # (B, T, 4, 4)
    fx_s = to_streams(fx)

    kc = ck.covariance_lanes(fx_s, n=4)
    pc = ck.covariance_lanes_ref(fx_s, n=4, r1=ck.identity_r1(4))
    e_k4 = compare_slots("K4 Σxx on the pre-roll's fx", kc, pc, COV_TOL)
    growth = (kc[-1].abs().amax(dim=0) / kc[0].abs().amax(dim=0))
    print(f"  K4 Σ growth over the horizon: median "
          f"{growth.median().item():.3e}, max {growth.max().item():.3e}")
    ms4 = cuda_ms(lambda: ck.covariance_lanes(fx_s, n=4), 20)
    plain_ms4 = cuda_ms(
        lambda: ck.covariance_lanes_ref(fx_s, n=4, r1=ck.identity_r1(4)), 3)
    print(f"  K4: kernel {ms4:.3f} ms, plain {plain_ms4:.1f} ms")
    rec["covariance_lanes"] = dict(max_abs_err=e_k4, ms=ms4,
                                   plain_ms=plain_ms4)

    # K1 in GPS mode, policy emission, no limits, on the pre-roll: a
    # previous policy with every KL term non-zero, and η scalar (1, where
    # the solve starts) or per step (1..10)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((T, 1, B)), 0.5 * rng.standard_normal((T, 4, B)),
        rng.uniform(0.5, 2.0, (T, 1, B))], axis=1), dtype=torch.float32,
        device=dev)
    etas = {"scalar η=1": torch.ones((T, B), device=dev),
            "per-step η": torch.tensor(10.0 ** rng.uniform(0, 1, (T, B)),
                                       dtype=torch.float32, device=dev)}
    lam0 = torch.zeros(B, device=dev)

    def gps_bwd(eta, plain):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(traj_pre, lam0, n=4, m=1, reg_type=1, lims=None,
                 derivs_tiles=tiles, prev=prev, eta=eta, emit="policy")

    lay = bk.OutLayout(4, 1, "policy")
    errs = []
    for what, eta in etas.items():
        k, p = gps_bwd(eta, False), gps_bwd(eta, True)
        errs.append(compare_slots(f"K1 GPS policy {what}: k, K, Quu",
                                  k.out[:, :lay.quui], p.out[:, :lay.quui],
                                  GPS_SLOT_TOL))
        errs.append(compare(f"K1 GPS policy {what}", {
            "dV": (k.stats[:2], p.stats[:2])}))
        errs.append(compare(f"K1 GPS policy {what}", {
            "Quu_inv": (k.out[:, lay.quui], p.out[:, lay.quui])},
            QUU_INV_TOL))
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"K1 GPS {what}: diverged/diverge_idx differ")
        print(f"  K1 GPS policy {what}: {int((k.stats[2] > 0.5).sum())} "
              f"latched lanes in both")
    gains = k.out
    # the KL loop's α=1 re-roll from the pre-rolled centre with GPS gains
    k3 = fk.forward_lanes(traj_pre, gains, x0_l, ones, model=model,
                          lims=None, emit_traj=True)
    p3 = fk.forward_lanes_ref(traj_pre, gains, x0_l, ones, model=model,
                              lims=None, emit_traj=True)
    e_k3 = max(e_k3, compare("K3 α=1 re-roll with GPS gains", {
        "totals": (k3.totals, p3.totals), "traj": (k3.traj, p3.traj)}))
    eta1 = etas["scalar η=1"]
    ms1 = cuda_ms(lambda: gps_bwd(eta1, False), 20)
    plain_ms1 = cuda_ms(lambda: gps_bwd(eta1, True), 3)
    print(f"  K1 GPS policy: kernel {ms1:.3f} ms, plain {plain_ms1:.1f} ms")
    rec["backward_lanes"].update(
        max_abs_err=max([rec["backward_lanes"]["max_abs_err"]] + errs),
        ms_gps_policy=ms1, plain_ms_gps_policy=plain_ms1)
    rec["forward_lanes"].update(
        max_abs_err=max(rec["forward_lanes"]["max_abs_err"], e_k3),
        ms_unclamped_rollout=ms3, plain_ms_unclamped_rollout=plain_ms3)
    del prev, etas, gains, k, p, k3, p3, kc, pc

    ph.start("kl-path", f"ilqgkl_batch_lanes, pendcart B={B} T={T}, "
             f"kl_step={KL_STEP}, max_iter={KL_ITERS}, scalar η, no limits")
    cfg = ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS)
    # the zero policy with k = u0 (bench.py:126-129)
    policy0 = GaussianPolicy(
        K=torch.zeros((B, T, 1, 4), device=dev), k=u_pre.contiguous(),
        sigma=torch.ones((B, T, 1, 1), device=dev),
        sigma_inv=torch.ones((B, T, 1, 1), device=dev))
    x_pre = x_pre.contiguous()
    fx = fx.contiguous()

    def kl_solve(sl=slice(None), to=dev):
        pol = GaussianPolicy(*(a[sl].to(to) for a in policy0))
        return ilqgkl_batch_lanes(model, tiles, x_pre[sl].to(to), pol,
                                  fx[sl].to(to), cost0[sl].to(to), cfg=cfg)

    kl_solve()                                   # warm-up
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0 = time.perf_counter()

    def timed():
        s.record()
        out = kl_solve()
        e.record()
        return out

    r, launches = counted(counters, timed)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kl_ms = s.elapsed_time(e)
    iters = int(r.n_iters.max())
    eta_maxed = r.bracket[:, 1] > 0.999 * r.bracket[:, 2]
    ok = ~r.pd_failed
    print(f"  launches: {launches}")
    print(f"  solve: {kl_ms:.3f} ms (CUDA events), {wall_ms:.3f} ms host "
          f"clock; max n_iters {iters}, {kl_ms / max(iters, 1):.4f} ms/iter")
    print(f"  cost_total median {r.cost_total.median().item():.6g} against "
          f"cost0 median {cost0.median().item():.6g}")
    print(f"  shares: satisfied {r.satisfied.float().mean().item():.4f}, "
          f"η maxed {eta_maxed.float().mean().item():.4f}, pd_failed "
          f"{r.pd_failed.float().mean().item():.4f}, kl_violated "
          f"{r.kl_violated.float().mean().item():.4f}")
    print(f"  median η {r.eta.median().item():.6g}, median divergence "
          f"{r.divergence.median().item():.6g}, n_iters histogram "
          f"{dict(zip(*(v.tolist() for v in torch.unique(r.n_iters, return_counts=True))))}")
    check(all(launches[c.__name__] > 0 for c in
              (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes)),
          f"a kernel of the KL path never ran: {launches}")
    check(launches["covariance_lanes"] == 1,
          f"K4 ran {launches['covariance_lanes']} times in one KL solve, "
          "expected once")
    check(r.x.shape == (B, T, 4) and r.u.shape == (B, T, 1)
          and r.policy.K.shape == (B, T, 1, 4) and r.cost_total.shape == (B,),
          "KL result shapes")
    check(1 <= iters <= KL_ITERS, f"KL n_iters {iters}")
    fin = (torch.isfinite(r.cost_total) & torch.isfinite(r.eta)
           & torch.isfinite(r.divergence)
           & torch.isfinite(r.x).flatten(1).all(dim=1)
           & torch.isfinite(r.policy.K).flatten(1).all(dim=1)
           & torch.isfinite(r.policy.sigma).flatten(1).all(dim=1))
    check(bool(fin[ok].all()), f"non-finite KL results on "
          f"{int((~fin & ok).sum())} lanes without pd_failed")
    by_path = {c.__name__: {"kl": launches[c.__name__]} for c in counters}
    del r

    ph.start("gps-rollout", f"gps_rollout_lanes, {GPS_OUTER} outer KL "
             f"solves, B={B} T={T}")
    fx_fn = lambda x, u: problem.derivs(x, u).fx       # noqa: E731

    def timed_gps():
        s.record()
        out = gps_rollout_lanes(model, tiles, x_pre, policy0, cost0, fx_fn,
                                GPS_OUTER, cfg=cfg)
        e.record()
        return out

    (xg, polg, per), launches = counted(counters, timed_gps)
    gps_ms = s.elapsed_time(e)
    print(f"  launches: {launches}")
    print(f"  rollout: {gps_ms:.3f} ms (CUDA events), "
          f"{gps_ms / GPS_OUTER:.3f} ms per outer iteration")
    costs, etas_o, divs, sat, viol = per
    for i in range(GPS_OUTER):
        print(f"  outer {i + 1}: median cost_total "
              f"{costs[i].median().item():.6g}, median η "
              f"{etas_o[i].median().item():.6g}, median divergence "
              f"{divs[i].median().item():.6g}, satisfied "
              f"{sat[i].float().mean().item():.4f}")
    check(costs.shape == (GPS_OUTER, B) and xg.shape == (B, T, 4),
          "GPS rollout shapes")
    check(all(launches[c.__name__] >= GPS_OUTER for c in
              (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes)),
          f"a kernel of the GPS rollout ran too rarely: {launches}")
    check(bool(torch.isfinite(costs[-1]).float().mean() >= AGREE_SHARE),
          "GPS rollout: non-finite final costs")
    for c in counters:
        by_path[c.__name__]["gps"] = launches[c.__name__]
        rec[c.__name__]["by_path"] = by_path[c.__name__]
    del xg, polg, per

    ph.start("kl-gpu-vs-cpu", f"first {B_CPU} scenarios, T={T}, "
             f"max_iter={KL_ITERS}")
    sl = slice(0, B_CPU)
    g = kl_solve(sl)
    t0 = time.perf_counter()
    c = kl_solve(sl, "cpu")
    print(f"  CPU KL solve (plain versions): {time.perf_counter() - t0:.1f} s")
    gc, cc = g.cost_total.cpu(), c.cost_total
    rel = (gc - cc).abs() / cc.abs()
    close = (rel <= COST_RTOL).float().mean().item()
    same_sat = (g.satisfied.cpu() == c.satisfied).float().mean().item()
    same_it = (g.n_iters.cpu() == c.n_iters).float().mean().item()
    print(f"  cost_total rel diff: max {rel.max().item():.3e}, median "
          f"{rel.median().item():.3e}")
    print(f"  share of lanes: cost within {COST_RTOL:.0e} {close:.3f}, same "
          f"satisfied {same_sat:.3f}, same n_iters {same_it:.3f} (need "
          f"{AGREE_SHARE} each)")
    check(min(close, same_sat, same_it) >= AGREE_SHARE,
          "KL: GPU and CPU outcomes differ")


def main() -> int:
    ph = Phases()
    ph.start("device")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 1
    card = smi()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, default_x0, pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import _build
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)

    ph.start("build")
    built = _build.build()
    print(f"  nvcc build: {built.seconds:.1f} s -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())
    _build.library()

    ph.start("ilqg-kernels", f"vs plain versions, B={B}, T={T}")
    spec = PendCartSpec()
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15)
    A = len(cfg.alphas)
    rng = np.random.default_rng(0)
    x0_np = np.asarray(default_x0().numpy(), np.float64)[None, :] + (
        0.2 * rng.standard_normal((B, 4)) * np.array([1.0, 0, 0, 0]))
    x0s = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    u_rand = torch.tensor(2.0 * rng.standard_normal((B, T, 1)),
                          dtype=torch.float32, device=dev)
    x0_l = x0s.T.contiguous()
    gains0 = torch.cat([to_streams(u_rand),
                        torch.zeros((T, 4, B), device=dev)], dim=1)
    traj0 = torch.zeros((T, 5, B), device=dev)
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    ladder = ladder.contiguous()
    al1 = torch.tensor(rng.uniform(0.0, 1.0, (1, B)), dtype=torch.float32,
                       device=dev)
    rec = {}

    def fwd(al, emit, plain):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(traj0, gains0, x0_l, al, model=model, lims=LIMS, gk=0,
                 gK=1, emit_traj=emit)

    k, p = fwd(ladder, False, False), fwd(ladder, False, True)
    e1 = compare("K3 sweep A=6", {"totals": (k.totals, p.totals),
                                  "terminal": (k.terminal, p.terminal)})
    k, p = fwd(al1, True, False), fwd(al1, True, True)
    e2 = compare("K3 rollout A=1", {"totals": (k.totals, p.totals),
                                    "traj": (k.traj, p.traj)})
    traj = k.traj           # kernel-produced [x, u, c] stream, (T, 6, B)
    tot = k.totals[0]
    ms = cuda_ms(lambda: fwd(ladder, False, False), 20)
    plain_ms = cuda_ms(lambda: fwd(ladder, False, True), 3)
    ms1 = cuda_ms(lambda: fwd(al1, True, False), 20)
    plain_ms1 = cuda_ms(lambda: fwd(al1, True, True), 3)
    print(f"  K3 sweep A=6: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
          f"rollout A=1: kernel {ms1:.3f} ms, plain {plain_ms1:.1f} ms")
    rec["forward_lanes"] = dict(max_abs_err=max(e1, e2), ms=ms,
                                plain_ms=plain_ms)

    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=torch.float32,
                       device=dev)
    lam[::8] = 0.0

    def bwd(emit, plain, tl=tiles, lm=lam):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(traj, lm, n=4, m=1, reg_type=2, lims=LIMS, derivs_tiles=tl,
                 emit=emit)

    errs = []
    for emit in ("gains", "full"):
        k, p = bwd(emit, False), bwd(emit, True)
        errs.append(compare(f"K1 {emit}", {
            "out": (k.out[:, :26], p.out[:, :26]),
            "dV": (k.stats[:2], p.stats[:2])}))
        if emit == "full":
            errs.append(compare("K1 full", {
                "Quu_inv": (k.out[:, 26], p.out[:, 26])}, QUU_INV_TOL))
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"K1 {emit}: diverged/diverge_idx differ")
    gains = k.out[:, :5].contiguous()
    dV = k.stats[:2]
    # a concave control cost makes Quu ≤ 0 where λ·fuᵀfu cannot lift it:
    # the λ vector (zeros on every 8th lane) decides which lanes latch
    latch_tiles = pendcart_derivs_tiles(PendCartSpec(R=-1e-3))
    k, p = bwd("full", False, latch_tiles), bwd("full", True, latch_tiles)
    check(torch.equal(k.stats[2:], p.stats[2:]),
          "K1 latch: diverged/diverge_idx differ")
    n_latch = int((k.stats[2] > 0.5).sum())
    zk = (k.out[:, :5] == 0).all(dim=1)
    zp = (p.out[:, :5] == 0).all(dim=1)
    print(f"  K1 latch: {n_latch} of {B} lanes latched, identical "
          f"diverged/diverge_idx; {int((zk != zp).sum())} of {T * B} steps "
          f"where only one version zeroed the gains")
    # Quu⁻¹ is not compared here: on these lanes Vxx turns indefinite and
    # Quu = cuu + fuᵀVxx·fu cancels between large terms, so an ulp decides
    # its sign and with it whether the 1e-30 Cholesky guard returns 1e30.
    # The main spec's full emission above holds Quu⁻¹ to QUU_INV_TOL.
    compare("K1 latch", {"k, K, Vx, Vxx, Quu": (k.out[:, :26],
                                                p.out[:, :26])}, LATCH_TOL)
    check(0 < n_latch, "K1 latch: no lane latched")
    ms = cuda_ms(lambda: bwd("gains", False), 20)
    plain_ms = cuda_ms(lambda: bwd("gains", True), 3)
    msf = cuda_ms(lambda: bwd("full", False), 20)
    plain_msf = cuda_ms(lambda: bwd("full", True), 3)
    print(f"  K1 gains: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
          f"full: kernel {msf:.3f} ms, plain {plain_msf:.1f} ms")
    rec["backward_lanes"] = dict(max_abs_err=max(errs), ms=ms,
                                 plain_ms=plain_ms)

    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([dV[0], dV[1], tot, allow])

    def ls(plain, s=sel):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(traj, gains, x0_l, s, model=model, alphas=cfg.alphas,
                 reduce_ratio_min=0.0, lims=LIMS, gk=0, gK=1)

    k, p = ls(False), ls(True)
    e = compare("K2 rr_min=0", {"traj": (k.traj, p.traj),
                                "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]), "K2: al_sel/any_ok differ")
    n_acc = int(((k.ls[1] > 0.5) & (allow > 0.5)).sum())
    print(f"  K2: {n_acc} of {B} lanes accept")
    ms = cuda_ms(lambda: ls(False), 20)
    plain_ms = cuda_ms(lambda: ls(True), 3)
    print(f"  K2: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    rec["linesearch_lanes"] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms)
    # trap 6 across kernels: a K3 stream re-rolled by K2 with α=0 everywhere
    out = ls(False, torch.stack([dV[0], dV[1], tot, torch.zeros_like(tot)]))
    check(torch.equal(out.traj, traj),
          "K2 α=0 retrace of a K3 stream is not bit-exact")
    print("  K2 α=0 retrace of the K3 stream: bit-exact")
    torch.cuda.synchronize()

    ph.start("ilqg-path", f"ilqg_batch_lanes, pendcart B={B} T={T}, "
             f"{A}-α ladder, reg_type 2, ±5, max_steps={ITERS}")
    u0s = torch.zeros((B, T, 1), device=dev)

    def solve(x0, u0, trace=False):
        return ilqg_batch_lanes(model, None, x0, u0, lims=LIMS, cfg=cfg,
                                derivs_tiles=tiles, max_steps=ITERS,
                                record_trace=trace)

    warm = solve(x0s, u0s, trace=True)         # warm-up, initial costs
    cost_init = warm.trace.cost[:, 0]
    del warm
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0 = time.perf_counter()

    def timed_solve():
        s.record()
        out = solve(x0s, u0s)
        e.record()
        return out

    r, launches = counted(counters, timed_solve)
    wall_ms = (time.perf_counter() - t0) * 1e3
    solve_ms = s.elapsed_time(e)
    iters = int(r.n_iters.max())
    ct = r.cost_total
    reasons = {int(v): int(n) for v, n in zip(*torch.unique(
        r.reason, return_counts=True))}
    print(f"  launches: {launches}")
    print(f"  cost_total min/median/max: {ct.min().item():.6g} / "
          f"{ct.median().item():.6g} / {ct.max().item():.6g} "
          f"(initial rollout median {cost_init.median().item():.6g})")
    print(f"  reasons: {reasons}; max n_iters {iters}; "
          f"accepted mean {r.n_accepted.float().mean().item():.3f}")
    print(f"  solve: {solve_ms:.3f} ms (CUDA events), {wall_ms:.3f} ms host "
          f"clock; {solve_ms / max(iters, 1):.4f} ms/iter over {iters} "
          f"iterations")
    kern_ms = (launches["backward_lanes"] * rec["backward_lanes"]["ms"]
               + launches["linesearch_lanes"] * rec["linesearch_lanes"]["ms"])
    print(f"  kernel share estimate: {kern_ms:.3f} ms of {solve_ms:.3f} ms "
          f"in K1(gains)+K2 at their phase-3 medians; the rest is K3, the "
          f"full replay, torch glue and host syncs")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the main path never ran: {launches}")
    check(1 <= iters <= ITERS, f"n_iters {iters}")
    ok5 = r.reason != 5
    check(bool(torch.isfinite(ct[ok5]).all()), "non-finite cost")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.u).all()),
          "non-finite trajectory")
    check(r.x.shape == (B, T, 4) and r.policy.K.shape == (B, T, 1, 4),
          "result shapes")
    check(ct.median() < cost_init.median(), "median cost did not improve")
    # trap 6 on the solution: rejected lanes retrace bit for bit
    st = torch.cat([to_streams(r.x), to_streams(r.u),
                    to_streams(r.cost[..., None])], dim=1)
    bo = bk.backward_lanes(st, r.lam, n=4, m=1, reg_type=2, lims=LIMS,
                           derivs_tiles=tiles, emit="gains")
    sel = torch.stack([bo.stats[0], bo.stats[1], ct, allow])
    out = fk.linesearch_lanes(st, bo.out, x0_l, sel, model=model,
                              alphas=cfg.alphas, lims=LIMS, gk=0, gK=1)
    rej = (out.ls[1] < 0.5) | (allow < 0.5)
    check(torch.equal(out.traj[..., rej], st[..., rej]),
          "rejected lanes of the solution do not retrace bit for bit")
    print(f"  retrace: {int(rej.sum())} rejected lanes reproduce the "
          f"solution stream bit for bit")
    launches_ilqg = launches
    del r, bo, out, st

    ph.start("ilqg-gpu-vs-cpu", f"first {B_CPU} scenarios, T={T}, "
             f"max_steps={ITERS}")
    g = solve(x0s[:B_CPU], u0s[:B_CPU])
    t0 = time.perf_counter()
    c = solve(x0s[:B_CPU].cpu(), u0s[:B_CPU].cpu())
    print(f"  CPU solve (plain versions): {time.perf_counter() - t0:.1f} s")
    gc, cc = g.cost_total.cpu(), c.cost_total
    rel = (gc - cc).abs() / cc.abs()
    same_reason = (g.reason.cpu() == c.reason).float().mean().item()
    same_acc = g.n_accepted.cpu() == c.n_accepted
    close = (rel <= COST_RTOL).float().mean().item()
    print(f"  cost_total rel diff: max {rel.max().item():.3e}, max on lanes "
          f"with equal accepted counts {rel[same_acc].max().item():.3e}, "
          f"median {rel.median().item():.3e}")
    print(f"  share of lanes: cost within {COST_RTOL:.0e} {close:.3f}, same "
          f"reason {same_reason:.3f}, same accepted count "
          f"{same_acc.float().mean().item():.3f} (need {AGREE_SHARE} each)")
    check(min(close, same_reason, same_acc.float().mean().item())
          >= AGREE_SHARE, "GPU and CPU outcomes differ")

    kl_phases(ph, dev, rec, counters, model, tiles, spec)

    # ---- record and result
    walls = ph.summary()
    print(f"  phase walls: {walls}")
    src = "differentialdynamicprogramming_jl_tpu_torch/ops/hopper/csrc/"
    tpu = "differentialdynamicprogramming_jl_tpu/ops/pallas/"
    where = {"backward_lanes": ("backward.cu", "backward_kernel.py:729"),
             "linesearch_lanes": ("forward.cu", "forward_kernel.py:506"),
             "forward_lanes": ("forward.cu", "forward_kernel.py:198"),
             "covariance_lanes": ("covariance.cu",
                                  "covariance_kernel.py:28")}
    kernels = []
    for c in counters:
        name = c.__name__
        by_path = {"ilqg": launches_ilqg[name], **rec[name].pop("by_path")}
        kernels.append(dict(name=name, route="cuda",
                            source=src + where[name][0],
                            replaces=tpu + where[name][1],
                            launches=sum(by_path.values()),
                            launches_by_path=by_path, **rec[name]))
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
