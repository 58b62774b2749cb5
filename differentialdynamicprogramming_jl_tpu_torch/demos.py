"""Runnable demos — parity with the reference's exported demo functions
(``demo_linear``, ``demo_linear_kl``, ``demo_pendcart``, ``demoQP``;
``src/DifferentialDynamicProgramming.jl:6``), and the fleet demos of the
JAX package (``differentialdynamicprogramming_jl_tpu/demos.py``).

Each demo takes ``device`` (None: the CUDA card) and chooses the lane tier
(the CUDA kernels) where the JAX package chooses it on its accelerator: on
the card. On the CPU it takes the JAX package's CPU branch. The random
inputs come from NumPy seeds (not JAX ``PRNGKey`` bits), built by a small
private function beside each demo. Printed times are taken after
``torch.cuda.synchronize()`` on the card.

Run as ``python -m differentialdynamicprogramming_jl_tpu_torch.demos
[name ...]`` on the card (the default tour without names).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .device import resolve
from .models.linear import SimpleLTVModel, make_lti_problem, random_lti
from .models.pendcart import (PendCartSpec, default_x0, linearized_upright,
                              lqr, make_pendcart_problem, simulate_pendcart)
from .ops.boxqp import demo_qp
from .ops.forward import forward_pass
from .policy import GaussianPolicy
from .solvers.ilqg import ILQGConfig, default_alphas, ilqg
from .solvers.ilqgkl import ILQGKLConfig, ilqg_kl
from .utils.plotting import plot_linear, plot_pendcart, plotting_available


def _on_card(device) -> bool:
    return device.type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def _linear_inputs(seed: int, T: int, dtype, device):
    """The random stable LTI problem of ``demo_linear`` and
    ``demo_linear_kl`` (n=10, m=2)."""
    return random_lti(seed, n=10, m=2, T=T, dtype=dtype, device=device)


def demo_linear(seed: int = 0, T: int = 1000, dtype=torch.float64,
                plot: bool = False, device=None, **cfg_kwargs):
    """Random stable LTI problem solved with iLQG
    (reference ``demo_linear``, ``src/demo_linear.jl:5-60``)."""
    print("Running linear demo (PyTorch iLQG)")
    device = resolve(device)
    spec = _linear_inputs(seed, T, dtype, device)
    prob = make_lti_problem(spec, T)
    cfg = ILQGConfig(**cfg_kwargs)
    t0 = time.perf_counter()
    res = ilqg(prob, spec.x0, spec.u0, cfg=cfg)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"  solved in {dt*1e3:.1f} ms ({int(res.n_iters)} iterations, "
          f"reason {int(res.reason)}), total cost "
          f"{float(torch.sum(res.cost)):.4f}")
    if plot and plotting_available():
        plot_linear(res)
    return res


def demo_linear_kl(seed: int = 0, T: int = 1000, kl_step: float = 100.0,
                   outer_iters: int = 5, dtype=torch.float64,
                   plot: bool = False, device=None, **cfg_kwargs):
    """GPS-style outer loop: 5 iLQGkl solves re-centered on the previous
    policy (reference ``demo_linear_kl``, ``src/demo_linear.jl:63-136``)."""
    print("Running linear demo with KL-divergence constraint")
    device = resolve(device)
    spec = _linear_inputs(seed, T, dtype, device)
    prob = make_lti_problem(spec, T)
    model = SimpleLTVModel.from_lti(spec.A, spec.B, T)
    ro = forward_pass(prob, spec.x0, spec.u0)
    x, cost = ro.x, ro.cost
    traj = GaussianPolicy.zeros(T, 10, 2, dtype, device)._replace(k=spec.u0)
    cfg = ILQGKLConfig(kl_step=kl_step, **cfg_kwargs)
    res = None
    for it in range(outer_iters):
        res = ilqg_kl(prob, x, traj, model, cost, cfg=cfg)
        x, cost, traj = res.x, res.cost, res.policy
        print(f"  outer {it + 1}: cost = {float(torch.sum(cost)):.4f}, "
              f"eta = {float(torch.mean(res.eta)):.3g}, "
              f"KL = {float(torch.mean(res.divergence)):.3g}")
    if plot and plotting_available():
        plot_linear(res)
    return res


def demo_pendcart(T: int = 600, dtype=torch.float64, plot: bool = False,
                  derivs: str = "zoh", lims_val: float = 10.0, device=None,
                  **cfg_kwargs):
    """Control-limited pendulum-on-cart swing-up
    (reference ``demo_pendcart``, ``src/system_pendcart.jl:42-212``).

    With the reference's exact constants and ±5 limits the upright goal is
    dynamically unreachable from x0 (holding torque needs |u| > 6.7; the
    d=0.99 damping kills pump-up) and the algorithm converges to the
    hanging local optimum. The demo therefore defaults to feasible ±10
    limits, where the swing-up succeeds, as the JAX package's does; pass
    ``lims_val=5.0`` for the exact reference configuration."""
    device = resolve(device)
    spec = PendCartSpec()
    prob = make_pendcart_problem(spec, derivs=derivs, dtype=dtype,
                                 device=device)
    x0 = default_x0(dtype, device)
    lims = torch.tensor([[-lims_val, lims_val]], dtype=dtype, device=device)

    # the failing LQG baseline (src/system_pendcart.jl:187-188)
    A, B = linearized_upright(spec)
    L = lqr(A, B, np.diag(spec.Q), np.array([[spec.R]]))
    x00, u00, cost00 = simulate_pendcart(x0, L, spec, T, lims, dtype)
    print(f"clamped-LQG baseline final angle error: "
          f"{abs(float(x00[-1, 0]) - np.pi):.3f} rad, "
          f"cost {float(torch.sum(cost00)):.1f}")

    defaults = dict(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                    lam_max=1e15, tol_fun=1e-8, tol_grad=1e-8, max_iter=1000)
    defaults.update(cfg_kwargs)
    cfg = ILQGConfig(**defaults)
    print("Entering iLQG")
    t0 = time.perf_counter()
    res = ilqg(prob, x0, torch.zeros((T, 1), dtype=dtype, device=device),
               lims=lims, cfg=cfg)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"  solved in {dt*1e3:.1f} ms ({int(res.n_iters)} iterations), "
          f"cost {float(torch.sum(res.cost)):.1f}, final angle error "
          f"{abs(float(res.x[-1, 0]) - np.pi):.3f} rad")
    if plot and plotting_available():
        plot_pendcart(x00, u00, res)
    return res


def _mpc_inputs(B: int, T: int, seed: int, dtype, device):
    """``demo_mpc``'s fleet: ``default_x0`` + 0.2·N(0, 1) on the angle and
    its rate, zero warm-start controls."""
    z = np.random.default_rng(seed).standard_normal((B, 4))
    x = (default_x0(torch.float64, "cpu")[None, :]
         + 0.2 * torch.from_numpy(z)
         * torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=torch.float64))
    return (x.to(dtype=dtype, device=device),
            torch.zeros((B, T, 1), dtype=dtype, device=device))


def _mpc_cfgs(inner_iters: int):
    """The warm re-solves' config and the cold start's."""
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                     lam_max=1e15, max_iter=inner_iters,
                     iter_cap=inner_iters + 4)
    cfg0 = ILQGConfig(alphas=cfg.alphas, reg_type=2, lam_max=1e15,
                      max_iter=200)
    return cfg, cfg0


def demo_mpc(B: int = 16, T: int = 300, mpc_steps: int = 40,
             dtype=torch.float32, seed: int = 0, lims_val: float = 10.0,
             inner_iters: int = 5, verbose: bool = True,
             tier: str = "auto", interpret: bool = False, device=None):
    """Receding-horizon MPC over a fleet of pendulum-carts — the production
    workload the batched solvers are built for.

    Each MPC step warm-starts a short iLQG solve from the shifted previous
    plan, applies the first control through the true dynamics, and repeats.

    ``tier``: ``"lanes"`` runs the lane fleet path (the CUDA kernels on the
    card, their plain versions on the CPU) with the ``warm_start=True``
    entry (no α-sweep); ``"vmap"`` the generic tier's ``ilqg_batched`` on
    pre-rolled inputs; ``"auto"`` picks lanes on the card. ``interpret``
    is the JAX package's and is ignored.
    """
    from .parallel.mesh import ilqg_batched

    device = resolve(device)
    if tier == "auto":
        tier = "lanes" if _on_card(device) else "vmap"
    spec = PendCartSpec()
    prob = make_pendcart_problem(spec, derivs="euler", dtype=dtype,
                                 device=device)
    lims = torch.tensor([[-lims_val, lims_val]], dtype=dtype, device=device)
    cfg, cfg0 = _mpc_cfgs(inner_iters)
    x, u_warm = _mpc_inputs(B, T, seed, dtype, device)
    u_pad = torch.zeros((B, 1, 1), dtype=dtype, device=device)

    if tier == "lanes":
        from .models.pendcart import pendcart_derivs_tiles, pendcart_lanes
        from .solvers.batch import ilqg_batch_lanes
        model = pendcart_lanes(spec)
        tiles = pendcart_derivs_tiles(spec)
        lims_t = ((-float(lims_val), float(lims_val)),)

        def solve(x_, u_, cfg_, warm):
            return ilqg_batch_lanes(model, None, x_, u_, lims=lims_t,
                                    cfg=cfg_, derivs_tiles=tiles,
                                    warm_start=warm)

        def mpc_step(x_, u_):
            res = solve(x_, u_, cfg, True)
            x_next = prob.dynamics(x_, res.u[:, 0], 0)
            u_shift = torch.cat([res.u[:, 1:], u_pad], dim=1)
            return x_next, u_shift, res.cost_total
    else:
        def mpc_step(x_, u_):
            # pre-rolled warm start (src/iLQG.jl:193-197): no initial
            # α-sweep, the shifted previous plan is used verbatim
            ro = forward_pass(prob, x_, u_, lims=lims)
            res = ilqg_batched(prob, ro.x, ro.u, lims=lims, cfg=cfg,
                               cost0=ro.cost)
            x_next = prob.dynamics(x_, res.u[:, 0], 0)
            u_shift = torch.cat([res.u[:, 1:], u_pad], dim=1)
            return x_next, u_shift, torch.sum(res.cost, dim=-1)

    if verbose:
        print(f"MPC fleet: {B} pendcarts, horizon {T}, "
              f"{mpc_steps} steps, {inner_iters} iLQG iters/step "
              f"[{tier} tier]")
    if tier == "lanes":
        res0 = solve(x, u_warm, cfg0, False)
        u_warm = res0.u
        cold_cost = float(torch.mean(res0.cost_total))
    else:
        res0 = ilqg_batched(prob, x, u_warm, lims=lims, cfg=cfg0)
        u_warm = res0.u
        cold_cost = float(torch.mean(torch.sum(res0.cost, -1)))
    if verbose:
        print(f"  cold-start solve: mean plan cost {cold_cost:.2f}")
    t0 = time.perf_counter()
    errs = []
    for step in range(mpc_steps):
        x, u_warm, costs = mpc_step(x, u_warm)
        err = float(torch.mean(torch.abs(x[:, 0] - np.pi)))
        errs.append(err)
        if verbose and (step + 1) % 10 == 0:
            print(f"  step {step + 1:3d}: mean |angle err| {err:7.4f} rad, "
                  f"mean plan cost {float(torch.mean(costs)):9.2f}")
    _sync(device)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"  {mpc_steps} MPC steps in {dt*1e3:.0f} ms "
              f"({dt*1e3/max(mpc_steps, 1):.1f} ms/step incl. host loop)")
    return x, errs


def _fleet_inputs(B: int, T: int, dtype, device):
    """``demo_fleet``'s fleet: ``default_x0`` + 0.2·N(0, 1) on the angle,
    zero initial controls."""
    z = np.random.default_rng(0).standard_normal((B, 4))
    x0s = (default_x0(torch.float64, "cpu")[None, :]
           + 0.2 * torch.from_numpy(z)
           * torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64))
    return (x0s.to(dtype=dtype, device=device),
            torch.zeros((B, T, 1), dtype=dtype, device=device))


def _fleet_cfg(max_iter: int) -> ILQGConfig:
    return ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                      lam_max=1e15, max_iter=max_iter, iter_cap=max_iter + 4)


def demo_fleet(B: int = None, T: int = 500, dtype=torch.float32,
               max_iter: int = 20, lims_val: float = 5.0, device=None):
    """Fleet-scale batched solve of the pendcart: on the card the lane path
    (``ilqg_batch_lanes``, the CUDA kernels) at B=4096; on the CPU a small
    fleet through the generic tier's ``ilqg_batched``."""
    device = resolve(device)
    on_card = _on_card(device)
    if B is None:
        B = 4096 if on_card else 16
    spec = PendCartSpec()
    cfg = _fleet_cfg(max_iter)
    x0s, u0s = _fleet_inputs(B, T, dtype, device)
    print(f"Fleet solve: {B} pendcart scenarios, T={T}, "
          f"{max_iter}-iteration budget, ±{lims_val} limits "
          f"[{'CUDA lane path' if on_card else 'generic batched path'}]")
    t0 = time.perf_counter()
    if on_card:
        from .models.pendcart import pendcart_derivs_tiles, pendcart_lanes
        from .solvers.batch import ilqg_batch_lanes
        res = ilqg_batch_lanes(
            pendcart_lanes(spec), None, x0s, u0s,
            lims=((-lims_val, lims_val),), cfg=cfg,
            derivs_tiles=pendcart_derivs_tiles(spec))
        costs = res.cost_total
    else:
        from .parallel.mesh import ilqg_batched
        prob = make_pendcart_problem(spec, derivs="euler", dtype=dtype,
                                     device=device)
        res = ilqg_batched(prob, x0s, u0s,
                           lims=torch.tensor([[-lims_val, lims_val]],
                                             dtype=dtype, device=device),
                           cfg=cfg)
        costs = torch.sum(res.cost, dim=-1)
    _sync(device)
    mean_cost = float(torch.mean(costs))
    dt = time.perf_counter() - t0
    print(f"  {B} solves in {dt*1e3:.0f} ms (incl. the kernels' build on "
          f"the first call) — mean cost {mean_cost:.1f}, "
          f"mean iterations {float(torch.mean(res.n_iters.float())):.1f}")
    return res


def _quad_inputs(B: int, T: int, dtype, device):
    """``demo_quadrotor``'s fleet: the quadrotor's ``default_x0`` +
    0.3·N(0, 1)·[1, 0, 1, 0, 0.5, 0] (displaced and tilted starts), hover
    thrust as the initial controls."""
    from .models.quadrotor import QuadrotorSpec, default_x0 as quad_x0
    z = np.random.default_rng(0).standard_normal((B, 6))
    x0s = (quad_x0(torch.float64, "cpu")[None, :]
           + 0.3 * torch.from_numpy(z)
           * torch.tensor([1.0, 0.0, 1.0, 0.0, 0.5, 0.0],
                          dtype=torch.float64))
    return (x0s.to(dtype=dtype, device=device),
            torch.full((B, T, 2), QuadrotorSpec().u_hover, dtype=dtype,
                       device=device))


def _quad_cfg(max_iter: int) -> ILQGConfig:
    return ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                      lam_max=1e15, max_iter=max_iter, iter_cap=max_iter + 8)


def demo_quadrotor(B: int = None, T: int = 400, dtype=torch.float32,
                   max_iter: int = 30, interpret: bool = None, device=None):
    """Planar-quadrotor fleet: displaced/tilted starts → hover at the goal
    under per-rotor thrust limits (0, u_max) — the m=2 in-kernel box-QP
    path, with the backward kernel's derivative tiles derived entirely by
    autodiff (``autodiff_derivs_tiles``): no hand-written Jacobians in this
    model (``models/quadrotor.py``).

    On the card the CUDA kernels at B=4096. On the CPU their plain versions
    (``interpret`` None or True), cut as the JAX package cuts its
    interpret mode: B=8, T ≤ 12, at most 3 iterations."""
    from .models.quadrotor import QuadrotorSpec, quadrotor_lanes
    from .ops.hopper.autodiff_tiles import autodiff_derivs_tiles
    from .solvers.batch import ilqg_batch_lanes
    device = resolve(device)
    on_card = _on_card(device)
    if interpret is None:
        interpret = not on_card
    if B is None:
        B = 4096 if on_card else 8
    if interpret:
        T = min(T, 12)
        max_iter = min(max_iter, 3)
    spec = QuadrotorSpec()
    model = quadrotor_lanes(spec)
    tiles = autodiff_derivs_tiles(model)
    cfg = _quad_cfg(max_iter)
    x0s, u0s = _quad_inputs(B, T, dtype, device)
    print(f"Quadrotor fleet: {B} scenarios, T={T}, thrust limits "
          f"(0, {spec.u_max}), autodiff derivative tiles "
          f"[{'CUDA kernels' if on_card else 'plain versions'}]")
    t0 = time.perf_counter()
    res = ilqg_batch_lanes(model, None, x0s, u0s, lims=spec.lims, cfg=cfg,
                           derivs_tiles=tiles)
    _sync(device)
    mean_cost = float(torch.mean(res.cost_total))
    dt = time.perf_counter() - t0
    print(f"  {B} solves in {dt*1e3:.0f} ms (incl. the kernels' build on "
          f"the first call) — mean cost {mean_cost:.2f}, mean iterations "
          f"{float(torch.mean(res.n_iters.float())):.1f}, "
          f"mean final height {float(torch.mean(res.x[:, -1, 2])):.2f} m")
    return res


BOXQP_RESULTS = {-1: "Hessian is not positive definite",
                 0: "No descent direction found",
                 1: "Maximum main iterations exceeded",
                 2: "Maximum line-search iterations exceeded",
                 3: "No bounds, returning Newton point",
                 4: "Improvement smaller than tolerance",
                 5: "Gradient norm smaller than tolerance",
                 6: "All dimensions are clamped"}


def demo_boxqp(n: int = 500, seed: int = 0, device=None):
    """Standalone box-QP demo (reference ``demoQP``,
    ``src/boxQP.jl:190-199``)."""
    device = resolve(device)
    t0 = time.perf_counter()
    out = demo_qp(n=n, seed=seed, device=device)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"boxQP n={n}: {BOXQP_RESULTS[int(out.result)]}; "
          f"iterations {int(out.iters)}, gradient {float(out.gnorm):.3g}, "
          f"value {float(out.value):.6g}, "
          f"factorizations {int(out.nfactor)}, {dt*1e3:.1f} ms")
    return out


REGISTRY = {
    "boxqp": demo_boxqp,
    "linear": demo_linear,
    "linear_kl": demo_linear_kl,
    "pendcart": demo_pendcart,
    "mpc": demo_mpc,
    "fleet": demo_fleet,
    "quadrotor": demo_quadrotor,
}
TOUR = ("boxqp", "linear", "linear_kl", "pendcart", "fleet", "quadrotor")


def main(argv=None):
    """Console entry point (``python -m
    differentialdynamicprogramming_jl_tpu_torch.demos [name ...]``): run
    the named demos, or the default tour, on the card. Exit codes: 0, or 2
    for an unknown name."""
    import sys as _sys
    names = list(argv) if argv is not None else _sys.argv[1:]
    if any(a in ("-h", "--help") for a in names):
        print("usage: python -m differentialdynamicprogramming_jl_tpu_torch"
              ".demos [name ...]\n"
              f"available demos: {', '.join(REGISTRY)}\n"
              f"default (no args): {' '.join(TOUR)}")
        return 0
    unknown = [a for a in names if a not in REGISTRY]
    if unknown:
        print(f"unknown demo(s): {', '.join(unknown)} — "
              f"available: {', '.join(REGISTRY)}", file=_sys.stderr)
        return 2
    for name in names or TOUR:
        REGISTRY[name]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
