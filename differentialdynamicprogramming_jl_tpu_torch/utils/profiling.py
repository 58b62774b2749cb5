"""Per-phase timing instrumentation.

Counterpart of ``differentialdynamicprogramming_jl_tpu/utils/profiling.py``:
the reference's ``@elapsed`` phase timers and ``print_timing`` percentage
report (``src/iLQG.jl:226,236,267`` and ``:343-366``). The solver's outer
loop runs here in Python over the generic tier's phases (derivatives,
:func:`~..ops.backward.backward_pass` with the λ escalation of
``solvers/ilqg.py``, :func:`~..ops.forward.line_search`), each timed on the
host clock after the device has finished it (``torch.cuda.synchronize`` on
the card).
"""
from __future__ import annotations

import time

import torch

from ..device import as_tensor, like
from ..ops.backward import backward_pass
from ..ops.forward import forward_pass, line_search
from ..problem import Problem
from ..solvers.ilqg import ILQGConfig, _escalate


def print_timing(t_derivs: float, t_backward: float, t_forward: float,
                 t_total: float, n_iters: int) -> None:
    """Reference-format phase breakdown (``print_timing``,
    ``src/iLQG.jl:343-366``)."""
    t_other = t_total - t_derivs - t_backward - t_forward
    tt = max(t_total, 1e-12)
    print(f"{'':12}{'derivs':>12}{'back pass':>12}{'fwd pass':>12}"
          f"{'other':>12}  (% of total)")
    print(f"{'time [%]':12}{100*t_derivs/tt:12.1f}{100*t_backward/tt:12.1f}"
          f"{100*t_forward/tt:12.1f}{100*t_other/tt:12.1f}")
    if n_iters:
        print(f"total time {t_total*1e3:.1f} ms, "
              f"{t_total*1e3/n_iters:.2f} ms per iteration")


def ilqg_profiled(problem: Problem, x0, u0, lims=None,
                  cfg: ILQGConfig = ILQGConfig(), verbose: bool = True):
    """Run iLQG with a host-level outer loop and per-phase wall timers.

    The JAX package's profiled loop (single scenario): the reference's
    solve loop with its ``trace(:time_derivs/:time_backward/:time_forward)``
    instrumentation. ``u0`` (T, m) keeps its device if it is a tensor, else
    goes to the CUDA card; the others follow it. Returns
    ``(x, u, timings dict)``.
    """
    u0 = as_tensor(u0)
    x0 = like(x0, u0)
    if lims is not None:
        lims = like(lims, u0)
    derivs_fn = problem.make_derivs()
    use_limits = lims is not None
    cuda = u0.device.type == "cuda"

    def sync(v):
        if cuda:
            torch.cuda.synchronize(u0.device)
        return v

    def bp_fn(d, u, lam):
        return backward_pass(d, u, lam, reg_type=cfg.reg_type, lims=lims,
                             use_limits=use_limits,
                             qp_max_iter=cfg.qp_max_iter)

    t_total0 = time.perf_counter()
    ro = sync(forward_pass(problem, x0, u0, lims=lims))
    x, u, cost = ro.x, ro.u, ro.cost
    # the λ schedule on the host in f64, as the JAX loop keeps it in floats
    lam = torch.tensor(cfg.lam, dtype=torch.float64)
    dlam = torch.tensor(cfg.dlam, dtype=torch.float64)
    td = tb = tf = 0.0
    it = 0
    for it in range(1, cfg.max_iter + 1):
        t0 = time.perf_counter()
        d = sync(derivs_fn(x, u))
        td += time.perf_counter() - t0

        t0 = time.perf_counter()
        bp = sync(bp_fn(d, u, float(lam)))
        while bool(bp.diverged) and float(lam) <= cfg.lam_max:
            lam, dlam = _escalate(lam, dlam, cfg.lam_factor, cfg.lam_min)
            bp = sync(bp_fn(d, u, float(lam)))
        tb += time.perf_counter() - t0

        g_norm = float(torch.mean(torch.amax(
            torch.abs(bp.policy.k) / (torch.abs(u) + 1.0), dim=-1)))
        if g_norm < cfg.tol_grad and float(lam) < 1e-5:
            break

        t0 = time.perf_counter()
        ls = sync(line_search(problem, x0, u, x, cost.sum(), bp.policy,
                              bp.dV, cfg.alphas, lims,
                              cfg.reduce_ratio_min))
        tf += time.perf_counter() - t0

        if bool(ls.done):
            x, u, cost = ls.x, ls.u, ls.cost
            dlam = torch.clamp_max(dlam / cfg.lam_factor,
                                   1.0 / cfg.lam_factor)
            lam = torch.clamp_min(lam * dlam, cfg.lam_min)
            if float(ls.dcost) < cfg.tol_fun:
                break
        else:
            lam, dlam = _escalate(lam, dlam, cfg.lam_factor, cfg.lam_min)
            if float(lam) > cfg.lam_max:
                break

    t_total = time.perf_counter() - t_total0
    if verbose:
        print_timing(td, tb, tf, t_total, it)
    return x, u, {"derivs": td, "backward": tb, "forward": tf,
                  "total": t_total, "iters": it}
