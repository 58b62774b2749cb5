"""KL-divergence-constrained iLQG (GPS trust-region solver).

Counterpart of ``differentialdynamicprogramming_jl_tpu/solvers/ilqgkl.py``
(reference ``iLQGkl``, ``src/iLQGkl.jl:25-252``): the trajectory optimiser
inside Guided Policy Search, with the previous ``GaussianPolicy`` as the
trust-region centre and the dual η adjusted by bracketing
(``src/klutils.jl:110-130``) or, per step, by ADAM in log-space
(``src/iLQGkl.jl:185-236``). The reference's contract holds as in the JAX
package: a pre-rolled trajectory and cost are required; derivatives are
formed once; every forward pass takes the full step α=1; η is the only
regulariser, raised additively with doubling increments on a divergence;
the last iterate is accepted unconditionally, with a warning flag when its
KL exceeds the bound.

:func:`ilqg_kl` solves one problem; its loops are host loops that read
their exit flags once a turn. The fleet solver that shares
:class:`ILQGKLConfig` is :func:`~.batch_kl.ilqgkl_batch_lanes`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import as_tensor, like
from ..ops.backward import backward_pass
from ..ops.forward import forward_covariance, forward_pass
from ..ops.kl import (adam_init, adam_update, calc_eta, entropy, grad_kl,
                      kl_div_wiki, pd_ok)
from ..policy import GaussianPolicy, Trace
from ..problem import Problem
from ..utils import printing as _pr
from ..utils.aot import recorded


@dataclasses.dataclass(frozen=True)
class ILQGKLConfig:
    """Options of the reference ``iLQGkl`` (``src/iLQGkl.jl:25-42``). Field
    names and defaults follow the JAX package's ``ILQGKLConfig``."""

    kl_step: float = 1.0
    constrain_per_step: bool = False
    max_iter: int = 50
    tol_fun: float = 1e-7
    tol_grad: float = 1e-4
    eta_bracket: Tuple[float, float, float] = (1e-8, 1.0, 1e16)
    del0: float = 1e-4
    gd_alpha: float = 0.01          # ADAM step for per-timestep η
    verbosity: int = 0
    print_head: int = 10            # src/iLQGkl.jl:32
    print_period: int = 1           # src/iLQGkl.jl:33
    qp_max_iter: int = 100
    # retry-loop safety: the reference's scalar η-escalation loop has no
    # abort (src/iLQGkl.jl:111-121 commented out); the retry stops once η
    # exceeds the bracket maximum, and after retry_cap relaunches
    retry_cap: int = 200


class ILQGKLResult(NamedTuple):
    """Result of :func:`ilqg_kl`."""

    x: torch.Tensor
    u: torch.Tensor
    policy: GaussianPolicy
    Vx: torch.Tensor
    Vxx: torch.Tensor
    cost: torch.Tensor
    trace: Trace
    n_iters: torch.Tensor
    eta: torch.Tensor              # final η (scalar or (T,))
    eta_bracket: torch.Tensor
    divergence: torch.Tensor       # final measured KL (scalar mean or (T,))
    satisfied: torch.Tensor
    kl_violated: torch.Tensor      # reference final warning (src/iLQGkl.jl:248)
    pd_failed: Optional[torch.Tensor] = None  # a Σ went indefinite in the KL
    #                                           measurement (src/klutils.jl:84)


@recorded
def ilqg_kl(problem: Problem, x0, traj_prev: GaussianPolicy, model, cost0,
            lims=None, cfg: ILQGKLConfig = ILQGKLConfig(),
            iter_callback=None) -> ILQGKLResult:
    """Solve the KL-constrained problem from the pre-rolled trajectory ``x0``
    (T, n) with per-step costs ``cost0``, around ``traj_prev`` (whose ``k``
    is the nominal control sequence, ``src/iLQGkl.jl:47``). ``model``
    supplies the linearisation ``fx_at`` and the prediction covariance
    ``covariance`` of :func:`~..ops.forward.forward_covariance`
    (``src/iLQGkl.jl:135``), e.g. ``SimpleLTVModel``. ``iter_callback``:
    per-iteration hook ``f(it, x, u, cost)`` with numpy arrays (the
    reference's ``plot_fun``, ``src/iLQGkl.jl:177``).

    ``x0`` keeps its device if it is a tensor, else goes to the CUDA card;
    the other inputs follow it."""
    x0 = as_tensor(x0)
    if x0.ndim != 2:
        raise ValueError("iLQGkl requires a pre-rolled trajectory (T, n)")
    dtype, dev = x0.dtype, x0.device
    traj_prev = GaussianPolicy(*(like(a, x0) for a in traj_prev))
    cost0 = like(cost0, x0)
    if lims is not None:
        lims = like(lims, x0)
    T, m = traj_prev.k.shape
    n = x0.shape[-1]
    use_limits = lims is not None
    per_step = cfg.constrain_per_step

    u = traj_prev.k                            # src/iLQGkl.jl:47
    x = x0
    x_start = x0[0]
    # zero the previous feedforward for the KL bookkeeping (src/iLQGkl.jl:52)
    traj_prev = traj_prev._replace(k=torch.zeros_like(traj_prev.k))

    kl_step = like(cfg.kl_step, x0)
    bracket = like(cfg.eta_bracket, x0)
    if per_step:
        kl_step = kl_step.expand(T)
        eta_bracket = bracket[:, None].expand(3, T)
        delta = torch.full((T,), cfg.del0, dtype=dtype, device=dev)
    else:
        eta_bracket = bracket
        delta = like(cfg.del0, x0)

    # derivatives, once (src/iLQGkl.jl:88)
    derivs = problem.make_derivs()(x, u)
    kl_terms = grad_kl(traj_prev)              # src/iLQGkl.jl:92
    # Σ_prev is loop-invariant: PD-check it once
    prev_pd = pd_ok(traj_prev.sigma).all()
    R1 = model.covariance(x, u)
    fx_model = model.fx_at(x, u)

    def run_bp(eta):
        return backward_pass(derivs, u, reg_type=1, lims=lims,
                             use_limits=use_limits, eta=eta,
                             kl_terms=kl_terms, qp_max_iter=cfg.qp_max_iter,
                             gps_mode=True)

    def bp_with_eta_retry(eb, dl):
        """η-inflation retry (``src/iLQGkl.jl:97-124`` scalar, ``:190-203``
        per step)."""
        bp = run_bp(eb[1])
        aborted = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(cfg.retry_cap):
            if not bool(bp.diverged & ~aborted):
                break
            if per_step:
                # escalate only the diverged step (src/iLQGkl.jl:193-195)
                idx = torch.clamp(bp.diverge_idx.long() - 1, 0, T - 1)
                hot = torch.nn.functional.one_hot(idx, T).to(dtype)
                eb = torch.stack([eb[0], eb[1] + dl * hot, eb[2]])
                dl = dl * (1.0 + hot)          # del[idx] *= 2
                aborted = (eb[1] > 0.999 * eb[2]).all()
            else:
                eb = torch.stack([eb[0], eb[1] + dl, eb[2]])
                dl = dl * 2.0                   # src/iLQGkl.jl:104
                aborted = eb[1] > eb[2]
            if not bool(aborted):
                bp = run_bp(eb[1])
        return bp, eb, dl, aborted

    adam = adam_init((T,) if per_step else (), dtype, dev)
    cap = cfg.max_iter + 1
    trace = Trace.zeros(cap, dtype, dev)
    trace.cost[0] = cost0.sum()
    policy = GaussianPolicy.zeros(T, n, m, dtype, device=dev)
    Vx = torch.zeros((T, n), dtype=dtype, device=dev)
    Vxx = torch.zeros((T, n, n), dtype=dtype, device=dev)
    x_new, u_new, cost_new = x, u, cost0
    divergence = torch.zeros_like(kl_step)
    satisfied = torch.zeros((), dtype=torch.bool, device=dev)
    pd_failed = torch.zeros((), dtype=torch.bool, device=dev)
    it = 1
    while it <= cfg.max_iter:
        # backward pass with η retry; the per-step variant resets the
        # escalation increments each outer iteration (src/iLQGkl.jl:189),
        # the scalar variant's persist (src/iLQGkl.jl:104-106)
        delta_in = (torch.full((T,), cfg.del0, dtype=dtype, device=dev)
                    if per_step else delta)
        bp, eta_bracket, delta, bp_aborted = bp_with_eta_retry(eta_bracket,
                                                               delta_in)
        g_norm = torch.mean(torch.amax(
            torch.abs(bp.policy.k) / (torch.abs(u) + 1.0), dim=-1))

        # full-step forward pass and covariance (src/iLQGkl.jl:132-143)
        ro = forward_pass(problem, x_start, u, x, 1.0, bp.policy, lims)
        sigma_new = forward_covariance(fx_model, R1, bp.policy)
        dcost = cost0.sum() - ro.cost.sum()
        div_t = kl_div_wiki(ro.x, x, sigma_new, bp.policy, traj_prev)
        # an indefinite Σ = the reference's logdet DomainError
        # (src/klutils.jl:84): abort with a diagnostic flag
        failed = (~prev_pd) | (~pd_ok(bp.policy.sigma).all())
        if per_step:
            divergence = div_t
            # ADAM on log(η) against the constraint violation
            # (src/iLQGkl.jl:211-218)
            violation = divergence - kl_step
            log_eta, adam = adam_update(adam, torch.log(eta_bracket[1]),
                                        -violation, it, alpha=cfg.gd_alpha)
            eta_new = torch.clamp(torch.exp(log_eta), eta_bracket[0],
                                  eta_bracket[2])
            eta_bracket = torch.stack([eta_bracket[0], eta_new,
                                       eta_bracket[2]])
            sat = ((divergence < 2.0 * kl_step).all()
                   & (torch.mean(violation) < 0.1 * kl_step[0]))
            eta_maxed = (eta_bracket[1] > 0.999 * eta_bracket[2]).all()
        else:
            divergence = torch.mean(div_t)
            eta_bracket, sat = calc_eta(divergence, eta_bracket, kl_step)
            eta_maxed = eta_bracket[1] > 0.999 * eta_bracket[2]
        sat = sat & ~failed
        done = sat | eta_maxed | bp_aborted | failed

        # reduce_ratio at α=1: Δcost / -(dV₁+dV₂) (src/iLQGkl.jl:137-140)
        expected = -(bp.dV[0] + bp.dV[1])
        if cfg.verbosity > 1:
            # the reference's period table (src/iLQGkl.jl:151-159)
            _pr.ilqgkl_row(it, ro.cost.sum(), dcost, expected, g_norm,
                           torch.mean(eta_bracket[1]), torch.mean(divergence),
                           entropy(bp.policy), cfg.print_head,
                           cfg.print_period)
        if iter_callback is not None:
            iter_callback(it, *(a.cpu().numpy() for a in (ro.x, ro.u,
                                                          ro.cost)))
        i = min(it, cap - 1)
        for key, val in dict(
                alpha=1.0, improvement=dcost,
                reduce_ratio=torch.where(expected != 0, dcost / expected,
                                         0.0),
                cost=ro.cost.sum(), grad_norm=g_norm,
                divergence=torch.mean(divergence),
                eta=torch.mean(eta_bracket[1]), accepted=True).items():
            getattr(trace, key)[i] = val

        x_new, u_new, cost_new = ro.x, ro.u, ro.cost
        policy, Vx, Vxx = bp.policy, bp.Vx, bp.Vxx
        satisfied = sat
        pd_failed = pd_failed | failed
        it += 1
        if bool(done):
            break

    # unconditional acceptance of the last iterate (src/iLQGkl.jl:239-241)
    policy = policy._replace(k=u_new)
    kl_violated = ((divergence > kl_step)
                   & (torch.abs(divergence - kl_step) > 0.1 * kl_step)).any()
    if cfg.verbosity > 0:
        _pr.ilqgkl_exit(satisfied,
                        (eta_bracket[1] > 0.999 * eta_bracket[2]).all(),
                        kl_violated)
    return ILQGKLResult(
        x=x_new, u=u_new, policy=policy, Vx=Vx, Vxx=Vxx, cost=cost_new,
        trace=trace, n_iters=torch.tensor(it - 1, dtype=torch.int32,
                                          device=dev),
        eta=eta_bracket[1], eta_bracket=eta_bracket, divergence=divergence,
        satisfied=satisfied, kl_violated=kl_violated, pd_failed=pd_failed)
