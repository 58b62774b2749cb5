"""iLQG driver: the generic tier's entry point, and the options that every
iLQG solver of the port shares.

Counterpart of ``differentialdynamicprogramming_jl_tpu/solvers/ilqg.py``
(reference ``iLQG``, ``src/iLQG.jl:143-341``): the derivative step, the
λ-adaptive backward-pass retry, the gradient-norm exit, the backtracking
line search and the accept/reject λ update.

The driver is written for a batch: every problem (lane) keeps its own λ, α,
``done`` and exit reason, and a finished lane is frozen by ``torch.where``,
the way a vmapped ``lax.while_loop`` freezes it. :func:`ilqg` is the batch
of one, and ``parallel.mesh.ilqg_batched`` the batch of many. The loops are
host loops: the solve loop and the λ-retry each read whether a lane is
still running once a turn (a host sync), and the recursions over t read
nothing back (:mod:`..ops.backward`).

Exit reasons: 0 running / iteration cap, 1 gradient norm < tol_grad
(``src/iLQG.jl:258-261``), 2 cost change < tol_fun (``src/iLQG.jl:306-309``),
3 λ > λmax (``src/iLQG.jl:319-322``), 4 max accepted iterations
(``src/iLQG.jl:334``), 5 initial rollout diverged (``src/iLQG.jl:205-210``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, like
from ..ops._linalg import where_lanes
from ..ops.backward import backward_pass
from ..ops.forward import forward_pass, line_search
from ..ops.riccati_scan import parallel_riccati
from ..policy import Derivs, GaussianPolicy, Trace
from ..problem import Problem
from ..utils import printing as _pr
from ..utils.aot import recorded


def default_alphas(lo: float = 0.0, hi: float = -3.0, num: int = 11):
    """Reference backtracking coefficients 10^linspace(0,-3,11)
    (``src/iLQG.jl:145``)."""
    return tuple(float(a) for a in np.power(10.0, np.linspace(lo, hi, num)))


@dataclasses.dataclass(frozen=True)
class ILQGConfig:
    """Solver options — kwargs of the reference ``iLQG``
    (``src/iLQG.jl:143-163``). Field names and defaults follow the JAX
    package's ``ILQGConfig``."""

    alphas: Tuple[float, ...] = default_alphas()
    # cost-change exit threshold (src/iLQG.jl:150); the working threshold is
    # max(tol_fun, 8·eps(dtype)·|cost|), see tol_fun_effective
    tol_fun: float = 1e-7
    tol_grad: float = 1e-4
    max_iter: int = 500
    lam: float = 1.0
    dlam: float = 1.0
    lam_factor: float = 1.6
    lam_max: float = 1e10
    lam_min: float = 1e-6
    reg_type: int = 1
    reduce_ratio_min: float = 0.0
    # 0: silent, 1: begin/exit messages and the final summary, 2: the
    # iteration table with periodic headers, 3: and each retry's Cholesky
    # failure (src/iLQG.jl:133,158)
    verbosity: int = 0
    print_head: int = 10
    qp_max_iter: int = 100
    # backward-pass engine: "scan" is the sequential recursion; "parallel"
    # the log-depth scan of ops/riccati_scan.py wherever λ ≤ 10·lam_min and
    # there are no limits and no second-order terms, with the sequential
    # recursion for every other lane
    backward: str = "scan"
    # total-iteration cap (accepted + rejected); None → max_iter + 128
    iter_cap: Optional[int] = None

    def cap(self) -> int:
        return self.iter_cap if self.iter_cap is not None else self.max_iter + 128


def tol_fun_effective(tol_fun: float, cost_total: torch.Tensor) -> torch.Tensor:
    """Cost-change exit threshold floored at the dtype's cost resolution:
    ``max(tol_fun, 8·eps·|cost|)``. In f32 the reference's ``dcost < 1e-7``
    absolute (``src/iLQG.jl:306``) is unreachable for any |cost| > ~0.1, so
    without the floor an f32 solve never takes the cost exit and instead
    escalates λ until it aborts."""
    eps = torch.finfo(cost_total.dtype).eps
    return torch.clamp_min(8.0 * eps * torch.abs(cost_total), tol_fun)


class ILQGResult(NamedTuple):
    """Return tuple of the reference ``iLQG`` (``src/iLQG.jl:340``) plus
    convergence metadata; batched, each leaf has a leading (B,)."""

    x: torch.Tensor              # (T, n) optimal state trajectory
    u: torch.Tensor              # (T, m) optimal control sequence
    policy: GaussianPolicy       # feedback policy; k == u on exit
    Vx: torch.Tensor             # (T, n) cost-to-go gradient
    Vxx: torch.Tensor            # (T, n, n) cost-to-go Hessian
    cost: torch.Tensor           # (T,) or (T+1,) per-step costs
    trace: Trace
    n_iters: torch.Tensor        # total iterations run
    n_accepted: torch.Tensor
    reason: torch.Tensor         # exit reason code (module docstring)
    lam: torch.Tensor
    g_norm: torch.Tensor
    dlam: torch.Tensor = None    # with lam and n_accepted, the resume state


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        out = [_tree_map(fn, a) for a in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def _escalate(lam, dlam, factor, lam_min):
    """λ escalation with the reference's simultaneous-assignment semantics
    (``src/iLQG.jl:246,313``): λ_new uses the *old* dλ."""
    return (torch.clamp_min(lam * dlam, lam_min),
            torch.clamp_min(dlam * factor, factor))


def backward_with_retry(derivs: Derivs, u, lam, dlam, cfg: ILQGConfig, lims,
                        use_limits: bool):
    """λ-adaptive backward pass (``src/iLQG.jl:234-251``) over a batch of
    lanes: a lane that diverged escalates its λ and re-runs until PD or
    λ > λmax. Returns ``(BackwardOut, lam, dlam, aborted)``."""

    def run_seq(lam_):
        return backward_pass(derivs, u, lam_, reg_type=cfg.reg_type,
                             lims=lims, use_limits=use_limits,
                             qp_max_iter=cfg.qp_max_iter)

    if (cfg.backward == "parallel" and not use_limits
            and derivs.fxx is None):
        def run(lam_):
            # the associative-scan pass is exact only at λ=0; a lane whose
            # λ has escalated past the floor takes the sequential recursion
            small = lam_ <= 10.0 * cfg.lam_min
            some, every = torch.stack([small.any(), small.all()]).tolist()
            if every:
                return parallel_riccati(derivs, u)
            seq = run_seq(lam_)
            if not some:
                return seq
            return where_lanes(small, parallel_riccati(derivs, u), seq)
    else:
        run = run_seq

    out = run(lam)
    aborted = torch.zeros_like(out.diverged)
    go = out.diverged
    while bool(go.any()):
        lam_e, dlam_e = _escalate(lam, dlam, cfg.lam_factor, cfg.lam_min)
        lam = torch.where(go, lam_e, lam)
        dlam = torch.where(go, dlam_e, dlam)
        ab = lam > cfg.lam_max
        out = where_lanes(go & ~ab, run(lam), out)
        aborted = torch.where(go, ab, aborted)
        go = out.diverged & ~aborted
    return out, lam, dlam, aborted


def _write_trace(trace: Trace, idx, mask, **kv) -> Trace:
    """Write ``kv`` (each (B,)) at column ``idx`` (B,) of the lanes in
    ``mask``."""
    slots = torch.arange(trace.lam.shape[-1], device=idx.device)
    hot = (slots == idx[:, None]) & mask[:, None]
    d = trace._asdict()
    for key, val in kv.items():
        d[key] = torch.where(hot, val[:, None], d[key])
    return Trace(**d)


@recorded
def ilqg(problem: Problem, x0, u0, lims=None, cfg: ILQGConfig = ILQGConfig(),
         cost0=None, lam0=None, dlam0=None, accepted0=None,
         iter_callback=None) -> ILQGResult:
    """Solve the optimal control problem from an initial state ``x0`` (n,)
    (initial rollout by an α-sweep, ``src/iLQG.jl:181-192``) or from a
    pre-rolled trajectory ``x0`` (T, n) with optional per-step ``cost0``
    ((T,) or (T+1,), ``src/iLQG.jl:193-197``). ``u0``: initial controls
    (T, m); ``lims``: (m, 2) control limits.

    ``lam0``/``dlam0``/``accepted0``: the resume entry — a solve continued
    from a prior :class:`ILQGResult` (its x as a pre-rolled ``x0``, its cost
    as ``cost0``, and these three) behaves as one uninterrupted solve.

    ``iter_callback``: the reference's per-iteration ``plotFn`` hook
    (``src/iLQG.jl:160,330``), called each iteration as
    ``f(it, x, u, cost, accepted)`` with numpy arrays.

    ``u0`` keeps its device if it is a tensor, else goes to the CUDA card;
    the dtype is ``u0``'s and the other inputs follow it."""
    u0 = as_tensor(u0)
    x0 = like(x0, u0)
    res = solve_batch(problem, x0[None], u0[None], lims, cfg,
                      None if cost0 is None else like(cost0, u0)[None],
                      *(None if v is None else like(v, u0).reshape(1)
                        for v in (lam0, dlam0)),
                      None if accepted0 is None else like(
                          accepted0, u0, torch.int32).reshape(1),
                      iter_callback=iter_callback)
    return _tree_map(lambda a: a[0], res)


def solve_batch(problem: Problem, x0, u0, lims=None,
                cfg: ILQGConfig = ILQGConfig(), cost0=None, lam0=None,
                dlam0=None, accepted0=None,
                iter_callback=None) -> ILQGResult:
    """The batched driver behind :func:`ilqg` and ``ilqg_batched``: ``x0``
    (B, n) or pre-rolled (B, T, n), ``u0`` (B, T, m) tensors on one device,
    ``lims`` (m, 2) or (B, m, 2), ``cost0`` (B, T) or (B, T+1), ``lam0``,
    ``dlam0`` and ``accepted0`` (B,). Lane b's result is that of
    :func:`ilqg` on lane b alone (``src/iLQG.jl:143-341``)."""
    B, T, m = u0.shape
    n = x0.shape[-1]
    dtype, dev = u0.dtype, u0.device
    use_limits = lims is not None
    if use_limits:
        lims = like(lims, u0)
    derivs_fn = problem.make_derivs()
    cap = cfg.cap()
    alphas = torch.tensor(cfg.alphas, dtype=dtype, device=dev)
    A = alphas.shape[0]

    # ---- initial trajectory (src/iLQG.jl:181-210)
    if x0.ndim == 3:
        x, u = x0, u0
        cost = problem.trajectory_cost(x0, u0) if cost0 is None else cost0
        init_ok = torch.ones(B, dtype=torch.bool, device=dev)
        x_start = x0[:, 0]
    else:
        x_start = x0
        # α-sweep: scale u0 by each α, take the first non-diverging rollout
        ro = forward_pass(problem, x0, alphas[:, None, None, None] * u0,
                          policy=None, lims=lims)
        ok = (torch.abs(ro.x) < 1e8).all(-1).all(-1)   # (A, B)
        init_ok = ok.any(0)
        idx = torch.argmax(ok.to(torch.uint8), dim=0)
        x, u, cost = (a[idx, torch.arange(B, device=dev)]
                      for a in (ro.x, ro.u, ro.cost))

    derivs = derivs_fn(x, u)
    policy = _tree_map(lambda a: a.expand((B,) + a.shape).clone(),
                       GaussianPolicy.zeros(T, n, m, dtype, device=dev))

    def lane(v, default, dt=dtype):
        if v is None:
            return torch.full((B,), default, dtype=dt, device=dev)
        return v.to(dt).expand(B).clone()

    lam = lane(lam0, cfg.lam)
    dlam = lane(dlam0, cfg.dlam)
    accepted = (lane(accepted0, 0, torch.int32) + 1).to(torch.int32)
    trace = Trace.zeros(cap, dtype, dev, lead=(B,))
    zero_i = torch.zeros(B, dtype=torch.int32, device=dev)
    trace = _write_trace(trace, zero_i, torch.ones_like(init_ok), lam=lam,
                         dlam=dlam,
                         cost=cost.sum(-1))
    flg_change = torch.ones(B, dtype=torch.bool, device=dev)
    Vx = torch.zeros((B, T, n), dtype=dtype, device=dev)
    Vxx = torch.zeros((B, T, n, n), dtype=dtype, device=dev)
    it = torch.ones(B, dtype=torch.int32, device=dev)
    done = ~init_ok
    reason = torch.where(init_ok, 0, 5).to(torch.int32)
    g_norm = torch.zeros(B, dtype=dtype, device=dev)

    if cfg.verbosity > 0:
        _pr.ilqg_begin()
    while True:
        active = (~done) & (accepted <= cfg.max_iter) & (it < cap)
        any_active, any_change = torch.stack(
            [active.any(), (active & flg_change).any()]).tolist()
        if not any_active:
            break
        # STEP 1: differentiate along the trajectory where it changed
        # (src/iLQG.jl:226-229)
        if any_change:
            derivs = where_lanes(flg_change, derivs_fn(x, u), derivs)

        # STEP 2: backward pass with λ retry (src/iLQG.jl:234-251)
        bp, lam_b, dlam_b, bp_aborted = backward_with_retry(
            derivs, u, lam, dlam, cfg, lims, use_limits)

        # gradient-norm exit (src/iLQG.jl:256-261)
        g_new = torch.mean(torch.amax(
            torch.abs(bp.policy.k) / (torch.abs(u) + 1.0), dim=-1), dim=-1)
        grad_conv = (g_new < cfg.tol_grad) & (lam_b < 1e-5) & ~bp_aborted

        # STEP 3: line search (src/iLQG.jl:264-283)
        cost_old = cost.sum(-1)
        ls = line_search(problem, x_start, u, x, cost_old, bp.policy,
                         bp.dV, alphas, lims, cfg.reduce_ratio_min)
        accept = ls.done & ~bp_aborted & ~grad_conv

        # STEP 4: accept / reject and the λ update (src/iLQG.jl:293-323);
        # on accept dλ decreases first and λ uses the new dλ
        dlam_acc = torch.clamp_max(dlam_b / cfg.lam_factor,
                                   1.0 / cfg.lam_factor)
        lam_acc = torch.clamp_min(lam_b * dlam_acc, cfg.lam_min)
        lam_rej, dlam_rej = _escalate(lam_b, dlam_b, cfg.lam_factor,
                                      cfg.lam_min)
        lam_new = torch.where(accept, lam_acc, lam_rej)
        dlam_new = torch.where(accept, dlam_acc, dlam_rej)
        cost_conv = accept & (ls.dcost < tol_fun_effective(cfg.tol_fun,
                                                           cost_old))
        lam_exceeded = ~accept & (lam_new > cfg.lam_max)
        done_new = grad_conv | cost_conv | lam_exceeded
        reason_new = torch.where(
            grad_conv, 1, torch.where(cost_conv, 2, torch.where(
                lam_exceeded, 3, 0))).to(torch.int32)
        # on gradient convergence the reference breaks before the line
        # search and the λ update
        lam_new = torch.where(grad_conv, lam_b, lam_new)
        dlam_new = torch.where(grad_conv, dlam_b, dlam_new)

        acc3 = accept[:, None, None]
        x_new = torch.where(acc3, ls.x, x)
        u_new = torch.where(acc3, ls.u, u)
        cost_new = torch.where(accept[:, None], ls.cost, cost)
        # the reference sets traj_new.k = u on accept (src/iLQG.jl:303)
        policy_new = bp.policy._replace(
            k=torch.where(acc3, u_new, bp.policy.k))

        if cfg.verbosity > 1 or iter_callback is not None:
            for b in active.nonzero()[:, 0].tolist():
                if cfg.verbosity > 2:
                    _pr.ilqg_cholesky_failed(
                        bp.diverge_idx[b] if bp.diverged[b] else 0)
                if cfg.verbosity > 1:
                    _pr.ilqg_row(it[b], cost_old[b], ls.dcost[b],
                                 ls.expected[b], g_new[b], lam_new[b],
                                 accept[b], cfg.print_head)
                if iter_callback is not None:
                    iter_callback(*(a[b].cpu().numpy() for a in (
                        it, x_new, u_new, cost_new, accept)))

        trace = _write_trace(
            trace, torch.clamp_max(it, cap - 1), active,
            lam=lam_new, dlam=dlam_new,
            alpha=torch.where(accept, ls.alpha, float("nan")),
            improvement=ls.dcost, cost=cost_new.sum(-1), grad_norm=g_new,
            reduce_ratio=ls.reduce_ratio,
            divergence=bp.diverge_idx.to(dtype), accepted=accept)

        new = (x_new, u_new, cost_new, derivs, accept, lam_new, dlam_new,
               policy_new, bp.Vx, bp.Vxx, it + 1,
               accepted + accept.to(torch.int32), done_new, reason_new,
               g_new)
        old = (x, u, cost, derivs, flg_change, lam, dlam, policy, Vx, Vxx,
               it, accepted, done, reason, g_norm)
        (x, u, cost, derivs, flg_change, lam, dlam, policy, Vx, Vxx, it,
         accepted, done, reason, g_norm) = where_lanes(active, new, old)

    reason = torch.where((reason == 0) & (accepted > cfg.max_iter), 4,
                         reason).to(torch.int32)
    if cfg.verbosity > 0:
        for b in range(B):
            _pr.ilqg_exit(reason[b], it[b] - 1, cost[b].sum(), g_norm[b],
                          lam[b])
    return ILQGResult(x=x, u=u, policy=policy, Vx=Vx, Vxx=Vxx, cost=cost,
                      trace=trace, n_iters=it - 1, n_accepted=accepted - 1,
                      reason=reason, lam=lam, g_norm=g_norm, dlam=dlam)
