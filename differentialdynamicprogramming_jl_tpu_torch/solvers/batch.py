"""Fleet iLQG solver on streams: B independent problems solved in lock-step.

Counterpart of ``differentialdynamicprogramming_jl_tpu/solvers/batch.py``
(``ilqg_batch_lanes``, reference semantics of ``src/iLQG.jl:143-341`` per
scenario, the MPC step ``ilqg_iteration_lanes`` and the receding-horizon
loop ``mpc_rollout_lanes``). The loop state is one trajectory stream
``(T, n+m+1, B)`` holding [x, u, running cost]; each iteration runs the
backward kernel (K1) on it, relaunched for the per-lane λ-retry, then the
fused line-search kernel (K2), which returns the next stream. The initial
α-sweep and rollout use the forward kernel (K3).

The JAX solver is one ``lax.while_loop`` and its MPC loop one ``lax.scan``;
these are host loops. The λ-retry condition and ``done.all()`` each
synchronise with the host once per check. Per-scenario control flow stays
elementwise on (B,) masks, line for line as in the JAX solver.

K1 takes its derivatives in one of two ways: in-kernel from the stream by
``derivs_tiles`` (preferred where both are given, as in JAX), or from a
**packed-derivatives stream** ``(T, D+m, B)`` made outside K1 by a
``packed_derivs(x_s, u_s)`` generator (``pendcart_packed_derivs``,
``lti_packed_derivs``, ``autodiff_packed_derivs``). The driver keeps JAX's
life of that stream (``solvers/batch.py:380-381, 550-556, 590-592``): built
at init, reused by every λ-retry, rebuilt after an iteration only when some
lane accepted, and made once more from the last backward pass's stream for
the final ``full`` replay.

Whether a kernel or its plain version runs is decided by the device of
``x0s``/``u0s`` alone: CPU tensors run the plain versions, CUDA tensors the
kernels, and inputs that are not tensors go to the card (:mod:`..device`).
Results live on that device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..device import as_tensor
from ..policy import GaussianPolicy
from ..utils import printing as _pr
from ..ops.hopper.pack import from_streams, mean_t, to_streams
from ..ops.hopper.backward_kernel import InLayout, OutLayout, backward_lanes
from ..ops.hopper.forward_kernel import (LanesModel, check_lims, par_args,
                                         forward_lanes, linesearch_lanes,
                                         step_indices)
from .ilqg import ILQGConfig, tol_fun_effective
from ..utils.aot import recorded


class BatchTrace(NamedTuple):
    """Per-iteration convergence record, batch-major (B, cap) (reference
    MVHistory keys, ``src/iLQG.jl:325-330``)."""

    cost: torch.Tensor
    lam: torch.Tensor
    dlam: torch.Tensor
    grad_norm: torch.Tensor
    improvement: torch.Tensor
    reduce_ratio: torch.Tensor
    alpha: torch.Tensor
    accepted: torch.Tensor
    divergence: torch.Tensor   # backward-pass diverge timestep (0 = none)


class BatchILQGResult(NamedTuple):
    """Per-scenario results, batch-major."""

    x: torch.Tensor           # (B, T, n)
    u: torch.Tensor           # (B, T, m)
    policy: GaussianPolicy    # leaves (B, T, ...); k == final u
    Vx: torch.Tensor          # (B, T, n)
    Vxx: torch.Tensor         # (B, T, n, n)
    cost: torch.Tensor        # (B, T) running costs
    cost_total: torch.Tensor  # (B,) incl. terminal component
    n_iters: torch.Tensor     # (B,)
    n_accepted: torch.Tensor  # (B,)
    reason: torch.Tensor      # (B,) exit codes as solvers.ilqg
    lam: torch.Tensor         # (B,)
    dlam: torch.Tensor        # (B,)
    g_norm: torch.Tensor      # (B,)
    trace: Optional[BatchTrace] = None   # with record_trace=True


def split_lims(lims):
    """Sort a user ``lims`` into (static tuple, per-scenario array): tuples
    and lists of (lo, hi) pairs stay static; anything else is a per-scenario
    (B, m, 2) array (a tensor keeps its device, anything else goes to the
    card), as the reference takes limits as runtime data
    (``src/iLQG.jl:124``)."""
    if lims is None:
        return None, None
    if isinstance(lims, (tuple, list)):
        return tuple((float(lo), float(hi)) for lo, hi in lims), None
    lims = as_tensor(lims)
    if lims.ndim != 3 or lims.shape[-1] != 2:
        raise ValueError(f"per-scenario lims must be (B, m, 2), got "
                         f"{tuple(lims.shape)}")
    return None, lims


def pack_lims(lims_batch: torch.Tensor) -> torch.Tensor:
    """(B, m, 2) per-scenario limits → the kernels' (2m, B) f32 stream, slot
    order [lo_0, hi_0, lo_1, hi_1, ...]. Streams are not padded (each kernel
    masks b < B), so the JAX package's zero rows for lanes beyond B have no
    counterpart here."""
    B, m = lims_batch.shape[0], lims_batch.shape[1]
    return lims_batch.to(torch.float32).reshape(B, 2 * m).T.contiguous()


def _eval_costs(model: LanesModel, x_s, u_s, par) -> torch.Tensor:
    """(T, B) running costs of a stream's (x, u) slots with the model's lane
    functions, outside the kernels (pre-rolled entry; JAX
    ``_eval_costs_lanes``, ``:138-149``), with the kernels' int32 step
    index."""
    ts = step_indices(x_s.shape[0], x_s.device)
    return torch.stack([
        model.cost([x_s[t, i] for i in range(model.n)],
                   [u_s[t, mi] for mi in range(model.m)], ts[t], *par)
        for t in range(x_s.shape[0])])


def _eval_terminal(model: LanesModel, xT, par) -> torch.Tensor:
    """Terminal cost at the last stored state, the forward kernel's
    convention (JAX ``_eval_terminal_lanes``, ``:152-160``)."""
    if model.terminal is None:
        return torch.zeros_like(xT[0])
    return model.terminal([xT[i] for i in range(model.n)], *par)


def active_means(active, *vals):
    """The number of active scenarios and each value's mean over them, as
    the JAX drivers form their aggregate rows (``solvers/batch.py:536-546``):
    masked f32 sums over max(count, 1)."""
    n_act = active.sum()
    den = torch.clamp_min(n_act, 1).to(torch.float32)
    return (n_act,) + tuple(torch.where(active, v, 0.0).sum() / den
                            for v in vals)


def _packed(packed_derivs, traj, n: int, m: int) -> torch.Tensor:
    """The packed-derivatives stream of a [x, u, ...] stream, checked: a
    (T, D+m, B) f32 stream for K1 (JAX ``InLayout``)."""
    dp = packed_derivs(traj[:, :n], traj[:, n:n + m])
    want = (traj.shape[0], InLayout(n, m).DU, traj.shape[2])
    if not isinstance(dp, torch.Tensor) or tuple(dp.shape) != want:
        raise ValueError(
            f"packed_derivs gave {getattr(dp, 'shape', type(dp))}; K1 takes "
            f"the (T, D+m, B) stream {want} (DerivLayout, then u)")
    return dp.to(torch.float32).contiguous()


@recorded
def ilqg_batch_lanes(model: LanesModel, packed_derivs, x0s, u0s, lims=None,
                     cfg: ILQGConfig = ILQGConfig(), derivs_tiles=None,
                     params=None, cost0=None, warm_start: bool = False,
                     lam0=None, dlam0=None, accepted0=None, max_steps=None,
                     kt_backward: int = 25, kt_forward: int = 25,
                     record_trace: bool = False,
                     interpret: bool = False, *,
                     cost_total0=None) -> BatchILQGResult:
    """Solve B independent iLQG problems.

    - ``model``: :class:`LanesModel`; ``derivs_tiles``: the in-kernel
      derivative function (e.g. ``pendcart_derivs_tiles(spec)``, or
      ``pendcart_derivs_tiles_so(spec)`` for full DDP); or, with
      ``derivs_tiles=None``, ``packed_derivs``: ``(x_s (T, n, B), u_s
      (T, m, B)) → (T, D+m, B)``, K1's packed-derivatives stream (e.g.
      ``pendcart_packed_derivs(spec)``, ``autodiff_packed_derivs(model)``),
      built at init and rebuilt only after iterations in which some lane
      accepted.
    - ``x0s``: (B, n) initial states, rolled out from ``u0s`` (B, T, m) by
      the α-sweep (``src/iLQG.jl:181-192``); or **pre-rolled** (B, T, n)
      trajectories used verbatim with ``u0s`` (``src/iLQG.jl:193-197``), a
      lane's supplied trajectory kept on every rejected iteration.
    - ``cost0``: optional (B, T) per-step costs of a pre-rolled trajectory,
      or (B, T+1) with the terminal cost last; computed from ``model`` when
      omitted.
    - ``warm_start``: with (B, n) ``x0s``, skip the α-sweep and roll
      ``u0s`` at α=1 (one K3 launch; the MPC re-roll of a shifted plan).
    - ``lam0``/``dlam0``/``accepted0``: optional (B,) initial λ, dλ and
      accepted-iteration counts, to resume a solve from a prior result;
      ``cost_total0``: with pre-rolled ``x0s`` and ``cost0``, the (B,)
      total cost that result carried, taken as it is instead of summed
      anew from ``cost0``, so that a resumed solve continues from the same
      bits (the fleet scheduler, :mod:`.fleet`).
    - ``lims``: static ``((lo, hi),) * m``, a per-scenario (B, m, 2) array,
      or None for the unconstrained solve; ``cfg``: :class:`ILQGConfig`.
    - ``params``: (B, P) per-scenario parameters of a model (and
      ``derivs_tiles``) with ``n_params == P``.
    - ``max_steps``: bound on this call's iterations below ``cfg.cap()``.
    - ``record_trace``: also return the (B, cap) :class:`BatchTrace`.
    - ``cfg.verbosity > 1``: a fleet-aggregate row an iteration
      (:func:`~..utils.printing.lanes_row`; a host sync each).

    The JAX signature's TPU switches ``kt_backward``, ``kt_forward``
    (time steps a grid step) and ``interpret`` (Pallas interpret mode) are
    taken and have no effect: each kernel thread walks the whole horizon,
    and a CPU tensor runs the plain versions.

    Host syncs: one per iteration for the exit check (with
    ``packed_derivs``, the same transfer also brings the "some lane
    accepted" flag) and one per λ-retry check, at least one an iteration.
    """
    x0s = as_tensor(x0s)
    u0s = as_tensor(u0s)
    if derivs_tiles is None and packed_derivs is None:
        raise ValueError("derivs_tiles or packed_derivs is required")
    lims, lims_batch = split_lims(lims)
    check_lims(model.m, lims)
    if (params is None) != (model.n_params == 0):
        raise ValueError(f"params: the model takes {model.n_params} "
                         "per-scenario parameters")
    n, m = model.n, model.m
    B, T = u0s.shape[0], u0s.shape[1]
    dev = u0s.device
    given = {name: as_tensor(v) for name, v in (
        ("x0s", x0s), ("params", params), ("lims", lims_batch),
        ("cost0", cost0), ("lam0", lam0), ("dlam0", dlam0),
        ("accepted0", accepted0), ("cost_total0", cost_total0))
        if v is not None}
    for name, v in given.items():
        if v.device != dev:
            raise ValueError(f"{name} on {v.device}, u0s on {dev}")
    f32 = torch.float32
    lay = OutLayout(n, m)
    cap = cfg.cap()
    pre_rolled = x0s.ndim == 3

    u_nom0 = to_streams(u0s.to(f32))                         # (T, m, B)
    if pre_rolled:
        x_roll = to_streams(x0s.to(f32))                     # (T, n, B)
        x0_l = x_roll[0]
    else:
        x0_l = x0s.to(f32).T.contiguous()                    # (n, B)
    # (B, P) → the kernels' (P, B) stream. No lane beyond B exists, so the
    # JAX package's benign padding row (solvers/batch.py:297-308) has no
    # counterpart here.
    par_l = (given["params"].to(f32).T.contiguous() if params is not None
             else None)
    lims_l = pack_lims(lims_batch) if lims_batch is not None else None
    par = par_args(par_l)
    alphas = torch.tensor(cfg.alphas, dtype=f32, device=dev)
    A = alphas.shape[0]

    def run_fwd(traj, gains, al, emit):
        return forward_lanes(traj, gains, x0_l, al, par_l, lims_l,
                             model=model, lims=lims, gk=0, gK=m,
                             emit_traj=emit)

    def run_bwd(bwd_in, lam, emit="gains"):
        # the packed stream holds the expansion: no params enter K1
        return backward_lanes(bwd_in, lam, n=n, m=m, reg_type=cfg.reg_type,
                              lims=lims, derivs_tiles=derivs_tiles,
                              params=par_l if derivs_tiles is not None
                              else None, lims_lanes=lims_l, emit=emit)

    # the in-kernel tiles read the trajectory stream itself; the packed
    # route carries its derivative stream (JAX :380-381, :426-431)
    use_packed = derivs_tiles is None

    if pre_rolled:
        # trust the supplied trajectory verbatim (src/iLQG.jl:193-197): no
        # rollout; per-step costs from cost0 or from the model's functions
        if cost0 is not None:
            c0 = given["cost0"].to(f32)
            c_l = c0[:, :T].T.contiguous()                   # (T, B)
            cterm = (c0[:, T] if c0.shape[1] == T + 1
                     else _eval_terminal(model, x_roll[T - 1], par))
        else:
            c_l = _eval_costs(model, x_roll, u_nom0, par)
            cterm = _eval_terminal(model, x_roll[T - 1], par)
        traj_init = torch.cat([x_roll, u_nom0, c_l[:, None]], dim=1)
        tot_init = (given["cost_total0"].to(f32) if cost_total0 is not None
                    else c_l.sum(dim=0) + cterm)
        any0 = torch.isfinite(tot_init) & (tot_init < 1e16)
    else:
        # ---- initial rollout α-sweep (src/iLQG.jl:181-210): u ← α·u0 via
        #      the trick k := u0, u_nom := 0; warm_start pins α=1
        traj0 = torch.zeros((T, n + m, B), dtype=f32, device=dev)
        gains0 = torch.cat(
            [u_nom0, torch.zeros((T, m * n, B), dtype=f32, device=dev)],
            dim=1)
        if warm_start:
            al_init = torch.ones((B,), dtype=f32, device=dev)
        else:
            fa0 = run_fwd(traj0, gains0,
                          alphas[:, None].expand(A, B).contiguous(), False)
            ok0 = torch.isfinite(fa0.totals) & (fa0.totals < 1e16)
            any0 = ok0.any(dim=0)                            # |x| < 1e8
            idx0 = torch.argmax(ok0.to(torch.int32), dim=0)  # first ok α
            al_init = torch.where(any0, alphas[idx0], 0.0)
        fb0 = run_fwd(traj0, gains0, al_init[None].contiguous(), True)
        traj_init, tot_init = fb0.traj, fb0.totals[0]
        if warm_start:
            any0 = torch.isfinite(tot_init) & (tot_init < 1e16)
        # NaN scrub on init-diverged (reason 5) lanes: once x overflows, the
        # control law computes 0·Inf = NaN. These lanes exit at once with
        # this rollout as their result; keep it Inf-marked but NaN-free.
        bad0 = ~any0
        traj_init = torch.where(bad0 & torch.isnan(traj_init), 0.0,
                                traj_init)
        tot_init = torch.where(bad0 & torch.isnan(tot_init), float("inf"),
                               tot_init)

    if record_trace:
        tr = {f: torch.zeros((cap, B), dtype=f32, device=dev)
              for f in BatchTrace._fields}
        tr["cost"][0] = tot_init
        tr["alpha"].fill_(float("nan"))

    traj, cost_tot = traj_init, tot_init
    bwd_in = _packed(packed_derivs, traj, n, m) if use_packed else None
    lam = (given["lam0"].to(f32) if lam0 is not None
           else torch.full((B,), cfg.lam, dtype=f32, device=dev))
    dlam = (given["dlam0"].to(f32) if dlam0 is not None
            else torch.full((B,), cfg.dlam, dtype=f32, device=dev))
    accepted = (given["accepted0"].to(torch.int32) + 1 if accepted0 is not None
                else torch.ones((B,), dtype=torch.int32, device=dev))
    traj_bwd, lam_used = traj, lam
    done = ~any0
    reason = torch.where(any0, 0, 5).to(torch.int32)
    it_lane = torch.zeros((B,), dtype=torch.int32, device=dev)
    g_norm = torch.zeros((B,), dtype=f32, device=dev)
    max_steps = cap - 1 if max_steps is None else int(max_steps)
    cap_rt = min(max_steps + 1, cap)

    it = 1
    all_done = bool(done.all())
    while it < cap_rt and not all_done:
        active = ~done
        u_cur = traj[:, n:n + m]

        # == derivatives + backward pass with per-scenario λ retry
        #    (src/iLQG.jl:226-251); every retry relaunches the whole fleet
        #    on the same stream: the packed one is not rebuilt for a retry
        if not use_packed:
            bwd_in = traj
        res = run_bwd(bwd_in, lam)
        lam_r, dlam_r = lam, dlam
        aborted = torch.zeros((B,), dtype=torch.bool, device=dev)
        while bool((active & (res.stats[2] > 0.5) & ~aborted).any()):
            div = (res.stats[2] > 0.5) & active & ~aborted
            lam_n = torch.where(
                div, torch.clamp_min(lam_r * dlam_r, cfg.lam_min), lam_r)
            dlam_n = torch.where(
                div, torch.clamp_min(dlam_r * cfg.lam_factor, cfg.lam_factor),
                dlam_r)
            aborted = aborted | (div & (lam_n > cfg.lam_max))
            lam_r, dlam_r = lam_n, dlam_n
            res = run_bwd(bwd_in, lam_r)
        bo = res.out
        dV1, dV2 = res.stats[0], res.stats[1]
        bp_bad = aborted | (res.stats[2] > 0.5)

        # gradient-norm termination (src/iLQG.jl:256-261)
        k_s = bo[:, lay.k:lay.k + m]                              # (T, m, B)
        g_it = mean_t(torch.amax(
            torch.abs(k_s) / (torch.abs(u_cur) + 1.0), dim=1))
        grad_conv = (g_it < cfg.tol_grad) & (lam_r < 1e-5) & ~bp_bad

        # == fused line search (src/iLQG.jl:264-283); rejected lanes retrace
        #    their stream with α=0. The output is a fresh stream: the
        #    backward replay after the loop needs this iteration's entry
        #    stream, which JAX gets from the kernel's echo instead.
        allow = ~bp_bad & ~grad_conv & active
        sel = torch.stack([dV1, dV2, cost_tot, allow.to(f32)])
        fb = linesearch_lanes(traj, bo, x0_l, sel, par_l, lims_l, model=model,
                              alphas=cfg.alphas,
                              reduce_ratio_min=cfg.reduce_ratio_min,
                              lims=lims, gk=lay.k, gK=lay.K)
        al_sel, dcost_sel = fb.ls[0], fb.ls[2]
        accept = (fb.ls[1] > 0.5) & allow

        # == accept / reject λ update (src/iLQG.jl:293-323)
        dlam_acc = torch.clamp_max(dlam_r / cfg.lam_factor,
                                   1.0 / cfg.lam_factor)
        lam_acc = torch.clamp_min(lam_r * dlam_acc, cfg.lam_min)
        lam_rej = torch.clamp_min(lam_r * dlam_r, cfg.lam_min)
        dlam_rej = torch.clamp_min(dlam_r * cfg.lam_factor, cfg.lam_factor)
        lam_n = torch.where(accept, lam_acc, lam_rej)
        dlam_n = torch.where(accept, dlam_acc, dlam_rej)

        cost_conv = accept & (dcost_sel < tol_fun_effective(cfg.tol_fun,
                                                             cost_tot))
        lam_exceeded = active & ~accept & ~grad_conv & (lam_n > cfg.lam_max)
        # on gradient convergence the reference breaks before the λ update
        lam_n = torch.where(grad_conv, lam_r, lam_n)
        dlam_n = torch.where(grad_conv, dlam_r, dlam_n)

        newly_done = active & (grad_conv | cost_conv | lam_exceeded)
        reason_new = torch.where(grad_conv, 1, torch.where(cost_conv, 2, 3))
        reason = torch.where(newly_done, reason_new.to(torch.int32), reason)
        accepted = accepted + accept.to(torch.int32)
        done = done | newly_done | (accepted > cfg.max_iter)

        if pre_rolled:
            # a supplied trajectory may be inconsistent with the dynamics,
            # so its α=0 retrace is not itself: keep it verbatim on reject
            traj_n = torch.where(accept, fb.traj, traj)
            tot_n = torch.where(accept, fb.ls[4], cost_tot)
        else:
            traj_n, tot_n = fb.traj, fb.ls[4]

        if record_trace:
            ti = min(it, cap - 1)
            for name, val in (("cost", tot_n), ("lam", lam_n),
                              ("dlam", dlam_n), ("grad_norm", g_it),
                              ("improvement", dcost_sel),
                              ("reduce_ratio", fb.ls[3]),
                              ("alpha", torch.where(accept, al_sel,
                                                    float("nan"))),
                              ("accepted", accept.to(f32)),
                              ("divergence", res.stats[3])):
                tr[name][ti] = val
        if cfg.verbosity > 1:
            _pr.lanes_row(it, *active_means(
                active, tot_n, accept.to(f32), lam_n, g_it), cfg.print_head)

        # the backward replay after the loop needs the inputs of the last
        # backward pass each lane ran: this iteration's entry stream and λ
        traj_bwd, lam_used = traj, lam_r
        traj, cost_tot = traj_n, tot_n
        lam = torch.where(active, lam_n, lam)
        dlam = torch.where(active, dlam_n, dlam)
        it_lane = torch.where(active, it, it_lane).to(torch.int32)
        g_norm = torch.where(active, g_it, g_norm)
        it += 1
        if use_packed:
            # one transfer brings the exit check and "some lane accepted";
            # the stream is rebuilt only when some lane moved (JAX
            # :550-556, the reference's flg_change, src/iLQG.jl:226-229)
            all_done, any_acc = torch.stack(
                [done.all(), accept.any()]).tolist()
            if any_acc:
                bwd_in = _packed(packed_derivs, traj, n, m)
        else:
            all_done = bool(done.all())

    reason = torch.where((reason == 0) & (accepted > cfg.max_iter), 4,
                         reason).to(torch.int32)

    # ---- replay the final backward outputs in full emission, once, on the
    #      stream of the last backward pass each lane ran (JAX :590-592)
    bo_full = run_bwd(_packed(packed_derivs, traj_bwd, n, m) if use_packed
                      else traj_bwd, lam_used, emit="full").out
    # reason-5 lanes: zero-gain, unit-Σ policy and zero value expansion
    # (GaussianPolicy.zeros, src/iLQG.jl:205-210); the rollout entry also
    # restores the frozen initial rollout, while a pre-rolled lane kept its
    # supplied trajectory through the select in the loop
    bad5 = ~any0
    eye_slots = torch.zeros((lay.S, 1), dtype=f32, device=dev)
    for i in range(m):
        eye_slots[lay.quu + i * m + i] = 1.0
        eye_slots[lay.quui + i * m + i] = 1.0
    bo_full = torch.where(bad5, eye_slots, bo_full)
    if not pre_rolled:
        traj = torch.where(bad5, traj_init, traj)
        cost_tot = torch.where(bad5, tot_init, cost_tot)

    # ---- unpack to batch-major
    u = from_streams(traj[:, n:n + m], (m,))
    policy = GaussianPolicy(
        K=from_streams(bo_full[:, lay.K:lay.K + m * n], (m, n)), k=u,
        sigma=from_streams(bo_full[:, lay.quui:lay.quui + m * m], (m, m)),
        sigma_inv=from_streams(bo_full[:, lay.quu:lay.quu + m * m], (m, m)))
    return BatchILQGResult(
        x=from_streams(traj[:, :n], (n,)), u=u, policy=policy,
        Vx=from_streams(bo_full[:, lay.Vx:lay.Vx + n], (n,)),
        Vxx=from_streams(bo_full[:, lay.Vxx:lay.Vxx + n * n], (n, n)),
        cost=from_streams(traj[:, n + m:n + m + 1], ()),
        cost_total=cost_tot, n_iters=it_lane, n_accepted=accepted - 1,
        reason=reason, lam=lam, dlam=dlam, g_norm=g_norm,
        trace=(BatchTrace(**{k: v.T for k, v in tr.items()})
               if record_trace else None))


def ilqg_iteration_lanes(model: LanesModel, packed_derivs, lims,
                         cfg: ILQGConfig, derivs_tiles=None,
                         kt_backward: int = 25, kt_forward: int = 25,
                         interpret: bool = False) -> Callable:
    """One iLQG iteration on stream state, the per-step hot path of an MPC
    loop (JAX ``solvers/batch.py:646-707``). Returns
    ``step(traj, cost_tot, lam) -> (traj, cost_tot, lam)`` with ``traj`` the
    (T, n+m+1, B) [x, u, c] stream, which must come from the forward kernel
    (its α=0 retrace is then itself, so rejected lanes need no select).

    K1 runs once in ``gains`` emission (no λ-retry), then K2 **in place**:
    the input ``traj`` is overwritten by the new stream and returned, as JAX
    donates it. Clone it first to keep it. λ moves by JAX's own rule,
    ``where(accept, max(λ/lam_factor, 1e-6), min(λ·lam_factor, lam_max))``,
    not by the solver's dλ schedule. ``lims`` is static, a per-scenario
    (B, m, 2) array (packed here once), or None. As in JAX, the step takes
    no ``params``. With ``derivs_tiles=None``, K1 reads the stream
    ``packed_derivs`` makes of ``traj`` at each step. ``kt_backward``,
    ``kt_forward`` and ``interpret`` are the TPU kernels' switches and have
    no effect here.
    """
    if derivs_tiles is None and packed_derivs is None:
        raise ValueError("derivs_tiles or packed_derivs is required")
    if model.n_params:
        raise ValueError("ilqg_iteration_lanes takes no params, as the JAX "
                         "package's; its model must have n_params == 0")
    n, m = model.n, model.m
    lims, lims_batch = split_lims(lims)
    check_lims(m, lims)
    lims_l = pack_lims(lims_batch) if lims_batch is not None else None
    lay = OutLayout(n, m)

    def step(traj, cost_tot, lam):
        x0_l = traj[0, :n]           # a view: K2 reads it before writing
        bwd_in = (traj if derivs_tiles is not None
                  else _packed(packed_derivs, traj, n, m))
        res = backward_lanes(bwd_in, lam, n=n, m=m, reg_type=cfg.reg_type,
                             lims=lims, derivs_tiles=derivs_tiles,
                             lims_lanes=lims_l, emit="gains")
        allow = ~(res.stats[2] > 0.5)
        sel = torch.stack([res.stats[0], res.stats[1], cost_tot,
                           allow.to(torch.float32)])
        fb = linesearch_lanes(traj, res.out, x0_l, sel, None, lims_l,
                              model=model, alphas=cfg.alphas,
                              reduce_ratio_min=cfg.reduce_ratio_min,
                              lims=lims, gk=lay.k, gK=lay.K, in_place=True)
        accept = (fb.ls[1] > 0.5) & allow
        lam_n = torch.where(accept, torch.clamp_min(lam / cfg.lam_factor,
                                                    1e-6),
                            torch.clamp_max(lam * cfg.lam_factor,
                                            cfg.lam_max))
        return fb.traj, fb.ls[4], lam_n

    return step


def mpc_rollout_lanes(model: LanesModel, packed_derivs, x0s, u0s,
                      plant: Callable, n_steps: int, lims=None,
                      cfg: ILQGConfig = ILQGConfig(), derivs_tiles=None,
                      params=None, kt_backward: int = 25,
                      kt_forward: int = 25, interpret: bool = False):
    """Receding-horizon MPC: ``n_steps`` chained steps of a warm-started,
    bounded iLQG re-solve (:func:`ilqg_batch_lanes` with
    ``warm_start=True``, ``max_steps = cfg.cap() - 1``), the plan's first
    control applied through ``plant``, and the plan shifted by one step with
    a zero last control (JAX ``solvers/batch.py:710-790``). JAX chains the
    steps in one ``lax.scan``; this is a host loop of solves.

    - ``plant(x (B, n), u (B, m)) -> x_next (B, n)``: the true plant, which
      may differ from ``model``'s prediction; its output is cast to f32.
    - ``x0s`` (B, n), ``u0s`` (B, T, m): the first state and plan, cast to
      f32. ``lims`` (static or per-scenario), ``params`` and
      ``derivs_tiles`` or ``packed_derivs`` go to every re-solve.
    - ``kt_backward``, ``kt_forward`` and ``interpret``: the TPU kernels'
      switches, taken and without effect.

    Returns ``(x_final (B, n), u_plan_final (B, T, m), states
    (n_steps, B, n), controls (n_steps, B, m), cost_totals (n_steps, B))``.
    """
    f32 = torch.float32
    x = as_tensor(x0s, f32)
    u = as_tensor(u0s, f32)
    B, _, m = u.shape
    rows = []
    for _ in range(int(n_steps)):
        res = ilqg_batch_lanes(model, packed_derivs, x, u, lims=lims, cfg=cfg,
                               derivs_tiles=derivs_tiles, params=params,
                               warm_start=True, max_steps=cfg.cap() - 1)
        u_apply = res.u[:, 0]
        x = plant(x, u_apply).to(f32)
        u = torch.cat([res.u[:, 1:],
                       torch.zeros((B, 1, m), dtype=f32, device=u.device)],
                      dim=1)
        rows.append((x, u_apply, res.cost_total))
    xs, us, costs = (torch.stack(col) for col in zip(*rows))
    return x, u, xs, us, costs
