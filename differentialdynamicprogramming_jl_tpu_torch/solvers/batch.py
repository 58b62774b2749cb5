"""Fleet iLQG solver on streams: B independent problems solved in lock-step.

Counterpart of ``differentialdynamicprogramming_jl_tpu/solvers/batch.py``
(``ilqg_batch_lanes``, reference semantics of ``src/iLQG.jl:143-341`` per
scenario). The loop state is one trajectory stream ``(T, n+m+1, B)`` holding
[x, u, running cost]; each iteration runs the backward kernel (K1) on it,
relaunched for the per-lane λ-retry, then the fused line-search kernel (K2),
which returns the next stream. The initial α-sweep and rollout use the
forward kernel (K3).

The JAX solver is one ``lax.while_loop``; this one is a host loop. The
λ-retry condition and ``done.all()`` each synchronise with the host once per
check. Per-scenario control flow stays elementwise on (B,) masks, line for
line as in the JAX solver.

Whether a kernel or its plain version runs is decided by the device of
``x0s``/``u0s`` alone: CPU tensors run the plain versions, CUDA tensors the
kernels, and inputs that are not tensors go to the card (:mod:`..device`).
Results live on that device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import as_tensor
from ..policy import GaussianPolicy
from ..ops.hopper.pack import to_streams, from_streams
from ..ops.hopper.backward_kernel import OutLayout, backward_lanes
from ..ops.hopper.forward_kernel import (LanesModel, check_slice,
                                         forward_lanes, linesearch_lanes)
from .ilqg import ILQGConfig, tol_fun_effective


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
    """Sort a user ``lims`` into (static tuple, per-scenario array). Only the
    static form ``((lo, hi),) * m`` is in this slice."""
    if lims is None:
        return None, None
    if isinstance(lims, (tuple, list)):
        return tuple((float(lo), float(hi)) for lo, hi in lims), None
    raise NotImplementedError("per-scenario lims arrays")


def _out_of_slice(packed_derivs, derivs_tiles, params, cost0, warm_start,
                  lam0, dlam0, accepted0, x0s, cfg):
    for name, val in (("packed_derivs", packed_derivs), ("params", params),
                      ("cost0", cost0), ("lam0", lam0), ("dlam0", dlam0),
                      ("accepted0", accepted0)):
        if val is not None:
            raise NotImplementedError(f"{name} is not ported yet")
    if warm_start:
        raise NotImplementedError("warm_start is not ported yet")
    if x0s.ndim == 3:
        raise NotImplementedError("pre-rolled (B, T, n) x0s are not ported yet")
    if cfg.verbosity > 1:
        raise NotImplementedError("verbosity > 1 (fleet iteration rows)")
    if derivs_tiles is None:
        raise ValueError("derivs_tiles is required")


def ilqg_batch_lanes(model: LanesModel, packed_derivs, x0s, u0s, lims=None,
                     cfg: ILQGConfig = ILQGConfig(), derivs_tiles=None,
                     params=None, cost0=None, warm_start: bool = False,
                     lam0=None, dlam0=None, accepted0=None, max_steps=None,
                     record_trace: bool = False) -> BatchILQGResult:
    """Solve B independent iLQG problems.

    - ``model``: :class:`LanesModel`; ``derivs_tiles``: the in-kernel
      derivative function (e.g. ``pendcart_derivs_tiles(spec)``).
    - ``x0s``: (B, n) initial states; ``u0s``: (B, T, m) initial controls.
      The initial rollout sweeps the α ladder (``src/iLQG.jl:181-192``).
    - ``lims``: static ``((lo, hi),) * m``, or None for the unconstrained
      solve; ``cfg``: :class:`ILQGConfig`.
    - ``max_steps``: bound on this call's iterations below ``cfg.cap()``.
    - ``record_trace``: also return the (B, cap) :class:`BatchTrace`.

    The JAX signature's TPU switches ``kt_backward``, ``kt_forward`` and
    ``interpret`` are not taken.

    Not in this slice (NotImplementedError): ``packed_derivs``, ``params``,
    per-scenario ``lims`` arrays, m > 2, pre-rolled ``x0s``, ``cost0``,
    ``warm_start`` and the resume counters ``lam0``/``dlam0``/``accepted0``.
    """
    x0s = as_tensor(x0s)
    u0s = as_tensor(u0s)
    _out_of_slice(packed_derivs, derivs_tiles, params, cost0, warm_start,
                  lam0, dlam0, accepted0, x0s, cfg)
    lims, _ = split_lims(lims)
    check_slice(model.m, lims)
    if x0s.device != u0s.device:
        raise ValueError(f"x0s on {x0s.device}, u0s on {u0s.device}")
    n, m = model.n, model.m
    B, T = u0s.shape[0], u0s.shape[1]
    dev = u0s.device
    f32 = torch.float32
    lay = OutLayout(n, m)
    cap = cfg.cap()

    x0_l = x0s.to(f32).T.contiguous()                       # (n, B)
    u_nom0 = to_streams(u0s.to(f32))                         # (T, m, B)
    alphas = torch.tensor(cfg.alphas, dtype=f32, device=dev)
    A = alphas.shape[0]

    def run_fwd(traj, gains, al, emit):
        return forward_lanes(traj, gains, x0_l, al, model=model, lims=lims,
                             gk=0, gK=m, emit_traj=emit)

    def run_bwd(traj, lam, emit="gains"):
        return backward_lanes(traj, lam, n=n, m=m, reg_type=cfg.reg_type,
                              lims=lims, derivs_tiles=derivs_tiles, emit=emit)

    # ---- initial rollout α-sweep (src/iLQG.jl:181-210): u ← α·u0 via the
    #      trick k := u0, u_nom := 0
    traj0 = torch.zeros((T, n + m, B), dtype=f32, device=dev)
    gains0 = torch.cat(
        [u_nom0, torch.zeros((T, m * n, B), dtype=f32, device=dev)], dim=1)
    fa0 = run_fwd(traj0, gains0, alphas[:, None].expand(A, B).contiguous(),
                  False)
    ok0 = torch.isfinite(fa0.totals) & (fa0.totals < 1e16)     # |x| < 1e8
    any0 = ok0.any(dim=0)
    idx0 = torch.argmax(ok0.to(torch.int32), dim=0)           # first ok α
    al_init = torch.where(any0, alphas[idx0], 0.0)
    fb0 = run_fwd(traj0, gains0, al_init[None].contiguous(), True)
    traj_init, tot_init = fb0.traj, fb0.totals[0]
    # NaN scrub on init-diverged (reason 5) lanes: once x overflows, the
    # control law computes 0·Inf = NaN. These lanes exit at once with this
    # rollout as their result; keep it Inf-marked but NaN-free.
    bad0 = ~any0
    traj_init = torch.where(bad0 & torch.isnan(traj_init), 0.0, traj_init)
    tot_init = torch.where(bad0 & torch.isnan(tot_init), float("inf"),
                           tot_init)

    if record_trace:
        tr = {f: torch.zeros((cap, B), dtype=f32, device=dev)
              for f in BatchTrace._fields}
        tr["cost"][0] = tot_init
        tr["alpha"].fill_(float("nan"))

    traj, cost_tot = traj_init, tot_init
    lam = torch.full((B,), cfg.lam, dtype=f32, device=dev)
    dlam = torch.full((B,), cfg.dlam, dtype=f32, device=dev)
    traj_bwd, lam_used = traj, lam
    done = ~any0
    reason = torch.where(any0, 0, 5).to(torch.int32)
    accepted = torch.ones((B,), dtype=torch.int32, device=dev)
    it_lane = torch.zeros((B,), dtype=torch.int32, device=dev)
    g_norm = torch.zeros((B,), dtype=f32, device=dev)
    max_steps = cap - 1 if max_steps is None else int(max_steps)
    cap_rt = min(max_steps + 1, cap)

    it = 1
    while it < cap_rt and not bool(done.all()):
        active = ~done
        u_cur = traj[:, n:n + m]

        # == derivatives + backward pass with per-scenario λ retry
        #    (src/iLQG.jl:226-251); every retry relaunches the whole fleet
        res = run_bwd(traj, lam)
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
            res = run_bwd(traj, lam_r)
        bo = res.out
        dV1, dV2 = res.stats[0], res.stats[1]
        bp_bad = aborted | (res.stats[2] > 0.5)

        # gradient-norm termination (src/iLQG.jl:256-261)
        k_s = bo[:, lay.k:lay.k + m]                              # (T, m, B)
        g_it = torch.mean(torch.amax(
            torch.abs(k_s) / (torch.abs(u_cur) + 1.0), dim=1), dim=0)
        grad_conv = (g_it < cfg.tol_grad) & (lam_r < 1e-5) & ~bp_bad

        # == fused line search (src/iLQG.jl:264-283); rejected lanes retrace
        #    their stream with α=0
        allow = ~bp_bad & ~grad_conv & active
        sel = torch.stack([dV1, dV2, cost_tot, allow.to(f32)])
        fb = linesearch_lanes(traj, bo, x0_l, sel, model=model,
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

        if record_trace:
            ti = min(it, cap - 1)
            for name, val in (("cost", fb.ls[4]), ("lam", lam_n),
                              ("dlam", dlam_n), ("grad_norm", g_it),
                              ("improvement", dcost_sel),
                              ("reduce_ratio", fb.ls[3]),
                              ("alpha", torch.where(accept, al_sel,
                                                    float("nan"))),
                              ("accepted", accept.to(f32)),
                              ("divergence", res.stats[3])):
                tr[name][ti] = val

        # the backward replay after the loop needs the inputs of the last
        # backward pass each lane ran: this iteration's entry stream and λ
        traj_bwd, lam_used = traj, lam_r
        traj, cost_tot = fb.traj, fb.ls[4]
        lam = torch.where(active, lam_n, lam)
        dlam = torch.where(active, dlam_n, dlam)
        it_lane = torch.where(active, it, it_lane).to(torch.int32)
        g_norm = torch.where(active, g_it, g_norm)
        it += 1

    reason = torch.where((reason == 0) & (accepted > cfg.max_iter), 4,
                         reason).to(torch.int32)

    # ---- replay the final backward outputs in full emission, once
    bo_full = run_bwd(traj_bwd, lam_used, emit="full").out
    # reason-5 lanes: zero-gain, unit-Σ policy and zero value expansion
    # (GaussianPolicy.zeros, src/iLQG.jl:205-210), and the frozen initial
    # rollout
    bad5 = ~any0
    eye_slots = torch.zeros((lay.S, 1), dtype=f32, device=dev)
    for i in range(m):
        eye_slots[lay.quu + i * m + i] = 1.0
        eye_slots[lay.quui + i * m + i] = 1.0
    bo_full = torch.where(bad5, eye_slots, bo_full)
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


def ilqg_iteration_lanes(*args, **kwargs):
    """The MPC per-step hot path of the JAX package; a later slice."""
    raise NotImplementedError("ilqg_iteration_lanes is not ported yet")


def mpc_rollout_lanes(*args, **kwargs):
    """On-device receding-horizon MPC rollout of the JAX package; a later
    slice."""
    raise NotImplementedError("mpc_rollout_lanes is not ported yet")
