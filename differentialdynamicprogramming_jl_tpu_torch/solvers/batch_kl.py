"""Fleet iLQGkl (GPS trust-region) solver on streams.

Counterpart of ``differentialdynamicprogramming_jl_tpu/solvers/batch_kl.py``
(reference ``iLQGkl``, ``src/iLQGkl.jl:25-252``, with the scalar-η
bracketing dual update ``calc_η``, ``src/klutils.jl:110-130``, or the
per-step ADAM variant, ``src/iLQGkl.jl:185-236``), for B scenarios at once:

- the backward kernel K1 in GPS mode (η-scaled Q terms plus the KL
  expansion of the previous policy) with ``"policy"`` emission, relaunched
  for the η-inflation retry;
- the α=1 re-roll (``src/iLQGkl.jl:134``) by the forward kernel K3, always
  from the fixed pre-rolled centre;
- Σxx propagation by the covariance kernel K4, once per solve;
- the closed-form policy KL (``kl_div_wiki``, ``src/klutils.jl:70-100``), the
  η update and the ADAM step as plain torch ops on (T, B) and (B,) tensors.

The JAX solver is one ``lax.while_loop``; this one is a host loop whose
retry condition and ``done.all()`` each synchronise with the host once per
check. Whether kernels or their plain versions run is decided by the device
of the inputs: CPU tensors run the plain versions, CUDA tensors the kernels;
inputs that are not tensors go to the card (:mod:`..device`).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..device import as_tensor
from ..policy import GaussianPolicy
from ..ops.hopper.pack import from_streams, mean_t, to_streams
from ..ops.hopper.backward_kernel import (OutLayout, _sum, _tiny_chol,
                                          backward_lanes)
from ..ops.hopper.covariance_kernel import covariance_lanes, identity_r1
from ..ops.hopper.forward_kernel import LanesModel, check_lims, forward_lanes
from ..utils import printing as _pr
from .batch import active_means, pack_lims, split_lims
from .ilqgkl import ILQGKLConfig
from ..utils.aot import recorded


def _logdet_tiles(S, m):
    """log det of an m×m slot stream (T, m², B), closed form for m ≤ 2 and
    by the Cholesky diagonal above. Returns ``(logdet, ok)``: ``ok`` flags a
    positive-definite entry. Julia's ``logdet`` throws on an indefinite
    matrix (``src/klutils.jl:84``); here the clamp keeps the arithmetic
    finite and ``ok`` carries the failure to the caller."""
    if m == 1:
        return torch.log(torch.clamp_min(S[:, 0], 1e-30)), S[:, 0] > 0
    if m == 2:
        det = S[:, 0] * S[:, 3] - S[:, 1] * S[:, 2]
        ok = (S[:, 0] > 0) & (det > 0)        # leading principal minors
        return torch.log(torch.clamp_min(det, 1e-30)), ok
    # m > 2: the unrolled Cholesky's diagonal, summed as JAX does (from 0)
    M = [[S[:, i * m + j] for j in range(m)] for i in range(m)]
    L, ok = _tiny_chol(M, m)
    return 2.0 * sum(torch.log(torch.clamp_min(L[j][j], 1e-30))
                     for j in range(m)), ok


def _seq(P: torch.Tensor) -> torch.Tensor:
    """Σ over the two axes after the first of P (…, T, a, b, B) in the
    order of Python's nested generator (a outer, b inner), left to right
    from the first term: each element summed as :func:`_sum` sums the
    list of its terms, the terms of every element added at once."""
    Q = P.reshape(P.shape[:-3] + (-1, P.shape[-1]))
    s = Q[..., 0, :]
    for q in range(1, Q.shape[-2]):
        s = s + Q[..., q, :]
    return s


def kl_div_wiki_lanes(mu, sxx, k_n, K_n, S_n, k_p, K_p, Si_p, n: int,
                      m: int):
    """Per-step policy KL on streams (``kl_div_wiki``,
    ``src/klutils.jl:70-100``). ``mu = x_new - x_old`` (T, n, B); ``sxx``
    (T, n², B); policies as slot streams; ``Si_p`` is the previous Σ⁻¹, so
    ``logdet Σp = -logdet Σp⁻¹``. Returns ``(kl, pd_ok)``, each (T, B);
    ``pd_ok`` flags both covariances positive definite. The clamp at 0 keeps
    NaN, as ``jnp.maximum`` does. Each sum runs in the JAX order from its
    first term; the elements of a product are formed together, and sums of
    equal length over the same lanes are taken together (:func:`_seq`),
    so that an evaluation at ⟨54,21⟩ launches ≈4.5k device operations
    rather than ≈194k."""
    T, B = mu.shape[0], mu.shape[-1]
    kd = k_p - k_n                                        # (T, m, B)
    Kd = (K_p - K_n).reshape(T, m, n, B)
    Sip = Si_p.reshape(T, m, m, B)
    Sn = S_n.reshape(T, m, m, B)

    tr_term, kk = _seq(torch.stack([
        Sip * Sn.transpose(1, 2),
        kd[:, :, None] * Sip * kd[:, None, :]]))
    ld_p, ok_p = _logdet_tiles(Si_p, m)
    ld_n, ok_n = _logdet_tiles(S_n, m)
    ld = -ld_p - ld_n
    kl = 0.5 * (tr_term + kk - float(m) + ld)

    SipKd = _sum(Sip[:, :, a, None] * Kd[:, a, None, :] for a in range(m))
    KdSipKd = _sum(Kd[:, a, :, None] * SipKd[:, a, None, :]
                   for a in range(m))
    mu_term, sxx_term = _seq(torch.stack([
        mu[:, :, None] * KdSipKd * mu[:, None, :],
        KdSipKd * sxx.reshape(T, n, n, B).transpose(1, 2)]))
    kl = kl + 0.5 * (mu_term + sxx_term)
    kl = kl + _seq(kd[:, :, None] * SipKd * mu[:, None, :])
    return torch.clamp_min(kl, 0.0), ok_p & ok_n


def calc_eta_lanes(divergence, bracket, kl_step):
    """Per-scenario dual bracket update (``calc_η``,
    ``src/klutils.jl:110-130``). ``divergence``: (B,) measured KL;
    ``bracket``: (3, B) [lo, mid, hi]; ``kl_step``: f32 scalar tensor.
    Returns (new bracket (3, B), satisfied (B,))."""
    violation = divergence - kl_step
    satisfied = torch.abs(violation) < 0.1 * kl_step
    too_big = violation < 0
    lo, mid, hi = bracket[0], bracket[1], bracket[2]
    hi_b = mid
    mid_b = torch.maximum(torch.sqrt(lo * hi_b), 0.1 * hi_b)
    lo_s = mid
    mid_s = torch.minimum(torch.sqrt(lo_s * hi), 10.0 * lo_s)
    new_lo = torch.where(too_big, lo, lo_s)
    new_mid = torch.where(too_big, mid_b, mid_s)
    new_hi = torch.where(too_big, hi_b, hi)
    keep = satisfied
    return (torch.stack([torch.where(keep, lo, new_lo),
                         torch.where(keep, mid, new_mid),
                         torch.where(keep, hi, new_hi)]), satisfied)


class BatchKLTrace(NamedTuple):
    """Per-iteration fleet record, batch-major (B, max_iter+1) (reference
    trace keys, ``src/iLQGkl.jl:161-166``)."""

    cost: torch.Tensor
    improvement: torch.Tensor
    reduce_ratio: torch.Tensor  # Δcost / -(dV₁+dV₂) (src/iLQGkl.jl:140,164)
    divergence: torch.Tensor
    eta: torch.Tensor


class BatchKLResult(NamedTuple):
    """Batch-major iLQGkl results."""

    x: torch.Tensor
    u: torch.Tensor
    policy: GaussianPolicy
    cost: torch.Tensor          # (B, T) running costs of the final rollout
    cost_total: torch.Tensor    # (B,)
    eta: torch.Tensor           # (B,)
    divergence: torch.Tensor    # (B,) mean KL
    satisfied: torch.Tensor     # (B,) bool
    kl_violated: torch.Tensor   # (B,) final warning (src/iLQGkl.jl:248)
    n_iters: torch.Tensor       # (B,)
    pd_failed: Optional[torch.Tensor] = None  # (B,) a Σ went indefinite in
    #                                           the KL measurement; aborted
    bracket: Optional[torch.Tensor] = None    # (B, 3) / (B, 3, T) per-step
    delta: Optional[torch.Tensor] = None      # (B,) / (B, T)
    adam: Optional[torch.Tensor] = None       # (B, 2, T) per-step; zeros
    done: Optional[torch.Tensor] = None       # (B,) lane terminated
    trace: Optional[BatchKLTrace] = None      # with record_trace=True


@recorded
def ilqgkl_batch_lanes(model: LanesModel, derivs_tiles: Callable, x0s,
                       traj_prev: GaussianPolicy, fx_model, cost0,
                       lims: Optional[Tuple] = None,
                       cfg: ILQGKLConfig = ILQGKLConfig(),
                       r1: Optional[Tuple] = None, kt: int = 16,
                       record_trace: bool = False, interpret: bool = False,
                       *, bracket0=None, delta0_in=None, adam0_in=None,
                       it0=None, max_steps=None) -> BatchKLResult:
    """KL-constrained solve for B scenarios. ``cfg.constrain_per_step``
    selects the per-step η variant (ADAM on log η); otherwise the scalar-η
    bracketing branch (``src/iLQGkl.jl:93-181``).

    - ``x0s``: pre-rolled trajectories (B, T, n), mandatory as in the
      reference (``src/iLQGkl.jl:65-72``); nominal controls = ``traj_prev.k``.
    - ``traj_prev``: previous policy, leaves (B, T, ...).
    - ``fx_model``: model linearisations (B, T, n, n) for the covariance
      propagation (for an LTI model, ``SimpleLTVModel.from_lti(A, B, T).fx``
      expanded to B); ``r1``: static (n, n) tuple (default identity).
    - ``cost0``: (B,) total cost of the pre-rolled trajectory.
    - ``lims``: static ``((lo, hi),) * m``, a per-scenario (B, m, 2) array
      (K1 in GPS mode and K3 read each lane's box), or None.
    - ``record_trace``: also return the (B, max_iter+1) :class:`BatchKLTrace`.
    - ``cfg.verbosity > 1``: a fleet-aggregate row an iteration
      (:func:`~..utils.printing.kl_lanes_row`; a host sync each).

    Resume entry (the KL fleet scheduler, :mod:`.fleet`; JAX
    ``_ilqgkl_batch_lanes_jit``, ``solvers/batch_kl.py:223-241``):
    ``bracket0`` (B, 3), or (B, 3, T) per step, ``delta0_in`` (B,) and
    ``adam0_in`` (B, 2, T) restore the η optimiser's state from a prior
    :class:`BatchKLResult` (per step, ``delta0_in`` is ignored: the
    increments reset each outer iteration, ``src/iLQGkl.jl:189``); ``it0``
    is the global iteration count already run, which the per-step ADAM's
    bias correction and the returned ``n_iters`` continue from; the loop
    runs while ``it <= min(it0 + max_steps, cfg.max_iter)``. A solve cut
    into such calls gives the lanes' results of one uninterrupted solve.

    The JAX signature's TPU switches ``kt`` (time steps a grid step) and
    ``interpret`` (Pallas interpret mode) are taken and have no effect:
    each kernel thread walks the whole horizon, and a CPU tensor runs the
    plain versions.
    """
    lims, lims_batch = split_lims(lims)
    check_lims(model.m, lims)
    x0s = as_tensor(x0s)
    traj_prev = GaussianPolicy(*map(as_tensor, traj_prev))
    dev = x0s.device
    f32 = torch.float32
    n, m = model.n, model.m
    B, T = x0s.shape[0], x0s.shape[1]
    # "policy" emission: the loop consumes k/K (forward pass) and Quu/Quu⁻¹
    # (measured KL, returned policy), never Vx/Vxx
    lay = OutLayout(n, m, emit="policy")
    r1 = identity_r1(n) if r1 is None else r1
    if lims_batch is not None and lims_batch.device != dev:
        raise ValueError(f"lims on {lims_batch.device}, x0s on {dev}")
    lims_l = pack_lims(lims_batch) if lims_batch is not None else None

    u0 = traj_prev.k.to(f32)                              # src/iLQGkl.jl:47
    traj = to_streams(torch.cat(
        [x0s.to(f32), u0, torch.zeros((B, T, 1), dtype=f32, device=dev)],
        dim=-1))                                          # cost slot unused
    x0_l = traj[0, :n].contiguous()
    # previous-policy stream with k zeroed for the KL bookkeeping
    # (src/iLQGkl.jl:51-52)
    prev = to_streams(torch.cat(
        [torch.zeros((B, T, m), dtype=f32, device=dev),
         traj_prev.K.to(f32).reshape(B, T, -1),
         traj_prev.sigma_inv.to(f32).reshape(B, T, -1)], dim=-1))
    k_p, K_p, Si_p = prev[:, :m], prev[:, m:m + m * n], prev[:, m + m * n:]
    sxx = covariance_lanes(
        to_streams(as_tensor(fx_model, f32).reshape(B, T, -1)),
        n=n, r1=r1)

    kl_step = torch.tensor(cfg.kl_step, dtype=f32, device=dev)
    per_step = bool(cfg.constrain_per_step)
    shape = (T, B) if per_step else (B,)
    if bracket0 is None:
        br = torch.stack([torch.full(shape, v, dtype=f32, device=dev)
                          for v in cfg.eta_bracket])
    else:               # batch-major (B, 3[, T]) → (3[, T], B)
        br = as_tensor(bracket0, f32).movedim(0, -1).contiguous()
    if delta0_in is None or per_step:
        delta0 = torch.full(shape, cfg.del0, dtype=f32, device=dev)
    else:
        delta0 = as_tensor(delta0_in, f32)
    adam = None
    if per_step:
        adam = (torch.zeros((2, T, B), dtype=f32, device=dev)
                if adam0_in is None
                else as_tensor(adam0_in, f32).movedim(0, -1).contiguous())
    tot0 = as_tensor(cost0, f32)
    one = torch.ones((1, B), dtype=f32, device=dev)
    lam0 = torch.zeros((B,), dtype=f32, device=dev)

    def run_bwd(eta_mid):
        eta_s = eta_mid if per_step else eta_mid.expand(T, B).contiguous()
        return backward_lanes(traj, lam0, n=n, m=m, reg_type=1, lims=lims,
                              derivs_tiles=derivs_tiles, prev=prev,
                              eta=eta_s, lims_lanes=lims_l, emit="policy")

    cap = cfg.max_iter + 1
    if record_trace:
        tr = {f: torch.zeros((cap, B), dtype=f32, device=dev)
              for f in BatchKLTrace._fields}
        tr["cost"][0] = tot0

    delta = delta0
    traj_new, tot_new = traj, tot0
    eta_used = br[1]
    div_c = torch.zeros((B,), dtype=f32, device=dev)
    sat_c = torch.zeros((B,), dtype=torch.bool, device=dev)
    pd_bad = torch.zeros((B,), dtype=torch.bool, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    it_lane = torch.zeros((B,), dtype=torch.int32, device=dev)
    t_idx = torch.arange(T, device=dev)[:, None]

    it0 = 0 if it0 is None else int(it0)
    it_end = cfg.max_iter if max_steps is None else min(
        it0 + int(max_steps), cfg.max_iter)
    it = it0 + 1
    while it <= it_end and not bool(done.all()):
        active = ~done

        # η-inflation backward retry (src/iLQGkl.jl:97-124 scalar; :190-203
        # per-step: only the diverged step escalates, and the increments
        # reset each outer iteration, :189)
        res = run_bwd(br[1])
        br_r = br
        dl = delta0 if per_step else delta
        ab = torch.zeros((B,), dtype=torch.bool, device=dev)
        k = 0
        while k < cfg.retry_cap and bool(
                (active & (res.stats[2] > 0.5) & ~ab).any()):
            bad = (res.stats[2] > 0.5) & active & ~ab
            if per_step:
                idx = torch.clamp(res.stats[3].to(torch.int32) - 1, 0, T - 1)
                hot = (t_idx == idx[None]) & bad[None]
                mid = torch.where(hot, br_r[1] + dl, br_r[1])
                dl = torch.where(hot, dl * 2.0, dl)
                ab = ab | (bad & (mid > 0.999 * br_r[2]).all(dim=0))
            else:
                mid = torch.where(bad, br_r[1] + dl, br_r[1])
                dl = torch.where(bad, dl * 2.0, dl)
                ab = ab | (bad & (mid > br_r[2]))
            br_r = torch.stack([br_r[0], mid, br_r[2]])
            res = run_bwd(mid)
            k += 1
        bo = res.out

        # full-step forward pass from the fixed centre (α = 1,
        # src/iLQGkl.jl:134)
        fb = forward_lanes(traj, bo, x0_l, one, None, lims_l, model=model,
                           lims=lims, gk=lay.k, gK=lay.K, emit_traj=True)

        # measured KL (src/iLQGkl.jl:143) of the new policy
        div_t, pdok_t = kl_div_wiki_lanes(
            fb.traj[:, :n] - traj[:, :n], sxx, bo[:, lay.k:lay.k + m],
            bo[:, lay.K:lay.K + m * n], bo[:, lay.quui:lay.quui + m * m],
            k_p, K_p, Si_p, n, m)
        div = mean_t(div_t)
        # an indefinite Σ anywhere along the horizon is the reference's
        # logdet DomainError (src/klutils.jl:84): the lane aborts
        pd_bad_now = active & ~pdok_t.all(dim=0)
        # Δcost against the FIXED pre-rolled cost (src/iLQGkl.jl:137-140)
        dcost = tot0 - fb.totals[0]
        expected = -(res.stats[0] + res.stats[1])
        ratio = torch.where(expected != 0, dcost / expected, 0.0)

        if per_step:
            # ADAM on log η against the per-step constraint violation
            # (src/iLQGkl.jl:211-218, klutils.jl:203-210)
            violation = div_t - kl_step
            b1, b2, eps = 0.9, 0.999, 1e-8
            g = -violation
            m_a = b1 * adam[0] + (1 - b1) * g
            v_a = b2 * adam[1] + (1 - b2) * g * g
            # bias correction at the global iteration count, in f32
            t_f = torch.tensor(float(it), dtype=f32, device=dev)
            m_hat = m_a / (1 - torch.pow(torch.tensor(b1, dtype=f32,
                                                      device=dev), t_f))
            v_hat = v_a / (1 - torch.pow(torch.tensor(b2, dtype=f32,
                                                      device=dev), t_f))
            log_eta = (torch.log(torch.clamp_min(br_r[1], 1e-30))
                       - cfg.gd_alpha * m_hat / (torch.sqrt(v_hat) + eps))
            eta_new = torch.minimum(torch.maximum(torch.exp(log_eta),
                                                  br_r[0]), br_r[2])
            br_n = torch.stack([br_r[0], eta_new, br_r[2]])
            adam_n = torch.stack([m_a, v_a])
            satisfied = ((div_t < 2.0 * kl_step).all(dim=0)
                         & (mean_t(violation) < 0.1 * float(cfg.kl_step)))
            eta_maxed = (br_n[1] > 0.999 * br_n[2]).all(dim=0)
        else:
            br_n, satisfied = calc_eta_lanes(div, br_r, kl_step)
            eta_maxed = br_n[1] > 0.999 * br_n[2]        # src/iLQGkl.jl:178
        satisfied = satisfied & ~pd_bad_now
        newly_done = active & (satisfied | eta_maxed | ab | pd_bad_now)

        # the centre and done lanes' η bracket are frozen, so the kernels
        # recompute the same fb.traj/bo for done lanes every iteration
        traj_new, tot_new = fb.traj, fb.totals[0]
        eta_mid = mean_t(br_n[1]) if per_step else br_n[1]
        if record_trace:
            ti = min(it, cap - 1)
            for name, val in (("cost", tot_new), ("improvement", dcost),
                              ("reduce_ratio", ratio),
                              ("divergence", torch.where(active, div, div_c)),
                              ("eta", eta_mid)):
                tr[name][ti] = val
        if cfg.verbosity > 1:
            _pr.kl_lanes_row(it, *active_means(
                active, tot_new, eta_mid, div, (satisfied & active).to(f32)),
                cfg.print_head)

        br = torch.where(active, br_n, br)
        delta = torch.where(active, dl, delta)
        # the η the last backward ran with (post-retry midpoint); done lanes'
        # η was never touched by the retry, so this is theirs too
        eta_used = br_r[1]
        div_c = torch.where(active, div, div_c)
        sat_c = torch.where(active, satisfied, sat_c)
        pd_bad = pd_bad | pd_bad_now
        done = done | newly_done
        it_lane = torch.where(active, it, it_lane).to(torch.int32)
        if per_step:
            adam = torch.where(active, adam_n, adam)
        it += 1

    # unconditional acceptance of the last iterate (src/iLQGkl.jl:239-241),
    # and one replay of the last backward from its η for the policy
    u = from_streams(traj_new[:, n:n + m], (m,))
    bo_fin = run_bwd(eta_used).out
    policy = GaussianPolicy(
        K=from_streams(bo_fin[:, lay.K:lay.K + m * n], (m, n)), k=u,
        sigma=from_streams(bo_fin[:, lay.quui:lay.quui + m * m], (m, m)),
        sigma_inv=from_streams(bo_fin[:, lay.quu:lay.quu + m * m], (m, m)))
    kl_violated = (div_c > float(cfg.kl_step)) & (
        torch.abs(div_c - float(cfg.kl_step)) > 0.1 * float(cfg.kl_step))
    if per_step:
        eta_fin = mean_t(br[1])
        bracket_bm = br.permute(2, 0, 1)                   # (B, 3, T)
        delta_bm = delta.T                                 # (B, T)
        adam_bm = adam.permute(2, 0, 1)                    # (B, 2, T)
    else:
        eta_fin = br[1]
        bracket_bm = br.T                                  # (B, 3)
        delta_bm = delta
        adam_bm = torch.zeros((B,), dtype=f32, device=dev)
    return BatchKLResult(
        x=from_streams(traj_new[:, :n], (n,)), u=u, policy=policy,
        cost=from_streams(traj_new[:, n + m:n + m + 1], ()),
        cost_total=tot_new, eta=eta_fin, divergence=div_c,
        satisfied=sat_c, kl_violated=kl_violated, n_iters=it_lane,
        pd_failed=pd_bad, bracket=bracket_bm, delta=delta_bm, adam=adam_bm,
        done=done,
        trace=(BatchKLTrace(**{k: v.T for k, v in tr.items()})
               if record_trace else None))


def gps_rollout_lanes(model, derivs_tiles, x0s, traj0: GaussianPolicy, cost0,
                      fx_fn: Callable, outer_iters: int, lims=None,
                      cfg: ILQGKLConfig = ILQGKLConfig(), r1=None,
                      kt: int = 16, unroll: Optional[int] = None,
                      interpret: bool = False):
    """GPS-style policy improvement: ``outer_iters`` chained
    :func:`ilqgkl_batch_lanes` solves, each re-centred on the previous
    result (``x ← res.x``, ``traj_prev ← res.policy``,
    ``cost ← res.cost_total``), the reference's 5× outer-loop pattern
    (``src/demo_linear.jl:124-130``). The JAX version is one ``lax.scan``;
    this one is a host loop of outer solves.

    ``fx_fn(x (B, T, n), u (B, T, m)) -> fx (B, T, n, n)`` gives the
    covariance-propagation dynamics along the current rollout. The JAX
    signature's compile switches ``kt``, ``unroll`` (of its ``lax.scan``)
    and ``interpret`` are taken and have no effect here.

    Returns ``(x_final (B, T, n), policy_final, per_outer)`` where
    ``per_outer`` is ``(cost_total, eta, divergence, satisfied,
    kl_violated)``, each (outer_iters, B).
    """
    f32 = torch.float32
    x = as_tensor(x0s, f32)
    cost = as_tensor(cost0, f32)
    traj = GaussianPolicy(*(as_tensor(a, f32) for a in traj0))
    rows: List[tuple] = []
    for _ in range(int(outer_iters)):
        res = ilqgkl_batch_lanes(model, derivs_tiles, x, traj,
                                 fx_fn(x, traj.k), cost, lims=lims, cfg=cfg,
                                 r1=r1)
        rows.append((res.cost_total, res.eta, res.divergence, res.satisfied,
                     res.kl_violated))
        x, traj, cost = res.x, res.policy, res.cost_total
    per_outer = tuple(torch.stack(col) for col in zip(*rows))
    return x, traj, per_outer
