"""Fleet scheduler: straggler-compacting batched solves.

Counterpart of ``differentialdynamicprogramming_jl_tpu/solvers/fleet.py``.
The lock-step solvers (:func:`~.batch.ilqg_batch_lanes`,
:func:`~.batch_kl.ilqgkl_batch_lanes`) launch every kernel over the whole
fleet until its slowest scenario exits. The scheduler solves in bounded
chunks instead: after each chunk the scenarios still running are compacted
into a smaller batch and continued alone through the solvers' resume
entries, so that each scenario's solve is the one uninterrupted lock-step
solve would give it.

On the card every kernel gives a block 32 scenarios and one thread walks a
scenario's whole horizon, so a launch over B ≲ 132 SMs × 32 × the blocks an
SM holds takes about as long as one over a compacted batch: compaction pays
only where the fleet fills the card several times (``PERF.md`` §6-7 has
the measurement). Use lock-step by default.

What the scheduler keeps from the JAX module, and what it changes:

- trajectory-sized state (x, u, Vx, Vxx, the running costs and the policy)
  stays on the device between chunks: a chunk gathers its rows with
  ``index_select`` and scatters its results with ``index_copy_``. The (B,)
  fields cross to the host as one stacked tensor, in one transfer a chunk.
- a compacted batch of k scenarios is padded to a multiple of
  :data:`LANE_PAD` by repeating its first index, as JAX pads to its TPU
  tile; the pad lanes re-solve that scenario and are never scattered back.
  :data:`LANE_PAD` is 32, a kernel block's scenarios (``plan.RING_W``).
  Against batches of exactly k (``tools_torch/fleet_ab.py``, on an H100)
  padding was within the noise at B=4096 and took 0.85× the time at
  B=65536, whose 32453-lane chunk exact compaction hands to the kernels
  with B % 4 != 0, off the ring's 16-byte ``cp.async`` path
  (``PERF.md`` §6).
- a resumed chunk takes the total cost the previous chunk carried
  (``cost_total0``) instead of summing the running costs anew, and no
  chunk runs a scenario past the lock-step solver's iteration cap: the
  results equal lock-step's bit for bit on the card, where JAX's fleet
  agrees with its lock-step to rtol 2e-4 (``tests/test_fleet.py:34``).
- where a chunk ends on a scenario's last iteration while the fleet goes
  on, the lock-step solver would have replayed that scenario's final
  backward pass on its accepted trajectory and λ (a lane that is done is
  still computed each iteration): a zero-step resume of those scenarios
  makes that replay, so that the policy and value expansion agree too.

The sharded entries run this scheduler on each shard of a
:class:`~..parallel.mesh.Mesh`, one shard after the other: scenario solves
are independent, so each shard's chunk loop runs on its own, without the
per-chunk collective by which JAX's SPMD program agrees on a compacted
size (``fleet.py:276-283``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor
from ..ops.hopper.plan import RING_W
from ..policy import GaussianPolicy
from .batch import BatchILQGResult, BatchTrace, ilqg_batch_lanes, split_lims
from .batch_kl import BatchKLResult, ilqgkl_batch_lanes
from .ilqg import ILQGConfig
from .ilqgkl import ILQGKLConfig
from ..utils.aot import recorded

# compacted batches are padded to a multiple of this many scenarios
LANE_PAD = RING_W

_BIG = ("x", "u", "Vx", "Vxx", "cost")
_POL = ("K", "k", "sigma", "sigma_inv")
_SMALL = ("cost_total", "n_iters", "n_accepted", "reason", "lam", "dlam",
          "g_norm")
_KLBIG = ("x", "u", "cost", "bracket", "delta", "adam")
_KLSMALL = ("cost_total", "eta", "divergence", "satisfied", "kl_violated",
            "n_iters", "pd_failed", "done")


def _stitch_traces(trace_np, sub_trace, idx, prior_iters, sub_iters, cap,
                   fields):
    """Splice a resumed chunk's per-scenario trace rows into the global
    record at each scenario's iteration offset (JAX ``fleet.py:73-92``).

    ``sub_trace``: (n_fields, kp, cap); rows ``idx`` (k ≤ kp real rows)
    land at columns ``prior+1 .. prior+sub_iters`` (clipped to cap-1)."""
    k = len(idx)
    prior = prior_iters.astype(np.int64)                      # (k,)
    t = np.minimum(sub_iters.astype(np.int64), cap - 1 - prior)
    cols = np.arange(cap)[None, :]                            # (1, cap)
    src = cols - prior[:, None]                               # (k, cap)
    sel = (src >= 1) & (src <= t[:, None])
    src_c = np.clip(src, 0, cap - 1)
    rows = np.arange(k)[:, None]
    for fi, f in enumerate(fields):
        cur = trace_np[f][idx]                                # (k, cap)
        moved = sub_trace[fi, :k][rows, src_c]                # (k, cap)
        trace_np[f][idx] = np.where(sel, moved, cur)


def _compacted(idx: np.ndarray, dev) -> torch.Tensor:
    """The rows of a compacted batch: ``idx`` padded to a multiple of
    :data:`LANE_PAD` by repeating its first entry."""
    kp = -(-len(idx) // LANE_PAD) * LANE_PAD
    return torch.as_tensor(np.concatenate([idx, np.repeat(idx[:1],
                                                          kp - len(idx))]),
                           device=dev)


def _fetch(t: torch.Tensor) -> np.ndarray:
    """One transfer to the host, into memory of its own (on the CPU,
    ``.numpy()`` would alias the tensor the scheduler goes on scattering
    into)."""
    return t.to("cpu", copy=True).numpy()


def _stack(res, fields) -> torch.Tensor:
    """A result's (B,) fields as one (F, B) f32 tensor (exact: the integer
    fields stay below 2^24)."""
    return torch.stack([getattr(res, f).to(torch.float32) for f in fields])


def _scatter(dst: dict, src, fields, rows, k: int) -> None:
    """``dst[f][rows[:k]] = src.f[:k]`` for each field, in place."""
    for f in fields:
        dst[f].index_copy_(0, rows[:k], getattr(src, f)[:k])


def _sel(a, rows):
    return None if a is None else a.index_select(0, rows)


@recorded
def ilqg_fleet(model,
               packed_derivs: Optional[Callable],
               x0s, u0s,
               lims: Optional[Tuple[Tuple[float, float], ...]] = None,
               cfg: ILQGConfig = ILQGConfig(),
               derivs_tiles: Optional[Callable] = None,
               params=None,
               chunk_iters: int = 16,
               chunk_growth: float = 8.0,
               max_chunks: int = 32,
               kt_backward: int = 25,
               kt_forward: int = 10,
               record_trace: bool = False,
               interpret: bool = False,
               verbose: bool = False) -> BatchILQGResult:
    """Solve B scenarios to the termination criteria of
    :func:`~.batch.ilqg_batch_lanes`, without straggler lock-step: after
    ``chunk_iters`` iterations the scenarios still running are compacted
    and continued alone, each further chunk ``chunk_growth`` times longer
    than the last (a chunk's loop ends early once its lanes are done, while
    every chunk costs a host round trip), for at most ``max_chunks``.

    Arguments are :func:`~.batch.ilqg_batch_lanes`'s. ``lims`` may be
    static ``((lo, hi),) * m`` or per scenario (B, m, 2), gathered through
    the compaction like ``params``; ``packed_derivs`` runs once more at
    each chunk's start. Returns a batch-major :class:`BatchILQGResult`;
    ``n_iters`` is the total across chunks, which equals the lock-step
    count. With ``record_trace=True`` each resumed chunk's rows are
    stitched in at the scenario's global iteration offset, so the record
    reads as lock-step's (one (kp, cap) transfer a chunk). ``verbose``
    prints a line a chunk.

    ``kt_backward``, ``kt_forward`` and ``interpret`` are the TPU kernels'
    switches, taken and without effect. Single device: the shards of a
    mesh run :func:`ilqg_fleet_sharded`.
    """
    u0s = as_tensor(u0s)
    dev = u0s.device
    B = u0s.shape[0]
    lims_s, lims_b = split_lims(lims)
    params = None if params is None else as_tensor(params)
    cap = cfg.cap()
    ci = {f: i for i, f in enumerate(_SMALL)}

    def run(x0s_, u0s_, params_, lims_b_, steps, **kw):
        return ilqg_batch_lanes(
            model, packed_derivs, x0s_, u0s_,
            lims=lims_s if lims_b_ is None else lims_b_, cfg=cfg,
            derivs_tiles=derivs_tiles, params=params_, max_steps=steps,
            record_trace=record_trace, **kw)

    def resume(rows, steps):
        return run(_sel(big["x"], rows), _sel(big["u"], rows),
                   _sel(params, rows), _sel(lims_b, rows), steps,
                   cost0=_sel(big["cost"], rows),
                   cost_total0=small[ci["cost_total"]].index_select(0, rows),
                   lam0=small[ci["lam"]].index_select(0, rows),
                   dlam0=small[ci["dlam"]].index_select(0, rows),
                   accepted0=small[ci["n_accepted"]].index_select(
                       0, rows).to(torch.int32))

    # ---- chunk 1: the whole fleet, cold start
    steps_done = steps = min(chunk_iters, cap - 1)
    res = run(x0s, u0s, params, lims_b, steps)
    big = {f: getattr(res, f) for f in _BIG}
    pol = {f: getattr(res.policy, f) for f in _POL}
    small = _stack(res, _SMALL)
    host = _fetch(small)                             # one transfer
    if record_trace:
        trace_np = {f: _fetch(getattr(res.trace, f))
                    for f in BatchTrace._fields}

    for chunk in range(1, max_chunks):
        unfinished = host[ci["reason"]] == 0
        n_left = int(unfinished.sum())
        if verbose:
            print(f"  fleet chunk {chunk}: {n_left}/{B} scenarios "
                  f"still running")
        if n_left == 0 or steps_done >= cap - 1:
            break
        # lock-step goes on: its later iterations replay the backward pass
        # of lanes done on the last step on their accepted trajectory (every
        # lane still running has run all steps_done iterations)
        ended = np.flatnonzero(~unfinished
                               & (host[ci["n_iters"]] == steps_done))
        if len(ended):
            rows = _compacted(ended, dev)
            fix = resume(rows, 0)
            _scatter(big, fix, ("Vx", "Vxx"), rows, len(ended))
            _scatter(pol, fix.policy, ("K", "sigma", "sigma_inv"), rows,
                     len(ended))
        steps = int(round(steps * chunk_growth))
        ms = min(steps, cap - 1 - steps_done)
        idx = np.flatnonzero(unfinished)
        k = len(idx)
        rows = _compacted(idx, dev)
        sub = resume(rows, ms)
        _scatter(big, sub, _BIG, rows, k)
        _scatter(pol, sub.policy, _POL, rows, k)
        sub_small = _stack(sub, _SMALL)[:, :k]
        sub_small[ci["n_iters"]] += small[ci["n_iters"]].index_select(
            0, rows[:k])
        small.index_copy_(1, rows[:k], sub_small)
        prior = host[ci["n_iters"]][idx]
        host = _fetch(small)                         # one transfer
        if record_trace:
            sub_tr = _fetch(torch.stack([getattr(sub.trace, f)
                                         for f in BatchTrace._fields]))
            _stitch_traces(trace_np, sub_tr, idx, prior,
                           host[ci["n_iters"]][idx] - prior, cap,
                           BatchTrace._fields)
        steps_done += ms

    out = {f: small[i] for i, f in enumerate(_SMALL)}
    for f in ("n_iters", "n_accepted", "reason"):
        out[f] = out[f].to(torch.int32)
    return BatchILQGResult(
        policy=GaussianPolicy(**pol), **big, **out,
        trace=(BatchTrace(**{f: torch.as_tensor(v, device=dev)
                             for f, v in trace_np.items()})
               if record_trace else None))


@recorded
def ilqgkl_fleet(model, derivs_tiles, x0s, traj_prev, fx_model, cost0,
                 lims=None, cfg=None, r1=None, kt: int = 16,
                 chunk_iters: int = 4,
                 chunk_growth: float = 4.0,
                 max_chunks: int = 32,
                 interpret: bool = False,
                 verbose: bool = False) -> BatchKLResult:
    """Solve B KL-constrained scenarios (``iLQGkl``, ``src/iLQGkl.jl:25-252``)
    to the termination criteria of :func:`~.batch_kl.ilqgkl_batch_lanes`,
    straggler-compacted through its resume entry (``bracket0``,
    ``delta0_in``, ``adam0_in``, ``it0``, ``max_steps``). The solver's
    inputs do not change during a solve (``src/iLQGkl.jl:88``): each chunk
    gathers ``x0s``, ``traj_prev``, ``fx_model``, ``cost0`` and per-scenario
    ``lims`` from the caller's tensors. ``n_iters`` is global (the solver
    counts on from ``it0``), so each chunk overwrites it.

    Arguments mirror :func:`~.batch_kl.ilqgkl_batch_lanes` (no trace); the
    TPU switches ``kt`` and ``interpret`` have no effect. The JAX module's
    measured advice holds in kind: the η search gives the fleet little
    iteration spread, so lock-step is the default.
    """
    if cfg is None:
        cfg = ILQGKLConfig()
    x0s = as_tensor(x0s)
    dev = x0s.device
    B = x0s.shape[0]
    traj_prev = GaussianPolicy(*map(as_tensor, traj_prev))
    fx_model = as_tensor(fx_model)
    cost0 = as_tensor(cost0)
    lims_s, lims_b = split_lims(lims)
    per_step = bool(cfg.constrain_per_step)
    ci = {f: i for i, f in enumerate(_KLSMALL)}

    def resume(rows, it0, steps):
        return ilqgkl_batch_lanes(
            model, derivs_tiles, _sel(x0s, rows),
            GaussianPolicy(*(_sel(a, rows) for a in traj_prev)),
            _sel(fx_model, rows), _sel(cost0, rows),
            lims=lims_s if lims_b is None else _sel(lims_b, rows), cfg=cfg,
            r1=r1, bracket0=_sel(big["bracket"], rows),
            delta0_in=_sel(big["delta"], rows),
            adam0_in=_sel(big["adam"], rows) if per_step else None,
            it0=it0, max_steps=steps)

    res = ilqgkl_batch_lanes(model, derivs_tiles, x0s, traj_prev, fx_model,
                             cost0, lims=lims, cfg=cfg, r1=r1, it0=0,
                             max_steps=chunk_iters)
    big = {f: getattr(res, f) for f in _KLBIG}
    pol = {f: getattr(res.policy, f) for f in _POL}
    small = _stack(res, _KLSMALL)
    host = _fetch(small)                             # one transfer

    steps_done = steps = chunk_iters
    for chunk in range(1, max_chunks):
        unfinished = host[ci["done"]] < 0.5
        n_left = int(unfinished.sum())
        if verbose:
            print(f"  kl-fleet chunk {chunk}: {n_left}/{B} running "
                  f"({steps_done}/{cfg.max_iter} iters)")
        if n_left == 0 or steps_done >= cfg.max_iter:
            break
        # lock-step goes on: its later iterations replay the backward pass
        # of lanes done on the last step at their updated η
        ended = np.flatnonzero(~unfinished
                               & (host[ci["n_iters"]] == steps_done))
        if len(ended):
            rows = _compacted(ended, dev)
            fix = resume(rows, steps_done, 0)
            _scatter(pol, fix.policy, ("K", "sigma", "sigma_inv"), rows,
                     len(ended))
        steps = int(round(steps * chunk_growth))
        idx = np.flatnonzero(unfinished)
        k = len(idx)
        rows = _compacted(idx, dev)
        sub = resume(rows, steps_done, steps)
        _scatter(big, sub, _KLBIG, rows, k)
        _scatter(pol, sub.policy, _POL, rows, k)
        small.index_copy_(1, rows[:k], _stack(sub, _KLSMALL)[:, :k])
        host = _fetch(small)                         # one transfer
        steps_done = min(steps_done + steps, cfg.max_iter)

    out = {f: small[i] for i, f in enumerate(_KLSMALL)}
    for f in ("satisfied", "kl_violated", "pd_failed", "done"):
        out[f] = out[f] > 0.5
    out["n_iters"] = out["n_iters"].to(torch.int32)
    return BatchKLResult(policy=GaussianPolicy(**pol), **big, **out,
                         trace=None)


def ilqg_fleet_sharded(model,
                       packed_derivs: Optional[Callable],
                       x0s, u0s,
                       lims: Optional[Tuple[Tuple[float, float], ...]] = None,
                       cfg: ILQGConfig = ILQGConfig(),
                       derivs_tiles: Optional[Callable] = None,
                       params=None,
                       chunk_iters: int = 16,
                       chunk_growth: float = 8.0,
                       max_chunks: int = 32,
                       kt_backward: int = 25,
                       kt_forward: int = 10,
                       record_trace: bool = False,
                       interpret: bool = False,
                       verbose: bool = False,
                       mesh=None,
                       axis: str = "b") -> BatchILQGResult:
    """:func:`ilqg_fleet` on each shard of ``mesh``
    (:func:`~..parallel.mesh.make_mesh` by default): this process's rows
    (``x0s``, ``u0s``, ``params`` and per-scenario ``lims``; tensors, numpy
    rows or :func:`~..parallel.distributed.distribute_batch`'s shards)
    split evenly over its devices, each shard's fleet run on its own
    device, and this process's rows returned batch-major on the mesh's
    first device, with the stitched trace where asked.

    Each shard schedules its own chunks and no collective runs: JAX's one
    max collective a chunk (``fleet.py:276-283``) only keeps its SPMD
    processes dispatching one program, and its masked scatter already makes
    each shard's results those of an independent per-shard fleet.
    """
    from ..parallel.mesh import _sharded, make_mesh
    if mesh is None:
        mesh = make_mesh(axis=axis)
    lims_s, lims_b = split_lims(lims)

    def solve(x0s, u0s, params, lims):
        return ilqg_fleet(
            model, packed_derivs, x0s, u0s,
            lims=lims_s if lims is None else lims, cfg=cfg,
            derivs_tiles=derivs_tiles, params=params,
            chunk_iters=chunk_iters, chunk_growth=chunk_growth,
            max_chunks=max_chunks, record_trace=record_trace,
            verbose=verbose)

    return _sharded(mesh, dict(x0s=x0s, u0s=u0s, params=params, lims=lims_b),
                    solve)


def ilqgkl_fleet_sharded(model, derivs_tiles, x0s, traj_prev, fx_model,
                         cost0, lims=None, cfg=None, r1=None, kt: int = 16,
                         chunk_iters: int = 4,
                         chunk_growth: float = 4.0,
                         max_chunks: int = 32,
                         interpret: bool = False,
                         verbose: bool = False,
                         mesh=None,
                         axis: str = "b") -> BatchKLResult:
    """:func:`ilqgkl_fleet` on each shard of ``mesh``, as
    :func:`ilqg_fleet_sharded` runs :func:`ilqg_fleet`: this process's rows
    of ``x0s``, ``traj_prev``, ``fx_model``, ``cost0`` and per-scenario
    ``lims`` in, this process's rows out, each shard's chunks scheduled on
    its own without a collective."""
    from ..parallel.mesh import _sharded, make_mesh
    if mesh is None:
        mesh = make_mesh(axis=axis)
    lims_s, lims_b = split_lims(lims)

    def solve(x0s, traj_prev, fx_model, cost0, lims):
        return ilqgkl_fleet(
            model, derivs_tiles, x0s, traj_prev, fx_model, cost0,
            lims=lims_s if lims is None else lims, cfg=cfg, r1=r1,
            chunk_iters=chunk_iters, chunk_growth=chunk_growth,
            max_chunks=max_chunks, verbose=verbose)

    return _sharded(mesh, dict(x0s=x0s, traj_prev=traj_prev,
                               fx_model=fx_model, cost0=cost0, lims=lims_b),
                    solve)
