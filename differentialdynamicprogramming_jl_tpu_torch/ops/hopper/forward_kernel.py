"""Multi-α forward rollout (K3) and fused line search (K2).

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/pallas/forward_kernel.py``.
Each wrapper takes streams ``(T, S, B)`` (see :mod:`.pack`):

- a CPU tensor goes to the plain PyTorch version (``*_ref``), which is
  vectorised over B and A with a Python loop over t, in the kernel's
  operation order;
- a CUDA tensor goes to the hand-written kernel in ``csrc/forward.cu``, or
  the wrapper raises. There is no fallback. The launch plans of K3 and K2
  (block shape and shared-memory ring) come from :mod:`.plan`.

The kernels read the model from its device descriptor
(:class:`DeviceModel`); a :class:`LanesModel` without one is lowered
(:mod:`.lower`) into a library of its own, and its ``diff``, where set,
replaces x - x_old in the feedback term (JAX ``forward_kernel.py:49-63``,
``:156-159``, ``:450-451``). Both wrappers take per-scenario model
parameters ``params`` (P, B) for
a model with ``n_params == P``, and per-scenario control limits
``lims_lanes`` (2m, B), slot order [lo_0, hi_0, lo_1, hi_1, ...], which
replace the static ``lims``. Each wrapper counts its kernel launches in
``<wrapper>.launches``. K2 takes a ladder of up to ``MAX_A`` (64) α
values, rolled in rounds of eight; K3 any number of candidates, launched
in groups of eight (``plan.k3_groups``), the first of which emits the
stream.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .plan import (LIBRARY_MAX_M, MAX_A, check_size, forward_plan,
                   k3_groups, linesearch_plan)

# controls the kernel library is built for (csrc/common.cuh MAX_M,
# plan.LIBRARY_MAX_M): no hand-written instance has more. A lowered model,
# a user's tiles and the packed K1 take up to the ceiling
# plan.MAX_CONTROLS, each from a library generated for its own m
MAX_M = LIBRARY_MAX_M
# (model id, n, m) of each model the CUDA kernels K2 and K3 are instantiated
# for; K1's instances are listed in backward_kernel.CUDA_BACKWARD
CUDA_MODELS = {(1, 4, 1): "pendcart (csrc/pendcart.cuh)",
               (2, 10, 2): "LTI (csrc/lti.cuh)",
               (2, 10, 3): "LTI (csrc/lti.cuh)",
               (3, 6, 2): "quadrotor (csrc/quadrotor.cuh)",
               (4, 4, 1): "pendcart with per-scenario [l, d] "
                          "(csrc/pendcart.cuh PendCartParam)"}


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceModel:
    """What a CUDA kernel needs to evaluate a model: the id of the model's
    device functions (1 = pendcart, ``csrc/pendcart.cuh``; 2 = LTI,
    ``csrc/lti.cuh``; 3 = quadrotor, ``csrc/quadrotor.cuh``; 4 = pendcart
    with per-scenario parameters, ``PendCartParam``) and a flat f32 array
    of its constants, passed to the kernel by value. ``autodiff``
    marks a derivative function made by forward-mode autodiff of the
    model's own functions: K1 then runs the model's ``Autodiff<Body>``
    instance (``csrc/autodiff.cuh``), never its analytic one.
    ``second_order`` marks derivative tiles that also give the dynamics
    Hessians (full DDP): K1 then runs the model's second-order instance,
    never a first-order one. ``lanes`` is set on the descriptor of the
    autodiff tiles of a model without one: K1 then runs
    ``Autodiff<Lowered>`` from that model's lowering (:mod:`.lower`),
    made at the first launch; ``consts`` is then unused. A user's tiles
    need no descriptor: K1 runs their own lowering (``LoweredTiles``,
    model id 6, :func:`~.lower.lower_tiles`)."""

    model_id: int
    consts: np.ndarray
    autodiff: bool = False
    second_order: bool = False
    lanes: Optional["LanesModel"] = None


@dataclasses.dataclass(frozen=True)
class LanesModel:
    """Batched problem functions on per-dimension ``(B,)`` tensors.

    - ``dynamics(x, u, t) -> x_next``: x list[n], u list[m] of tensors.
    - ``cost(x, u, t) -> tensor``: running cost.
    - ``terminal(x) -> tensor`` or None: terminal cost, evaluated at the
      last stored state of the trajectory.
    - ``device``: the device-model descriptor the CUDA kernels read, or
      None for a model that runs only through the plain versions.
    - ``n_params``: per-scenario parameter count. When > 0, the three
      functions take a trailing ``par`` argument, a list of ``n_params``
      (B,) tensors constant over the horizon (heterogeneous fleets), and
      the kernels a ``params`` stream (P, B).
    - ``diff``: optional state difference ``diff(x, x_old) -> list[n]``
      used by the feedback term of the control law (reference
      ``diff_fun``, e.g. angle wrapping); default x - x_old.

    A model with ``device=None`` runs on CUDA tensors through its lowering
    (:mod:`.lower`): its functions are traced and compiled into a library
    of its own. A hand-written descriptor has no ``diff``: such a model
    with a ``diff`` raises on CUDA tensors. Every path passes ``t`` as the
    logical step 0…T-1, an int32 (:func:`step_indices`; the kernels' int),
    so a time-varying model (a tracked reference r(t)) runs on all of
    them.
    """

    n: int
    m: int
    dynamics: Callable
    cost: Callable
    terminal: Optional[Callable] = None
    device: Optional[DeviceModel] = None
    n_params: int = 0
    diff: Optional[Callable] = None


class ForwardLanesOut(NamedTuple):
    totals: torch.Tensor            # (A, B) total cost per α candidate
    traj: Optional[torch.Tensor]    # (T, n+m+1, B): x, u, c — or None
    terminal: torch.Tensor          # (A, B) terminal-cost component


class LineSearchLanesOut(NamedTuple):
    traj: torch.Tensor   # (T, n+m+1, B) accepted-α rollout
    ls: torch.Tensor     # (5, B): al_sel, any_ok, dcost_sel, ratio_sel, total_new


def check_lims(m: int, lims):
    """Raise ValueError for static limits that are not one (lo, hi) per
    control."""
    if lims is not None and (not isinstance(lims, (tuple, list))
                             or len(lims) != m):
        raise ValueError(f"lims {lims}: static limits are one (lo, hi) per "
                         f"control, m={m}; per-scenario limits go in "
                         "lims_lanes")


def check_lanes(what: str, n_params: int, m: int, B: int, params,
                lims_lanes) -> None:
    """The per-scenario inputs: ``params`` (P, B) exactly when the model
    takes P > 0 parameters, ``lims_lanes`` (2m, B) or None."""
    if (params is None) != (n_params == 0) or (
            params is not None and tuple(params.shape) != (n_params, B)):
        raise ValueError(
            f"{what}: the model takes {n_params} per-scenario parameters; "
            f"params {None if params is None else tuple(params.shape)}, "
            f"expected {f'({n_params}, {B})' if n_params else None}")
    if lims_lanes is not None and tuple(lims_lanes.shape) != (2 * m, B):
        raise ValueError(f"{what}: lims_lanes {tuple(lims_lanes.shape)}, "
                         f"expected ({2 * m}, {B})")


def bounds(lims, m: int, lims_lanes=None):
    """Per-control (lo, hi): the rows of ``lims_lanes`` (tensors (B,)), or
    the static limits' floats, or ±inf for ``lims=None``. The JAX rollout
    does not clamp without limits (``forward_kernel.py:117-121``); the
    NaN-keeping clamp to ±inf returns every value, NaN included, unchanged,
    so one code path serves both."""
    if lims_lanes is not None:
        return ([lims_lanes[2 * mi] for mi in range(m)],
                [lims_lanes[2 * mi + 1] for mi in range(m)])
    if lims is None:
        return (-float("inf"),) * m, (float("inf"),) * m
    return tuple(lo for lo, _ in lims), tuple(hi for _, hi in lims)


def step_indices(T: int, device) -> torch.Tensor:
    """The step indices 0…T-1 that the plain versions pass a model's
    functions as ``t``: int32 on the streams' device, as JAX's kernels pass
    their int32 ``t_log``, so that ``t * h`` is the f32 product
    ``f32(t)·f32(h)`` on every path (the kernels' ``(float)t * h``). A
    Python int would make it the f64 product rounded once."""
    return torch.arange(T, dtype=torch.int32, device=device)


def par_args(params) -> tuple:
    """The trailing arguments of a model's functions: none, or the list of
    per-scenario parameter rows."""
    return () if params is None else ([params[p] for p in range(
        params.shape[0])],)


def lims_host(lims, m: int) -> np.ndarray:
    """Static limits as the CUDA launchers take them: f32
    [lo_0, hi_0, lo_1, hi_1, ...]."""
    lo, hi = bounds(lims, m)
    return np.asarray([v for pair in zip(lo, hi) for v in pair], np.float32)


def launch_device(what: str, *tensors: torch.Tensor):
    """Validate tensors for a kernel launch; returns (device index, stream
    handle)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for tensors on {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def launch_args(what: str, *tensors: torch.Tensor):
    """:func:`launch_device` and the kernel library: (lib, device index,
    stream handle)."""
    dev, stream = launch_device(what, *tensors)
    return _build.library(), dev, stream


def model_source(model_device: Optional[DeviceModel], lanes, what: str,
                 n: int, m: int, models=CUDA_MODELS):
    """Which model a launch evaluates: the model to lower (a model without a
    descriptor: ``model_device`` None and ``lanes`` the model, or a
    descriptor with ``lanes`` set), or None for the hand-written
    descriptor. ``models`` are the (model id, n, m) the kernel library is
    built for, or None where the caller has checked its own instance table.
    Raises NotImplementedError for a model no kernel can evaluate, and
    ValueError for a hand-written descriptor combined with a ``diff``,
    which its struct lacks."""
    if model_device is not None and model_device.lanes is not None:
        return model_device.lanes
    if model_device is None:
        return lanes
    if lanes is not None and lanes.diff is not None:
        raise ValueError(
            f"{what}: the model has a hand-written device descriptor (id "
            f"{model_device.model_id}) and a diff; the descriptor's struct "
            "has no diff, so the kernel would subtract. Drop the "
            "descriptor (device=None) to lower the model with its diff")
    if models is not None and (model_device.model_id, n, m) not in models:
        raise NotImplementedError(
            f"{what}: no CUDA kernel is built for model id "
            f"{model_device.model_id} at n={n}, m={m}; built: "
            f"{sorted(CUDA_MODELS.items())}")
    return None


def cuda_args(model_device: Optional[DeviceModel], what: str, n: int,
              m: int, lims, lims_lanes, params, *tensors: torch.Tensor,
              models=CUDA_MODELS, lanes=None, group: str = "fwd",
              tiles=None, library=None):
    """:func:`launch_args` plus the model arguments of a launcher: the
    static limits (host), the per-scenario limits and parameters (or null),
    P, model id, n, m, the host pointer to the constants and their count.
    The host arrays are returned too, to outlive the call. A model to lower
    (:func:`model_source`; ``lanes``: the model, where it has no
    descriptor) is lowered once the tensors are checked, and its library of
    instance group ``group`` (``_build.LOWERED_GROUPS``) is built at the
    first launch; so is that of ``tiles``, a user's lowered tiles
    (:class:`~.lower.LoweredTiles`), where given. An m above the ceiling
    ``plan.MAX_CONTROLS``, or an n above ``plan.MAX_STATES``, raises
    NotImplementedError before anything is lowered, built or launched.
    ``library``: for a hand-written descriptor, a function that loads the
    library to launch in place of the kernel library (a generated one). A
    lowering, build or launch that fails raises."""
    check_size(n, m, what)
    per_lane = [t for t in (lims_lanes, params) if t is not None]
    src = (tiles if tiles is not None
           else model_source(model_device, lanes, what, n, m, models))
    if src is None and library is not None:
        dev, stream = launch_device(what, *tensors, *per_lane)
        lib = library()
        model_id, consts = model_device.model_id, model_device.consts
    elif src is None:
        lib, dev, stream = launch_args(what, *tensors, *per_lane)
        model_id, consts = model_device.model_id, model_device.consts
    else:
        dev, stream = launch_device(what, *tensors, *per_lane)
        from .lower import LOWERED_ID, LOWERED_TILES_ID, lower
        low, model_id = ((tiles, LOWERED_TILES_ID) if tiles is not None
                         else (lower(src), LOWERED_ID))
        lib, consts = low.group(group)
    lim = lims_host(lims, m)
    return lib, dev, stream, (lim, consts), (
        lim.ctypes.data, _ptr(lims_lanes), _ptr(params),
        0 if params is None else params.shape[0], model_id, n,
        m, consts.ctypes.data, consts.size)


def _check_streams(what, model, traj, gains, x0, gk, gK, per_lane):
    """Shapes the kernels index without bounds checks."""
    T, S, B = traj.shape
    n, m = model.n, model.m
    ok = (S >= n + m and gains.shape[0] == T and gains.shape[2] == B
          and 0 <= gk and gk + m <= gains.shape[1] and 0 <= gK
          and gK + m * n <= gains.shape[1] and tuple(x0.shape) == (n, B)
          and all(a.ndim == 2 and a.shape[1] == B for a in per_lane))
    if not ok:
        raise ValueError(
            f"{what}: traj {tuple(traj.shape)}, gains {tuple(gains.shape)} "
            f"(gk={gk}, gK={gK}), x0 {tuple(x0.shape)}, per-lane inputs "
            f"{[tuple(a.shape) for a in per_lane]}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _rollout_step(model, x, acc, term, alpha, x_old, u_nom, k, K, lo, hi,
                  t, last, par):
    """One step of every candidate (tensors (A, B) or (B,)); the kernels'
    rollout_step. Per control, u = clip(u_nom + α·k + Σ_j K_j·dx_j, lo, hi)
    (JAX ``forward_kernel.py:156-169``), lo/hi floats or per-scenario (B,)
    tensors; ``t`` the step index (:func:`step_indices`); ``par`` the
    model's trailing arguments (:func:`par_args`).
    Returns (x_next, acc, term, u, c)."""
    dx = (model.diff(x, x_old) if model.diff is not None
          else [x[j] - x_old[j] for j in range(model.n)])
    u = []
    for mi in range(model.m):
        v = u_nom[mi] + alpha * k[mi]
        for j in range(model.n):
            v = v + K[mi][j] * dx[j]
        u.append(torch.clamp(v, lo[mi], hi[mi]))
    c = model.cost(x, u, t, *par)
    if last and model.terminal is not None:
        term = model.terminal(x, *par)
    x_next = model.dynamics(x, u, t, *par)
    return x_next, acc + c, term, u, c


def _step_inputs(traj, gains, gk, gK, n, m, t):
    return ([traj[t, i] for i in range(n)],
            [traj[t, n + mi] for mi in range(m)],
            [gains[t, gk + mi] for mi in range(m)],
            [[gains[t, gK + mi * n + j] for j in range(n)] for mi in range(m)])


def forward_lanes_ref(traj, gains, x0, alphas, params=None, lims_lanes=None,
                      *, model: LanesModel, lims, gk: int = 0,
                      gK: Optional[int] = None,
                      emit_traj: bool = False) -> ForwardLanesOut:
    """Plain version of :func:`forward_lanes` (same arguments)."""
    n, m = model.n, model.m
    gK = m if gK is None else gK
    T, B = traj.shape[0], traj.shape[2]
    A = alphas.shape[0]
    lo, hi = bounds(lims, m, lims_lanes)
    par = par_args(params)
    x = [x0[i].expand(A, B) for i in range(n)]
    acc = torch.zeros((A, B), dtype=traj.dtype, device=traj.device)
    term = torch.zeros_like(acc)
    out = (torch.empty((T, n + m + 1, B), dtype=traj.dtype,
                       device=traj.device) if emit_traj else None)
    ts = step_indices(T, traj.device)
    for t in range(T):
        x_old, u_nom, k, K = _step_inputs(traj, gains, gk, gK, n, m, t)
        x_s = x
        x, acc, term, u, c = _rollout_step(model, x, acc, term, alphas,
                                           x_old, u_nom, k, K, lo, hi, ts[t],
                                           t == T - 1, par)
        if emit_traj:
            out[t] = torch.stack([v[0] for v in x_s + u] + [c[0]])
    return ForwardLanesOut(totals=acc + term, traj=out, terminal=term)


def _accept(totals, sel, alphas: Sequence[float], rr_min: float):
    """The accept rule at the pass boundary (src/iLQG.jl:269-280)."""
    dv1, dv2, ctot, allow = sel[0], sel[1], sel[2], sel[3]
    al_sel = dc_sel = rt_sel = found = None
    for a_i, a in enumerate(alphas):
        a = float(np.float32(a))
        dcost = ctot - totals[a_i]
        expected = (-a) * (dv1 + a * dv2)
        # sign that keeps NaN, as jnp.sign does (torch.sign(nan) is 0)
        sgn = torch.where(torch.isnan(dcost), dcost, torch.sign(dcost))
        ratio = torch.where(expected > 0, dcost / expected, sgn)
        ok = ratio > rr_min
        if a_i == 0:
            dc_sel, rt_sel, found = dcost, ratio, ok
            al_sel = torch.where(ok, a, 0.0)
        else:
            take = ok & ~found
            al_sel = torch.where(take, a, al_sel)
            dc_sel = torch.where(take, dcost, dc_sel)
            rt_sel = torch.where(take, ratio, rt_sel)
            found = found | ok
    al_eff = torch.where(found & (allow > 0.5), al_sel, 0.0)
    return al_sel, found, dc_sel, rt_sel, al_eff


def linesearch_lanes_ref(traj, gains, x0, sel, params=None, lims_lanes=None,
                         *, model: LanesModel, alphas: Tuple[float, ...],
                         reduce_ratio_min: float, lims, gk: int = 0,
                         gK: Optional[int] = None) -> LineSearchLanesOut:
    """Plain version of :func:`linesearch_lanes` with a fresh output (same
    arguments; the wrapper does the in-place copy)."""
    A = len(alphas)
    B = traj.shape[2]
    ladder = torch.tensor([float(np.float32(a)) for a in alphas],
                          dtype=traj.dtype, device=traj.device)
    pass1 = forward_lanes_ref(traj, gains, x0, ladder[:, None].expand(A, B),
                              params, lims_lanes, model=model, lims=lims,
                              gk=gk, gK=gK)
    al_sel, found, dc_sel, rt_sel, al_eff = _accept(
        pass1.totals, sel, alphas, reduce_ratio_min)
    pass2 = forward_lanes_ref(traj, gains, x0, al_eff[None], params,
                              lims_lanes, model=model, lims=lims, gk=gk,
                              gK=gK, emit_traj=True)
    ls = torch.stack([al_sel, found.to(traj.dtype), dc_sel, rt_sel,
                      pass2.totals[0]])
    return LineSearchLanesOut(traj=pass2.traj, ls=ls)


# ---------------------------------------------------------------------------
# wrappers: CPU → plain version, CUDA → kernel
# ---------------------------------------------------------------------------

def forward_lanes(traj: torch.Tensor, gains: torch.Tensor, x0: torch.Tensor,
                  alphas: torch.Tensor, params=None, lims_lanes=None, *,
                  model: LanesModel, lims=None, gk: int = 0,
                  gK: Optional[int] = None,
                  emit_traj: bool = False) -> ForwardLanesOut:
    """Roll out A candidates per scenario from ``x0``.

    - ``traj``: (T, ≥n+m, B) — slots [x_old(n), u_nom(m), ...].
    - ``gains``: (T, Sg, B) — k at slot ``gk``, K (row-major (m, n)) at
      slot ``gK`` (pass the backward output with its OutLayout offsets).
    - ``x0``: (n, B); ``alphas``: (A, B) per-scenario α, any A ≥ 1 (on
      the card one launch for each group of eight).
    - ``params``: (P, B) per-scenario parameters of a model with
      ``n_params == P``, else None.
    - ``lims``: static ``((lo, hi),) * m``, or None for no clamp;
      ``lims_lanes``: per-scenario limits (2m, B), which replace ``lims``.
    - ``emit_traj``: also return the candidate-0 stream (T, n+m+1, B).

    Returns per-α totals (running + terminal) and terminal costs, (A, B).
    """
    check_lims(model.m, lims)
    gK = model.m if gK is None else gK
    _check_streams("forward_lanes", model, traj, gains, x0, gk, gK, [alphas])
    T, B = traj.shape[0], traj.shape[2]
    check_lanes("forward_lanes", model.n_params, model.m, B, params,
                lims_lanes)
    if traj.device.type == "cpu":
        return forward_lanes_ref(traj, gains, x0, alphas, params, lims_lanes,
                                 model=model, lims=lims, gk=gk, gK=gK,
                                 emit_traj=emit_traj)
    A = alphas.shape[0]
    if A < 1:
        raise ValueError(f"forward_lanes: A={A}, expected at least 1")
    lib, dev, stream, _keep, model_args = cuda_args(
        model.device, "forward_lanes", model.n, model.m, lims, lims_lanes,
        params, traj, gains, x0, alphas, lanes=model)
    totals = torch.empty((A, B), dtype=torch.float32, device=traj.device)
    term = torch.empty_like(totals)
    out = (torch.empty((T, model.n + model.m + 1, B), dtype=torch.float32,
                       device=traj.device) if emit_traj else None)
    for a0, na in k3_groups(A):
        # rows a0… of the (A, B) inputs and outputs; the first group emits
        emit = emit_traj and a0 == 0
        plan = forward_plan(model.n, model.m, na, T, B, emit)
        rc = lib.ddp_forward_lanes(
            traj.data_ptr(), traj.shape[1], gains.data_ptr(), gains.shape[1],
            gk, gK, x0.data_ptr(), alphas[a0].data_ptr(), na,
            totals[a0].data_ptr(), term[a0].data_ptr(),
            _ptr(out) if emit else None, T, B, *model_args,
            *plan.launcher_args(), dev, stream)
        _build.check(lib, rc, "forward_lanes")
        forward_lanes.launches += 1
    return ForwardLanesOut(totals=totals, traj=out, terminal=term)


forward_lanes.launches = 0


def linesearch_lanes(traj: torch.Tensor, gains: torch.Tensor,
                     x0: torch.Tensor, sel: torch.Tensor, params=None,
                     lims_lanes=None, *, model: LanesModel,
                     alphas: Tuple[float, ...], reduce_ratio_min: float = 0.0,
                     lims=None, gk: int = 0, gK: Optional[int] = None,
                     in_place: bool = False) -> LineSearchLanesOut:
    """Fused line search: per-α totals over the static ladder ``alphas``,
    the accept decision, and the accepted-α re-roll, in one launch.

    ``sel``: (4, B) [dV1, dV2, cost_old_total, allow]; ``allow`` (1/0) masks
    the lanes permitted to accept. Rejected lanes re-roll with α=0, which
    retraces a kernel-produced trajectory bit for bit. ``params`` and
    ``lims_lanes`` as :func:`forward_lanes`.

    The output is a fresh stream and the input stays valid, unless
    ``in_place`` is set and ``traj`` has exactly n+m+1 slots (JAX
    ``forward_kernel.py:611``): the new stream then overwrites ``traj``,
    which is returned, as JAX donates the input buffer. ``x0`` may then be
    a view of ``traj``.

    Returns the new stream (T, n+m+1, B) and the (5, B) record
    [al_sel, any_ok, dcost_sel, ratio_sel, total_new].
    """
    check_lims(model.m, lims)
    gK = model.m if gK is None else gK
    _check_streams("linesearch_lanes", model, traj, gains, x0, gk, gK, [sel])
    if sel.shape[0] != 4:
        raise ValueError(f"linesearch_lanes: sel {tuple(sel.shape)}, "
                         "expected (4, B)")
    T, B = traj.shape[0], traj.shape[2]
    check_lanes("linesearch_lanes", model.n_params, model.m, B, params,
                lims_lanes)
    alias = in_place and traj.shape[1] == model.n + model.m + 1
    if traj.device.type == "cpu":
        res = linesearch_lanes_ref(traj, gains, x0, sel, params, lims_lanes,
                                   model=model, alphas=alphas,
                                   reduce_ratio_min=reduce_ratio_min,
                                   lims=lims, gk=gk, gK=gK)
        return res._replace(traj=traj.copy_(res.traj)) if alias else res
    A = len(alphas)
    if not 1 <= A <= MAX_A:
        raise ValueError(f"linesearch_lanes: {A} alphas outside 1..{MAX_A}")
    lib, dev, stream, _keep, model_args = cuda_args(
        model.device, "linesearch_lanes", model.n, model.m, lims, lims_lanes,
        params, traj, gains, x0, sel, lanes=model)
    ladder = np.asarray(alphas, np.float32)
    out = traj if alias else torch.empty(
        (T, model.n + model.m + 1, B), dtype=torch.float32,
        device=traj.device)
    ls = torch.empty((5, B), dtype=torch.float32, device=traj.device)
    plan = linesearch_plan(model.n, model.m, A, T, B)
    rc = lib.ddp_linesearch_lanes(
        traj.data_ptr(), traj.shape[1], gains.data_ptr(), gains.shape[1], gk,
        gK, x0.data_ptr(), sel.data_ptr(), ladder.ctypes.data, A,
        float(reduce_ratio_min), out.data_ptr(), ls.data_ptr(), T, B,
        *model_args, *plan.launcher_args(), dev, stream)
    _build.check(lib, rc, "linesearch_lanes")
    linesearch_lanes.launches += 1
    return LineSearchLanesOut(traj=out, ls=ls)


linesearch_lanes.launches = 0
