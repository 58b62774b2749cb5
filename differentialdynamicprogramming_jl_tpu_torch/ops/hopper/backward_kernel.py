"""Batched backward pass (K1): the Riccati recursion with in-kernel derivatives.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/pallas/backward_kernel.py``
for the subset on the fleet iLQG path: m = 1, derivatives computed per step
from the (x, u) slots of the trajectory stream by ``derivs_tiles``, static
control limits, reg_type 1 or 2, and ``"gains"`` or ``"full"`` emission.

:func:`backward_lanes` gives a CPU tensor to :func:`backward_lanes_ref`, the
plain PyTorch version (vectorised over B, Python loop over t, in the
kernel's operation order), and a CUDA tensor to the hand-written kernel in
``csrc/backward.cu``, or raises. There is no fallback. Launches are counted
in ``backward_lanes.launches``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from . import _build
from .forward_kernel import DeviceModel, check_slice, cuda_args


class OutLayout:
    """Slot offsets of the packed backward outputs, row-major flattened, in
    the JAX kernel's order (``backward_kernel.py:64-103``):

    - ``"full"``: k, K, Vx, Vxx, Quu, Quu⁻¹ (27 slots at n=4, m=1);
    - ``"gains"``: k, K only (5 slots) — all the iLQG loop consumes;
    - ``"policy"``: k, K, Quu, Quu⁻¹ — defined for the layout, not emitted
      by this slice.

    Absent blocks have offset ``None``; the k/K prefix is the same in every
    mode.
    """

    def __init__(self, n: int, m: int, emit: str = "full"):
        assert emit in ("full", "gains", "policy"), emit
        self.n, self.m, self.emit = n, m, emit
        self.k = 0
        self.K = m
        off = self.K + m * n
        if emit == "full":
            self.Vx = off
            self.Vxx = off + n
            off += n + n * n
        else:
            self.Vx = self.Vxx = None
        if emit in ("full", "policy"):
            self.quu = off
            self.quui = off + m * m
            off += 2 * m * m
        else:
            self.quu = self.quui = None
        self.S = off


@dataclasses.dataclass(frozen=True)
class DerivsTiles:
    """An in-kernel derivative function ``fn(x, u, t) -> dict`` (keys fx, fu,
    cx, cu, cxx, cxu, cuu; lists of per-scenario tensors, cxu is (n, m)),
    with the device-model descriptor that lets the CUDA kernel evaluate the
    same model."""

    fn: Callable
    device: Optional[DeviceModel] = None

    def __call__(self, x, u, t):
        return self.fn(x, u, t)


class BackwardLanesOut(NamedTuple):
    out: torch.Tensor     # (T, S, B), slots per OutLayout
    stats: torch.Tensor   # (4, B): dV1, dV2, diverged, diverge_idx


def _inv1(q):
    """Quu⁻¹ for m=1 by the JAX kernel's unrolled Cholesky (``_tiny_inv``):
    L = sqrt(max(q, 1e-30)), then two triangular solves against e0."""
    L = torch.sqrt(torch.clamp_min(q, 1e-30))
    return (1.0 / L) / L


def _sum(terms):
    s = terms[0]
    for v in terms[1:]:
        s = s + v
    return s


def backward_lanes_ref(traj, lam, *, n: int, m: int, reg_type: int, lims,
                       derivs_tiles: Callable,
                       emit: str = "full") -> BackwardLanesOut:
    """Plain version of :func:`backward_lanes` (same arguments)."""
    T, B = traj.shape[0], traj.shape[2]
    lay = OutLayout(n, m, emit)
    full = emit == "full"
    out = torch.empty((T, lay.S, B), dtype=traj.dtype, device=traj.device)
    lo_lim, hi_lim = lims[0]
    R = range(n)

    # boundary t = T-1 (src/backward_pass.jl:97-99)
    d = derivs_tiles([traj[T - 1, i] for i in R], [traj[T - 1, n]], T - 1)
    Vx = list(d["cx"])
    Vxx = [list(row) for row in d["cxx"]]
    zero = torch.zeros_like(Vx[0])
    slots = [zero] * (1 + n)
    if full:
        cuu = d["cuu"][0][0]
        slots += Vx + [v for row in Vxx for v in row] + [cuu, _inv1(cuu)]
    out[T - 1] = torch.stack(slots)
    dv1 = dv2 = div = divt = zero

    for t in range(T - 2, -1, -1):
        x = [traj[t, i] for i in R]
        u = traj[t, n]
        d = derivs_tiles(x, [u], t)
        fx, fu = d["fx"], [row[0] for row in d["fu"]]
        cx, cu = d["cx"], d["cu"][0]
        cxx, cxu, cuu = d["cxx"], [row[0] for row in d["cxu"]], d["cuu"][0][0]

        # Q expansions (src/backward_pass.jl:103-123)
        Qx = [cx[i] + _sum([fx[a][i] * Vx[a] for a in R]) for i in R]
        Qu = cu + _sum([fu[a] * Vx[a] for a in R])
        W = [[_sum([Vxx[a][c] * fx[c][j] for c in R]) for j in R] for a in R]
        U = [_sum([Vxx[a][c] * fu[c] for c in R]) for a in R]
        Qxx = [[cxx[i][j] + _sum([fx[a][i] * W[a][j] for a in R]) for j in R]
               for i in R]
        Quu = cuu + _sum([fu[a] * U[a] for a in R])
        Qux = [cxu[j] + _sum([fu[a] * W[a][j] for a in R]) for j in R]

        # regularised gain matrices (src/backward_pass.jl:119-123)
        if reg_type == 2:
            Qux_r = [Qux[j] + lam * _sum([fu[a] * fx[a][j] for a in R])
                     for j in R]
            QuuF = Quu + lam * _sum([fu[a] * fu[a] for a in R])
        else:
            Qux_r = Qux
            QuuF = Quu + lam

        # m = 1 closed-form box QP, limits relative to u_t
        lo = lo_lim - u
        hi = hi_lim - u
        ok = QuuF > 0
        xq = torch.minimum(torch.maximum(-Qu / QuuF, lo), hi)
        grad = Qu + QuuF * xq
        clamped = ((xq <= lo) & (grad > 0)) | ((xq >= hi) & (grad < 0))
        quu_s = torch.where(torch.abs(QuuF) > 1e-30, QuuF, 1e-30)
        k = torch.where(ok, xq, 0.0)
        K = [torch.where(ok, torch.where(clamped, 0.0, -Qux_r[j] / quu_s),
                         0.0) for j in R]

        # value update with the unregularised terms (src/backward_pass.jl:63-72)
        Quu_k = Quu * k
        dv1 = dv1 + k * Qu
        dv2 = dv2 + 0.5 * (k * Quu_k)
        QuuK = [Quu * K[j] for j in R]
        Vx = [Qx[i] + K[i] * (Quu_k + Qu) + Qux[i] * k for i in R]
        Vraw = [[Qxx[i][j] + K[i] * QuuK[j] + K[i] * Qux[j] + Qux[i] * K[j]
                 for j in R] for i in R]
        Vxx = [[0.5 * (Vraw[i][j] + Vraw[j][i]) for j in R] for i in R]

        # divergence latch: t+1 of the first failing step, recursion goes on
        bad = (~ok).to(traj.dtype)
        newly = bad * (1.0 - div)
        divt = divt * (1.0 - newly) + newly * float(t + 1)
        div = torch.maximum(div, bad)

        slots = [k] + K
        if full:
            slots += Vx + [v for row in Vxx for v in row] + [Quu, _inv1(Quu)]
        out[t] = torch.stack(slots)

    return BackwardLanesOut(out=out, stats=torch.stack([dv1, dv2, div, divt]))


def backward_lanes(traj: torch.Tensor, lam: torch.Tensor, *, n: int, m: int,
                   reg_type: int = 1, lims=None,
                   derivs_tiles: Optional[Callable] = None, prev=None,
                   eta=None, params=None, lims_lanes=None,
                   emit: str = "full") -> BackwardLanesOut:
    """Run the backward pass over a trajectory stream.

    - ``traj``: (T, ≥n+m, B) with x in slots [0, n) and u in [n, n+m);
      derivatives are computed per step by ``derivs_tiles``.
    - ``lam``: per-scenario λ (B,). ``lims``: static ``((lo, hi),)``.
    - ``emit``: ``"gains"`` (k, K) or ``"full"`` (see :class:`OutLayout`).

    Out of this slice (NotImplementedError): the packed-derivatives input
    (``derivs_tiles=None``), GPS ``prev``/``eta``, ``params``, per-scenario
    ``lims_lanes``, m ≠ 1, ``"policy"`` emission.
    """
    if derivs_tiles is None:
        raise NotImplementedError(
            "packed-derivatives input: pass derivs_tiles")
    if prev is not None or eta is not None:
        raise NotImplementedError("GPS mode (prev/eta)")
    check_slice(m, lims, params, lims_lanes)
    if emit not in ("gains", "full"):
        raise NotImplementedError(f"emit={emit!r}")
    if reg_type not in (1, 2):
        raise ValueError(f"reg_type must be 1 or 2, got {reg_type}")
    T, S_in, B = traj.shape
    if T < 2 or S_in < n + m or lam.shape != (B,):
        raise ValueError(f"backward_lanes: traj {tuple(traj.shape)}, "
                         f"lam {tuple(lam.shape)}")
    if traj.device.type == "cpu":
        return backward_lanes_ref(traj, lam, n=n, m=m, reg_type=reg_type,
                                  lims=lims, derivs_tiles=derivs_tiles,
                                  emit=emit)
    lib, dev, stream, consts = cuda_args(
        getattr(derivs_tiles, "device", None), "backward_lanes", traj, lam)
    S = OutLayout(n, m, emit).S
    out = torch.empty((T, S, B), dtype=torch.float32, device=traj.device)
    stats = torch.empty((4, B), dtype=torch.float32, device=traj.device)
    lo, hi = lims[0]
    rc = lib.ddp_backward_lanes(
        traj.data_ptr(), S_in, lam.data_ptr(), out.data_ptr(), S,
        stats.data_ptr(), T, B, int(emit == "full"), reg_type, lo, hi,
        derivs_tiles.device.model_id, consts, dev, stream)
    _build.check(lib, rc, "backward_lanes")
    backward_lanes.launches += 1
    return BackwardLanesOut(out=out, stats=stats)


backward_lanes.launches = 0
