"""Batched backward pass (K1): the Riccati recursion with in-kernel derivatives.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/pallas/backward_kernel.py``
for the subset on the fleet iLQG and KL/GPS paths: m = 1, derivatives
computed per step from the (x, u) slots of the trajectory stream by
``derivs_tiles``, static control limits or none (the unconstrained solve),
reg_type 1 or 2, GPS mode (``prev``/``eta``), and ``"gains"``, ``"full"`` or
``"policy"`` emission.

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
from .forward_kernel import DeviceModel, bounds, check_slice, cuda_args


class OutLayout:
    """Slot offsets of the packed backward outputs, row-major flattened, in
    the JAX kernel's order (``backward_kernel.py:64-103``):

    - ``"full"``: k, K, Vx, Vxx, Quu, Quu⁻¹ (27 slots at n=4, m=1);
    - ``"gains"``: k, K only (5 slots) — all the iLQG loop consumes;
    - ``"policy"``: k, K, Quu, Quu⁻¹ (7 slots) — what the KL/GPS loop
      consumes.

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


# emission mode codes of the CUDA launcher (csrc/backward.cu)
EMIT_CODE = {"gains": 0, "full": 1, "policy": 2}


class BackwardLanesOut(NamedTuple):
    out: torch.Tensor     # (T, S, B), slots per OutLayout
    stats: torch.Tensor   # (4, B): dV1, dV2, diverged, diverge_idx


def _inv1(q):
    """Quu⁻¹ for m=1 by the JAX kernel's unrolled Cholesky (``_tiny_inv``):
    L = sqrt(max(q, 1e-30)), then two triangular solves against e0."""
    L = torch.sqrt(torch.clamp_min(q, 1e-30))
    return (1.0 / L) / L


def _sum(terms):
    """Left-to-right sum, the order of the JAX kernels' Python ``sum``."""
    it = iter(terms)
    s = next(it)
    for v in it:
        s = s + v
    return s


def _read_kl(prev, eta, t, n):
    """GPS mode at step t, m = 1: the dual η (0 replaced by 1, JAX
    ``backward_kernel.py:795-797``) and the pieces of the KL expansion from
    the previous-policy stream [k_prev, K_prev(n), Σ⁻¹_prev] (``read_kl``,
    ``:370-392``): cx_i = K_i·(Σ⁻¹k), cu = -Σ⁻¹k, cxx_ij = K_i·(Σ⁻¹K_j),
    cxu_j = -Σ⁻¹K_j, cuu = Σ⁻¹."""
    e = eta[t]
    Kp = [prev[t, 1 + j] for j in range(n)]
    Si = prev[t, 1 + n]
    return dict(eta=torch.where(e == 0, 1.0, e), Kp=Kp, Si=Si,
                Sik=Si * prev[t, 0], SiK=[Si * Kp[j] for j in range(n)])


def backward_lanes_ref(traj, lam, *, n: int, m: int, reg_type: int, lims,
                       derivs_tiles: Callable, prev=None, eta=None,
                       emit: str = "full") -> BackwardLanesOut:
    """Plain version of :func:`backward_lanes` (same arguments; ``eta`` is
    (T, B))."""
    T, B = traj.shape[0], traj.shape[2]
    lay = OutLayout(n, m, emit)
    gps = prev is not None
    out = torch.empty((T, lay.S, B), dtype=traj.dtype, device=traj.device)
    R = range(n)

    # boundary t = T-1 (src/backward_pass.jl:97-99, 280-283): V = the cost
    # expansion, unscaled also in GPS mode; only the emitted Quu is
    # cuu/η + Σ⁻¹_prev there (JAX :418-429)
    d = derivs_tiles([traj[T - 1, i] for i in R], [traj[T - 1, n]], T - 1)
    Vx = list(d["cx"])
    Vxx = [list(row) for row in d["cxx"]]
    zero = torch.zeros_like(Vx[0])
    slots = [zero] * (1 + n)
    if lay.Vx is not None:
        slots += Vx + [v for row in Vxx for v in row]
    if lay.quu is not None:
        cuu = d["cuu"][0][0]
        if gps:
            kl = _read_kl(prev, eta, T - 1, n)
            cuu = cuu / kl["eta"] + kl["Si"]
        slots += [cuu, _inv1(cuu)]
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

        if gps:
            # GPS mode: Q terms scaled by 1/η plus the KL expansion, Quu
            # symmetrised, λ unused (src/backward_pass.jl:293-299; JAX
            # :483-497)
            kl = _read_kl(prev, eta, t, n)
            ie = 1.0 / kl["eta"]
            Kp, Sik, SiK = kl["Kp"], kl["Sik"], kl["SiK"]
            Qx = [Qx[i] * ie + Kp[i] * Sik for i in R]
            Qu = Qu * ie + (-Sik)
            Qxx = [[Qxx[i][j] * ie + Kp[i] * SiK[j] for j in R] for i in R]
            Qux = [Qux[j] * ie + (-SiK[j]) for j in R]
            Quu_g = Quu * ie + kl["Si"]
            Quu = 0.5 * (Quu_g + Quu_g)
            Qux_r, QuuF = Qux, Quu
        # regularised gain matrices (src/backward_pass.jl:119-123)
        elif reg_type == 2:
            Qux_r = [Qux[j] + lam * _sum([fu[a] * fx[a][j] for a in R])
                     for j in R]
            QuuF = Quu + lam * _sum([fu[a] * fu[a] for a in R])
        else:
            Qux_r = Qux
            QuuF = Quu + lam

        ok = QuuF > 0
        if lims is None:
            # unconstrained m = 1 solve by the unrolled Cholesky
            # (_tiny_chol/_tiny_chol_solve, JAX :514-522, :122-158)
            L = torch.sqrt(torch.clamp_min(QuuF, 1e-30))
            k = torch.where(ok, ((-Qu) / L) / L, 0.0)
            K = [torch.where(ok, ((-Qux_r[j]) / L) / L, 0.0) for j in R]
        else:
            # m = 1 closed-form box QP, limits relative to u_t
            lo = lims[0][0] - u
            hi = lims[0][1] - u
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
        if lay.Vx is not None:
            slots += Vx + [v for row in Vxx for v in row]
        if lay.quu is not None:
            slots += [Quu, _inv1(Quu)]
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
    - ``lam``: per-scenario λ (B,). ``lims``: static ``((lo, hi),)``, or
      None for the unconstrained solve.
    - GPS mode (reference ``back_pass_gps``, ``src/backward_pass.jl:259-350``)
      when ``prev``/``eta`` are given: ``prev`` is the previous-policy stream
      (T, m+m·n+m², B) holding [k_prev, K_prev, Σ⁻¹_prev] and ``eta`` the
      per-step dual, (T, B) or (T, 1, B); a zero η counts as 1. λ is then
      unused.
    - ``emit``: ``"gains"``, ``"full"`` or ``"policy"`` (see
      :class:`OutLayout`).

    Out of this slice (NotImplementedError): the packed-derivatives input
    (``derivs_tiles=None``), ``params``, per-scenario ``lims_lanes``,
    m ≠ 1.
    """
    if derivs_tiles is None:
        raise NotImplementedError(
            "packed-derivatives input: pass derivs_tiles")
    check_slice(m, lims, params, lims_lanes)
    if emit not in EMIT_CODE:
        raise ValueError(f"emit={emit!r}: one of {tuple(EMIT_CODE)}")
    if reg_type not in (1, 2):
        raise ValueError(f"reg_type must be 1 or 2, got {reg_type}")
    T, S_in, B = traj.shape
    if T < 2 or S_in < n + m or lam.shape != (B,):
        raise ValueError(f"backward_lanes: traj {tuple(traj.shape)}, "
                         f"lam {tuple(lam.shape)}")
    gps = prev is not None
    if gps != (eta is not None):
        raise ValueError("GPS mode needs both prev and eta")
    if gps:
        if (tuple(prev.shape) != (T, m + m * n + m * m, B)
                or tuple(eta.shape) not in ((T, B), (T, 1, B))):
            raise ValueError(f"backward_lanes: prev {tuple(prev.shape)}, "
                             f"eta {tuple(eta.shape)} for traj "
                             f"{tuple(traj.shape)}")
        eta = eta.reshape(T, B)
    if traj.device.type == "cpu":
        return backward_lanes_ref(traj, lam, n=n, m=m, reg_type=reg_type,
                                  lims=lims, derivs_tiles=derivs_tiles,
                                  prev=prev, eta=eta, emit=emit)
    lib, dev, stream, consts = cuda_args(
        getattr(derivs_tiles, "device", None), "backward_lanes", traj, lam,
        *((prev, eta) if gps else ()))
    S = OutLayout(n, m, emit).S
    out = torch.empty((T, S, B), dtype=torch.float32, device=traj.device)
    stats = torch.empty((4, B), dtype=torch.float32, device=traj.device)
    lo, hi = bounds(lims)                 # unused without limits
    rc = lib.ddp_backward_lanes(
        traj.data_ptr(), S_in, lam.data_ptr(),
        prev.data_ptr() if gps else None, eta.data_ptr() if gps else None,
        out.data_ptr(), S, stats.data_ptr(), T, B, EMIT_CODE[emit], reg_type,
        int(lims is not None), lo, hi, derivs_tiles.device.model_id, consts,
        dev, stream)
    _build.check(lib, rc, "backward_lanes")
    backward_lanes.launches += 1
    return BackwardLanesOut(out=out, stats=stats)


backward_lanes.launches = 0
