"""Batched backward pass (K1): the Riccati recursion.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/pallas/backward_kernel.py``
for the subset on the fleet iLQG, KL/GPS and MPC paths: derivatives
computed per step from the (x, u) slots of the trajectory stream by
``derivs_tiles`` (first order, or with the dynamics Hessians of full DDP)
or read from a packed-derivatives stream (``derivs_tiles=None``),
per-scenario model parameters (``params``), control limits (the m=1 clamp,
the m=2 9-set enumeration, or for m > 2 the masked projected-Newton box QP
of ``qp_iters`` iterations warm-started from the next step's k), static or
per scenario (``lims_lanes``), or none (the unconstrained Cholesky solve),
reg_type 1 or 2, GPS mode
(``prev``/``eta``), and ``"gains"``, ``"full"`` or ``"policy"`` emission;
and the batch-major wrapper :func:`backward_pass_pallas`.

:func:`backward_lanes` gives a CPU tensor to :func:`backward_lanes_ref`, the
plain PyTorch version (vectorised over B and over each product's elements,
a Python loop over t and over each sum's terms, in the kernel's operation
order; any size), and a CUDA tensor to a hand-written kernel, or raises:
the lane design of ``csrc/backward.cuh`` (the kernel library's instances,
m ≤ ``MAX_M`` = 4, or a library generated for a lowered model's, a user's
tiles' or the packed stream's own m), or where its ring does not fit a
block the wide design of ``csrc/backward_wide.cuh`` on the packed stream
(:func:`_backward_wide`), up to ``plan.MAX_STATES`` = 64 states and
``plan.MAX_CONTROLS`` = 32 controls. There is no fallback. Its launch plan
comes from :mod:`.plan`. Launches are counted in
``backward_lanes.launches``, those of the wide design also in
``backward_lanes.wide_launches``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .plan import backward_plan, check_size
from .forward_kernel import (CUDA_MODELS, DeviceModel, _ptr, bounds,
                             check_lanes, check_lims, cuda_args,
                             launch_device, lims_host, par_args,
                             step_indices)
from .pack import (DERIV_FIELDS, DerivLayout, from_streams,
                   pack_backward_inputs, stack_tiles, to_streams)
from ..backward import BackwardOut
from ...policy import Derivs, GaussianPolicy


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


class InLayout(DerivLayout):
    """K1's packed input: the derivative stack, then the nominal controls
    (JAX ``backward_kernel.py:106-115``)."""

    @property
    def u(self) -> int:
        return self.D

    @property
    def DU(self) -> int:
        return self.D + self.m


@dataclasses.dataclass(frozen=True)
class DerivsTiles:
    """An in-kernel derivative function ``fn(x, u, t) -> dict`` (keys fx, fu,
    cx, cu, cxx, cxu, cuu; lists of per-scenario tensors, cxu is (n, m);
    ``t`` the step index, an int32 tensor), with the device-model
    descriptor that lets the CUDA kernel evaluate the same model: by its
    analytic derivatives, or by autodiff of its own functions where
    ``device.autodiff`` is set
    (:func:`~.autodiff_tiles.autodiff_derivs_tiles`). With ``n_params > 0``
    it takes a trailing ``par`` list, as the model's functions do. Tiles
    that also return ``fxx``, ``fxu`` and ``fuu`` (full DDP) carry a
    descriptor with ``second_order`` set.

    A user's tiles need no descriptor (``device=None``): on CUDA tensors K1
    runs their lowering (:func:`~.lower.lower_tiles`), the traced function
    emitted as K1's analytic expansion ``LoweredTiles``, first or second
    order by what the function returns (:data:`LOWERED_TILES_K1`)."""

    fn: Callable
    device: Optional[DeviceModel] = None
    n_params: int = 0

    def __call__(self, x, u, t, *par):
        return self.fn(x, u, t, *par)


# emission mode codes of the CUDA launcher (csrc/backward.cu)
EMIT_CODE = {"gains": 0, "full": 1, "policy": 2}
# K1's CUDA instances: (model id, n, m, autodiff, GPS mode) -> the
# emissions built. autodiff marks the Autodiff<Body> instances
# (csrc/autodiff.cuh), whose derivatives are made in the kernel from the
# model's own functions (DeviceModel.autodiff). Model id 4 is the pendcart
# with per-scenario parameters (PendCartParam). Per-scenario limits are a
# runtime input of every instance. Every derivative source a public entry
# can pass runs in the modes the entries launch: "gains" and "full"
# without GPS mode (ilqg_batch_lanes), "policy" in it (ilqgkl_batch_lanes,
# which takes no params).
_ALL = tuple(EMIT_CODE)
_ILQG = ("gains", "full")
_KL = ("policy",)
CUDA_BACKWARD = {
    (1, 4, 1, False, False): _ALL, (1, 4, 1, False, True): _ALL,
    (2, 10, 2, False, False): _ALL, (2, 10, 2, False, True): _ALL,
    (2, 10, 3, False, False): _ALL, (2, 10, 3, False, True): _ALL,
    (4, 4, 1, False, False): _ILQG, (4, 4, 1, True, False): _ILQG,
    (1, 4, 1, True, False): _ILQG, (1, 4, 1, True, True): _KL,
    (2, 10, 2, True, False): _ILQG, (2, 10, 2, True, True): _KL,
    (2, 10, 3, True, False): _ILQG, (2, 10, 3, True, True): _KL,
    (3, 6, 2, True, False): _ILQG,
    (3, 6, 2, True, True): ("full", "policy"),
}
# K1's instances of a lowered model (a descriptor with ``lanes`` set,
# csrc/lowered.cuh), which are Autodiff<Lowered>: (second order, GPS mode)
# -> {emission: the library's instance group (_build.LOWERED_GROUPS)}
LOWERED_K1 = {
    (False, False): {"gains": "k1", "full": "k1", "policy": "k1_gps"},
    (False, True): {"full": "k1_gps", "policy": "k1_gps"},
    (True, False): {"gains": "k1_so", "full": "k1_so"},
    (True, True): {"full": "k1_so_gps", "policy": "k1_so_gps"},
}
# K1's instances of a user's tiles without a descriptor, which are
# LoweredTiles (csrc/lowered.cuh): (second order, GPS mode) -> {emission:
# the library's instance group}
LOWERED_TILES_K1 = {
    (False, False): {"gains": "t1", "full": "t1", "policy": "t1_gps"},
    (False, True): {"full": "t1_gps", "policy": "t1_gps"},
    (True, False): {"gains": "t1_so", "full": "t1_so"},
    (True, True): {"full": "t1_so_gps", "policy": "t1_so_gps"},
}
# the second-order (full DDP) instances, keyed as CUDA_BACKWARD: the
# analytic PendCartSO (csrc/pendcart.cuh) and Autodiff<PendCart, true>,
# Autodiff<Quadrotor, true>, Autodiff<LTI, true> and Autodiff<PendCartParam,
# true>, in the modes the fleet entries launch
CUDA_BACKWARD_SO = {
    (1, 4, 1, False, False): _ILQG, (1, 4, 1, False, True): _KL,
    (1, 4, 1, True, False): _ILQG, (1, 4, 1, True, True): _KL,
    (3, 6, 2, True, False): _ILQG, (3, 6, 2, True, True): _KL,
    (2, 10, 2, True, False): _ILQG, (2, 10, 2, True, True): _KL,
    (2, 10, 3, True, False): _ILQG, (2, 10, 3, True, True): _KL,
    (4, 4, 1, True, False): _ILQG,
}
# the instances built in the sources library (_build.sources_library) at
# their first launch, not in the kernel library: (second order, key of
# CUDA_BACKWARD_SO or CUDA_BACKWARD) of Autodiff<LTI> at ⟨10,2⟩ and ⟨10,3⟩
# and of Autodiff<Quadrotor, true> in GPS mode
SOURCE_LIBRARY_K1 = frozenset(
    [(so, (2, 10, m, True, gps)) for so in (False, True) for m in (2, 3)
     for gps in (False, True)] + [(True, (3, 6, 2, True, True))])
# the packed-derivatives instances (csrc/packed.cuh) of the kernel
# library, keyed by (n, m, GPS mode) alone: the model does not enter K1 in
# that mode. At any other (n, m) with m up to the ceiling
# plan.MAX_CONTROLS the "gains" and "full" instances without GPS mode are a
# library of their own, built at their first launch for that m
# (_build.packed_library; the kernel library's bound MAX_M = 4 is its
# own); the GPS and "policy" instances are not built
CUDA_PACKED = {
    (4, 1, False): ("gains", "full"), (4, 1, True): ("full",),
    (6, 2, False): ("gains", "full"), (10, 2, False): ("gains", "full"),
}
PACKED_ANY = ("gains", "full")
# the packed stream's descriptor: the launcher's model id 0, no constants
PACKED_ID = 0
PACKED_MODEL = DeviceModel(PACKED_ID, np.zeros(0, np.float32))


class BackwardLanesOut(NamedTuple):
    out: torch.Tensor     # (T, S, B), slots per OutLayout
    stats: torch.Tensor   # (4, B): dV1, dV2, diverged, diverge_idx


def _sum(terms):
    """Left-to-right sum from the first term, the order of the JAX kernels'
    Python ``sum``; of tensors of any one shape, each element alike."""
    it = iter(terms)
    s = next(it)
    for v in it:
        s = s + v
    return s


def _sqrt_rn(v):
    """The square root rounded to nearest, as the kernels' ``sqrtf`` and
    XLA's are. PyTorch's CPU ``sqrt`` is not on some vector lanes (0.72%
    of f32 inputs, ``tools_torch/m3_diagnose.py``), and the m > 2 box QP's
    Cholesky pivots carry such an ulp into which candidate a solve takes;
    taken in f64 and rounded back, it is exact on every device."""
    return torch.sqrt(v.double()).to(v.dtype)


def _tiny_chol(Q, mm):
    """Unrolled Cholesky of an mm×mm list-matrix of tensors; returns (L, ok)
    with ok the all-leading-minors-positive flag, the reference's
    ``isposdef`` (JAX ``backward_kernel.py:122-141``). The pivot is
    sqrt(max(d, 1e-30))."""
    L = [[None] * mm for _ in range(mm)]
    ok = None
    for j in range(mm):
        d = Q[j][j]
        for p in range(j):
            d = d - L[j][p] * L[j][p]
        okj = d > 0
        ok = okj if ok is None else ok & okj
        Ljj = _sqrt_rn(torch.clamp_min(d, 1e-30))
        L[j][j] = Ljj
        for i in range(j + 1, mm):
            s = Q[i][j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s / Ljj
    return L, ok


def _tiny_chol_solve(L, b, mm):
    """Solve L·Lᵀ·x = b by forward and back substitution (JAX
    ``:144-158``)."""
    y = [None] * mm
    for i in range(mm):
        s = b[i]
        for p in range(i):
            s = s - L[i][p] * y[p]
        y[i] = s / L[i][i]
    x = [None] * mm
    for i in reversed(range(mm)):
        s = y[i]
        for p in range(i + 1, mm):
            s = s - L[p][i] * x[p]
        x[i] = s / L[i][i]
    return x


def _tiny_inv(Q, mm):
    """Inverse by Cholesky solves against the unit vectors (JAX
    ``_tiny_inv``, ``:161-170``); for m=1, (1/L)/L."""
    L, _ = _tiny_chol(Q, mm)
    cols = [_tiny_chol_solve(
        L, [torch.full_like(Q[0][0], 1.0 if i == j else 0.0)
            for i in range(mm)], mm) for j in range(mm)]
    return [[cols[j][i] for j in range(mm)] for i in range(mm)]


def _clip(x, lo, hi):
    """jnp.clip: NaN-keeping max, then min."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _guard(v):
    """v where |v| > 1e-30, else 1e-30 (the JAX kernel's det_s/a_s/c_s)."""
    return torch.where(torch.abs(v) > 1e-30, v, 1e-30)


def _boxqp_m2(Q, g, lo, hi):
    """Exact 2-D box QP by the 9 active sets, in the JAX order (JAX
    ``_boxqp_m2``, ``:184-235``): the unconstrained point, dim 0 at lo/hi
    with dim 1 free, dim 1 at lo/hi with dim 0 free, the four corners; each
    clipped, the first strict minimum kept, the running minimum NaN-keeping.
    The free set comes from the KKT gradient at the minimiser. Returns
    (x0, x1, free0, free1, ok)."""
    a, b, c = Q[0][0], Q[0][1], Q[1][1]
    g0, g1 = g[0], g[1]
    det = a * c - b * b
    det_s, a_s, c_s = _guard(det), _guard(a), _guard(c)

    def val(x0, x1):
        return (x0 * g0 + x1 * g1
                + 0.5 * (a * x0 * x0 + 2.0 * b * x0 * x1 + c * x1 * x1))

    cands = [((-g0 * c + g1 * b) / det_s, (g0 * b - g1 * a) / det_s)]
    for v0 in (lo[0], hi[0]):
        cands.append((v0, -(g1 + b * v0) / c_s))
    for v1 in (lo[1], hi[1]):
        cands.append((-(g0 + b * v1) / a_s, v1))
    for v0 in (lo[0], hi[0]):
        for v1 in (lo[1], hi[1]):
            cands.append((v0, v1))
    best = None
    for x0, x1 in cands:
        x0, x1 = _clip(x0, lo[0], hi[0]), _clip(x1, lo[1], hi[1])
        v = val(x0, x1)
        if best is None:
            best = [x0, x1, v]
        else:
            take = v < best[2]
            best = [torch.where(take, x0, best[0]),
                    torch.where(take, x1, best[1]), torch.minimum(v, best[2])]
    bx0, bx1 = best[0], best[1]
    gr0 = g0 + a * bx0 + b * bx1
    gr1 = g1 + b * bx0 + c * bx1
    f0 = ~(((bx0 <= lo[0]) & (gr0 > 0)) | ((bx0 >= hi[0]) & (gr0 < 0)))
    f1 = ~(((bx1 <= lo[1]) & (gr1 > 0)) | ((bx1 >= hi[1]) & (gr1 < 0)))
    # a lane with both controls clamped is OK whatever QuuF is (JAX :231-234)
    ok = ((f0 & f1 & (a > 0) & (det > 0)) | (f0 & ~f1 & (a > 0))
          | (~f0 & f1 & (c > 0)) | (~f0 & ~f1))
    return bx0, bx1, f0, f1, ok


def _boxqp_masked(H, g, lo, hi, x0, mm, n_iter):
    """Fixed-iteration masked projected-Newton box QP on lists of (B,)
    tensors, line for line JAX ``_boxqp_masked`` (``:238-320``; reference
    ``src/boxQP.jl:71-165``): from x0 clipped to the box, each iteration
    finds the KKT free set (``src/boxQP.jl:92-94``), factors H on it (the
    clamped rows and columns replaced by the identity's), takes the Newton
    step on the free dimensions and keeps the best of α ∈ {1, ½, ¼} clipped
    to the box by a strict <, the running minimum NaN-keeping. Every sum
    runs in JAX's order, Python ``sum`` from 0 included.

    Returns ``(x, free, L, ok)``: the solution, the final free set, its
    Cholesky factor (for the gain solve) and the PD flag, latched False by
    any failed factorisation and, with ``n_iter > 0``, by a last iteration
    that found no descent while the free gradient is still far from the KKT
    point (the reference's ``result=0``)."""
    def val(x):
        v = sum(x[i] * g[i] for i in range(mm))
        for i in range(mm):
            for j in range(mm):
                v = v + 0.5 * x[i] * H[i][j] * x[j]
        return v

    def kkt_free(x, grad):
        return [~(((x[i] <= lo[i]) & (grad[i] > 0))
                  | ((x[i] >= hi[i]) & (grad[i] < 0))) for i in range(mm)]

    def gradient(x):
        return [g[i] + sum(H[i][j] * x[j] for j in range(mm))
                for i in range(mm)]

    def masked_chol(free):
        Hm = [[torch.where(free[i] & free[j], H[i][j], 0.0)
               + (torch.where(free[i], 0.0, 1.0) if i == j else 0.0)
               for j in range(mm)] for i in range(mm)]
        return _tiny_chol(Hm, mm)

    x = [_clip(x0[i], lo[i], hi[i]) for i in range(mm)]
    ok = torch.zeros_like(g[0]) < 1.0
    improved = None                  # did the last iteration descend?
    for _ in range(n_iter):
        grad = gradient(x)
        free = kkt_free(x, grad)
        L, okc = masked_chol(free)
        ok = ok & okc
        gf = [torch.where(free[i], grad[i], 0.0) for i in range(mm)]
        dx = _tiny_chol_solve(L, [-v for v in gf], mm)
        dx = [torch.where(free[i], dx[i], 0.0) for i in range(mm)]
        vb = val(x)
        xb = x
        improved = torch.zeros_like(g[0]) > 1.0
        for a in (1.0, 0.5, 0.25):
            xc = [_clip(x[i] + a * dx[i], lo[i], hi[i]) for i in range(mm)]
            vc = val(xc)
            take = vc < vb
            improved = improved | take
            xb = [torch.where(take, xc[i], xb[i]) for i in range(mm)]
            vb = torch.minimum(vc, vb)
        x = xb
    grad = gradient(x)
    free = kkt_free(x, grad)
    L, okf = masked_chol(free)
    ok = ok & okf
    if improved is not None:
        gf2 = sum(torch.where(free[i], grad[i], 0.0) ** 2 for i in range(mm))
        g2 = sum(g[i] * g[i] for i in range(mm))
        ok = ok & ~((gf2 > 1e-6 * (g2 + 1e-30)) & ~improved)
    return x, free, L, ok


def _gain_solve(QuuF, Qu, Qux_r, u, lims, m, warm=None, qp_iters=8):
    """k (m) and K (m rows of (n, B)), and the PD flag, not yet zeroed on
    failing lanes (JAX ``:513-568``). ``QuuF`` and ``Qu`` are lists of (B,)
    tensors, ``Qux_r`` a list of m (n, B) rows, whose n columns are solved
    at once (each element by the same operations as alone). ``lims``:
    None, or the per-control (lo, hi) of :func:`~.forward_kernel.bounds`,
    floats or per-scenario (B,) tensors. ``warm``: at m > 2 with limits,
    the box QP's start (the sanitised k of step t+1); ``qp_iters`` its
    iterations."""
    if lims is None:
        # unconstrained: the unrolled Cholesky solve (:514-522)
        L, ok = _tiny_chol(QuuF, m)
        k = _tiny_chol_solve(L, [-v for v in Qu], m)
        return k, _tiny_chol_solve(L, [-r for r in Qux_r], m), ok
    lo = [lims[0][mi] - u[mi] for mi in range(m)]
    hi = [lims[1][mi] - u[mi] for mi in range(m)]
    if m == 1:
        # closed-form box QP, limits relative to u_t (:173-181, :523-531)
        q = QuuF[0][0]
        xq = _clip(-Qu[0] / q, lo[0], hi[0])
        grad = Qu[0] + q * xq
        clamped = ((xq <= lo[0]) & (grad > 0)) | ((xq >= hi[0]) & (grad < 0))
        quu_s = _guard(q)
        return [xq], [torch.where(clamped, 0.0, -Qux_r[0] / quu_s)], q > 0
    if m == 2:
        # the 9-set enumeration and its K rows (:532-551)
        x0, x1, f0, f1, ok = _boxqp_m2(QuuF, Qu, lo, hi)
        both = f0 & f1
        a, b, c = QuuF[0][0], QuuF[0][1], QuuF[1][1]
        det_s, a_s, c_s = _guard(a * c - b * b), _guard(a), _guard(c)
        q0, q1 = Qux_r[0], Qux_r[1]
        kb0 = (-q0 * c + q1 * b) / det_s
        kb1 = (q0 * b - q1 * a) / det_s
        return [x0, x1], [
            torch.where(both, kb0, torch.where(f0, -q0 / a_s, 0.0)),
            torch.where(both, kb1, torch.where(f1, -q1 / c_s, 0.0))], ok
    # m > 2: the masked projected-Newton box QP from the warm start, and K
    # solved on its final free subspace (:552-568)
    k, free, Lq, ok = _boxqp_masked(QuuF, Qu, lo, hi, warm, m, qp_iters)
    cols = _tiny_chol_solve(Lq, [torch.where(free[mi], -Qux_r[mi], 0.0)
                                 for mi in range(m)], m)
    return k, [torch.where(free[mi], cols[mi], 0.0) for mi in range(m)], ok


def _read_kl(prev, eta, t, n, m):
    """GPS mode at step t: the dual η (0 replaced by 1, JAX
    ``backward_kernel.py:795-797``) and the KL expansion from the
    previous-policy stream [k_prev(m), K_prev(m·n), Σ⁻¹_prev(m²)]
    (``read_kl``, ``:370-392``), each sum over a control in the JAX order:
    Sik = Σ⁻¹k, SiK = Σ⁻¹K, cx_i = Σ_mi K[mi][i]·Sik[mi], cu = -Sik,
    cxx_ij = Σ_mi K[mi][i]·SiK[mi][j], cxu = -SiK, cuu = Σ⁻¹; as tensors
    (cx (n, B), cxx (n, n, B), cxu (m, n, B), Σ⁻¹ (m, m, B))."""
    e = eta[t]
    B = prev.shape[-1]
    kp = prev[t, :m]
    Kp = prev[t, m:m + m * n].reshape(m, n, B)
    Si = prev[t, m + m * n:].reshape(m, m, B)
    M = range(m)
    Sik = _sum(Si[:, mj] * kp[mj] for mj in M)
    SiK = _sum(Si[:, mj, None] * Kp[mj][None] for mj in M)
    return dict(
        eta=torch.where(e == 0, 1.0, e),
        cx=_sum(Kp[mi] * Sik[mi] for mi in M), cu=-Sik,
        cxx=_sum(Kp[mi][:, None] * SiK[mi][None] for mi in M),
        cxu=-SiK, cuu=Si)


def _stack(v, shape, B):
    """A tile field (a tensor, or nested lists of (B,) tensors) as one
    (*shape, B) tensor."""
    from .pack import _flat
    if isinstance(v, torch.Tensor) and v.dim() == len(shape) + 1:
        return v
    return torch.stack([torch.broadcast_to(e, (B,)) for e in _flat(v)]
                       ).reshape(tuple(shape) + (B,))


def _lists(a):
    """An (m, m, B) tensor as m lists of m (B,) views."""
    return [[a[i, j] for j in range(a.shape[1])] for i in range(a.shape[0])]


def backward_lanes_ref(traj, lam, *, n: int, m: int, reg_type: int, lims,
                       derivs_tiles: Optional[Callable], prev=None, eta=None,
                       params=None, lims_lanes=None, emit: str = "full",
                       qp_iters: int = 8) -> BackwardLanesOut:
    """Plain version of :func:`backward_lanes` (same arguments; ``eta`` is
    (T, B)). Every element's sum runs in the JAX kernel's order
    (``:450-600``), from its first term; the elements of a product are
    formed together, as (…, B) tensors, one term of the sum at a time."""
    T, B = traj.shape[0], traj.shape[2]
    lay = OutLayout(n, m, emit)
    gps = prev is not None
    out = torch.empty((T, lay.S, B), dtype=traj.dtype, device=traj.device)
    R, M = range(n), range(m)
    par = par_args(params)
    lim = (None if lims is None and lims_lanes is None
           else bounds(lims, m, lims_lanes))
    ts = step_indices(T, traj.device)
    lay_in = InLayout(n, m)

    def step(t):
        """The expansion of step t as tensors (fx (n, n, B), fu (n, m, B),
        cx (n, B), cu (m, B), cxx (n, n, B), cxu (n, m, B), cuu (m, m, B),
        and fxx (n, n, n, B), fxu (n, n, m, B), fuu (n, m, m, B) for full
        DDP) and u (m, B): from the tiles at (x, u, t), or read from the
        packed stream."""
        if derivs_tiles is None:
            return ({f: traj[t, lay_in.offset(f):lay_in.offset(f)
                              + int(np.prod(lay_in.shape(f)))].reshape(
                                  lay_in.shape(f) + (B,))
                     for f in DERIV_FIELDS}, traj[t, lay_in.u:lay_in.DU])
        u = traj[t, n:n + m]
        d = derivs_tiles([traj[t, i] for i in R], [u[mi] for mi in M],
                         ts[t], *par)
        shapes = dict(fx=(n, n), fu=(n, m), cx=(n,), cu=(m,), cxx=(n, n),
                      cxu=(n, m), cuu=(m, m), fxx=(n, n, n), fxu=(n, n, m),
                      fuu=(n, m, m))
        return {f: _stack(v, shapes[f], B) for f, v in d.items()}, u

    # boundary t = T-1 (src/backward_pass.jl:97-99, 280-283): V = the cost
    # expansion, unscaled also in GPS mode; only the emitted Quu is
    # cuu/η + Σ⁻¹_prev there (JAX :418-429)
    d, _ = step(T - 1)
    Vx, Vxx = d["cx"], d["cxx"]
    zero = torch.zeros_like(traj[T - 1, 0])
    slots = [torch.zeros((m + m * n, B), dtype=traj.dtype,
                         device=traj.device)]
    if lay.Vx is not None:
        slots += [Vx, Vxx.reshape(n * n, B)]
    if lay.quu is not None:
        cuu = d["cuu"]
        if gps:
            kl = _read_kl(prev, eta, T - 1, n, m)
            cuu = cuu / kl["eta"] + kl["cuu"]
        slots += [cuu.reshape(m * m, B), _tiny_inv_t(cuu, m)]
    out[T - 1] = torch.cat(slots)
    dv1 = dv2 = div = divt = zero
    # m > 2 with limits: the box QP's warm start, the sanitised k of step
    # t+1, zero before the first solve (JAX :434-438, :647-650)
    warm = [zero] * m

    for t in range(T - 2, -1, -1):
        d, u = step(t)
        fx, fu, cx, cu = d["fx"], d["fu"], d["cx"], d["cu"]
        cxx, cxu, cuu = d["cxx"], d["cxu"], d["cuu"]

        # Q expansions (src/backward_pass.jl:103-123)
        Qx = cx + _sum(fx[a] * Vx[a] for a in R)
        Qu = cu + _sum(fu[a] * Vx[a] for a in R)
        W = _sum(Vxx[:, c, None] * fx[c][None] for c in R)
        U = _sum(Vxx[:, c, None] * fu[c][None] for c in R)
        Qxx = cxx + _sum(fx[a][:, None] * W[a][None] for a in R)
        Quu = cuu + _sum(fu[a][:, None] * U[a][None] for a in R)
        Qux = cxu.transpose(0, 1) + _sum(fu[a][:, None] * W[a][None]
                                         for a in R)

        if "fxx" in d:
            # full DDP: the dynamics Hessians contracted with V′ (Vx of
            # t+1), before the regularisation, so that reg_type 2's terms
            # inherit them (JAX :466-481)
            fxx, fxu, fuu = d["fxx"], d["fxu"], d["fuu"]
            Qxx = Qxx + _sum(Vx[a] * fxx[a] for a in R)
            Qux = Qux + _sum(Vx[a] * fxu[a].transpose(0, 1) for a in R)
            Quu = Quu + _sum(Vx[a] * fuu[a] for a in R)

        if gps:
            # GPS mode: Q terms scaled by 1/η plus the KL expansion, Quu
            # symmetrised, λ unused (src/backward_pass.jl:293-299; JAX
            # :483-497)
            kl = _read_kl(prev, eta, t, n, m)
            ie = 1.0 / kl["eta"]
            Qx = Qx * ie + kl["cx"]
            Qu = Qu * ie + kl["cu"]
            Qxx = Qxx * ie + kl["cxx"]
            Qux = Qux * ie + kl["cxu"]
            Quu_g = Quu * ie + kl["cuu"]
            Quu = 0.5 * (Quu_g + Quu_g.transpose(0, 1))
            Qux_r, QuuF = Qux, Quu
        # regularised gain matrices (src/backward_pass.jl:119-123)
        elif reg_type == 2:
            Qux_r = Qux + lam * _sum(fu[a][:, None] * fx[a][None]
                                     for a in R)
            QuuF = Quu + lam * _sum(fu[a][:, None] * fu[a][None] for a in R)
        else:
            Qux_r = Qux
            eye = torch.eye(m, dtype=torch.bool, device=traj.device)
            QuuF = Quu + torch.where(eye[:, :, None], lam, 0.0)

        k, K, ok = _gain_solve(_lists(QuuF), list(Qu), list(Qux_r), u, lim,
                               m, warm, qp_iters)
        # a non-PD lane gets zero gains; V keeps updating (JAX :570-572)
        k = [torch.where(ok, v, 0.0) for v in k]
        K = torch.stack([torch.where(ok, row, 0.0) for row in K])
        warm = k

        # value update with the unregularised terms (src/backward_pass.jl:63-72)
        Quu_k = _sum(Quu[:, mj] * k[mj] for mj in M)
        dv1 = dv1 + _sum([k[mi] * Qu[mi] for mi in M])
        dv2 = dv2 + 0.5 * _sum([k[mi] * Quu_k[mi] for mi in M])
        QuuK = _sum(Quu[:, mj, None] * K[mj][None] for mj in M)
        Vx = (Qx + _sum(K[mi] * (Quu_k[mi] + Qu[mi]) for mi in M)
              + _sum(Qux[mi] * k[mi] for mi in M))
        Vraw = (Qxx + _sum(K[mi][:, None] * QuuK[mi][None] for mi in M)
                + _sum(K[mi][:, None] * Qux[mi][None] for mi in M)
                + _sum(Qux[mi][:, None] * K[mi][None] for mi in M))
        Vxx = 0.5 * (Vraw + Vraw.transpose(0, 1))

        # divergence latch: t+1 of the first failing step, recursion goes on
        bad = (~ok).to(traj.dtype)
        newly = bad * (1.0 - div)
        divt = divt * (1.0 - newly) + newly * float(t + 1)
        div = torch.maximum(div, bad)

        slots = [torch.stack(k), K.reshape(m * n, B)]
        if lay.Vx is not None:
            slots += [Vx, Vxx.reshape(n * n, B)]
        if lay.quu is not None:
            slots += [Quu.reshape(m * m, B), _tiny_inv_t(Quu, m)]
        out[t] = torch.cat(slots)

    return BackwardLanesOut(out=out, stats=torch.stack([dv1, dv2, div, divt]))


def _tiny_inv_t(Q, m):
    """:func:`_tiny_inv` of an (m, m, B) tensor as (m·m, B) row-major: the
    m unit vectors solved at once, each column by the operations of its own
    solve."""
    L, _ = _tiny_chol(_lists(Q), m)
    e = torch.eye(m, dtype=Q.dtype, device=Q.device)[:, :, None].expand(
        m, m, Q.shape[-1])
    return torch.stack(_tiny_chol_solve(L, list(e), m)).reshape(m * m, -1)


def backward_lanes(traj: torch.Tensor, lam: torch.Tensor, *, n: int, m: int,
                   reg_type: int = 1, lims=None,
                   derivs_tiles: Optional[Callable] = None, prev=None,
                   eta=None, params=None, lims_lanes=None,
                   emit: str = "full", qp_iters: int = 8) -> BackwardLanesOut:
    """Run the backward pass over a stream. Two input modes (JAX
    ``backward_lanes``, ``:729-790``):

    - ``derivs_tiles=fn``: ``traj`` is (T, ≥n+m, B) with x in slots [0, n)
      and u in [n, n+m); derivatives are computed per step by ``fn``, with
      the dynamics Hessians of full DDP where ``fn`` returns ``fxx``,
      ``fxu`` and ``fuu``.
    - ``derivs_tiles=None``: ``traj`` is the packed-derivatives stream
      (T, D+m, B) of :func:`~.pack.pack_backward_inputs` (or a model's
      packed generator): the derivative stack in ``DerivLayout`` order,
      then u. It takes no ``params``: the model does not enter K1.

    - ``lam``: per-scenario λ (B,). ``lims``: static ``((lo, hi),) * m``,
      or None for the unconstrained solve; ``lims_lanes``: per-scenario
      limits (2m, B), slot order [lo_0, hi_0, ...], which replace ``lims``.
    - ``params``: (P, B) per-scenario parameters, passed to a
      ``derivs_tiles`` with ``n_params == P``.
    - GPS mode (reference ``back_pass_gps``, ``src/backward_pass.jl:259-350``)
      when ``prev``/``eta`` are given: ``prev`` is the previous-policy stream
      (T, m+m·n+m², B) holding [k_prev, K_prev, Σ⁻¹_prev] and ``eta`` the
      per-step dual, (T, B) or (T, 1, B); a zero η counts as 1. λ is then
      unused.
    - ``emit``: ``"gains"``, ``"full"`` or ``"policy"`` (see
      :class:`OutLayout`).
    - ``qp_iters``: iterations of the m > 2 box QP (JAX's default 8); 0
      keeps the warm start clipped to the box.

    On a CUDA tensor the combination must be an instance the kernel is
    built for: :data:`CUDA_BACKWARD` (first-order tiles: model,
    derivative source, GPS mode, emission), :data:`CUDA_BACKWARD_SO`
    (second-order tiles) or :data:`CUDA_PACKED` (the packed stream, by n,
    m and GPS mode; at any other (n, m) its ``"gains"`` and ``"full"``
    instances without GPS mode, built at their first launch where their
    ring fits), with m up to the ceiling ``plan.MAX_CONTROLS`` (a library
    generated for its m above the kernel library's ``MAX_M`` = 4). Every
    public derivative source (analytic, autodiff and full-DDP tiles of the
    pendcart, ``PendCartParam``, the LTI and the quadrotor) has the modes
    the fleet entries launch: ``"gains"`` and ``"full"`` without GPS mode,
    ``"policy"`` in it (but ``PendCartParam``, whose KL entry takes no
    params). Where the lane design's ring does not fit a block
    (``plan.backward_plan`` gives ``tc == 0``) every first-order input runs
    the wide design, in every mode, up to ``plan.MAX_STATES``. Anything
    else raises NotImplementedError before anything is lowered, built or
    launched: GPS ``"gains"``, a descriptor's ``"policy"`` without GPS mode
    where the tables lack it, the packed stream's GPS mode beyond ⟨4,1⟩
    ``"full"``, and second order in the wide design. Autodiff
    tiles of a model without a descriptor run ``Autodiff<Lowered>`` from
    the model's lowering (:mod:`.lower`, :data:`LOWERED_K1`), and a user's
    tiles without a descriptor run ``LoweredTiles``, their own expansion
    lowered (:data:`LOWERED_TILES_K1`), each built at its first launch. The
    tiles (and the model) get the logical step t = 0…T-1 on every path.
    """
    check_lims(m, lims)
    if qp_iters < 0:
        raise ValueError(f"qp_iters={qp_iters}: at least 0")
    if emit not in EMIT_CODE:
        raise ValueError(f"emit={emit!r}: one of {tuple(EMIT_CODE)}")
    if reg_type not in (1, 2):
        raise ValueError(f"reg_type must be 1 or 2, got {reg_type}")
    T, S_in, B = traj.shape
    packed = derivs_tiles is None
    DU = InLayout(n, m).DU
    if packed and S_in != DU:
        raise ValueError(
            f"backward_lanes: a packed-derivatives stream of {S_in} slots; "
            f"at n={n}, m={m} it holds D+m = {DU} (DerivLayout, then u)")
    if T < 2 or S_in < n + m or lam.shape != (B,):
        raise ValueError(f"backward_lanes: traj {tuple(traj.shape)}, "
                         f"lam {tuple(lam.shape)}")
    check_lanes("backward_lanes", getattr(derivs_tiles, "n_params", 0), m, B,
                params, lims_lanes)
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
                                  prev=prev, eta=eta, params=params,
                                  lims_lanes=lims_lanes, emit=emit,
                                  qp_iters=qp_iters)
    check_size(n, m, "backward_lanes")
    plan = backward_plan(n, m, gps, emit, T, B, packed=packed)
    if plan.tc == 0:
        return _backward_wide(traj, lam, n, m, reg_type, lims, derivs_tiles,
                              prev, eta, params, lims_lanes, emit, qp_iters,
                              plan)
    gps_t = (prev, eta) if gps else ()
    group = tiles_low = library = None      # library: a loader, or None
    if packed:
        dm = PACKED_MODEL
        if (n, m, gps) in CUDA_PACKED:
            if emit not in CUDA_PACKED[(n, m, gps)]:
                raise NotImplementedError(
                    f"backward_lanes: no CUDA kernel (K1 instance) is built "
                    f"for the packed-derivatives stream at n={n}, m={m}, "
                    f"{'in' if gps else 'without'} GPS mode, emit={emit!r}; "
                    f"built (n, m, GPS): {CUDA_PACKED}")
        elif gps or emit not in PACKED_ANY:
            raise NotImplementedError(
                f"backward_lanes: the packed-derivatives stream at n={n}, "
                f"m={m} runs on the card in {PACKED_ANY} emission without "
                f"GPS mode (and the sizes {CUDA_PACKED}); not "
                f"{'in' if gps else 'without'} GPS mode, emit={emit!r}")
        else:
            library = lambda: _build.packed_library(n, m)
    elif getattr(derivs_tiles, "device", None) is None:
        # a user's tiles: their lowering, K1's analytic expansion
        from .lower import LOWERED_TILES_ID, lower_tiles
        tiles_low = lower_tiles(derivs_tiles, n, m)
        so = tiles_low.second_order
        dm = DeviceModel(LOWERED_TILES_ID, tiles_low.consts,
                         second_order=so)
        group = LOWERED_TILES_K1.get((so, gps), {}).get(emit)
        if group is None:
            raise NotImplementedError(
                f"backward_lanes: a user's lowered tiles' K1 "
                f"({'second-order' if so else 'first-order'}, "
                f"{'in' if gps else 'without'} GPS mode) has no "
                f"emit={emit!r} instance; built: {LOWERED_TILES_K1}")
    else:
        dm = derivs_tiles.device
        so = dm.second_order
        table = CUDA_BACKWARD_SO if so else CUDA_BACKWARD
        if dm.lanes is not None:
            group = LOWERED_K1.get((so, gps), {}).get(emit)
            if group is None:
                raise NotImplementedError(
                    f"backward_lanes: a lowered model's K1 "
                    f"({'second-order' if so else 'first-order'}, "
                    f"{'in' if gps else 'without'} GPS mode) has no "
                    f"emit={emit!r} instance; built: {LOWERED_K1}")
        elif emit not in table.get(key := (dm.model_id, n, m, dm.autodiff,
                                           gps), ()):
            raise NotImplementedError(
                f"backward_lanes: no CUDA kernel (K1 instance) is built for "
                f"model id {dm.model_id} at n={n}, m={m} with "
                f"{'autodiff' if dm.autodiff else 'analytic'} "
                f"{'second-order' if so else 'first-order'} derivatives, "
                f"{'in' if gps else 'without'} GPS mode, emit={emit!r}; "
                f"built (model id, n, m, autodiff, GPS): {sorted(table)}")
        elif (so, key) in SOURCE_LIBRARY_K1:
            library = _build.sources_library
    lib, dev, stream, _keep, model_args = cuda_args(
        dm, "backward_lanes", n, m, lims, lims_lanes, params, traj, lam,
        *gps_t, models=None if packed else CUDA_MODELS, group=group,
        tiles=tiles_low, library=library)
    S = OutLayout(n, m, emit).S
    out = torch.empty((T, S, B), dtype=torch.float32, device=traj.device)
    stats = torch.empty((4, B), dtype=torch.float32, device=traj.device)
    rc = lib.ddp_backward_lanes(
        traj.data_ptr(), S_in, lam.data_ptr(),
        prev.data_ptr() if gps else None, eta.data_ptr() if gps else None,
        out.data_ptr(), S, stats.data_ptr(), T, B, EMIT_CODE[emit], reg_type,
        int(lims is not None or lims_lanes is not None), *model_args,
        int(dm.autodiff), int(dm.second_order), int(qp_iters),
        *plan.launcher_args(), dev, stream)
    _build.check(lib, rc, "backward_lanes")
    backward_lanes.launches += 1
    return BackwardLanesOut(out=out, stats=stats)


backward_lanes.launches = 0
backward_lanes.wide_launches = 0


def _wide_stream(tiles, traj, n: int, m: int, params) -> torch.Tensor:
    """The wide K1's input: the packed-derivatives stream (T, D+m, B) of
    ``tiles`` evaluated with torch on the trajectory's (T, B) x and u
    slices (:func:`~.pack.stack_tiles`; elementwise, so each element has
    the bits of the plain version's per-step evaluation). Second-order
    tiles raise NotImplementedError: the wide design has no full DDP."""
    T = traj.shape[0]
    x = [traj[:, i] for i in range(n)]
    u = [traj[:, n + mi] for mi in range(m)]
    t = torch.arange(T, dtype=torch.int32, device=traj.device)[:, None]
    d = tiles(x, u, t, *par_args(params))
    if "fxx" in d:
        raise NotImplementedError(_wide_so(n, m))
    return stack_tiles(d, u, n, m)


def _wide_so(n: int, m: int) -> str:
    return (f"backward_lanes: second-order tiles (full DDP) at n={n}, m={m}: "
            "the lane design's ring does not fit a block at this size, and "
            "the wide K1 (csrc/backward_wide.cuh) takes first-order "
            "derivatives only, in every mode; second order runs in the lane "
            "design's sizes, in the modes of CUDA_BACKWARD_SO, "
            "LOWERED_K1 and LOWERED_TILES_K1")


def _backward_wide(traj, lam, n, m, reg_type, lims, derivs_tiles, prev, eta,
                   params, lims_lanes, emit, qp_iters,
                   plan) -> BackwardLanesOut:
    """K1's wide design on CUDA tensors (``plan.tc == 0``): the packed
    stream as given, or formed from the tiles (:func:`_wide_stream`), then
    one launch of ``csrc/backward_wide.cuh``."""
    dm = getattr(derivs_tiles, "device", None)
    if dm is not None and dm.second_order:
        raise NotImplementedError(_wide_so(n, m))
    per_lane = [v for v in (prev, eta, lims_lanes) if v is not None]
    dev, stream = launch_device("backward_lanes", traj, lam, *per_lane)
    dp = (traj if derivs_tiles is None
          else _wide_stream(derivs_tiles, traj, n, m, params))
    T, B = traj.shape[0], traj.shape[2]
    S = OutLayout(n, m, emit).S
    out = torch.empty((T, S, B), dtype=torch.float32, device=traj.device)
    stats = torch.empty((4, B), dtype=torch.float32, device=traj.device)
    lim = lims_host(lims, m)
    lib = _build.wide_library()
    rc = lib.ddp_backward_wide(
        dp.data_ptr(), dp.shape[1], lam.data_ptr(), _ptr(prev), _ptr(eta),
        out.data_ptr(), S, stats.data_ptr(), T, B, EMIT_CODE[emit],
        reg_type, int(lims is not None or lims_lanes is not None),
        lim.ctypes.data, _ptr(lims_lanes), n, m, int(qp_iters),
        plan.blocks, plan.threads, plan.smem, dev, stream)
    _build.check(lib, rc, "backward_lanes")
    backward_lanes.launches += 1
    backward_lanes.wide_launches += 1
    return BackwardLanesOut(out=out, stats=stats)


def backward_pass_pallas(derivs: Derivs, u: torch.Tensor, lam: torch.Tensor,
                         reg_type: int = 1, lims=None,
                         use_limits: bool = False, k_t: int = 8, eta=None,
                         traj_prev: Optional[GaussianPolicy] = None,
                         interpret: bool = False,
                         qp_iters: int = 8) -> BackwardOut:
    """Batch-major wrapper of K1 in packed mode, the parity interface with
    :func:`~..backward.backward_pass` over B problems (JAX ``:852-924``).

    ``derivs``: (B, T, ...) first-order leaves; ``u``: (B, T, m); ``lam``:
    (B,). ``lims`` ((m, 2), used with ``use_limits``). GPS mode: pass
    ``traj_prev`` (leaves (B, T, ...)) and ``eta``, (B,) or (B, T). Packs
    the streams, runs K1 in ``"full"`` emission and unpacks; ``qp_iters``
    as :func:`backward_lanes` (the JAX wrapper keeps its kernel's default
    8). ``k_t`` and ``interpret`` are the TPU kernel's switches and have no
    effect here: one thread walks the whole horizon."""
    B, T, m = u.shape
    n = derivs.cx.shape[-1]
    f32 = torch.float32
    lims_t = (tuple((float(lo), float(hi)) for lo, hi in
                    torch.as_tensor(lims, dtype=f32).tolist())
              if use_limits else None)
    gps = {}
    if traj_prev is not None:
        eta = torch.as_tensor(eta, dtype=f32, device=u.device)
        if eta.ndim == 1:
            eta = eta[:, None].expand(B, T)
        gps = dict(prev=to_streams(torch.cat(
            [traj_prev.k.to(f32), traj_prev.K.to(f32).reshape(B, T, -1),
             traj_prev.sigma_inv.to(f32).reshape(B, T, -1)], dim=-1)),
            eta=eta.T.contiguous())
    res = backward_lanes(pack_backward_inputs(derivs, u, B),
                         lam.to(f32).contiguous(), n=n, m=m,
                         reg_type=reg_type, lims=lims_t, emit="full",
                         qp_iters=qp_iters, **gps)
    lay = OutLayout(n, m)
    o = res.out

    def take(off, size, shape):
        return from_streams(o[:, off:off + size], shape)

    return BackwardOut(
        diverged=res.stats[2] > 0.5,
        diverge_idx=res.stats[3].to(torch.int32),
        policy=GaussianPolicy(K=take(lay.K, m * n, (m, n)),
                              k=take(lay.k, m, (m,)),
                              sigma=take(lay.quui, m * m, (m, m)),
                              sigma_inv=take(lay.quu, m * m, (m, m))),
        Vx=take(lay.Vx, n, (n,)), Vxx=take(lay.Vxx, n * n, (n, n)),
        dV=res.stats[:2].T)
