"""Linear (LTI) benchmark problem family: the lane pieces and the Problem.

Counterpart of ``differentialdynamicprogramming_jl_tpu/models/linear.py``
(``LTISpec`` ``:20-26``, ``random_lti`` ``:29-43``, ``make_lti_problem``
``:46-76``, ``lti_lanes`` ``:79-121``, ``lti_packed_derivs`` ``:124-157``,
``lti_derivs_tiles`` ``:160-197``,
``SimpleLTVModel`` ``:200-233``):
the reference's ``demo_linear`` problem (``src/demo_linear.jl:9-49``),
x' = A·x + B·u with the cost ½x'Qx + ½u'Ru and no terminal term.

The lane functions keep the JAX package's zero-skipping rule: every term
whose constant is exactly 0 is left out, each sum starts at its first
non-zero term, and ½·Q[i,j] is formed before it multiplies x[i]·x[j]. A
dense sum would differ where 0·Inf gives NaN (an overflowing lane) and in
the sign of a zero.

Both lane objects carry a device-model descriptor where the kernel library
holds the hand-written LTI at their (n, m) (⟨10,2⟩ and ⟨10,3⟩,
``forward_kernel.CUDA_MODELS``): model id 2 and the f32 constants
``[A (n·n), B (n·m), Q (n·n), R (m·m)]`` row-major, from which the CUDA
kernels (``ops/hopper/csrc/lti.cuh``) evaluate the same model. At any other
size they carry none (``device=None``), and on CUDA tensors the kernels run
their lowering (``ops/hopper/lower.py``): K2 and K3 the lowered model, K1
the lowered tiles (``LoweredTiles``) or ``Autodiff<Lowered>``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..device import as_tensor, resolve
from ..ops.hopper.backward_kernel import DerivsTiles
from ..ops.hopper.forward_kernel import CUDA_MODELS, DeviceModel, LanesModel
from ..ops.hopper.pack import packed_from_tiles
from ..policy import Derivs
from ..problem import Problem, broadcast_derivs
from ..utils.aot import factory

MODEL_ID = 2   # csrc/lti.cuh: MODEL_LTI


class LTISpec(NamedTuple):
    A: torch.Tensor    # (n, n) discrete dynamics
    B: torch.Tensor    # (n, m)
    Q: torch.Tensor    # (n, n) state cost
    R: torch.Tensor    # (m, m) control cost
    x0: torch.Tensor   # (n,)
    u0: torch.Tensor   # (T, m)


def random_lti(key: Union[int, torch.Generator] = 0, n: int = 10, m: int = 2,
               T: int = 1000, h: float = 0.01, dtype=torch.float32,
               device=None) -> LTISpec:
    """Random stable LTI problem by the reference's construction
    (``src/demo_linear.jl:9-26``): ``A = expm(h(M - Mᵀ))`` (skew-symmetric,
    so A is orthogonal), ``B = h·randn``, ``Q = h·I``, ``R = 0.1h·I``,
    ``x0 = 1``, ``u0 = 0.1·randn``.

    ``key``: a seed or a ``torch.Generator``. The draws and the matrix
    exponential are made in f64 on the host, then cast to ``dtype`` on
    ``device`` (None: the CUDA card). The random bits differ from the JAX
    package's ``PRNGKey``."""
    gen = (key if isinstance(key, torch.Generator)
           else torch.Generator().manual_seed(int(key)))
    f64 = torch.float64
    M = torch.randn((n, n), generator=gen, dtype=f64)
    A = torch.linalg.matrix_exp(h * (M - M.T))
    B = h * torch.randn((n, m), generator=gen, dtype=f64)
    u0 = 0.1 * torch.randn((T, m), generator=gen, dtype=f64)
    dev = resolve(device)
    return LTISpec(*(a.to(dtype=dtype, device=dev) for a in (
        A, B, h * torch.eye(n, dtype=f64), 0.1 * h * torch.eye(m, dtype=f64),
        torch.ones(n, dtype=f64), u0)))


@factory
def make_lti_problem(spec: LTISpec, T: int,
                     use_autodiff: bool = False) -> Problem:
    """The :class:`~..problem.Problem` of an LTI spec, its functions
    broadcasting over leading batch dimensions, on the spec's device.

    Dynamics ``x' = Ax + Bu`` (``src/demo_linear.jl:42-45``); cost
    ``0.5 x'Qx + 0.5 u'Ru`` (``:49``); analytic derivatives that broadcast
    the time-invariant ``(A, B, Q, R)`` to ``(T, ...)`` (``:35-41``);
    ``use_autodiff=True`` takes the autodiff derivatives instead
    (``derivs=None``, :func:`~..problem.make_autodiff_derivs`).
    """
    A, Bm, Q, R = spec.A, spec.B, spec.Q, spec.R
    n, m = Bm.shape

    def dynamics(x, u, t):
        return x @ A.T + u @ Bm.T

    def cost(x, u, t):
        return 0.5 * ((x * (x @ Q.T)).sum(-1) + (u * (u @ R.T)).sum(-1))

    def zeros(*shape):
        return torch.zeros(shape, dtype=A.dtype, device=A.device)

    base = broadcast_derivs(T, fx=A, fu=Bm, cx=zeros(n), cu=zeros(m),
                            cxx=Q, cxu=zeros(n, m), cuu=R)

    def derivs(x_traj, u_traj):
        """Derivatives along (..., T, n), (..., T, m) trajectories."""
        lead = tuple(u_traj.shape[:-2])

        def ex(a):
            return a.expand(lead + tuple(a.shape))

        return Derivs(fx=ex(base.fx), fu=ex(base.fu),
                      cx=x_traj[..., :T, :] @ Q.T, cu=u_traj @ R.T,
                      cxx=ex(base.cxx), cxu=ex(base.cxu), cuu=ex(base.cuu))

    return Problem(dynamics=dynamics, cost=cost,
                   derivs=None if use_autodiff else derivs)


def _f32(spec: LTISpec):
    return tuple(np.asarray(a.detach().cpu(), np.float32)
                 for a in (spec.A, spec.B, spec.Q, spec.R))


def device_model(spec: LTISpec) -> DeviceModel:
    return DeviceModel(model_id=MODEL_ID, consts=np.concatenate(
        [a.ravel() for a in _f32(spec)]).astype(np.float32))


def _built_device(spec: LTISpec) -> Optional[DeviceModel]:
    """The descriptor where the kernel library holds the hand-written LTI
    at the spec's (n, m), else None (the lowering runs)."""
    n, m = spec.B.shape
    return device_model(spec) if (MODEL_ID, n, m) in CUDA_MODELS else None


def _lincomb(M: np.ndarray, vec, zero):
    """Row i: Σ_j M[i,j]·vec[j] over the non-zero M[i,j] only, starting at
    the first such term; ``zero`` for a row without one."""
    out = []
    for i in range(M.shape[0]):
        s = None
        for j in range(M.shape[1]):
            if M[i, j] != 0.0:
                term = float(M[i, j]) * vec[j]
                s = term if s is None else s + term
        out.append(zero if s is None else s)
    return out


@factory
def lti_lanes(spec: LTISpec) -> LanesModel:
    """Lane model: dynamics and running cost on lists of per-scenario
    tensors with the zero-skipping rule, no terminal cost, and the
    device-model descriptor where one is built (else ``device=None``)."""
    A, Bm, Q, R = _f32(spec)
    n, m = Bm.shape
    AB = np.concatenate([A, Bm], axis=1)

    def dynamics(x, u, t):
        return _lincomb(AB, list(x) + list(u), torch.zeros_like(x[0]))

    def cost(x, u, t):
        c = None
        for M, v in ((Q, x), (R, u)):
            for i in range(M.shape[0]):
                for j in range(M.shape[1]):
                    if M[i, j] != 0.0:
                        term = 0.5 * float(M[i, j]) * v[i] * v[j]
                        c = term if c is None else c + term
        return c

    return LanesModel(n=n, m=m, dynamics=dynamics, cost=cost, terminal=None,
                      device=_built_device(spec))


@factory
def lti_derivs_tiles(spec: LTISpec) -> DerivsTiles:
    """In-kernel derivatives: the constant A, B, Q, R, and cx = Q·x,
    cu = R·u with the zero-skipping rule; the descriptor as
    :func:`lti_lanes`'s."""
    A, Bm, Q, R = _f32(spec)
    n, m = Bm.shape

    def tiles(x, u, t):
        o = torch.ones_like(x[0])
        z = torch.zeros_like(o)

        def const(M):
            return [[float(v) * o if v != 0.0 else z for v in row]
                    for row in M]

        return dict(fx=const(A), fu=const(Bm), cx=_lincomb(Q, x, z),
                    cu=_lincomb(R, u, z), cxx=const(Q),
                    cxu=[[z] * m for _ in range(n)], cuu=const(R))

    return DerivsTiles(fn=tiles, device=_built_device(spec))


@factory
def lti_packed_derivs(spec: LTISpec):
    """K1's packed-derivatives generator: ``(x_s (T, n, B), u_s (T, m, B))
    → (T, D+m, B)`` (258 slots at ⟨10,2⟩), the tiles of
    :func:`lti_derivs_tiles` over the whole trajectory in ``DerivLayout``
    order with u appended: the constant A, B, Q, R broadcast, cx and cu
    with the zero-skipping rule."""
    n, m = spec.B.shape
    return packed_from_tiles(lti_derivs_tiles(spec), n, m)


@dataclasses.dataclass(frozen=True)
class SimpleLTVModel:
    """Linear time-varying model for covariance propagation, the JAX
    package's ``SimpleLTVModel`` (``LinearTimeVaryingModelsBase`` as
    ``forward_covariance`` uses it, ``src/forward_pass.jl:38-42``;
    ``src/demo_linear.jl:118``): ``fx`` and the prediction covariance
    ``R1`` (identity by default)."""

    fx: torch.Tensor                       # (T, n, n)
    fu: torch.Tensor                       # (T, n, m)
    R1: Optional[torch.Tensor] = None      # (n, n)

    def fx_at(self, x_traj=None, u_traj=None) -> torch.Tensor:
        """Linearisation along the trajectory (reference
        ``df(model, x, u)``, ``src/forward_pass.jl:38``), cut to the control
        horizon of ``u_traj`` (..., T, m)."""
        T = self.fx.shape[0] if u_traj is None else u_traj.shape[-2]
        return self.fx[:T]

    def covariance(self, x_traj=None, u_traj=None) -> torch.Tensor:
        if self.R1 is not None:
            return self.R1
        n = self.fx.shape[-1]
        return torch.eye(n, dtype=self.fx.dtype, device=self.fx.device)

    @staticmethod
    def from_lti(A, B, T: int) -> "SimpleLTVModel":
        """The constant A, B broadcast over T steps (views, no copies);
        tensors keep their device, anything else goes to the CUDA card."""
        A, B = as_tensor(A), as_tensor(B)
        return SimpleLTVModel(fx=A.expand((T,) + tuple(A.shape)),
                              fu=B.expand((T,) + tuple(B.shape)))
