"""Pendulum-on-a-cart swing-up: the lane pieces and the Problem.

Counterpart of ``differentialdynamicprogramming_jl_tpu/models/pendcart.py``
(``PendCartSpec``, ``make_pendcart_problem`` ``:53-158``,
``pendcart_lanes`` ``:161-195``, ``pendcart_packed_derivs`` ``:199-230``,
``pendcart_derivs_tiles`` ``:233-263``, ``pendcart_derivs_tiles_so``
``:267-290``, ``pendcart_lanes_param`` ``:295-328``,
``pendcart_derivs_tiles_param`` ``:332-359``, ``default_lims``,
``default_x0``, and the LQR baseline ``care``, ``lqr``,
``linearized_upright`` and ``simulate_pendcart`` ``:376-431``): the Euler
step of the reference dynamics (``src/system_pendcart.jl:75-89``), the diagonal quadratic cost with its
terminal term (``:92-106``) and the analytic Jacobians of the Euler step,
written as functions over per-dimension ``(B,)`` tensors. The plain kernel
versions call these directly.

The lane objects carry a device-model descriptor: model id 1 and the f32
constants ``[g, l, h, d, Q0..Q3, R, goal0..goal3]``, from which the CUDA
kernels (``ops/hopper/csrc/pendcart.cuh``) evaluate the same model. The
derived constants (-g/l, 1-h·d, Q/2, R/2) are formed in f32 from that
descriptor, here and on the card alike, so a kernel and its plain version
use the same bits. The ``_param`` variants (heterogeneous fleets) take the
pole length and damping per scenario, ``params = [l, d]``: model id 4
(``PendCartParam``), the same descriptor, and -g/l, 1-h·d formed per
scenario in the same f32 order, so that rows all equal to the spec's (l, d)
give the fixed model's bits. ``pendcart_packed_derivs`` stacks the same
tiles over a whole trajectory into K1's packed-derivatives stream, and
``pendcart_derivs_tiles_so`` adds the Euler step's two nonzero dynamics
Hessian entries (full DDP), its descriptor marked second order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..device import as_tensor, like, resolve
from ..ops.hopper.backward_kernel import DerivsTiles
from ..ops.hopper.forward_kernel import DeviceModel, LanesModel
from ..ops.hopper.pack import packed_from_tiles
from ..policy import Derivs
from ..problem import Problem
from ..utils.aot import factory

# reference constants (src/system_pendcart.jl:42-60)
GRAV = 9.82
POLE_LEN = 0.35
DT = 0.01
DAMP = 0.99
MODEL_ID = 1        # csrc/pendcart.cuh: PendCart
MODEL_ID_PARAM = 4  # csrc/pendcart.cuh: PendCartParam, params = [l, d]


@dataclasses.dataclass(frozen=True)
class PendCartSpec:
    Q: Tuple[float, ...] = (10.0, 1.0, 2.0, 1.0)   # state weights (diagonal)
    R: float = 1.0
    goal: Tuple[float, ...] = (np.pi, 0.0, 0.0, 0.0)
    g: float = GRAV
    l: float = POLE_LEN
    h: float = DT
    d: float = DAMP


def dynamics_continuous(x, u, spec: PendCartSpec):
    """xd = [θ̇, -g/l sinθ + u/l cosθ - d θ̇, ṗ, u]
    (src/system_pendcart.jl:75-80), on (..., 4) and (..., 1)."""
    return torch.stack([
        x[..., 1],
        -spec.g / spec.l * torch.sin(x[..., 0])
        + u[..., 0] / spec.l * torch.cos(x[..., 0]) - spec.d * x[..., 1],
        x[..., 3],
        u[..., 0],
    ], dim=-1)


@factory
def make_pendcart_problem(spec: PendCartSpec = PendCartSpec(),
                          derivs: str = "zoh", dtype=torch.float32,
                          device=None) -> Problem:
    """Build the pendcart :class:`~..problem.Problem`, its functions
    broadcasting over leading batch dimensions.

    ``derivs``: ``"zoh"`` — the reference's scheme: analytic continuous
    Jacobians, zero-order-hold discretised per step by the 5×5 matrix
    exponential ``expm([[fxc·h, fuc·h], [0, 0]])``
    (``src/system_pendcart.jl:137-154``), one batched
    ``torch.linalg.matrix_exp`` over the steps; ``"euler"`` — hand-written
    exact Jacobians of the Euler step (pure elementwise trig), in the JAX
    package's expression order; ``"autodiff"`` — the same Jacobians by
    autodiff of the Euler step (``derivs=None``,
    :func:`~..problem.make_autodiff_derivs`). ``device=None`` is the CUDA
    card.
    """
    if derivs not in ("zoh", "autodiff", "euler"):
        raise ValueError(f"unknown derivs scheme {derivs!r}")
    device = resolve(device)
    Q = torch.diag(torch.tensor(spec.Q, dtype=dtype, device=device))
    R = torch.tensor([[spec.R]], dtype=dtype, device=device)
    goal = torch.tensor(spec.goal, dtype=dtype, device=device)
    h, g, l, d = spec.h, spec.g, spec.l, spec.d

    def dynamics(x, u, t):
        """Euler step (``dfsys``, src/system_pendcart.jl:83-89)."""
        return x + h * dynamics_continuous(x, u, spec)

    def quad(a, M, b):
        return torch.einsum("...i,ij,...j->...", a, M, b)

    def cost(x, u, t):
        dx = x - goal
        return 0.5 * (quad(dx, Q, dx) + quad(u, R, u))

    def traj_cost(x_traj, u_traj):
        """Per-step costs with the reference's appended terminal evaluation
        at zero control (src/system_pendcart.jl:97-106): (..., T+1)."""
        dx = x_traj - goal
        c_run = 0.5 * (quad(dx, Q, dx) + quad(u_traj, R, u_traj))
        dT = x_traj[..., -1, :] - goal
        return torch.cat([c_run, (0.5 * quad(dT, Q, dT))[..., None]], dim=-1)

    def cost_derivs(x_traj, u_traj, fx, fu):
        T = u_traj.shape[-2]
        dxg = x_traj[..., :T, :] - goal
        lead = fx.shape[:-2]
        return Derivs(
            fx=fx, fu=fu, cx=dxg @ Q.T, cu=u_traj @ R.T,
            cxx=Q.expand(lead + (4, 4)),
            cxu=torch.zeros(lead + (4, 1), dtype=dtype, device=fx.device),
            cuu=R.expand(lead + (1, 1)))

    def zoh_fn(x_traj, u_traj):
        """ZoH-sampled continuous Jacobians along (..., T)."""
        T = u_traj.shape[-2]
        th = x_traj[..., :T, 0]
        u0 = u_traj[..., 0]
        M = torch.zeros(th.shape + (5, 5), dtype=dtype, device=th.device)
        M[..., 0, 1] = h
        M[..., 1, 0] = (-g / l * torch.cos(th) - u0 / l * torch.sin(th)) * h
        M[..., 1, 1] = -d * h
        M[..., 2, 3] = h
        M[..., 1, 4] = torch.cos(th) / l * h
        M[..., 3, 4] = h
        ABd = torch.linalg.matrix_exp(M)
        return cost_derivs(x_traj, u_traj, ABd[..., :4, :4], ABd[..., :4, 4:])

    def deriv_fn(x_traj, u_traj):
        """Exact Jacobians of the Euler step, elementwise along (..., T)."""
        T = u_traj.shape[-2]
        th = x_traj[..., :T, 0]
        u0 = u_traj[..., 0]
        a21 = h * (-g / l * torch.cos(th) - u0 / l * torch.sin(th))
        z = torch.zeros_like(th)
        o = torch.ones_like(th)
        hh = torch.full_like(th, h)
        dd = torch.full_like(th, 1.0 - h * d)
        # fx = I + h*fxc (rows [1,h,0,0; a21,1-hd,0,0; 0,0,1,h; 0,0,0,1])
        fx = torch.stack([
            torch.stack([o, hh, z, z], -1),
            torch.stack([a21, dd, z, z], -1),
            torch.stack([z, z, o, hh], -1),
            torch.stack([z, z, z, o], -1),
        ], -2)
        fu = torch.stack([z, h * torch.cos(th) / l, z, hh], -1)[..., None]
        return cost_derivs(x_traj, u_traj, fx, fu)

    return Problem(dynamics=dynamics, cost=cost,
                   derivs={"zoh": zoh_fn, "euler": deriv_fn}.get(derivs),
                   traj_cost=traj_cost)


def device_model(spec: PendCartSpec, param: bool = False) -> DeviceModel:
    """The descriptor; with ``param``, of the model whose l and d come per
    scenario from ``params`` (the descriptor's l and d are then unused)."""
    consts = np.asarray([spec.g, spec.l, spec.h, spec.d, *spec.Q, spec.R,
                         *spec.goal], np.float32)
    return DeviceModel(model_id=MODEL_ID_PARAM if param else MODEL_ID,
                       consts=consts)


class _Consts:
    """f32 constants of one spec, derived in f32 as the kernels derive them;
    held as Python floats (exact f32 values) for tensor arithmetic."""

    def __init__(self, dm: DeviceModel):
        c = dm.consts
        g, l, h, d = c[0], c[1], c[2], c[3]
        f = float
        self.g, self.l, self.h, self.d = f(g), f(l), f(h), f(d)
        self.ngl = f(-g / l)
        self.nhl = f(-(h / l))
        self.hd1 = f(np.float32(1.0) - h * d)
        self.Q = [f(q) for q in c[4:8]]
        self.halfQ = [f(np.float32(0.5) * q) for q in c[4:8]]
        self.R = f(c[8])
        self.halfR = f(np.float32(0.5) * c[8])
        self.goal = [f(v) for v in c[9:13]]

    def lane(self, par):
        """(l, d, -g/l, 1-h·d): the spec's, or per scenario from
        ``par = [[l, d]]`` (the model functions' trailing arguments),
        formed in f32 in PendCartParam's order. ``torch.div`` divides
        correctly rounded, where ``float / tensor`` multiplies by a
        reciprocal (on the card; see :func:`_over`)."""
        if not par:
            return self.l, self.d, self.ngl, self.hd1
        l, d = par[0]
        return l, d, -torch.div(self.g, l), 1.0 - self.h * d


def _over(a: torch.Tensor, l) -> torch.Tensor:
    """a / l correctly rounded on every device, as the kernels divide: on a
    CUDA tensor PyTorch divides by a Python number as a product with its
    reciprocal, which a long swing-up amplifies."""
    if not isinstance(l, torch.Tensor):
        l = a.new_full((), l)
    return torch.div(a, l)


def _lanes(spec: PendCartSpec, param: bool) -> LanesModel:
    dm = device_model(spec, param)
    k = _Consts(dm)

    def dynamics(x, u, t, *par):
        l, d, ngl, _ = k.lane(par)
        th, thd, p, pd = x
        f = u[0]
        thdd = ngl * torch.sin(th) + _over(f, l) * torch.cos(th) - d * thd
        return [th + k.h * thd, thd + k.h * thdd, p + k.h * pd, pd + k.h * f]

    def cost(x, u, t, *par):
        c = k.halfR * u[0] * u[0]
        for i in range(4):
            dx = x[i] - k.goal[i]
            c = c + k.halfQ[i] * dx * dx
        return c

    def terminal(x, *par):
        c = None
        for i in range(4):
            dx = x[i] - k.goal[i]
            term = k.halfQ[i] * dx * dx
            c = term if c is None else c + term
        return c

    return LanesModel(n=4, m=1, dynamics=dynamics, cost=cost,
                      terminal=terminal, device=dm, n_params=2 if param else 0)


def _derivs_tiles(spec: PendCartSpec, param: bool) -> DerivsTiles:
    dm = device_model(spec, param)
    k = _Consts(dm)

    def tiles(x, u, t, *par):
        l, _, ngl, hd1 = k.lane(par)
        th = x[0]
        u0 = u[0]
        z = torch.zeros_like(th)
        o = torch.ones_like(th)
        a21 = k.h * (ngl * torch.cos(th) - _over(u0, l) * torch.sin(th))
        fx = [[o, k.h * o, z, z],
              [a21, hd1 * o, z, z],
              [z, z, o, k.h * o],
              [z, z, z, o]]
        fu = [[z], [_over(k.h * torch.cos(th), l)], [z], [k.h * o]]
        cx = [k.Q[i] * (x[i] - k.goal[i]) for i in range(4)]
        cu = [k.R * u0]
        cxx = [[k.Q[i] * o if i == j else z for j in range(4)]
               for i in range(4)]
        cxu = [[z] for _ in range(4)]
        cuu = [[k.R * o]]
        return dict(fx=fx, fu=fu, cx=cx, cu=cu, cxx=cxx, cxu=cxu, cuu=cuu)

    return DerivsTiles(fn=tiles, device=dm, n_params=2 if param else 0)


@factory
@functools.lru_cache(maxsize=32)
def pendcart_lanes(spec: PendCartSpec = PendCartSpec()) -> LanesModel:
    """Lane model: dynamics, running cost and terminal cost on lists of
    per-scenario tensors, plus the device-model descriptor."""
    return _lanes(spec, param=False)


@factory
@functools.lru_cache(maxsize=32)
def pendcart_derivs_tiles(spec: PendCartSpec = PendCartSpec()) -> DerivsTiles:
    """In-kernel derivatives: the analytic Euler-step Jacobians and cost
    expansions at (x, u), so the backward pass streams only the
    trajectory."""
    return _derivs_tiles(spec, param=False)


@factory
@functools.lru_cache(maxsize=32)
def pendcart_packed_derivs(spec: PendCartSpec = PendCartSpec()):
    """K1's packed-derivatives generator: ``(x_s (T, 4, B), u_s (T, 1, B))
    → (T, 47, B)``, the analytic tiles of :func:`pendcart_derivs_tiles`
    over the whole trajectory in ``DerivLayout`` order with u appended
    (elementwise torch operations, the tiles' bits)."""
    return packed_from_tiles(_derivs_tiles(spec, param=False), 4, 1)


@factory
@functools.lru_cache(maxsize=32)
def pendcart_derivs_tiles_so(spec: PendCartSpec = PendCartSpec()
                             ) -> DerivsTiles:
    """Second-order tiles (full DDP): the tiles of
    :func:`pendcart_derivs_tiles` plus the Euler step's dynamics Hessians,
    ``fxx[a][i][j]``, ``fxu[a][j][mi]`` and ``fuu[a][mi][mj]``, zero but
    for f₁ = θ̇ + h·θ̈: ∂²f₁/∂θ² = h·(g/l·sinθ − u/l·cosθ) and ∂²f₁/∂θ∂u =
    −(h/l)·sinθ. The zeros are tensors, as JAX keeps them: K1 contracts
    them with V′ too, so NaN and Inf in V′ propagate alike. The descriptor
    is the pendcart's, marked second order (``csrc/pendcart.cuh``
    ``PendCartSO``)."""
    dm = device_model(spec)
    k = _Consts(dm)
    first = _derivs_tiles(spec, param=False)

    def tiles(x, u, t):
        out = dict(first(x, u, t))
        th = x[0]
        z = torch.zeros_like(th)
        s = torch.sin(th)
        d2_thth = k.h * ((-k.ngl) * s - _over(u[0], k.l) * torch.cos(th))
        d2_thu = k.nhl * s
        fxx = [[[z] * 4 for _ in range(4)] for _ in range(4)]
        fxx[1][0][0] = d2_thth
        fxu = [[[z] for _ in range(4)] for _ in range(4)]
        fxu[1][0][0] = d2_thu
        out.update(fxx=fxx, fxu=fxu, fuu=[[[z]] for _ in range(4)])
        return out

    return DerivsTiles(fn=tiles,
                       device=dataclasses.replace(dm, second_order=True))


@factory
@functools.lru_cache(maxsize=32)
def pendcart_lanes_param(spec: PendCartSpec = PendCartSpec()) -> LanesModel:
    """Lane model of a heterogeneous fleet: per-scenario pole length and
    damping, ``params = [l, d]`` (``n_params = 2``; the functions take a
    trailing ``par`` list of two (B,) tensors); the other constants from
    ``spec``, whose l and d are unused."""
    return _lanes(spec, param=True)


@factory
@functools.lru_cache(maxsize=32)
def pendcart_derivs_tiles_param(spec: PendCartSpec = PendCartSpec()
                                ) -> DerivsTiles:
    """In-kernel derivatives with per-scenario ``params = [l, d]``."""
    return _derivs_tiles(spec, param=True)


def default_lims(dtype=torch.float32, device=None) -> torch.Tensor:
    """±5 control limits (src/system_pendcart.jl:45); ``device=None`` is the
    CUDA card."""
    return torch.tensor([[-5.0, 5.0]], dtype=dtype, device=resolve(device))


def default_x0(dtype=torch.float32, device=None) -> torch.Tensor:
    """x0 = [π - 0.6, 0, 0, 0] (src/system_pendcart.jl:42); ``device=None``
    is the CUDA card."""
    return torch.tensor([np.pi - 0.6, 0.0, 0.0, 0.0], dtype=dtype,
                        device=resolve(device))


# ---------------------------------------------------------------------------
# LQR baseline (host-side; reference care/lqr, src/system_pendcart.jl:3-25)
# ---------------------------------------------------------------------------

def care(A, B, Q, R):
    """Continuous algebraic Riccati equation via ordered Schur decomposition
    of the Hamiltonian (reference ``care``, src/system_pendcart.jl:3-20).
    Host-side NumPy/SciPy, as in the JAX package: it only builds the LQG
    baseline."""
    import scipy.linalg
    A, B, Q, R = (np.asarray(a, np.float64) for a in (A, B, Q, R))
    G = B @ np.linalg.inv(R) @ B.T
    Z = np.block([[A, -G], [-Q, -A.T]])
    S, U, _ = scipy.linalg.schur(Z, sort=lambda w: w.real < 0)
    n = A.shape[0]
    U11 = U[:n, :n]
    U21 = U[n:, :n]
    return U21 @ np.linalg.inv(U11)


def lqr(A, B, Q, R):
    """LQR state feedback from CARE (src/system_pendcart.jl:21-25)."""
    S = care(A, B, Q, R)
    return np.linalg.solve(np.asarray(R, np.float64),
                           np.asarray(B, np.float64).T @ S)


def linearized_upright(spec: PendCartSpec = PendCartSpec()):
    """Continuous-time linearization around the upright equilibrium used for
    the LQG baseline (src/system_pendcart.jl:55-59)."""
    A = np.array([[0.0, 1.0, 0.0, 0.0],
                  [spec.g / spec.l, -spec.d, 0.0, 0.0],
                  [0.0, 0.0, 0.0, 1.0],
                  [0.0, 0.0, 0.0, 0.0]])
    B = np.array([[0.0], [-1.0 / spec.l], [0.0], [1.0]])
    return A, B


def simulate_pendcart(x0, L, spec: PendCartSpec, T: int, lims,
                      dtype=torch.float32):
    """Closed-loop simulation under the (limit-clamped) LQG law
    u = -L·(x - [π, 0, 0, 0]) — the failure baseline of the demo
    (src/system_pendcart.jl:162-188). A loop over the T steps on ``x0``'s
    device (a tensor keeps its own; anything else goes to the CUDA card);
    ``lims`` an (m, 2) array or None. Returns the visited states (T, 4),
    the controls (T, 1) and the per-step costs with the terminal term
    (T+1,)."""
    x = as_tensor(x0, dtype)
    L = like(L, x)
    if lims is not None:
        lims = like(lims, x)
    problem = make_pendcart_problem(spec, dtype=dtype, device=x.device)
    xs, us = [], []
    for _ in range(T):
        dx = torch.cat([x[:1] - np.pi, x[1:]])
        u = -(L @ dx)
        if lims is not None:
            u = torch.clamp(u, lims[:, 0], lims[:, 1])
        xs.append(x)
        us.append(u)
        x = problem.dynamics(x, u, 0)
    xs, us = torch.stack(xs), torch.stack(us)
    return xs, us, problem.trajectory_cost(xs, us)
