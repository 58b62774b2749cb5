"""Planar quadrotor (birotor): the lane model and the Problem.

Counterpart of ``differentialdynamicprogramming_jl_tpu/models/quadrotor.py``
(``QuadrotorSpec`` ``:36-54``, ``_step_scalars``, ``_cost_scalars``,
``_terminal_scalars`` ``:57-91``, ``quadrotor_lanes`` ``:94-111``,
``make_quadrotor_problem`` ``:114-135``, ``default_x0`` ``:138-140``). The
model defines only its dynamics and cost: its derivative expansion comes
from forward-mode autodiff (:func:`~..ops.hopper.autodiff_tiles.
autodiff_derivs_tiles`, and :func:`~..problem.make_autodiff_derivs` for the
Problem), on the CPU and on the card alike. There is no hand-written
Jacobian.

    state  x = [px, vx, pz, vz, θ, ω]        control u = [u₁, u₂] ≥ 0
    v̇x = -(u₁+u₂)·sinθ/mass,  v̇z = (u₁+u₂)·cosθ/mass − g,
    ω̇ = arm·(u₁−u₂)/inertia

Euler-discretised with step ``h``; diagonal quadratic cost to a hover goal,
the control penalised around the hover thrust u_h = mass·g/2. The thrust
box (0, u_max) is active at its lower bound at rest.

The scalar functions take the spec's Python floats, as the JAX functions do:
on f32 tensors each constant is rounded to f32 before it is used (PyTorch
and JAX alike), on f64 tensors it stays f64. The device-model descriptor
(model id 3) holds the same constants rounded to f32, so the CUDA kernels
(``ops/hopper/csrc/quadrotor.cuh``) evaluate the same f32 operations.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve
from ..ops.hopper.forward_kernel import DeviceModel, LanesModel
from ..problem import Problem
from ..utils.aot import factory

MODEL_ID = 3   # csrc/quadrotor.cuh: Quadrotor::ID


@dataclasses.dataclass(frozen=True)
class QuadrotorSpec:
    mass: float = 0.5
    inertia: float = 0.01
    arm: float = 0.17
    g: float = 9.81
    h: float = 0.02            # integration step
    u_max: float = 5.0         # per-rotor thrust limit; hover needs 2.45
    Q: tuple = (1.0, 0.1, 1.0, 0.1, 0.5, 0.05)
    R: float = 0.05
    goal: tuple = (0.0, 0.0, 1.0, 0.0, 0.0, 0.0)

    @property
    def u_hover(self) -> float:
        return self.mass * self.g / 2.0

    @property
    def lims(self):
        return ((0.0, self.u_max), (0.0, self.u_max))


def _step_scalars(spec: QuadrotorSpec, x, u):
    """One Euler step on per-dimension tensors, in the JAX order."""
    px, vx, pz, vz, th, om = x
    u1, u2 = u
    thrust = u1 + u2
    s, c = torch.sin(th), torch.cos(th)
    ax = -thrust * s / spec.mass
    az = thrust * c / spec.mass - spec.g
    al = spec.arm * (u1 - u2) / spec.inertia
    h = spec.h
    return [px + h * vx, vx + h * ax, pz + h * vz, vz + h * az,
            th + h * om, om + h * al]


def _cost_scalars(spec: QuadrotorSpec, x, u):
    c = None
    for i in range(6):
        dx = x[i] - spec.goal[i]
        term = 0.5 * spec.Q[i] * dx * dx
        c = term if c is None else c + term
    for j in range(2):
        du = u[j] - spec.u_hover
        c = c + 0.5 * spec.R * du * du
    return c


def _terminal_scalars(spec: QuadrotorSpec, x):
    c = None
    for i in range(6):
        dx = x[i] - spec.goal[i]
        term = 0.5 * spec.Q[i] * dx * dx
        c = term if c is None else c + term
    return c


def device_model(spec: QuadrotorSpec) -> DeviceModel:
    """Model id 3 and the f32 constants
    ``[mass, inertia, arm, g, h, u_hover, Q0..Q5, R, goal0..goal5]``;
    u_hover is formed in f64 and then rounded, as the JAX functions form
    it."""
    consts = np.asarray([spec.mass, spec.inertia, spec.arm, spec.g, spec.h,
                         spec.u_hover, *spec.Q, spec.R, *spec.goal],
                        np.float32)
    return DeviceModel(model_id=MODEL_ID, consts=consts)


@factory
@functools.lru_cache(maxsize=32)
def quadrotor_lanes(spec: QuadrotorSpec = QuadrotorSpec()) -> LanesModel:
    """Lane model (n=6, m=2) with its device-model descriptor. Pair it with
    ``autodiff_derivs_tiles(quadrotor_lanes(spec))`` for the backward pass:
    there is no hand-written derivative function."""

    def dynamics(x, u, t):
        return _step_scalars(spec, x, u)

    def cost(x, u, t):
        return _cost_scalars(spec, x, u)

    def terminal(x):
        return _terminal_scalars(spec, x)

    return LanesModel(n=6, m=2, dynamics=dynamics, cost=cost,
                      terminal=terminal, device=device_model(spec))


@factory
def make_quadrotor_problem(spec: QuadrotorSpec = QuadrotorSpec(),
                           dtype=torch.float32, device=None) -> Problem:
    """The :class:`~..problem.Problem` of the same model, its functions
    broadcasting over leading batch dimensions; derivatives by autodiff
    (``derivs=None``). ``traj_cost`` takes (..., T, 6) states and
    (..., T, 2) controls and returns (..., T+1): the running costs and the
    terminal cost at the last stored state. The problem holds no tensors:
    its functions run where their inputs lie; ``device`` follows the rule of
    every factory (None is the CUDA card, and raises without one)."""
    resolve(device)

    def split(x, u):
        return ([x[..., i] for i in range(6)], [u[..., 0], u[..., 1]])

    def dynamics(x, u, t):
        return torch.stack(_step_scalars(spec, *split(x, u)), -1).to(dtype)

    def cost(x, u, t):
        return _cost_scalars(spec, *split(x, u))

    def traj_cost(x, u):
        run = _cost_scalars(spec, *split(x, u))
        term = _terminal_scalars(spec, [x[..., -1, i] for i in range(6)])
        return torch.cat([run, term[..., None]], dim=-1)

    return Problem(dynamics=dynamics, cost=cost, traj_cost=traj_cost)


def default_x0(dtype=torch.float32, device=None) -> torch.Tensor:
    """Displaced start: 1 m sideways, on the ground, slight tilt;
    ``device=None`` is the CUDA card."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0, 0.3, 0.0], dtype=dtype,
                        device=resolve(device))
