"""Pendulum-on-a-cart swing-up, the lane pieces.

Counterpart of ``differentialdynamicprogramming_jl_tpu/models/pendcart.py``
(``PendCartSpec``, ``pendcart_lanes`` ``:161-195``, ``pendcart_derivs_tiles``
``:233-263``, ``default_lims``, ``default_x0``): the Euler step of the
reference dynamics (``src/system_pendcart.jl:75-89``), the diagonal
quadratic cost with its terminal term (``:92-106``) and the analytic
Jacobians of the Euler step, written as functions over per-dimension
``(B,)`` tensors. The plain kernel versions call these directly.

Both returned objects carry a device-model descriptor: model id 1 and the
f32 constants ``[g, l, h, d, Q0..Q3, R, goal0..goal3]``, from which the CUDA
kernels (``ops/hopper/csrc/pendcart.cuh``) evaluate the same model. The
derived constants (-g/l, 1-h·d, Q/2, R/2) are formed in f32 from that
descriptor, here and on the card alike, so a kernel and its plain version
use the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..ops.hopper.backward_kernel import DerivsTiles
from ..ops.hopper.forward_kernel import DeviceModel, LanesModel

# reference constants (src/system_pendcart.jl:42-60)
GRAV = 9.82
POLE_LEN = 0.35
DT = 0.01
DAMP = 0.99
MODEL_ID = 1   # csrc/pendcart.cuh: MODEL_PENDCART


@dataclasses.dataclass(frozen=True)
class PendCartSpec:
    Q: Tuple[float, ...] = (10.0, 1.0, 2.0, 1.0)   # state weights (diagonal)
    R: float = 1.0
    goal: Tuple[float, ...] = (np.pi, 0.0, 0.0, 0.0)
    g: float = GRAV
    l: float = POLE_LEN
    h: float = DT
    d: float = DAMP


def device_model(spec: PendCartSpec) -> DeviceModel:
    consts = np.asarray([spec.g, spec.l, spec.h, spec.d, *spec.Q, spec.R,
                         *spec.goal], np.float32)
    return DeviceModel(model_id=MODEL_ID, consts=consts)


class _Consts:
    """f32 constants of one spec, derived in f32 as the kernels derive them;
    held as Python floats (exact f32 values) for tensor arithmetic."""

    def __init__(self, dm: DeviceModel):
        c = dm.consts
        g, l, h, d = c[0], c[1], c[2], c[3]
        f = float
        self.l, self.h, self.d = f(l), f(h), f(d)
        self.ngl = f(-g / l)
        self.hd1 = f(np.float32(1.0) - h * d)
        self.Q = [f(q) for q in c[4:8]]
        self.halfQ = [f(np.float32(0.5) * q) for q in c[4:8]]
        self.R = f(c[8])
        self.halfR = f(np.float32(0.5) * c[8])
        self.goal = [f(v) for v in c[9:13]]


@functools.lru_cache(maxsize=32)
def pendcart_lanes(spec: PendCartSpec = PendCartSpec()) -> LanesModel:
    """Lane model: dynamics, running cost and terminal cost on lists of
    per-scenario tensors, plus the device-model descriptor."""
    dm = device_model(spec)
    k = _Consts(dm)

    def dynamics(x, u, t):
        th, thd, p, pd = x
        f = u[0]
        thdd = k.ngl * torch.sin(th) + (f / k.l) * torch.cos(th) - k.d * thd
        return [th + k.h * thd, thd + k.h * thdd, p + k.h * pd, pd + k.h * f]

    def cost(x, u, t):
        c = k.halfR * u[0] * u[0]
        for i in range(4):
            dx = x[i] - k.goal[i]
            c = c + k.halfQ[i] * dx * dx
        return c

    def terminal(x):
        c = None
        for i in range(4):
            dx = x[i] - k.goal[i]
            term = k.halfQ[i] * dx * dx
            c = term if c is None else c + term
        return c

    return LanesModel(n=4, m=1, dynamics=dynamics, cost=cost,
                      terminal=terminal, device=dm)


@functools.lru_cache(maxsize=32)
def pendcart_derivs_tiles(spec: PendCartSpec = PendCartSpec()) -> DerivsTiles:
    """In-kernel derivatives: the analytic Euler-step Jacobians and cost
    expansions at (x, u), so the backward pass streams only the
    trajectory."""
    dm = device_model(spec)
    k = _Consts(dm)

    def tiles(x, u, t):
        th = x[0]
        u0 = u[0]
        z = torch.zeros_like(th)
        o = torch.ones_like(th)
        a21 = k.h * (k.ngl * torch.cos(th) - (u0 / k.l) * torch.sin(th))
        fx = [[o, k.h * o, z, z],
              [a21, k.hd1 * o, z, z],
              [z, z, o, k.h * o],
              [z, z, z, o]]
        fu = [[z], [k.h * torch.cos(th) / k.l], [z], [k.h * o]]
        cx = [k.Q[i] * (x[i] - k.goal[i]) for i in range(4)]
        cu = [k.R * u0]
        cxx = [[k.Q[i] * o if i == j else z for j in range(4)]
               for i in range(4)]
        cxu = [[z] for _ in range(4)]
        cuu = [[k.R * o]]
        return dict(fx=fx, fu=fu, cx=cx, cu=cu, cxx=cxx, cxu=cxu, cuu=cuu)

    return DerivsTiles(fn=tiles, device=dm)


def default_lims(dtype=torch.float32, device=None) -> torch.Tensor:
    """±5 control limits (src/system_pendcart.jl:45)."""
    return torch.tensor([[-5.0, 5.0]], dtype=dtype, device=device)


def default_x0(dtype=torch.float32, device=None) -> torch.Tensor:
    """x0 = [π - 0.6, 0, 0, 0] (src/system_pendcart.jl:42)."""
    return torch.tensor([np.pi - 0.6, 0.0, 0.0, 0.0], dtype=dtype,
                        device=device)
