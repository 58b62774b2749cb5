"""Time-varying tracking models, written once for both packages.

Each function takes the array module ``xp`` (``torch`` or ``jax.numpy``)
and the package's ``LanesModel`` class, so that the port's tests, its
``chip_smoke.py`` and the JAX package's kernels run the same operations in
the same order. The models read the step index ``t``: the kernels pass the
logical step, an int32, so ``t * c`` is the f32 product ``f32(t)·f32(c)``
in every package and on every path.

- :func:`lti_track`: the LTI fleet (``x' = A·x + B·u``) with the cost
  ½(x−r(t))ᵀQ(x−r(t)) + ½uᵀRu, r(t) = 0.5·sin(π·h·t) on state 0 and 0
  elsewhere, the zero-skipping sums of the LTI lane functions; and the
  user's hand-written derivative tiles of it (cx = Q(x − r(t)), the rest
  the constant A, B, Q, R), as plain Python with no device descriptor.
- :func:`quad_track`: the quadrotor whose goal px follows
  0.5·sin(π/2·h·t), its other goals, dynamics and terminal cost the
  quadrotor's.

Nothing here imports JAX; the constants are numpy f32 arrays.
"""
from __future__ import annotations

import math

import numpy as np

# the amplitude of each reference
AMPLITUDE = 0.5


def lti_reference(xp, t, h: float):
    """r₀(t) = 0.5·sin(π·h·t): one product of t by an f32 constant."""
    return AMPLITUDE * xp.sin(t * float(np.float32(math.pi * h)))


def _quad(M: np.ndarray, v, c):
    """Σ ½·M[i,j]·v[i]·v[j] over the non-zero M[i,j], added to c (None to
    start), as the LTI lane cost forms it."""
    for i in range(M.shape[0]):
        for j in range(M.shape[1]):
            if M[i, j] != 0.0:
                term = 0.5 * float(M[i, j]) * v[i] * v[j]
                c = term if c is None else c + term
    return c


def _lincomb(M: np.ndarray, vec, zero):
    out = []
    for i in range(M.shape[0]):
        s = None
        for j in range(M.shape[1]):
            if M[i, j] != 0.0:
                term = float(M[i, j]) * vec[j]
                s = term if s is None else s + term
        out.append(zero if s is None else s)
    return out


def lti_track(xp, lanes_cls, A, B, Q, R, h: float = 0.01):
    """(model, tiles) of the tracking LTI: the lane model without a device
    descriptor and the tiles function ``tiles(x, u, t)``. ``A, B, Q, R``
    (arrays, or tensors on any device) are cast to f32."""
    A, B, Q, R = (np.asarray(a.cpu() if hasattr(a, "cpu") else a,
                             np.float32) for a in (A, B, Q, R))
    n, m = B.shape
    AB = np.concatenate([A, B], axis=1)

    def err(x, t):
        return [x[0] - lti_reference(xp, t, h)] + list(x[1:])

    def dynamics(x, u, t):
        return _lincomb(AB, list(x) + list(u), xp.zeros_like(x[0]))

    def cost(x, u, t):
        return _quad(R, u, _quad(Q, err(x, t), None))

    def tiles(x, u, t):
        o = xp.ones_like(x[0])
        z = xp.zeros_like(o)

        def const(M):
            return [[float(v) * o if v != 0.0 else z for v in row]
                    for row in M]

        return dict(fx=const(A), fu=const(B), cx=_lincomb(Q, err(x, t), z),
                    cu=_lincomb(R, u, z), cxx=const(Q),
                    cxu=[[z] * m for _ in range(n)], cuu=const(R))

    return lanes_cls(n=n, m=m, dynamics=dynamics, cost=cost), tiles


def quad_track(xp, lanes_cls, spec):
    """The quadrotor of ``spec`` (the package's QuadrotorSpec) tracking
    px = 0.5·sin(π/2·h·t), without a device descriptor."""
    goal = [float(g) for g in spec.goal]
    w = float(np.float32(0.5 * math.pi * spec.h))

    def step(x, u):
        px, vx, pz, vz, th, om = x
        u1, u2 = u
        thrust = u1 + u2
        s, c = xp.sin(th), xp.cos(th)
        ax = -thrust * s / spec.mass
        az = thrust * c / spec.mass - spec.g
        al = spec.arm * (u1 - u2) / spec.inertia
        hh = spec.h
        return [px + hh * vx, vx + hh * ax, pz + hh * vz, vz + hh * az,
                th + hh * om, om + hh * al]

    def state_cost(x, g0):
        c = None
        for i in range(6):
            dx = x[i] - (g0 if i == 0 else goal[i])
            term = 0.5 * spec.Q[i] * dx * dx
            c = term if c is None else c + term
        return c

    def dynamics(x, u, t):
        return step(x, u)

    def cost(x, u, t):
        c = state_cost(x, AMPLITUDE * xp.sin(t * w))
        for j in range(2):
            du = u[j] - spec.u_hover
            c = c + 0.5 * spec.R * du * du
        return c

    def terminal(x):
        return state_cost(x, goal[0])

    return lanes_cls(n=6, m=2, dynamics=dynamics, cost=cost,
                     terminal=terminal)
