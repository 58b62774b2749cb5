"""Autodiff derivative tiles: K1's derivative expansion for any lane model.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/pallas/autodiff_tiles.py``
(``autodiff_derivs_tiles`` ``:59-156``). From a :class:`~.forward_kernel.
LanesModel`'s own dynamics and running cost, forward-mode autodiff gives the
per-step expansion that :func:`~.backward_kernel.backward_lanes` consumes,
so a user model needs no hand-written Jacobian:

- one ``torch.func.jvp`` per input direction (n+m of them) gives a column
  of fx/fu and an entry of cx/cu;
- one forward-over-forward jvp per direction pair i ≤ j
  ((n+m)(n+m+1)/2 of them), mirrored, gives cxx, cxu and cuu.

Every tangent is a unit vector over the (x, u) inputs, zeros included, as
the JAX function builds it. The directions (and the pairs) are batched by
``torch.func.vmap`` over a leading axis of the tangents: the model's
functions are elementwise, so each direction's result has the bits a jvp of
its own would give, at a fraction of the Python overhead of 44 separate
calls (at ⟨6,2⟩). The boundary step t = T-1 differentiates the RUNNING
cost, as the analytic generators do (JAX ``:27-31``).

:func:`autodiff_derivs_tiles` returns this plain version as a
:class:`~.backward_kernel.DerivsTiles` whose device descriptor is the
model's with ``autodiff=True``. On CPU tensors K1's plain version calls it;
on CUDA tensors K1 runs the model's ``Autodiff<Body>`` instance
(``csrc/autodiff.cuh``), which makes the same expansion with dual numbers in
registers, or the wrapper raises when no such instance is built. It never
substitutes a model's analytic instance.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.func import jvp, vmap

from .backward_kernel import DerivsTiles
from .forward_kernel import LanesModel


def autodiff_derivs_tiles(model: LanesModel,
                          second_order: bool = False) -> DerivsTiles:
    """The derivative function of ``model`` by forward-mode autodiff, for
    :func:`~.backward_kernel.backward_lanes`; cached per model.

    ``second_order=True`` (the dynamics Hessians of full DDP) and a model
    with per-scenario parameters (``n_params > 0``) belong to a later slice
    and raise NotImplementedError."""
    if second_order:
        raise NotImplementedError(
            "second_order=True: the dynamics-Hessian tiles of full DDP are "
            "not ported yet")
    if model.n_params:
        raise NotImplementedError(
            "autodiff tiles with params (a model with n_params > 0) are not "
            "ported yet")
    return _autodiff_derivs_tiles(model)


@functools.lru_cache(maxsize=64)
def _autodiff_derivs_tiles(model: LanesModel) -> DerivsTiles:
    n, m = model.n, model.m
    nm = n + m

    # the direction pairs i ≤ j of the second-order passes, in JAX's order
    pairs = [(i, j) for j in range(nm) for i in range(j + 1)]

    def tiles(x, u, t):
        def fc(xu):
            xs, us = xu[:n], xu[n:]
            return list(model.dynamics(xs, us, t)), model.cost(xs, us, t)

        xu0 = list(x) + list(u)

        def units(dirs):
            # per input k, the tangents of the directions `dirs` stacked on
            # a leading axis: ones where the direction is k, else zeros,
            # each shaped and typed like its primal
            return [torch.stack([torch.ones_like(xu0[k]) if d == k
                                 else torch.zeros_like(xu0[k])
                                 for d in dirs]) for k in range(nm)]

        # first order: one jvp per input direction
        def first(tan):
            return jvp(fc, (xu0,), (tan,))[1]

        df, dc = vmap(first)(units(range(nm)))
        out = dict(fx=[[df[a][i] for i in range(n)] for a in range(n)],
                   fu=[[df[a][n + mi] for mi in range(m)] for a in range(n)],
                   cx=list(dc[:n]), cu=list(dc[n:]))

        # second order: forward (along i) over forward (along j) per pair
        # i ≤ j, mirrored
        def second(ti, tj):
            def g(xu):
                return jvp(fc, (xu,), (tj,))[1][1]

            return jvp(g, (xu0,), (ti,))[1]

        d2 = vmap(second)(units([i for i, _ in pairs]),
                          units([j for _, j in pairs]))
        H = [[None] * nm for _ in range(nm)]
        for p, (i, j) in enumerate(pairs):
            H[i][j] = H[j][i] = d2[p]
        out["cxx"] = [[H[i][j] for j in range(n)] for i in range(n)]
        out["cxu"] = [[H[i][n + mi] for mi in range(m)] for i in range(n)]
        out["cuu"] = [[H[n + mi][n + mj] for mj in range(m)]
                      for mi in range(m)]
        return out

    dev = (None if model.device is None
           else dataclasses.replace(model.device, autodiff=True))
    return DerivsTiles(fn=tiles, device=dev)


def autodiff_packed_derivs(model: LanesModel):
    """The out-of-kernel derivative stream of the JAX package (JAX
    ``:159-192``); K1's packed-derivatives input is not ported yet."""
    raise NotImplementedError(
        "autodiff_packed_derivs: K1's packed-derivatives input is not "
        "ported yet; use autodiff_derivs_tiles")
