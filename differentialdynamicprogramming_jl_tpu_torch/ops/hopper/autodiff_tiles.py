"""Autodiff derivative tiles: K1's derivative expansion for any lane model.

Counterpart of ``differentialdynamicprogramming_jl_tpu/ops/pallas/autodiff_tiles.py``
(``autodiff_derivs_tiles`` ``:59-156``, ``autodiff_packed_derivs``
``:159-192``). From a :class:`~.forward_kernel.
LanesModel`'s own dynamics and running cost, forward-mode autodiff gives the
per-step expansion that :func:`~.backward_kernel.backward_lanes` consumes,
so a user model needs no hand-written Jacobian:

- one ``torch.func.jvp`` per input direction (n+m of them) gives a column
  of fx/fu and an entry of cx/cu;
- one forward-over-forward jvp per direction pair i ≤ j
  ((n+m)(n+m+1)/2 of them), mirrored, gives cxx, cxu and cuu, and with
  ``second_order=True`` from the same passes the dynamics Hessians
  ``fxx[a][i][j]``, ``fxu[a][j][mi]`` and ``fuu[a][mi][mj]`` of full DDP.

Every tangent is a unit vector over the (x, u) inputs, zeros included, as
the JAX function builds it. The model's functions run under JAX's rules at
ties (``ops/tie_rules.py``: abs, the clamps, maximum and minimum), as
K1's Dual and Jet passes do. The directions (and the pairs) are batched by
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
substitutes a model's analytic instance. A model without a descriptor
gets a lowered one (:mod:`.lower`): K1 then runs ``Autodiff<Lowered>``,
built from the model's traced functions at the first launch. A model with
``n_params > 0`` gives tiles ``fn(x, u, t, par)``. Second-order tiles
carry the descriptor marked ``second_order`` too: K1's ``Autodiff<Body, true>``
instance runs the Jet passes over the dynamics as well and contracts each
pass's n outputs with V′ at once.

:func:`autodiff_packed_derivs` is the out-of-kernel route: the first-order
tiles evaluated over a whole trajectory at once, stacked into K1's packed
``(T, D+m, B)`` stream (work the JAX package leaves to XLA), on CPU or CUDA
tensors alike.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.func import jvp, vmap

from ..tie_rules import jax_ties
from .backward_kernel import DerivsTiles
from .forward_kernel import DeviceModel, LanesModel
from .lower import LOWERED_ID
from .pack import packed_from_tiles
from ...utils.aot import factory


@factory
def autodiff_derivs_tiles(model: LanesModel,
                          second_order: bool = False) -> DerivsTiles:
    """The derivative function of ``model`` by forward-mode autodiff, for
    :func:`~.backward_kernel.backward_lanes`; cached per model and order.

    ``second_order=True`` also gives the dynamics Hessians of full DDP. A
    model with per-scenario parameters (``n_params > 0``) gives tiles that
    take them as a trailing ``par`` list, constants of the expansion, as
    JAX threads them (``autodiff_tiles.py:44-56``)."""
    return _autodiff_derivs_tiles(model, bool(second_order))


@functools.lru_cache(maxsize=64)
def _autodiff_derivs_tiles(model: LanesModel,
                           second_order: bool) -> DerivsTiles:
    n, m = model.n, model.m
    nm = n + m

    # the direction pairs i ≤ j of the second-order passes, in JAX's order
    pairs = [(i, j) for j in range(nm) for i in range(j + 1)]

    def tiles(x, u, t, *par):
        # the model's functions under JAX's rules at ties (ops/tie_rules.py)
        def fc(xu):
            xs, us = xu[:n], xu[n:]
            with jax_ties():
                return (list(model.dynamics(xs, us, t, *par)),
                        model.cost(xs, us, t, *par))

        def cost(xu):
            with jax_ties():
                return model.cost(xu[:n], xu[n:], t, *par)

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
        # i ≤ j, mirrored; with second_order the dynamics' tangents too.
        # First-order tiles differentiate the cost alone here (the same
        # operations as on its share of fc): at n=10 the dynamics would be
        # most of the work and of the memory
        def second(ti, tj):
            def g(xu):
                return jvp(fc if second_order else cost, (xu,), (tj,))[1]

            return jvp(g, (xu0,), (ti,))[1]

        d2 = vmap(second)(units([i for i, _ in pairs]),
                          units([j for _, j in pairs]))
        if second_order:
            # an output linear in (x, u) has a symbolic zero second tangent
            # (a ZeroTensor, whose products drop NaN and Inf): made dense,
            # as JAX's zeros are, so that K1 contracts real zeros with V′
            d2f, d2 = d2
            d2f = [torch.zeros(v.shape, dtype=v.dtype, device=v.device)
                   if v._is_zerotensor() else v for v in d2f]
        H = [[None] * nm for _ in range(nm)]
        Hf = [[[None] * nm for _ in range(nm)] for _ in range(n)]
        for p, (i, j) in enumerate(pairs):
            H[i][j] = H[j][i] = d2[p]
            if second_order:
                for a in range(n):
                    Hf[a][i][j] = Hf[a][j][i] = d2f[a][p]
        out["cxx"] = [[H[i][j] for j in range(n)] for i in range(n)]
        out["cxu"] = [[H[i][n + mi] for mi in range(m)] for i in range(n)]
        out["cuu"] = [[H[n + mi][n + mj] for mj in range(m)]
                      for mi in range(m)]
        if second_order:
            # K1's layouts (JAX :145-153): fxx[a][i][j], fxu[a][j][mi],
            # fuu[a][mi][mj]
            out["fxx"] = [[[Hf[a][i][j] for j in range(n)]
                           for i in range(n)] for a in range(n)]
            out["fxu"] = [[[Hf[a][j][n + mi] for mi in range(m)]
                           for j in range(n)] for a in range(n)]
            out["fuu"] = [[[Hf[a][n + mi][n + mj] for mj in range(m)]
                           for mi in range(m)] for a in range(n)]
        return out

    # a model with a hand-written descriptor keeps it: K1 runs its
    # Autodiff<Body> instance, in the modes the fleet entries launch
    # (backward_kernel.CUDA_BACKWARD, CUDA_BACKWARD_SO); GPS "gains", and
    # "policy" without GPS mode, still raise on the card. A model without
    # one: K1 runs Autodiff<Lowered> of its lowering, made at the first
    # launch (DeviceModel.lanes)
    dev = (DeviceModel(LOWERED_ID, np.zeros(0, np.float32), lanes=model)
           if model.device is None else model.device)
    dev = dataclasses.replace(dev, autodiff=True, second_order=second_order)
    return DerivsTiles(fn=tiles, device=dev, n_params=model.n_params)


@factory
@functools.lru_cache(maxsize=64)
def autodiff_packed_derivs(model: LanesModel):
    """K1's packed-derivatives generator for ``model`` by forward-mode
    autodiff (JAX ``:159-192``): ``(x_s (T, n, B), u_s (T, m, B)) →
    (T, D+m, B)``, the first-order tiles of :func:`autodiff_derivs_tiles`
    over the whole trajectory in ``DerivLayout`` order with u appended. It
    runs as torch operations on the streams' device: n+m first-order and
    (n+m)(n+m+1)/2 pair passes, each batched over its directions. The
    fleet driver calls it once at init, once after each iteration in which
    some lane accepted, and once for the final replay. Cached per model.

    Memory: a call holds the tangents of every pass over the whole (T, B)
    trajectory at once, so its peak grows with T·B·(n+m)². On the
    quadrotor at B=4096, T=400 one call holds 28.77 GiB at its peak above
    what was allocated before it (H100 80GB HBM3, ``chip_smoke.py``'s
    packed-kernels phase): under three times that T·B fills an 80 GB
    card. Cut T·B per call where that binds.

    The packed stream carries no per-scenario parameters into K1: a model
    with ``n_params > 0`` raises NotImplementedError."""
    if model.n_params:
        raise NotImplementedError(
            "autodiff_packed_derivs: the packed stream takes no params; use "
            "autodiff_derivs_tiles(model) with params= for a model with "
            "n_params > 0")
    return packed_from_tiles(autodiff_derivs_tiles(model), model.n, model.m)
