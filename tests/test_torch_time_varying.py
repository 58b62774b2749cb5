"""Models and derivative tiles that read the step index ``t``, on the
port's plain versions (CPU) against the JAX package's kernels in
interpret mode.

JAX's kernels pass the model the logical step ``t_log``, an int32 (JAX
``ops/pallas/forward_kernel.py:170,177``, ``backward_kernel.py:345-366``).
Under JAX's default setting (``jax_enable_x64`` off, as on the TPU)
``t * 0.01`` is then the f32 product f32(t)·f32(0.01); the port passes
an int32 tensor on every path (``forward_kernel.step_indices``) for the
same bits. The JAX calls here run with ``jax_enable_x64`` off
(``tests/conftest.py`` turns it on for every test) and restore it.

- The t rule: K3's rollout and K1's boundary step of a model whose cost
  reads ``t * 0.01`` in products alone (no multiply-add that XLA could
  contract), bit for bit; at t = 5, 9, 10 the f64 product rounded once
  (a Python int t) has other bits. The packed generator and the lowering
  give the same bits.
- The LTI fleet tracking r(t) = 0.5·sin(π·h·t) with the user's tiles that
  read t, and the quadrotor tracking px = 0.5·sin(π/2·h·t) with autodiff
  tiles (``tools_torch/tracking.py``), through ``ilqg_batch_lanes``
  against JAX's interpret-mode solve at B=8, T=10, k_t=1 (half the
  program of k_t=2 to compile, the same per-step operations): costs within
  1e-4, reasons and accepted counts equal, K within 1e-4 (XLA contracts
  multiply-adds on the host, and its sin differs from PyTorch's by an
  ulp).

Inputs are made in numpy f64 from seeded Generators and cast to f32 for
both packages.
"""
import contextlib
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import quadrotor as jq
from differentialdynamicprogramming_jl_tpu.ops.pallas import (
    backward_kernel as jbk, forward_kernel as jfk)
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_autodiff_tiles)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    backward_kernel as bk, forward_kernel as fk, lower)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_derivs_tiles
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
    import DerivsTiles
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    packed_from_tiles)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "tools_torch"))
import tracking  # noqa: E402

B = 8
# the steps whose f32 product t·0.01 differs from the f64 one rounded
STEPS_APART = (5, 9, 10)


@contextlib.contextmanager
def jax_x32():
    """JAX's default precision (jax_enable_x64 off), restored after."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(np.asarray(a, np.float32)))


# ---------------------------------------------------------------------------
# the t rule
# ---------------------------------------------------------------------------

def _rule_fns(zeros_like, ones_like):
    """Dynamics, cost and tiles of a model whose cost reads t·0.01 through
    products alone: x' = [0.9·x0, x1·u], c = x0²·(t·0.01)."""
    def dynamics(x, u, t):
        return [x[0] * 0.9, x[1] * u[0]]

    def cost(x, u, t):
        return (x[0] * x[0]) * (t * 0.01)

    def tiles(x, u, t):
        w = t * 0.01
        z = zeros_like(x[0])
        o = ones_like(x[0])
        return dict(fx=[[0.9 * o, z], [z, u[0] * o]], fu=[[z], [x[1] * o]],
                    cx=[(x[0] + x[0]) * w, z], cu=[z],
                    cxx=[[(w + w) * o, z], [z, z]], cxu=[[z], [z]],
                    cuu=[[z]])

    return dynamics, cost, tiles


def _rule_inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    x0 = (1.0 + rng.standard_normal((2, B))).astype(np.float32)
    u = (1.0 + 0.1 * rng.standard_normal((T, 1, B))).astype(np.float32)
    return x0, u


def test_t_rule_matches_jax():
    """K3's [x, u, c] stream and K1's boundary step (Vx = cx, Vxx = cxx at
    t = T-1 = 5) of the t-reading model, the port's plain versions
    against JAX's kernels (jax_enable_x64 off), bit for bit; a Python int
    t would part at t = 5, 9 and 10."""
    T = 11
    tdyn, tcost, ttiles = _rule_fns(torch.zeros_like, torch.ones_like)
    jdyn, jcost, jtiles = _rule_fns(jnp.zeros_like, jnp.ones_like)
    tm = fk.LanesModel(n=2, m=1, dynamics=tdyn, cost=tcost)
    jm = jfk.LanesModel(n=2, m=1, dynamics=jdyn, cost=jcost)
    x0, u = _rule_inputs(T)
    traj = np.zeros((T, 3, B), np.float32)
    gains = np.concatenate([u, np.zeros((T, 2, B), np.float32)], axis=1)
    al = np.ones((1, B), np.float32)
    with jax_x32():
        ref = jfk.forward_lanes(_lanes(traj), _lanes(gains), _lanes(x0),
                                _lanes(al), model=jm, lims=None,
                                emit_traj=True, k_t=2, interpret=True)
        ref_traj = convert.stream_from_lanes(ref.traj, B)
        Tb = 6
        jout = jbk.backward_lanes(
            _lanes(ref_traj[:Tb]), _lanes(np.ones(B, np.float32)), n=2, m=1,
            derivs_tiles=jtiles, emit="full", k_t=2, interpret=True)
        jb = convert.stream_from_lanes(jout.out, B)
    out = fk.forward_lanes(torch.from_numpy(traj), torch.from_numpy(gains),
                           torch.from_numpy(x0), torch.from_numpy(al),
                           model=tm, lims=None, emit_traj=True)
    np.testing.assert_array_equal(out.traj.numpy(), ref_traj)
    tb = bk.backward_lanes(torch.from_numpy(ref_traj[:Tb]), torch.ones(B),
                           n=2, m=1, derivs_tiles=DerivsTiles(fn=ttiles),
                           emit="full")
    lay = bk.OutLayout(2, 1, "full")
    vs = slice(lay.Vx, lay.Vxx + 4)
    np.testing.assert_array_equal(tb.out.numpy()[Tb - 1, vs],
                                  jb[Tb - 1, vs])
    # the f64 product rounded once has other bits at these steps
    t = np.asarray(STEPS_APART)
    assert np.all(np.float32(t * 0.01)
                  != t.astype(np.float32) * np.float32(0.01))


def test_t_rule_packed_and_lowering():
    """The packed generator passes (T, 1) int32 steps, K1's plain version
    and the lowering int32 scalars: each entry of the generator's stream
    equals the per-step tiles' bit for bit, and the lowering's cost and
    tiles equal the model's at each step, f32(t)·f32(0.01) included."""
    T = 11
    dyn, cost, tiles = _rule_fns(torch.zeros_like, torch.ones_like)
    x0, u = _rule_inputs(T, seed=1)
    rng = np.random.default_rng(2)
    x_s = torch.tensor(rng.standard_normal((T, 2, B)), dtype=torch.float32)
    u_s = torch.from_numpy(u)
    packed = packed_from_tiles(tiles, 2, 1)(x_s, u_s)
    model = fk.LanesModel(n=2, m=1, dynamics=dyn, cost=cost)
    low = lower.lower(model)
    lt = lower.lower_tiles(DerivsTiles(fn=tiles), 2, 1)
    for t in range(T):
        tt = fk.step_indices(T, "cpu")[t]
        xs, us = list(x_s[t]), list(u_s[t])
        d = tiles(xs, us, tt)
        flat = [torch.as_tensor(v).expand(B) for f in bk.DERIV_FIELDS
                for v in _flat(d[f])]
        assert torch.equal(packed[t, :len(flat)], torch.stack(flat)), t
        assert torch.equal(low.interpret("cost", xs, us, t=tt),
                           cost(xs, us, tt)), t
        li = lt.interpret(xs, us, t=tt)
        assert torch.equal(torch.as_tensor(li["cx"][0]), d["cx"][0]), t
        w = np.float32(t) * np.float32(0.01)
        assert d["cxx"][0][0][0].item() == np.float32(w + w), t


def _flat(v):
    return ([e for row in v for e in _flat(row)]
            if isinstance(v, (list, tuple)) else [v])


# ---------------------------------------------------------------------------
# tracking fleets through ilqg_batch_lanes, against JAX
# ---------------------------------------------------------------------------

T_SOLVE = 10
CFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                   max_iter=3, iter_cap=4)


def _solve_both(jm, jtiles, tm, ttiles, x0s, u0s, lims):
    with jax_x32():
        ref = convert.result_to_numpy(J.ilqg_batch_lanes(
            jm, None, jnp.asarray(x0s), jnp.asarray(u0s), lims=lims,
            cfg=CFG, derivs_tiles=jtiles, kt_backward=1, kt_forward=1,
            interpret=True))
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tm, None, torch.from_numpy(x0s), torch.from_numpy(u0s), lims=lims,
        cfg=convert.config_from_jax(CFG), derivs_tiles=ttiles))
    return ref, out


def _hold(ref, out):
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert (out["n_accepted"] >= 1).all()
    np.testing.assert_allclose(out["policy"]["K"], ref["policy"]["K"],
                               rtol=1e-4, atol=1e-5)


def test_lti_track_with_user_tiles_matches_jax():
    """The tracking LTI (n=4, m=2, ±0.6) with the user's tiles reading t,
    the model without a descriptor: K3 and K2 call its cost with t, K1 the
    tiles."""
    rng = np.random.default_rng(3)
    n, m, h = 4, 2, 0.05
    Mm = rng.standard_normal((n, n))
    from scipy.linalg import expm
    A = expm(h * (Mm - Mm.T))
    Bm = h * rng.standard_normal((n, m))
    Q, R = np.eye(n), 0.1 * np.eye(m)
    jm, jt = tracking.lti_track(jnp, jfk.LanesModel, A, Bm, Q, R, h)
    tm, tt = tracking.lti_track(torch, fk.LanesModel, A, Bm, Q, R, h)
    x0s = (0.3 * rng.standard_normal((B, n))).astype(np.float32)
    u0s = (0.1 * rng.standard_normal((B, T_SOLVE, m))).astype(np.float32)
    ref, out = _solve_both(jm, jt, tm, DerivsTiles(fn=tt), x0s, u0s,
                           ((-0.6, 0.6),) * m)
    _hold(ref, out)


def test_quad_track_with_autodiff_tiles_matches_jax():
    """The quadrotor tracking px = 0.5·sin(π/2·h·t), thrust box (0, 5),
    with autodiff tiles (torch.func on the CPU; Autodiff<Lowered> reading
    t on the card)."""
    jm = tracking.quad_track(jnp, jfk.LanesModel, jq.QuadrotorSpec())
    tspec = convert.quadrotor_spec_from_jax(jq.QuadrotorSpec())
    tm = tracking.quad_track(torch, fk.LanesModel, tspec)
    rng = np.random.default_rng(4)
    x0s = (np.asarray(tq.default_x0(device="cpu"))[None, :]
           + 0.2 * rng.standard_normal((B, 6))).astype(np.float32)
    u0s = np.full((B, T_SOLVE, 2), tspec.u_hover, np.float32)
    ref, out = _solve_both(jm, jax_autodiff_tiles(jm), tm,
                           autodiff_derivs_tiles(tm), x0s, u0s, tspec.lims)
    _hold(ref, out)
