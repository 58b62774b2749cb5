"""The port's quadrotor (n=6, m=2, thrust box (0, 5)) against the JAX
package's: the lane model and its descriptor, the Problem in f64 with its
autodiff derivatives and (T+1,) trajectory cost, and the fleet solve with
autodiff derivative tiles against JAX ``ilqg_batch_lanes`` with its Pallas
kernels in interpret mode (JAX ``tests/test_quadrotor.py:63-94``).

Inputs are made in numpy f64 from a seeded Generator and cast for both
packages. The JAX side runs as its own tests run it on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import quadrotor as jq
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_autodiff_tiles)
from differentialdynamicprogramming_jl_tpu_torch import (
    autodiff_derivs_tiles, convert)
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

B, T = 8, 6
SPECS = [jq.QuadrotorSpec(),
         jq.QuadrotorSpec(mass=0.7, inertia=0.02, arm=0.2, h=0.05, u_max=4.0,
                          Q=(2.0, 0.2, 1.5, 0.3, 1.0, 0.1), R=0.1,
                          goal=(0.5, 0.0, 2.0, 0.0, 0.0, 0.0))]


def _states(n, m, dtype, seed=0, size=(64,)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + size).astype(dtype)
    u = (2.45 + rng.standard_normal((m,) + size)).astype(dtype)
    return x, u


@pytest.mark.parametrize("spec", SPECS)
def test_quadrotor_lanes_match_jax(spec):
    """f32 lane functions: the same operations in the same order on both
    sides; XLA on the CPU may contract a multiply-add, so rtol 1e-6."""
    x, u = _states(6, 2, np.float32)
    jm = jq.quadrotor_lanes(spec)
    tm = tq.quadrotor_lanes(convert.quadrotor_spec_from_jax(spec))
    jx, ju = [jnp.asarray(v) for v in x], [jnp.asarray(v) for v in u]
    tx, tu = [torch.from_numpy(v) for v in x], [torch.from_numpy(v) for v in u]
    for i, (a, b) in enumerate(zip(tm.dynamics(tx, tu, 0),
                                   jm.dynamics(jx, ju, 0))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=f"dynamics[{i}]")
    np.testing.assert_allclose(tm.cost(tx, tu, 0).numpy(),
                               np.asarray(jm.cost(jx, ju, 0)), rtol=1e-6)
    np.testing.assert_allclose(tm.terminal(tx).numpy(),
                               np.asarray(jm.terminal(jx)), rtol=1e-6)
    assert (tm.n, tm.m) == (jm.n, jm.m) == (6, 2)


def test_quadrotor_descriptor_and_defaults():
    spec = tq.QuadrotorSpec(mass=0.6, Q=(1, 2, 3, 4, 5, 6), R=0.2)
    dm = tq.quadrotor_lanes(spec).device
    assert dm.model_id == 3 and not dm.autodiff
    assert dm.consts.dtype == np.float32 and dm.consts.shape == (19,)
    np.testing.assert_array_equal(dm.consts, np.float32(
        [0.6, spec.inertia, spec.arm, spec.g, spec.h, 0.6 * spec.g / 2,
         1, 2, 3, 4, 5, 6, 0.2, *spec.goal]))
    js = jq.QuadrotorSpec()
    ts = convert.quadrotor_spec_from_jax(js)
    assert ts == tq.QuadrotorSpec() and ts.lims == js.lims == ((0.0, 5.0),) * 2
    assert ts.u_hover == js.u_hover
    np.testing.assert_array_equal(tq.default_x0(device="cpu").numpy(),
                                  np.asarray(jq.default_x0()))
    assert tq.default_x0(torch.float64, device="cpu").dtype == torch.float64


@pytest.mark.parametrize("spec", SPECS)
def test_quadrotor_problem_matches_jax_f64(spec):
    """make_quadrotor_problem in f64: dynamics, cost, the (T+1,)
    trajectory cost and the autodiff derivative stack against JAX's."""
    jp = jq.make_quadrotor_problem(spec, dtype=jnp.float64)
    tp = tq.make_quadrotor_problem(convert.quadrotor_spec_from_jax(spec),
                                   dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, T, 6))
    u = 2.45 + rng.standard_normal((3, T, 2))
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    for fn in ("dynamics", "cost"):
        a = getattr(tp, fn)(tx[:, 0], tu[:, 0], 0).numpy()
        b = np.asarray(jax.vmap(lambda p, q: getattr(jp, fn)(p, q, 0))(
            jnp.asarray(x[:, 0]), jnp.asarray(u[:, 0])))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14, err_msg=fn)
    tc = tp.trajectory_cost(tx, tu).numpy()
    assert tc.shape == (3, T + 1)
    np.testing.assert_allclose(
        tc, np.asarray(jax.vmap(jp.trajectory_cost)(jnp.asarray(x),
                                                    jnp.asarray(u))),
        rtol=1e-12)
    assert tp.derivs is None and jp.derivs is None
    jd = jax.vmap(jp.make_derivs())(jnp.asarray(x), jnp.asarray(u))
    td = tp.make_derivs()(tx, tu)
    for name in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu"):
        a, b = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14,
                                   err_msg=name)


# "hover": the spec and the x0 spread of the JAX benchmark tier
# (bench.py:230-235); "clamped": a spec whose height weight and lower
# thrust limit make both bounds bind within T=6 steps (from 2 m above the
# start height every rotor is cut to 0 on some steps, and held at 3 on
# others), so that the m=2 box QP's active sets are exercised
CASES = {"hover": (jq.QuadrotorSpec(), 0.0),
         "clamped": (jq.QuadrotorSpec(u_max=3.0,
                                      Q=(1.0, 0.1, 50.0, 5.0, 0.5, 0.05)),
                     2.0)}


@pytest.fixture(scope="module", params=sorted(CASES))
def solved(request):
    """The fleet solve of both packages on the same f32 inputs: x0 around
    default_x0 with lateral, height and tilt offsets, u0 around hover. JAX's
    kernels take one step a grid step (k_t=1): the same per-step
    operations as at k_t=2, and half the interpret-mode program to
    compile (about half the compile time)."""
    spec, dz = CASES[request.param]
    rng = np.random.default_rng(0)
    x0s = (np.asarray(jq.default_x0(jnp.float64))[None, :]
           + np.array([0, 0, dz, 0, 0, 0])
           + 0.3 * rng.standard_normal((B, 6))
           * np.array([1, 0, 1, 0, 0.5, 0])).astype(np.float32)
    u0s = (spec.u_hover + 0.1 * rng.standard_normal((B, T, 2))).astype(
        np.float32)
    jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                        lam_max=1e15, max_iter=3, iter_cap=4)
    jm = jq.quadrotor_lanes(spec)
    ref = J.ilqg_batch_lanes(jm, None, jnp.asarray(x0s), jnp.asarray(u0s),
                             lims=spec.lims, cfg=jcfg,
                             derivs_tiles=jax_autodiff_tiles(jm),
                             kt_backward=1, kt_forward=1, record_trace=True,
                             interpret=True)
    tm = tq.quadrotor_lanes(convert.quadrotor_spec_from_jax(spec))
    out = ilqg_batch_lanes(tm, None, torch.from_numpy(x0s),
                           torch.from_numpy(u0s), lims=spec.lims,
                           cfg=convert.config_from_jax(jcfg),
                           derivs_tiles=autodiff_derivs_tiles(tm),
                           record_trace=True)
    return spec, convert.result_to_numpy(ref), convert.result_to_numpy(out)


def test_quadrotor_solve_outcomes_match_jax(solved):
    spec, ref, out = solved
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4, atol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert out["x"].shape == (B, T, 6) and out["u"].shape == (B, T, 2)
    u = out["u"]
    assert u.min() >= -1e-6 and u.max() <= spec.u_max + 1e-6
    assert np.all(out["n_accepted"] >= 1)
    if spec.u_max == 3.0:
        # both bounds bind: some rotor is cut to 0, some held at u_max
        assert np.any(u == 0.0) and np.any(u == np.float32(spec.u_max))


def test_quadrotor_solve_policy_and_trace_match_jax(solved):
    """K, Σ, Vx and the per-iteration trace: f32 recursions that differ in
    rounding (XLA's multiply-add contraction on the host) and, where one
    rotor is clamped, in the box QP's near-ties; rtol 1e-3 on the policy."""
    _, ref, out = solved
    for name in ("cost", "lam", "accepted", "alpha"):
        np.testing.assert_allclose(out["trace"][name], ref["trace"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["Vx"], ref["Vx"], rtol=1e-3, atol=1e-4)
    for name in ("K", "sigma"):
        a, b = out["policy"][name], ref["policy"][name]
        close = np.isclose(a, b, rtol=1e-3, atol=1e-4)
        assert close.mean() >= 0.99, (name, close.mean())
