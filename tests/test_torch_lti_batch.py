"""The port's fleet solver on the LTI model (plain versions, CPU) against the
JAX package's ``ilqg_batch_lanes`` with its Pallas kernels in interpret
mode, and the device rule of the port's entry points.

Shapes and options follow ``tests/test_batch_driver.py:137-165`` (n=4,
T=6, B=8, 3-α ladder, max_iter 3, iter_cap 4, k_t 2) at m=2, with
per-control limits that bind and without limits. Inputs are made once in
numpy f64 with a seeded Generator and cast to f32 for both packages. The
reason-5 case is ``tests/test_batch_driver.py:168-211`` (n=1, m=1,
A=1e30), which needs the LTI model's zero-skipping rule to stay NaN-free.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu_torch import (
    GaussianPolicy, convert, default_lims, default_x0, make_pendcart_problem,
    random_lti)
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

N, M, T, B = 4, 2, 6, 8
LIMS = ((-0.3, 0.3), (-0.1, 0.4))


def _spec(seed=3):
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((N, N))
    f = jnp.float32
    return jl.LTISpec(A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), f),
                      B=jnp.asarray(0.3 * rng.standard_normal((N, M)), f),
                      Q=jnp.asarray(0.5 * np.eye(N), f),
                      R=jnp.asarray(0.05 * np.eye(M), f),
                      x0=jnp.ones((N,), f),
                      u0=jnp.asarray(0.1 * rng.standard_normal((T, M)), f))


def _solve_both(spec, x0s, u0s, lims, reg_type, n_alphas=3, max_iter=3,
                iter_cap=4):
    jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, n_alphas),
                        reg_type=reg_type, max_iter=max_iter,
                        iter_cap=iter_cap)
    ref = J.ilqg_batch_lanes(
        jl.lti_lanes(spec), None, jnp.asarray(x0s), jnp.asarray(u0s),
        lims=lims, cfg=jcfg, derivs_tiles=jl.lti_derivs_tiles(spec),
        kt_backward=2, kt_forward=2, record_trace=True, interpret=True)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    out = ilqg_batch_lanes(
        tl.lti_lanes(tspec), None, torch.from_numpy(x0s),
        torch.from_numpy(u0s), lims=lims, cfg=convert.config_from_jax(jcfg),
        derivs_tiles=tl.lti_derivs_tiles(tspec), record_trace=True)
    return convert.result_to_numpy(ref), convert.result_to_numpy(out)


@pytest.fixture(scope="module", params=["limits", "unconstrained"])
def solved(request):
    spec = _spec()
    x0s = (np.ones((B, N)) * np.linspace(0.5, 2.0, B)[:, None]).astype(
        np.float32)
    u0s = np.tile(3.0 * np.asarray(spec.u0), (B, 1, 1)).astype(np.float32)
    if request.param == "limits":
        return request.param, _solve_both(spec, x0s, u0s, LIMS, 2)
    return request.param, _solve_both(spec, x0s, u0s, None, 1)


def test_lti_batch_outcomes_match_jax(solved):
    kind, (ref, out) = solved
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert out["x"].shape == (B, T, N) and out["u"].shape == (B, T, M)
    if kind == "limits":
        # every control stays inside its limits, and each one binds
        u = out["u"]
        for i, (lo, hi) in enumerate(LIMS):
            assert np.all((u[..., i] >= np.float32(lo))
                          & (u[..., i] <= np.float32(hi)))
            assert np.any((u[..., i] == np.float32(lo))
                          | (u[..., i] == np.float32(hi)))


def test_lti_batch_policy_and_value_match_jax(solved):
    """K, the 2×2 Σ and Σ⁻¹, Vx, Vxx: f32 recursions on both sides that
    differ in rounding (XLA's multiply-add contraction on the host);
    rtol 1e-4 as the pendcart parity test."""
    _, (ref, out) = solved
    assert out["policy"]["sigma"].shape == (B, T, M, M)
    for name in ("K", "sigma", "sigma_inv"):
        np.testing.assert_allclose(out["policy"][name], ref["policy"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out["Vxx"], ref["Vxx"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["Vx"], ref["Vx"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-5, atol=1e-6)


def test_lti_batch_trace_matches_jax(solved):
    _, (ref, out) = solved
    for name in ("cost", "lam", "accepted", "alpha"):
        np.testing.assert_allclose(out["trace"][name], ref["trace"][name],
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_lti_reason5_matches_jax():
    """The initial rollout of lane 1 overflows (x' = 1e30·x): reason 5,
    the frozen initial rollout and the zero-gain unit-Σ policy, NaN-free
    because the model leaves out its zero terms (JAX
    tests/test_batch_driver.py:168-211)."""
    one = np.ones((1, 1), np.float32)
    spec = jl.LTISpec(A=jnp.asarray(1e30 * one), B=jnp.asarray(one),
                      Q=jnp.asarray(one), R=jnp.asarray(one),
                      x0=jnp.zeros((1,), jnp.float32),
                      u0=jnp.zeros((8, 1), jnp.float32))
    x0s = np.array([[0.0], [100.0]], np.float32)
    u0s = np.zeros((2, 8, 1), np.float32)
    ref, out = _solve_both(spec, x0s, u0s, None, 1, max_iter=2, iter_cap=3)
    np.testing.assert_array_equal(out["reason"], ref["reason"])
    assert out["reason"][1] == 5 and out["reason"][0] != 5
    assert not np.isnan(out["u"]).any() and not np.isnan(out["x"][0]).any()
    np.testing.assert_array_equal(out["u"][1], 0.0)
    np.testing.assert_array_equal(out["x"][1][0], [100.0])
    np.testing.assert_array_equal(out["policy"]["K"][1], 0.0)
    for name in ("sigma", "sigma_inv"):
        np.testing.assert_array_equal(out["policy"][name][1], 1.0)
        np.testing.assert_array_equal(out["policy"][name],
                                      ref["policy"][name])
    assert not np.isnan(out["Vxx"][1]).any()
    np.testing.assert_array_equal(out["x"], ref["x"])


def test_lti_reason5_restores_unit_sigma_on_the_diagonal():
    """At m=2 the reason-5 restore sets the diagonals of the Σ and Σ⁻¹
    blocks, not one slot each: Σ = Σ⁻¹ = I (JAX batch.py:605-611)."""
    eye = torch.eye(2)
    spec = tl.LTISpec(A=1e30 * eye, B=eye, Q=eye, R=eye, x0=torch.zeros(2),
                      u0=torch.zeros((T, 2)))
    x0s = torch.tensor([[0.0, 0.0], [100.0, 1.0]])
    cfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=1,
                       max_iter=2, iter_cap=3)
    out = ilqg_batch_lanes(tl.lti_lanes(spec), None, x0s,
                           torch.zeros((2, T, 2)),
                           cfg=convert.config_from_jax(cfg),
                           derivs_tiles=tl.lti_derivs_tiles(spec))
    assert out.reason.tolist()[1] == 5
    for name in ("sigma", "sigma_inv"):
        assert torch.equal(getattr(out.policy, name)[1],
                           eye.expand(T, 2, 2)), name
    assert torch.equal(out.policy.K[1], torch.zeros((T, 2, 2)))


def _on_card_or_raises(make):
    """Without a device argument the port builds on the CUDA card; here,
    without one, that raises instead of falling back to the CPU."""
    def tensors(v):       # the tensors of nested NamedTuples
        if isinstance(v, tuple):
            return [t for w in v if w is not None for t in tensors(w)]
        return [v]

    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in tensors(make()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()


@pytest.mark.parametrize("what", ["ilqg_batch_lanes", "default_x0",
                                  "default_lims", "make_pendcart_problem",
                                  "GaussianPolicy.zeros", "policy_from_jax",
                                  "random_lti", "lti_spec_from_jax"])
def test_non_tensor_inputs_and_default_devices_go_to_the_card(what):
    spec = tl.random_lti(0, n=N, m=M, T=T, device="cpu")
    x0s = np.ones((2, N), np.float32)
    u0s = np.zeros((2, T, M), np.float32)
    make = {
        "ilqg_batch_lanes": lambda: ilqg_batch_lanes(
            tl.lti_lanes(spec), None, x0s, u0s, lims=LIMS,
            derivs_tiles=tl.lti_derivs_tiles(spec)),
        "default_x0": default_x0,
        "default_lims": default_lims,
        "make_pendcart_problem": lambda: make_pendcart_problem(
            derivs="euler").derivs(torch.zeros((1, T, 4), device="cuda"),
                                   torch.zeros((1, T, 1), device="cuda")),
        "GaussianPolicy.zeros": lambda: GaussianPolicy.zeros(T, N, M),
        "policy_from_jax": lambda: convert.policy_from_jax(
            GaussianPolicy.zeros(T, N, M, device="cpu")),
        "random_lti": lambda: random_lti(0, n=N, m=M, T=T),
        "lti_spec_from_jax": lambda: convert.lti_spec_from_jax(spec),
    }[what]
    _on_card_or_raises(make)
