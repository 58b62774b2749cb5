"""The port's fleet solver (plain versions, CPU) against the JAX package's
``ilqg_batch_lanes`` with its Pallas kernels in interpret mode.

Shapes and options are those of the first test in
``tests/test_batch_driver.py`` (B=8, T=6, 3-α ladder, reg_type 2,
max_iter 2, iter_cap 3, k_t 2, record_trace) so that the JAX side compiles
the same program. Inputs are
made once in numpy f64 with a seeded Generator and cast to f32 for both
packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

B, T = 8, 6
LIMS = ((-5.0, 5.0),)


def _inputs(nan_lane=None):
    rng = np.random.default_rng(0)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.1 * rng.standard_normal((B, 4)))
    u0s = 0.1 * rng.standard_normal((B, T, 1))
    if nan_lane is not None:
        u0s[nan_lane, 2, 0] = np.nan
    return x0s.astype(np.float32), u0s.astype(np.float32)


def _solve_both(x0s, u0s, lims=LIMS):
    jspec = jpc.PendCartSpec()
    jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                        max_iter=2, iter_cap=3)
    ref = J.ilqg_batch_lanes(
        jpc.pendcart_lanes(jspec), None, jnp.asarray(x0s), jnp.asarray(u0s),
        lims=lims, cfg=jcfg, derivs_tiles=jpc.pendcart_derivs_tiles(jspec),
        kt_backward=2, kt_forward=2, record_trace=True, interpret=True)
    spec = convert.spec_from_jax(jspec)
    out = ilqg_batch_lanes(
        tpc.pendcart_lanes(spec), None, torch.from_numpy(x0s),
        torch.from_numpy(u0s), lims=lims, cfg=convert.config_from_jax(jcfg),
        derivs_tiles=tpc.pendcart_derivs_tiles(spec), record_trace=True)
    return convert.result_to_numpy(ref), convert.result_to_numpy(out)


@pytest.fixture(scope="module")
def solved():
    return _solve_both(*_inputs())


def test_batch_outcomes_match_jax(solved):
    ref, out = solved
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert out["x"].shape == (B, T, 4) and out["u"].shape == (B, T, 1)
    assert out["cost"].shape == (B, T)


def test_batch_policy_and_value_match_jax(solved):
    # f32 recursions on both sides; the two differ only in rounding (the
    # model's derived constants, host vs XLA transcendentals), which six
    # steps of Riccati recursion amplify to ~1e-5 relative
    ref, out = solved
    for name in ("K", "sigma", "sigma_inv"):
        np.testing.assert_allclose(out["policy"][name], ref["policy"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out["Vxx"], ref["Vxx"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["Vx"], ref["Vx"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-5, atol=1e-5)


def test_batch_trace_matches_jax(solved):
    ref, out = solved
    for name in ("cost", "lam", "accepted", "alpha"):
        np.testing.assert_allclose(out["trace"][name], ref["trace"][name],
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_batch_nan_lane_is_reason5_with_unit_sigma():
    """A NaN in one lane's u0s diverges its initial rollout: reason 5, the
    NaN scrub and the zero-gain unit-Σ restore (JAX batch.py:368-378,
    :595-618)."""
    ref, out = _solve_both(*_inputs(nan_lane=3))
    assert out["reason"][3] == 5 and ref["reason"][3] == 5
    np.testing.assert_array_equal(out["reason"], ref["reason"])
    assert not np.isnan(out["policy"]["K"]).any()
    np.testing.assert_array_equal(out["policy"]["K"][3], 0.0)
    np.testing.assert_array_equal(out["policy"]["sigma"][3], 1.0)
    np.testing.assert_array_equal(out["policy"]["sigma_inv"][3], 1.0)
    assert not np.isnan(out["u"][3]).any()
    healthy = np.arange(B) != 3
    np.testing.assert_allclose(out["cost_total"][healthy],
                               ref["cost_total"][healthy], rtol=1e-4)


def test_batch_unconstrained_matches_jax():
    """lims=None: K1's unconstrained solve and unclamped K3/K2 rollouts
    (JAX backward_kernel.py:514-522, forward_kernel.py:117-121)."""
    ref, out = _solve_both(*_inputs(), lims=None)
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for name in ("K", "sigma"):
        np.testing.assert_allclose(out["policy"][name], ref["policy"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out["trace"]["cost"], ref["trace"]["cost"],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kwargs,option", [
    (dict(packed_derivs=lambda x, u: None), "packed_derivs"),
    (dict(cfg=convert.config_from_jax(J.ILQGConfig(verbosity=2))),
     "verbosity"),
])
def test_batch_out_of_slice_options_raise(kwargs, option, capsys):
    """A generator that does not give K1's (T, D+m, B) stream is refused
    (ValueError). verbosity > 1, which used to raise here, now prints the
    fleet-aggregate rows (the text is held to JAX's in
    tests/test_torch_m3_fleet.py): a header and one row an iteration."""
    x0s, u0s = _inputs()
    spec = tpc.PendCartSpec()
    call = dict(lims=LIMS, derivs_tiles=tpc.pendcart_derivs_tiles(spec))
    call.update(kwargs)
    args = (tpc.pendcart_lanes(spec), call.pop("packed_derivs", None),
            torch.from_numpy(x0s), torch.from_numpy(u0s))
    if option == "packed_derivs":
        call["derivs_tiles"] = None
        with pytest.raises(ValueError, match=option):
            ilqg_batch_lanes(*args, **call)
        return
    res = ilqg_batch_lanes(*args, max_steps=3, **call)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("iteration   active      mean cost")
    assert len(lines) == 1 + int(res.n_iters.max())
    assert [int(r.split()[0]) for r in lines[1:]] == list(
        range(1, len(lines)))
