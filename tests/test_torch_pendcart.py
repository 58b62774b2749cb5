"""The port's pendcart lane model and derivative tiles against the JAX
package's, on random states (numpy f64 from a seeded Generator, cast to
f32 for both). rtol 1e-5: the two packages form the model's derived
constants in different precisions (f64 then rounded, against f32 from the
f32 descriptor), which moves a result by a few ulps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc

B = 256
SPECS = [jpc.PendCartSpec(),
         jpc.PendCartSpec(Q=(3.0, 0.5, 1.0, 0.2), R=0.1,
                          goal=(np.pi, 0.0, 0.5, 0.0), l=0.5, d=0.5)]


def _states(seed=0):
    rng = np.random.default_rng(seed)
    x = (np.array([np.pi, 0, 0, 0])[:, None]
         + np.array([2.0, 3.0, 1.0, 2.0])[:, None]
         * rng.standard_normal((4, B))).astype(np.float32)
    u = (5.0 * rng.standard_normal((1, B))).astype(np.float32)
    return x, u


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("spec", SPECS)
def test_lanes_model_matches_jax(spec):
    x, u = _states()
    jm = jpc.pendcart_lanes(spec)
    tm = tpc.pendcart_lanes(convert.spec_from_jax(spec))
    jx, ju = [jnp.asarray(v) for v in x], [jnp.asarray(u[0])]
    tx, tu = [torch.from_numpy(v) for v in x], [torch.from_numpy(u[0])]
    for i, (a, b) in enumerate(zip(tm.dynamics(tx, tu, 0),
                                   jm.dynamics(jx, ju, 0))):
        _close(a, b, f"dynamics[{i}]")
    _close(tm.cost(tx, tu, 0), jm.cost(jx, ju, 0), "cost")
    _close(tm.terminal(tx), jm.terminal(jx), "terminal")
    assert (tm.n, tm.m) == (jm.n, jm.m) == (4, 1)


@pytest.mark.parametrize("spec", SPECS)
def test_derivs_tiles_match_jax(spec):
    x, u = _states(seed=1)
    jd = jpc.pendcart_derivs_tiles(spec)(
        [jnp.asarray(v) for v in x], [jnp.asarray(u[0])], 0)
    td = tpc.pendcart_derivs_tiles(convert.spec_from_jax(spec))(
        [torch.from_numpy(v) for v in x], [torch.from_numpy(u[0])], 0)
    assert set(td) == set(jd)
    for key in jd:
        a = np.stack([np.broadcast_to(np.asarray(v), (B,))
                      for v in np.asarray(td[key], dtype=object).ravel()])
        b = np.stack([np.broadcast_to(np.asarray(v), (B,))
                      for v in np.asarray(jd[key], dtype=object).ravel()])
        _close(a, b, key)


def test_device_descriptor_holds_the_spec_constants():
    spec = tpc.PendCartSpec(Q=(1.0, 2.0, 3.0, 4.0), R=0.5, l=0.4)
    for obj in (tpc.pendcart_lanes(spec), tpc.pendcart_derivs_tiles(spec)):
        dm = obj.device
        assert dm.model_id == 1 and dm.consts.dtype == np.float32
        np.testing.assert_array_equal(
            dm.consts, np.float32([spec.g, 0.4, spec.h, spec.d, 1, 2, 3, 4,
                                   0.5, *spec.goal]))
    x0 = tpc.default_x0(device="cpu")
    assert x0.dtype == torch.float32 and x0.shape == (4,)
    _close(x0.numpy(), np.asarray(jpc.default_x0()), "default_x0")
    _close(tpc.default_lims(device="cpu").numpy(),
           np.asarray(jpc.default_lims()),
           "default_lims")
