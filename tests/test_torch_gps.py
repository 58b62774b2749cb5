"""The port's GPS policy-improvement loop ``gps_rollout_lanes`` (a host
loop of re-centred KL solves, plain versions on the CPU) against the JAX
package's ``gps_rollout_lanes`` (one ``lax.scan``, Pallas kernels in
interpret mode).

Two cases. At ``kl_step=0.05`` (3 outer iterations) every inner iterate
runs at a well-conditioned η. At the chip's ``kl_step=2`` and
``max_iter=10`` (5 outer iterations) the bracket passes through η=0.1,
where V grows ~10× per step, and the reference itself shows the satisfied
share falling and the cost rising over the later outer iterations: the
port must follow it flag for flag.

Inputs as in ``tests/test_torch_kl.py``: numpy f64 from a seeded Generator,
cast to f32, pre-rolled once and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ILQGKLConfig as JKLConfig)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl

from test_torch_kl import SPEC, kl_inputs

B = 8
# (T, outer iterations, config). At kl_step=2 the horizon stays at T=10: at
# T=13 one lane's η=0.1 backward pass cancels Quu = 1623 (f64) to -278 in
# the JAX package's f32 and to 1634 in the port's, so one package retries
# that lane and the other does not.
CASES = {"kl_step=0.05": (8, 3, JKLConfig(kl_step=0.05, max_iter=3)),
         "kl_step=2": (10, 5, JKLConfig(kl_step=2.0, max_iter=10))}
NAMES = ("cost_total", "eta", "divergence", "satisfied", "kl_violated")


@pytest.fixture(scope="module", params=list(CASES))
def rolled(request):
    T, OUTER, CFG = CASES[request.param]
    inp = kl_inputs(B=B, T=T, seed=5)
    jprob = jpc.make_pendcart_problem(SPEC, derivs="euler", dtype=jnp.float32)
    jderivs = jax.vmap(jprob.make_derivs())
    jprev = JPolicy(**{k: jnp.asarray(v) for k, v in inp["policy"].items()})
    jx, jpol, jper = jkl.gps_rollout_lanes(
        jpc.pendcart_lanes(SPEC), jpc.pendcart_derivs_tiles(SPEC),
        jnp.asarray(inp["x"]), jprev, jnp.asarray(inp["cost0"]),
        lambda x, u: jderivs(x, u).fx, OUTER, cfg=CFG, kt=4, unroll=1,
        interpret=True)
    tspec = convert.spec_from_jax(SPEC)
    tprob = tpc.make_pendcart_problem(tspec, derivs="euler", device="cpu")
    tx, tpol, tper = tkl.gps_rollout_lanes(
        tpc.pendcart_lanes(tspec), tpc.pendcart_derivs_tiles(tspec),
        torch.from_numpy(inp["x"]),
        convert.policy_from_jax(jprev, device="cpu"),
        torch.from_numpy(inp["cost0"]), lambda x, u: tprob.derivs(x, u).fx,
        OUTER, cfg=convert.kl_config_from_jax(CFG))
    ref = dict(zip(NAMES, map(np.asarray, jper)), x=np.asarray(jx),
               K=np.asarray(jpol.K), sigma=np.asarray(jpol.sigma))
    out = dict(zip(NAMES, (a.numpy() for a in tper)), x=tx.numpy(),
               K=tpol.K.numpy(), sigma=tpol.sigma.numpy())
    return ref, out


def test_gps_per_outer_matches_jax(rolled):
    ref, out = rolled
    assert out["cost_total"].shape == ref["cost_total"].shape
    assert out["cost_total"].shape[1] == B
    for name in ("satisfied", "kl_violated"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for name in ("cost_total", "eta", "divergence"):
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-4,
                                   err_msg=name)


def test_gps_final_policy_matches_jax(rolled):
    ref, out = rolled
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-5, atol=1e-5)
    for name in ("K", "sigma"):
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert np.isfinite(out["x"]).all()
