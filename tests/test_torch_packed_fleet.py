"""The fleet driver on K1's packed-derivatives input, and
``backward_pass_pallas`` in GPS mode, against the JAX package (its Pallas
kernels in interpret mode, k_t=2):

- ``ilqg_batch_lanes`` with ``pendcart_packed_derivs`` (as
  ``tests/test_batch_driver.py:118``), and against the port's own solve
  with in-kernel tiles;
- one ``mpc_rollout_lanes`` case with packed derivatives (the shapes of
  ``tests/test_torch_mpc.py``);
- ``backward_pass_pallas`` with a previous policy and per-step η (as
  ``tests/test_pallas_kernels.py:155-180``), with the helpers of
  ``tests/test_torch_packed.py``.

Costs to rtol 1e-4 with equal reasons and accepted counts, the JAX tests'
own tolerance. Inputs are made in numpy f64 with a seeded Generator and
cast to f32. Apart from ``tests/test_torch_packed.py`` so that each file's
JAX compiles stay under a minute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes, mpc_rollout_lanes)

from test_torch_packed import (B as B_K1, LIMS as LIMS_K1, T as T_K1,
                               _cmp_pallas, _derivs_np, _packed_input,
                               _pallas_both)

B, T = 8, 6
LIMS = ((-5.0, 5.0),)
SPEC = jpc.PendCartSpec()
TSPEC = convert.spec_from_jax(SPEC)
KT = dict(kt_backward=2, kt_forward=2, interpret=True)


def _inputs(Bn=B, seed=0):
    rng = np.random.default_rng(seed)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.1 * rng.standard_normal((Bn, 4)))
    u0s = 0.1 * rng.standard_normal((Bn, T, 1))
    return x0s.astype(np.float32), u0s.astype(np.float32)


def _outcomes(out, ref):
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


def test_fleet_packed_matches_jax():
    x0s, u0s = _inputs()
    jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                        max_iter=2, iter_cap=3)
    cfg = convert.config_from_jax(jcfg)
    ref = convert.result_to_numpy(J.ilqg_batch_lanes(
        jpc.pendcart_lanes(SPEC), jpc.pendcart_packed_derivs(SPEC),
        jnp.asarray(x0s), jnp.asarray(u0s), lims=LIMS, cfg=jcfg, **KT))
    model = tpc.pendcart_lanes(TSPEC)
    res = ilqg_batch_lanes(model, tpc.pendcart_packed_derivs(TSPEC),
                           torch.from_numpy(x0s), torch.from_numpy(u0s),
                           lims=LIMS, cfg=cfg)
    out = convert.result_to_numpy(res)
    _outcomes(out, ref)
    for name in ("K", "sigma"):
        np.testing.assert_allclose(out["policy"][name], ref["policy"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out["Vx"], ref["Vx"], rtol=1e-4, atol=1e-4)
    # the packed stream carries the tiles' bits: the same solve
    tiles = convert.result_to_numpy(ilqg_batch_lanes(
        model, None, torch.from_numpy(x0s), torch.from_numpy(u0s), lims=LIMS,
        cfg=cfg, derivs_tiles=tpc.pendcart_derivs_tiles(TSPEC)))
    for name in ("cost_total", "reason", "n_accepted", "x", "u"):
        np.testing.assert_array_equal(out[name], tiles[name], err_msg=name)


def test_mpc_packed_matches_jax():
    """mpc_rollout_lanes with the packed-derivatives generator, B=2, T=6,
    3 steps, ±10 (tests/test_torch_mpc.py's MPC case)."""
    x, u = _inputs(2, seed=2)
    jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                        lam_max=1e15, max_iter=1, iter_cap=3)
    jprob = jpc.make_pendcart_problem(SPEC, derivs="euler", dtype=jnp.float32)
    prob = tpc.make_pendcart_problem(TSPEC, "euler", device="cpu")

    def jplant(a, b):
        return jax.vmap(lambda p, q: jprob.dynamics(p, q, 0))(a, b)

    ref = J.mpc_rollout_lanes(
        jpc.pendcart_lanes(SPEC), jpc.pendcart_packed_derivs(SPEC),
        jnp.asarray(x), jnp.asarray(u), jplant, 3, lims=((-10.0, 10.0),),
        cfg=jcfg, **KT)
    out = mpc_rollout_lanes(
        tpc.pendcart_lanes(TSPEC), tpc.pendcart_packed_derivs(TSPEC),
        torch.from_numpy(x), torch.from_numpy(u),
        lambda a, b: prob.dynamics(a, b, 0), 3, lims=((-10.0, 10.0),),
        cfg=convert.config_from_jax(jcfg))
    names = ("x_final", "u_final", "states", "controls", "costs")
    for name, r, o in zip(names, ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("use_limits", [False, True])
def test_backward_pass_pallas_gps_matches_jax(use_limits):
    """GPS mode: the KL expansion of a previous policy, per-step η (JAX
    tests/test_pallas_kernels.py:155-180)."""
    _, dp, _ = _packed_input(1)
    d, u = _derivs_np(dp.numpy())
    rng = np.random.default_rng(7)
    f = np.float32
    prev = dict(K=(0.3 * rng.standard_normal((B_K1, T_K1, 1, 4))).astype(f),
                k=(0.2 * rng.standard_normal((B_K1, T_K1, 1))).astype(f),
                sigma=np.full((B_K1, T_K1, 1, 1), 0.5, f),
                sigma_inv=np.full((B_K1, T_K1, 1, 1), 2.0, f))
    eta = (0.5 + rng.uniform(0, 1, (B_K1, T_K1))).astype(f)
    ref, out = _pallas_both(
        d, u, np.zeros(B_K1, f), reg_type=1,
        lims=np.asarray(LIMS_K1, f) if use_limits else None,
        use_limits=use_limits, eta=eta, traj_prev=prev)
    _cmp_pallas(ref, out)
