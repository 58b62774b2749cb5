"""The MPC serving path of the port (plain versions, CPU) against the JAX
package with its Pallas kernels in interpret mode: the warm-start,
pre-rolled and resume entries of ``ilqg_batch_lanes``, the MPC step
``ilqg_iteration_lanes`` and the receding-horizon loop ``mpc_rollout_lanes``.

Shapes are the JAX tests' own (``tests/test_batch_driver.py``,
``tests/test_mpc_rollout.py``): B ≤ 8, T = 6, k_t = 2 or 3, iter_cap ≤ 9.
Inputs are made once in numpy f64 from a seeded Generator and cast to f32
for both packages. Tolerances: costs rtol 1e-4 with reasons and accepted
counts equal (the JAX tests' own); states, controls and gains rtol 1e-4,
atol 1e-5, because XLA on the host contracts multiply-adds and its sin/cos
differ from PyTorch's by an ulp, which a few Riccati steps amplify to
~1e-5 relative. The port against itself is held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import forward_lanes
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    to_streams)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes, ilqg_iteration_lanes, mpc_rollout_lanes)

B, T = 8, 6
LIMS = ((-5.0, 5.0),)
JSPEC = jpc.PendCartSpec()
SPEC = convert.spec_from_jax(JSPEC)
JCFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                    max_iter=2, iter_cap=3)
CFG = convert.config_from_jax(JCFG)
KT = dict(kt_backward=2, kt_forward=2, interpret=True)


def _inputs(Bn=B, seed=0):
    rng = np.random.default_rng(seed)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.2 * rng.standard_normal((Bn, 4)) * np.array([1, 1, 0, 0]))
    u0s = 0.1 * rng.standard_normal((Bn, T, 1))
    return x0s.astype(np.float32), u0s.astype(np.float32)


def _jax(x0s, u0s, **kw):
    kw.setdefault("lims", LIMS)
    kw.setdefault("cfg", JCFG)
    return convert.result_to_numpy(J.ilqg_batch_lanes(
        jpc.pendcart_lanes(JSPEC), None, jnp.asarray(x0s), jnp.asarray(u0s),
        derivs_tiles=jpc.pendcart_derivs_tiles(JSPEC), **KT, **kw))


def _port(x0s, u0s, **kw):
    kw.setdefault("lims", LIMS)
    kw.setdefault("cfg", CFG)
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return convert.result_to_numpy(ilqg_batch_lanes(
        tpc.pendcart_lanes(SPEC), None, torch.from_numpy(x0s),
        torch.from_numpy(u0s), derivs_tiles=tpc.pendcart_derivs_tiles(SPEC),
        **kw))


def _check(ref, out):
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for name in ("x", "u", "cost", "lam", "dlam"):
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out["policy"]["K"], ref["policy"]["K"],
                               rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def warm():
    x0s, u0s = _inputs()
    return (x0s, u0s, _jax(x0s, u0s, warm_start=True, record_trace=True),
            _port(x0s, u0s, warm_start=True, record_trace=True))


def test_warm_start_matches_jax(warm):
    """warm_start: one K3 roll at α=1 and no sweep (JAX batch.py:349-367)."""
    _, _, ref, out = warm
    _check(ref, out)
    np.testing.assert_allclose(out["trace"]["cost"], ref["trace"]["cost"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out["trace"]["alpha"], ref["trace"]["alpha"],
                               rtol=1e-6)


def test_warm_start_rolls_at_alpha_one():
    """The warm start's initial rollout is the K3 roll of u0s at α=1, where
    the sweep may take a smaller α: the port's trace row 0 is that roll's
    cost, lane for lane."""
    x0s, u0s = _inputs()
    u0s = 40.0 * u0s                     # a plan the sweep would shrink
    out = ilqg_batch_lanes(
        tpc.pendcart_lanes(SPEC), None, torch.from_numpy(x0s),
        torch.from_numpy(u0s), lims=None, cfg=CFG, warm_start=True,
        derivs_tiles=tpc.pendcart_derivs_tiles(SPEC), max_steps=0,
        record_trace=True)
    gains = torch.cat([to_streams(torch.from_numpy(u0s)),
                       torch.zeros((T, 4, B))], dim=1)
    ro = forward_lanes(torch.zeros((T, 5, B)), gains,
                       torch.from_numpy(x0s).T.contiguous(), torch.ones(1, B),
                       model=tpc.pendcart_lanes(SPEC), emit_traj=True)
    assert torch.equal(out.trace.cost[:, 0], ro.totals[0])
    assert torch.equal(out.u, torch.from_numpy(u0s))


def _pre_rolled(seed=1):
    """A rollout of u0s with a little noise on x, so the trajectory is not
    the dynamics' own (its rejected lanes must then stay verbatim), and its
    per-step costs scaled by 1.01 (a cost0 the model would not give)."""
    x0s, u0s = _inputs(seed=seed)
    gains = torch.cat([to_streams(torch.from_numpy(u0s)),
                       torch.zeros((T, 4, B))], dim=1)
    ro = forward_lanes(torch.zeros((T, 5, B)), gains,
                       torch.from_numpy(x0s).T.contiguous(), torch.ones(1, B),
                       model=tpc.pendcart_lanes(SPEC), emit_traj=True)
    rng = np.random.default_rng(seed + 10)
    x = ro.traj[:, :4].permute(2, 0, 1).double().numpy()
    x = (x + 1e-3 * rng.standard_normal(x.shape)).astype(np.float32)
    c = (1.01 * ro.traj[:, 5].T.double().numpy()).astype(np.float32)
    return x, u0s, c


def _jax_costs(x, u):
    """Per-step (B, T) and terminal (B,) costs of a pre-rolled trajectory by
    the JAX model's own lane functions, as its pre-rolled entry evaluates
    them without cost0 (JAX batch.py:138-160)."""
    jm = jpc.pendcart_lanes(JSPEC)
    c = np.stack([np.asarray(jm.cost([jnp.asarray(x[:, t, i])
                                      for i in range(4)],
                                     [jnp.asarray(u[:, t, 0])], t))
                  for t in range(T)], axis=1)
    cT = np.asarray(jm.terminal([jnp.asarray(x[:, T - 1, i])
                                 for i in range(4)]))
    return c.astype(np.float32), cT.astype(np.float32)


def _jax_pre_rolled(x, u, cost0, lam0=None, dlam0=None, accepted0=None):
    """JAX's pre-rolled solve, always with a (B, T) cost0 and the resume
    counters (JAX's defaults where not given: cfg.lam, cfg.dlam, 0 accepted,
    batch.py:392-397), so that every pre-rolled case of this module runs
    one JAX structure and JAX traces its solver once."""
    ones = np.ones(x.shape[0], np.float32)
    return _jax(x, u, cost0=cost0,
                lam0=JCFG.lam * ones if lam0 is None else lam0,
                dlam0=JCFG.dlam * ones if dlam0 is None else dlam0,
                accepted0=(np.zeros(x.shape[0], np.int32) if accepted0 is None
                           else accepted0))


@pytest.mark.parametrize("cost0", ["none", "B_T", "B_T+1"])
def test_pre_rolled_matches_jax(cost0):
    """Pre-rolled (B, T, n) x0s used verbatim (JAX batch.py:330-347), the
    accept-select on the stream in the loop (:508-513), with the per-step
    costs from the model's functions, from cost0 (B, T), or from cost0
    (B, T+1) with the terminal cost last. JAX is given the same costs as a
    (B, T) cost0: the model's own where the port evaluates them, and its
    terminal cost at the stored last state where the port is handed it."""
    x, u0s, c = _pre_rolled()
    cm, cT = _jax_costs(x, u0s)
    kw = {}
    if cost0 == "B_T":
        kw["cost0"] = c
    elif cost0 == "B_T+1":
        kw["cost0"] = np.concatenate([c, cT[:, None]], axis=1)
    ref = _jax_pre_rolled(x, u0s, cm if cost0 == "none" else c)
    out = _port(x, u0s, record_trace=True, **kw)
    _check(ref, out)
    assert out["x"].shape == (B, T, 4)
    rejected_all = out["n_accepted"] == 0
    np.testing.assert_array_equal(out["x"][rejected_all], x[rejected_all])
    if cost0 == "B_T+1":
        # the supplied terminal cost is the one used: another value moves
        # the initial total by exactly the difference
        kw["cost0"] = np.concatenate([c, cT[:, None] + 1.0], axis=1)
        moved = _port(x, u0s, record_trace=True, max_steps=0, **kw)
        np.testing.assert_allclose(moved["trace"]["cost"][:, 0],
                                   out["trace"]["cost"][:, 0] + 1.0,
                                   rtol=1e-6)


def test_pre_rolled_reason5_matches_jax():
    """A supplied trajectory with an Inf state and cost: reason 5, the
    trajectory back verbatim (Inf included), a zero-gain unit-Σ policy
    (JAX batch.py:595-618; tests/test_batch_driver.py:214-252)."""
    T_, B_ = 8, 2
    one = jnp.ones((1, 1), jnp.float32)
    spec = jl.LTISpec(A=one, B=one, Q=one, R=one,
                      x0=jnp.zeros((1,), jnp.float32),
                      u0=jnp.zeros((T_, 1), jnp.float32))
    x0s = np.ones((B_, T_, 1), np.float32)
    x0s[1, 5, 0] = np.inf
    u0s = np.zeros((B_, T_, 1), np.float32)
    cost0 = np.full((B_, T_), 0.5, np.float32)
    cost0[1, 5] = np.inf
    ref = convert.result_to_numpy(J.ilqg_batch_lanes(
        jl.lti_lanes(spec), None, jnp.asarray(x0s), jnp.asarray(u0s),
        cost0=jnp.asarray(cost0), cfg=JCFG,
        derivs_tiles=jl.lti_derivs_tiles(spec), **KT))
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tl.lti_lanes(tspec), None, torch.from_numpy(x0s),
        torch.from_numpy(u0s), cost0=torch.from_numpy(cost0), cfg=CFG,
        derivs_tiles=tl.lti_derivs_tiles(tspec)))
    np.testing.assert_array_equal(out["reason"], ref["reason"])
    assert out["reason"][1] == 5 and out["reason"][0] != 5
    np.testing.assert_array_equal(out["x"][1], x0s[1])
    np.testing.assert_array_equal(out["u"][1], 0.0)
    np.testing.assert_array_equal(out["policy"]["K"][1], 0.0)
    np.testing.assert_array_equal(out["policy"]["sigma"][1], 1.0)
    np.testing.assert_array_equal(out["policy"]["sigma_inv"][1], 1.0)
    assert not np.isnan(out["Vxx"][1]).any()
    np.testing.assert_allclose(out["cost_total"][0], ref["cost_total"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(out["x"][0], ref["x"][0], rtol=1e-5)


def test_resume_counters_match_jax(warm):
    """Resume a solve from a result: its trajectory pre-rolled with cost0,
    and lam0/dlam0/accepted0 (JAX batch.py:392-397), in both packages."""
    _, _, ref0, out0 = warm
    ref = _jax_pre_rolled(ref0["x"], ref0["u"], ref0["cost"], ref0["lam"],
                          ref0["dlam"], ref0["n_accepted"])
    out = _port(out0["x"], out0["u"], cost0=out0["cost"], lam0=out0["lam"],
                dlam0=out0["dlam"], accepted0=out0["n_accepted"])
    _check(ref, out)
    assert (out["n_accepted"] >= out0["n_accepted"]).all()


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(a))


def test_iteration_lanes_matches_jax():
    """Three MPC steps (K1 gains, K2 in place, JAX's λ rule, JAX
    batch.py:646-707) against JAX's step. The port's step overwrites its
    input stream, so each call gets a clone."""
    x0s, u0s = _inputs()
    gains = torch.cat([to_streams(torch.from_numpy(u0s)),
                       torch.zeros((T, 4, B))], dim=1)
    ro = forward_lanes(torch.zeros((T, 5, B)), gains,
                       torch.from_numpy(x0s).T.contiguous(), torch.ones(1, B),
                       model=tpc.pendcart_lanes(SPEC), lims=LIMS,
                       emit_traj=True)
    jstep = J.ilqg_iteration_lanes(
        jpc.pendcart_lanes(JSPEC), None, LIMS, JCFG,
        derivs_tiles=jpc.pendcart_derivs_tiles(JSPEC), **KT)
    step = ilqg_iteration_lanes(tpc.pendcart_lanes(SPEC), None, LIMS, CFG,
                                derivs_tiles=tpc.pendcart_derivs_tiles(SPEC))
    traj, tot = ro.traj, ro.totals[0]
    lam = torch.full((B,), CFG.lam)
    jt, jc, jlam = (_lanes(traj.numpy()), _lanes(tot.numpy()),
                    _lanes(lam.numpy()))
    # deterministic, and the input stream is overwritten with the result
    a, b = traj.clone(), traj.clone()
    ta, ca, la = step(a, tot, lam)
    tb, cb, lb = step(b, tot, lam)
    assert ta.data_ptr() == a.data_ptr() and torch.equal(a, b)
    assert torch.equal(ca, cb) and torch.equal(la, lb)
    for _ in range(3):
        traj, tot, lam = step(traj.clone(), tot, lam)
        jt, jc, jlam = jstep(jt, jc, jlam)
        np.testing.assert_allclose(tot.numpy(),
                                   convert.stream_from_lanes(jc, B),
                                   rtol=1e-4)
        np.testing.assert_array_equal(lam.numpy(),
                                      convert.stream_from_lanes(jlam, B))
        np.testing.assert_allclose(traj.numpy(),
                                   convert.stream_from_lanes(jt, B),
                                   rtol=1e-4, atol=1e-5)


MPC_CFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                       lam_max=1e15, max_iter=1, iter_cap=3)
JPROB = jpc.make_pendcart_problem(JSPEC, derivs="euler", dtype=jnp.float32)
PROB = tpc.make_pendcart_problem(SPEC, "euler", device="cpu")


def _jplant(x, u):
    return jax.vmap(lambda a, b: JPROB.dynamics(a, b, 0))(x, u)


def _plant(x, u):
    return PROB.dynamics(x, u, 0)


def _mpc_inputs(Bn):
    x, u = _inputs(Bn, seed=2)
    return x, u


def _check_mpc(ref, out):
    names = ("x_final", "u_final", "states", "controls", "costs")
    for name, r, o in zip(names, ref, out):
        rtol = 1e-4 if name == "costs" else 1e-4
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=rtol,
                                   atol=1e-5, err_msg=name)


def test_mpc_rollout_matches_jax_and_host_loop():
    """mpc_rollout_lanes at the JAX test's shapes (B=2, T=6, 3 steps,
    tests/test_mpc_rollout.py) against JAX's lax.scan chain, and against
    the port's own host loop of warm-started solves bit for bit."""
    x, u = _mpc_inputs(2)
    ref = J.mpc_rollout_lanes(
        jpc.pendcart_lanes(JSPEC), None, jnp.asarray(x), jnp.asarray(u),
        _jplant, 3, lims=((-10.0, 10.0),), cfg=MPC_CFG,
        derivs_tiles=jpc.pendcart_derivs_tiles(JSPEC), **KT)
    cfg = convert.config_from_jax(MPC_CFG)
    model, tiles = tpc.pendcart_lanes(SPEC), tpc.pendcart_derivs_tiles(SPEC)
    out = mpc_rollout_lanes(model, None, torch.from_numpy(x),
                            torch.from_numpy(u), _plant, 3,
                            lims=((-10.0, 10.0),), cfg=cfg,
                            derivs_tiles=tiles)
    assert out[2].shape == (3, 2, 4) and out[3].shape == (3, 2, 1)
    assert out[4].shape == (3, 2)
    _check_mpc(ref, out)
    xh, uh = torch.from_numpy(x), torch.from_numpy(u)
    for i in range(3):
        res = ilqg_batch_lanes(model, None, xh, uh, lims=((-10.0, 10.0),),
                               cfg=cfg, derivs_tiles=tiles, warm_start=True)
        u0 = res.u[:, 0]
        xh = _plant(xh, u0)
        uh = torch.cat([res.u[:, 1:], torch.zeros((2, 1, 1))], dim=1)
        assert torch.equal(out[2][i], xh) and torch.equal(out[3][i], u0)
        assert torch.equal(out[4][i], res.cost_total)
    assert torch.equal(out[0], xh) and torch.equal(out[1], uh)


def test_mpc_params_and_lims_match_jax():
    """The MPC loop on a heterogeneous fleet: per-scenario [l, d] and
    limits through every re-solve, with a plant that steps each lane's own
    pendulum, against JAX."""
    Bn = 4
    x, u = _mpc_inputs(Bn)
    rng = np.random.default_rng(4)
    params = np.stack([rng.uniform(0.25, 0.55, Bn),
                       rng.uniform(0.5, 1.5, Bn)], axis=1).astype(np.float32)
    hi = rng.uniform(0.8, 6.0, Bn)
    lims = np.stack([-hi, hi], axis=-1)[:, None, :].astype(np.float32)
    jmodel = jpc.pendcart_lanes_param(JSPEC)
    jpar = [jnp.asarray(params[:, 0]), jnp.asarray(params[:, 1])]

    def jplant(x_, u_):
        return jnp.stack(jmodel.dynamics(list(x_.T), list(u_.T), 0, jpar),
                         axis=1)

    ref = J.mpc_rollout_lanes(
        jmodel, None, jnp.asarray(x), jnp.asarray(u), jplant, 3,
        lims=jnp.asarray(lims), cfg=MPC_CFG,
        derivs_tiles=jpc.pendcart_derivs_tiles_param(JSPEC),
        params=jnp.asarray(params), **KT)
    model = tpc.pendcart_lanes_param(SPEC)
    par = [torch.from_numpy(params[:, 0]), torch.from_numpy(params[:, 1])]

    def plant(x_, u_):
        return torch.stack(model.dynamics(list(x_.T), list(u_.T), 0, par),
                           dim=1)

    out = mpc_rollout_lanes(model, None, torch.from_numpy(x),
                            torch.from_numpy(u), plant, 3,
                            lims=torch.from_numpy(lims),
                            cfg=convert.config_from_jax(MPC_CFG),
                            derivs_tiles=tpc.pendcart_derivs_tiles_param(SPEC),
                            params=torch.from_numpy(params))
    _check_mpc(ref, out)
    assert (out[3][..., 0].abs() <= torch.from_numpy(hi).float()).all()
