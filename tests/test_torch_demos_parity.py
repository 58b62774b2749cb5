"""Each inner solve of the port's demos
(``differentialdynamicprogramming_jl_tpu_torch/demos.py``) on the CPU
against the JAX call its JAX twin makes, on the same NumPy-built inputs.

Tolerances: f64 costs to 1e-9 relative, f32 costs to 1e-5; exit reasons
and accepted counts equal. The pendcart's ``"zoh"`` derivatives come from
``torch.linalg.matrix_exp``, not ``jax.scipy.linalg.expm``, so that solve
is held by outcome at the same tolerance. The lane tier (the kernels'
plain versions) against JAX's lane solver in interpret mode:
``demo_mpc``'s warm re-solve (``ilqg_batch_lanes`` with
``warm_start=True``, pendcart, the 4-α ladder, ±10) at B=8, T=6, live; and
``demo_quadrotor``'s CPU cut (B=8, T=12, 3 iterations, autodiff tiles,
thrust box) against the JAX outcome that
``tools_torch/make_demo_outcomes.py`` wrote to
``tools_torch/demo_outcomes.npz`` on the same inputs (JAX takes minutes to
trace that solve)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu import demos as jdemos
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
    ilqg_batched as j_ilqg_batched)
from differentialdynamicprogramming_jl_tpu_torch import demos
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.forward import (
    forward_pass)
from differentialdynamicprogramming_jl_tpu_torch.parallel.mesh import (
    ilqg_batched)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

HERE = os.path.dirname(os.path.abspath(__file__))
OUTCOMES = os.path.join(HERE, "..", "tools_torch", "demo_outcomes.npz")
F32, F64 = torch.float32, torch.float64
RTOL64, RTOL32 = 1e-9, 1e-5


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy())


def _jcfg(cfg, cls=J.ILQGConfig):
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def _close(a, b, rtol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol)


def _same_outcome(res, jres, cost, jcost, rtol):
    _close(cost, jcost, rtol)
    np.testing.assert_array_equal(np.asarray(res.reason),
                                  np.asarray(jres.reason))
    np.testing.assert_array_equal(np.asarray(res.n_accepted),
                                  np.asarray(jres.n_accepted))


# ---------------------------------------------------------------------------
# the generic tier and demo_fleet's CPU branch
# ---------------------------------------------------------------------------

def test_demo_linear_matches_jax():
    T = 6
    res = demos.demo_linear(T=T, device="cpu")
    spec = demos._linear_inputs(0, T, F64, "cpu")
    jspec = jl.LTISpec(*(_j(a) for a in spec))
    jres = J.ilqg(jl.make_lti_problem(jspec, T), jspec.x0, jspec.u0,
                  cfg=J.ILQGConfig())
    _same_outcome(res, jres, res.cost.sum(), jnp.sum(jres.cost), RTOL64)
    _close(res.u.numpy(), jres.u, RTOL64)


def test_demo_linear_kl_matches_jax():
    """Two outer iLQGkl solves re-centred on the previous policy: cost, η
    and the measured KL of the last."""
    T, outer = 6, 2
    res = demos.demo_linear_kl(T=T, outer_iters=outer, device="cpu")
    spec = demos._linear_inputs(0, T, F64, "cpu")
    jspec = jl.LTISpec(*(_j(a) for a in spec))
    prob = jl.make_lti_problem(jspec, T)
    model = jl.SimpleLTVModel.from_lti(jspec.A, jspec.B, T)
    ro = J.forward_pass(prob, jspec.x0, jspec.u0)
    x, cost = ro.x, ro.cost
    traj = J.GaussianPolicy.zeros(T, 10, 2, jnp.float64)._replace(
        k=jspec.u0)
    for _ in range(outer):
        jres = J.ilqg_kl(prob, x, traj, model, cost,
                         cfg=J.ILQGKLConfig(kl_step=100.0))
        x, cost, traj = jres.x, jres.cost, jres.policy
    _close(res.cost.sum(), jnp.sum(jres.cost), RTOL64)
    _close(res.eta.numpy(), jres.eta, RTOL64)
    _close(res.divergence.numpy(), jres.divergence, 1e-7)
    assert int(res.n_iters) == int(jres.n_iters)


def test_demo_pendcart_matches_jax(capsys):
    """The swing-up demo at T=20 with a 20-iteration budget against the
    JAX package's demo_pendcart at the same settings (it has no random
    inputs), and the clamped-LQG baseline it prints. At T=8 both solves
    end at the f64 noise floor of their cost, where the last bits decide
    between exits 2 and 3 (the ROADMAP's trap); at T=20 they end above
    it."""
    res = demos.demo_pendcart(T=20, max_iter=20, device="cpu")
    port_out = capsys.readouterr().out
    jres = jdemos.demo_pendcart(T=20, max_iter=20)
    jax_out = capsys.readouterr().out
    _same_outcome(res, jres, res.cost.sum(), jnp.sum(jres.cost), RTOL64)
    assert int(res.n_iters) == int(jres.n_iters)
    base = [ln for ln in port_out.splitlines() if "baseline" in ln]
    assert base == [ln for ln in jax_out.splitlines() if "baseline" in ln]


def test_demo_mpc_vmap_inner_solves_match_jax():
    """The vmap tier's two solves at B=2, T=12: the cold start
    (``ilqg_batched`` from x0) and one warm re-solve on the pre-rolled
    shifted plan (``forward_pass`` then ``ilqg_batched`` with ``cost0``),
    f32."""
    B, T = 2, 12
    x, u = demos._mpc_inputs(B, T, 0, F32, "cpu")
    cfg, cfg0 = demos._mpc_cfgs(1)
    prob = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs="euler",
                                     dtype=F32, device="cpu")
    lims = torch.tensor([[-10.0, 10.0]], dtype=F32)
    jprob = jpc.make_pendcart_problem(jpc.PendCartSpec(), derivs="euler",
                                      dtype=jnp.float32)
    jlims = jnp.array([[-10.0, 10.0]], jnp.float32)
    r0 = ilqg_batched(prob, x, u, lims=lims, cfg=cfg0)
    j0 = j_ilqg_batched(jprob, _j(x), _j(u), lims=jlims, cfg=_jcfg(cfg0))
    _same_outcome(r0, j0, r0.cost.sum(-1), jnp.sum(j0.cost, -1), RTOL32)
    u_shift = torch.cat([r0.u[:, 1:], torch.zeros((B, 1, 1))], dim=1)
    ro = forward_pass(prob, x, u_shift, lims=lims)
    r1 = ilqg_batched(prob, ro.x, ro.u, lims=lims, cfg=cfg, cost0=ro.cost)
    jro = jax.vmap(lambda a, b: J.forward_pass(jprob, a, b, lims=jlims))(
        _j(x), _j(u_shift))
    j1 = j_ilqg_batched(jprob, jro.x, jro.u, lims=jlims, cfg=_jcfg(cfg),
                        cost0=jro.cost)
    _same_outcome(r1, j1, r1.cost.sum(-1), jnp.sum(j1.cost, -1), RTOL32)


def test_demo_fleet_cpu_matches_jax():
    """demo_fleet's CPU branch (``ilqg_batched``, pendcart "euler", ±5,
    B=2, T=30, 3 iterations, f32)."""
    B, T = 2, 30
    res = demos.demo_fleet(B=B, T=T, max_iter=3, device="cpu")
    x0s, u0s = demos._fleet_inputs(B, T, F32, "cpu")
    jres = j_ilqg_batched(
        jpc.make_pendcart_problem(jpc.PendCartSpec(), derivs="euler",
                                  dtype=jnp.float32),
        _j(x0s), _j(u0s), lims=jnp.array([[-5.0, 5.0]], jnp.float32),
        cfg=_jcfg(demos._fleet_cfg(3)))
    _same_outcome(res, jres, res.cost.sum(-1), jnp.sum(jres.cost, -1),
                  RTOL32)


def test_demo_boxqp_matches_jax():
    """demoQP at n=50 against the JAX package's boxqp on the same H, g and
    x0 (the port's NumPy draws)."""
    n = 50
    out = demos.demo_boxqp(n=n, device="cpu")
    rng = np.random.default_rng(0)
    g = rng.standard_normal(n)
    A = torch.tensor(rng.standard_normal((n, n)), dtype=F64)
    x0 = rng.standard_normal(n)
    H = (A @ A.T).numpy()
    jout = J.boxqp(jnp.asarray(H), jnp.asarray(g), -jnp.ones(n),
                   jnp.ones(n), jnp.asarray(x0))
    assert int(out.result) == int(jout.result)
    assert int(out.iters) == int(jout.iters)
    _close(float(out.value), float(jout.value), RTOL64)
    _close(out.x.numpy(), jout.x, 1e-8)


# ---------------------------------------------------------------------------
# the lane tier
# ---------------------------------------------------------------------------

def test_demo_mpc_lanes_warm_solve_matches_jax():
    """The MPC step's solve: after the cold start (the port's), the
    fleet's next states and the shifted plan, warm-started, no α-sweep."""
    B, T = 8, 6
    x, u = demos._mpc_inputs(B, T, 0, torch.float32, "cpu")
    cfg, cfg0 = demos._mpc_cfgs(2)
    spec = tpc.PendCartSpec()
    model, tiles = tpc.pendcart_lanes(spec), tpc.pendcart_derivs_tiles(spec)
    lims = ((-10.0, 10.0),)
    cold = ilqg_batch_lanes(model, None, x, u, lims=lims, cfg=cfg0,
                            derivs_tiles=tiles)
    prob = tpc.make_pendcart_problem(spec, derivs="euler", device="cpu")
    x1 = prob.dynamics(x, cold.u[:, 0], 0)
    u1 = torch.cat([cold.u[:, 1:], torch.zeros((B, 1, 1))], dim=1)
    res = ilqg_batch_lanes(model, None, x1, u1, lims=lims, cfg=cfg,
                           derivs_tiles=tiles, warm_start=True)
    jspec = jpc.PendCartSpec()
    jres = J.ilqg_batch_lanes(
        jpc.pendcart_lanes(jspec), None, jnp.asarray(x1.numpy()),
        jnp.asarray(u1.numpy()), lims=lims, cfg=_jcfg(cfg),
        derivs_tiles=jpc.pendcart_derivs_tiles(jspec), warm_start=True,
        interpret=True, kt_backward=2, kt_forward=2)
    np.testing.assert_allclose(res.cost_total.numpy(),
                               np.asarray(jres.cost_total), rtol=RTOL32)
    np.testing.assert_array_equal(res.reason.numpy(),
                                  np.asarray(jres.reason))
    np.testing.assert_array_equal(res.n_accepted.numpy(),
                                  np.asarray(jres.n_accepted))
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u),
                               rtol=RTOL32, atol=1e-5)


def test_demo_quadrotor_cpu_cut_matches_jax_outcome():
    res = demos.demo_quadrotor(device="cpu")
    ref = np.load(OUTCOMES)
    x0s, _ = demos._quad_inputs(8, 12, torch.float32, "cpu")
    np.testing.assert_array_equal(x0s.numpy(), ref["quad_x0s"])
    assert res.u.shape == (8, 12, 2)
    np.testing.assert_allclose(res.cost_total.numpy(),
                               ref["quad_cost_total"], rtol=RTOL32)
    for k in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(getattr(res, k).numpy(),
                                      ref[f"quad_{k}"])
    np.testing.assert_allclose(res.u.numpy(), ref["quad_u"], rtol=RTOL32,
                               atol=1e-5)
    # the thrust box held
    assert float(res.u.min()) >= 0.0 and float(res.u.max()) <= 5.0
