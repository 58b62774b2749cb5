"""m > 4 controls, on the CPU: the plain versions, the drivers and the plans
that the card's libraries for larger m are built from.

- K1 through ``backward_pass_pallas`` (the packed stream's plain version)
  at n=6, m=5, T=7, B=8, with a ±0.05 box (the masked box QP) and in GPS
  mode: against JAX's generic (XLA) ``backward_pass`` vmapped over the
  lanes, at the JAX package's own lane-against-generic tolerances
  (``tests/test_pallas_kernels.py``: 5e-4 with the box, 3e-4 in GPS mode).
  JAX's Pallas K1 in interpret mode takes about a minute to trace at m=5
  (its box QP unrolled over m²), so it is not the reference here.
- K3 and K2 at n=6, m=5 against JAX's Pallas kernels in interpret mode,
  one call structure each.
- The ⟨14,7⟩ LTI fleet (tiles, and the packed stream) and KL on it against
  JAX's generic ``ilqg``/``ilqg_kl`` vmapped over three lanes at T=16
  (``tests/test_torch_lti_sizes.py``'s tolerances).
- The drivers at m ∈ {5, 7}: the fleet scheduler against its lock-step
  call, the MPC loop, ``reduce_stats`` of the sharded entries, and
  ``kl_div_wiki_lanes``'s log-determinant against JAX's.
- ``plan.py`` at m ∈ {5, 7, 8, 16} and the ceiling at m = 33 (the meta
  device, no card), and the emitted source of a library for m = 7 (text
  only, no nvcc).

Inputs are made in numpy from seeded Generators and cast to f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.ops.backward import (
    backward_pass as jax_backward_pass)
from differentialdynamicprogramming_jl_tpu.ops.forward import (
    forward_pass as jax_forward_pass)
from differentialdynamicprogramming_jl_tpu.ops.kl import grad_kl
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    forward_lanes as jax_forward_lanes, linesearch_lanes as jax_linesearch)
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import ilqg as jax_ilqg
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ILQGKLConfig as JKLConfig, ilqg_kl as jax_ilqg_kl)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    _build, backward_kernel as bk, forward_kernel as fk, lower, plan)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    from_streams, to_streams)
from differentialdynamicprogramming_jl_tpu_torch.parallel import mesh as M
from differentialdynamicprogramming_jl_tpu_torch.policy import Derivs
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl
from differentialdynamicprogramming_jl_tpu_torch.solvers import fleet
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes, mpc_rollout_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)

F32 = np.float32
B, T = 8, 7
BOX = 0.05
ALPHAS = default_alphas(0.2, -3.0, 4)


# ---- K1 at m = 5 against JAX's generic backward pass ---------------------

def _k1_inputs(n, m, seed=2):
    """JAX's random LTI (f32) rolled out by its generic forward pass from
    3·u0 with a ±BOX box, and its derivative stack along it."""
    spec = jl.random_lti(jax.random.PRNGKey(seed), n=n, m=m, T=T,
                         dtype=jnp.float32)
    prob = jl.make_lti_problem(spec, T)
    lims = jnp.array([[-BOX, BOX]] * m, jnp.float32)
    x0s = (jnp.tile(spec.x0, (B, 1))
           * jnp.linspace(0.5, 2.0, B, dtype=jnp.float32)[:, None])
    u0s = jnp.tile(spec.u0, (B, 1, 1)) * 3.0
    ro = jax.vmap(lambda a, b: jax_forward_pass(prob, a, b, lims=lims))(
        x0s, u0s)
    return lims, ro.u, jax.vmap(prob.make_derivs())(ro.x, ro.u)


def _torch_derivs(d):
    return Derivs(*(None if a is None else torch.from_numpy(np.asarray(a))
                    for a in d))


def _cmp(ref, out, tol):
    for name, a, b in (("k", ref.policy.k, out.policy.k),
                       ("K", ref.policy.K, out.policy.K),
                       ("Vx", ref.Vx, out.Vx), ("Vxx", ref.Vxx, out.Vxx),
                       ("dV", ref.dV, out.dV),
                       ("sigma", ref.policy.sigma, out.policy.sigma),
                       ("diverged", ref.diverged, out.diverged)):
        np.testing.assert_allclose(np.asarray(b, F32), np.asarray(a, F32),
                                   rtol=tol, atol=tol, err_msg=name)


def test_backward_box_m5_matches_jax_generic():
    """K1 with a ±0.05 box at n=6, m=5: the masked box QP (8 iterations,
    warm-started) against the generic boxqp backward pass; the box binds."""
    n, m = 6, 5
    lims, u, d = _k1_inputs(n, m)
    lam = jnp.full((B,), 0.1, jnp.float32)
    ref = jax.vmap(lambda dd, uu, ll: jax_backward_pass(
        dd, uu, lam=ll, reg_type=1, lims=lims, use_limits=True))(d, u, lam)
    out = bk.backward_pass_pallas(
        _torch_derivs(d), torch.from_numpy(np.asarray(u)),
        torch.from_numpy(np.asarray(lam)), reg_type=1,
        lims=np.asarray(lims), use_limits=True)
    _cmp(ref, out, 5e-4)
    u_new = np.asarray(u) + out.policy.k.numpy()
    assert np.any(np.abs(u_new) > 0.049)


def test_backward_gps_m5_matches_jax_generic():
    """K1 in GPS mode at n=6, m=5 (per-step η, the previous policy's KL
    terms, the 5×5 Cholesky of the KL-augmented Quu), no limits, against
    the generic GPS backward pass."""
    n, m = 6, 5
    _, u, d = _k1_inputs(n, m, seed=3)
    rng = np.random.default_rng(9)
    G = rng.standard_normal((B, T, m, m))
    Si = np.einsum("btij,btkj->btik", G, G) + 0.5 * np.eye(m)
    prev = JPolicy(K=jnp.asarray(0.3 * rng.standard_normal((B, T, m, n)), F32),
                   k=jnp.asarray(0.2 * rng.standard_normal((B, T, m)), F32),
                   sigma=jnp.asarray(np.linalg.inv(Si), F32),
                   sigma_inv=jnp.asarray(Si, F32))
    eta = jnp.asarray(0.5 + rng.uniform(0.0, 1.0, (B, T)), F32)
    ref = jax.vmap(lambda dd, uu, pv, et: jax_backward_pass(
        dd, uu, lam=0.0, reg_type=1, eta=et, kl_terms=grad_kl(pv),
        gps_mode=True))(d, u, prev, eta)
    out = bk.backward_pass_pallas(
        _torch_derivs(d), torch.from_numpy(np.asarray(u)), torch.zeros(B),
        reg_type=1, eta=torch.from_numpy(np.asarray(eta)),
        traj_prev=convert.policy_from_jax(prev, device="cpu"))
    _cmp(ref, out, 3e-4)
    assert not out.diverged.any()


# ---- K3 and K2 at m = 5 against JAX's kernels ----------------------------

N5, M5 = 6, 5
LIMS5 = ((-0.05, 0.05), (-0.02, 0.08), (-0.1, 0.03), (-0.04, 0.04),
         (-0.07, 0.01))


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(a))


def _lti5():
    rng = np.random.default_rng(11)
    Mm = rng.standard_normal((N5, N5))
    spec = jl.LTISpec(A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), F32),
                      B=jnp.asarray(0.3 * rng.standard_normal((N5, M5)), F32),
                      Q=jnp.asarray(0.5 * np.eye(N5), F32),
                      R=jnp.asarray(0.05 * np.eye(M5), F32),
                      x0=jnp.ones((N5,), F32), u0=jnp.zeros((T, M5), F32))
    return spec, convert.lti_spec_from_jax(spec, device="cpu")


def _rollout_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((N5, B)).astype(F32)
    traj = np.concatenate([rng.standard_normal((T, N5, B)),
                           0.1 * rng.standard_normal((T, M5, B)),
                           np.zeros((T, 1, B))], axis=1).astype(F32)
    gains = np.concatenate(
        [0.3 * rng.standard_normal((T, M5, B)),
         0.5 * rng.standard_normal((T, M5 * N5, B))], axis=1).astype(F32)
    return x0, traj, gains


def test_forward_m5_matches_jax():
    """K3's rollout at α=1 with the stream emitted: totals and the stream
    to 1e-5; each control's clamp binds on some step."""
    spec, tspec = _lti5()
    x0, traj, gains = _rollout_inputs()
    al = np.ones((1, B), F32)
    ref = jax_forward_lanes(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(al),
        model=jl.lti_lanes(spec), lims=LIMS5, gk=0, gK=M5, emit_traj=True,
        k_t=2, interpret=True)
    out = fk.forward_lanes(*(torch.from_numpy(a) for a in
                             (traj, gains, x0, al)),
                           model=tl.lti_lanes(tspec), lims=LIMS5,
                           emit_traj=True)
    np.testing.assert_allclose(out.totals.numpy(),
                               convert.stream_from_lanes(ref.totals, B),
                               rtol=1e-5, atol=1e-6)
    o = out.traj.numpy()
    np.testing.assert_allclose(o, convert.stream_from_lanes(ref.traj, B),
                               rtol=1e-5, atol=1e-6)
    for mi, (lo, hi) in enumerate(LIMS5):
        u = o[:, N5 + mi]
        assert np.any((u == F32(lo)) | (u == F32(hi)))


def test_linesearch_m5_matches_jax():
    """K2 at m=5 on the plain K1's gains: the decisions exactly, the
    accepted trajectory and the expected-reduction slot to 1e-5."""
    spec, tspec = _lti5()
    tmodel = tl.lti_lanes(tspec)
    x0, _, _ = _rollout_inputs()
    gains0 = np.concatenate([np.full((T, M5, B), 0.01, F32),
                             np.zeros((T, M5 * N5, B), F32)], axis=1)
    ro = fk.forward_lanes(torch.zeros((T, N5 + M5, B)),
                          torch.from_numpy(gains0), torch.from_numpy(x0),
                          torch.ones((1, B)), model=tmodel, lims=LIMS5,
                          emit_traj=True)
    bo = bk.backward_lanes(ro.traj, torch.ones(B), n=N5, m=M5, reg_type=2,
                           lims=LIMS5, derivs_tiles=tl.lti_derivs_tiles(tspec),
                           emit="gains")
    traj, gains = ro.traj.numpy(), bo.out.numpy()
    allow = (np.arange(B) % 2 == 0).astype(F32)
    sel = np.stack([bo.stats[0].numpy(), bo.stats[1].numpy(),
                    ro.totals[0].numpy(), allow])
    ref = jax_linesearch(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(sel),
        model=jl.lti_lanes(spec), alphas=ALPHAS, reduce_ratio_min=0.0,
        lims=LIMS5, gk=0, gK=M5, emit_echo=False, k_t=2, interpret=True)
    out = fk.linesearch_lanes(*(torch.from_numpy(a) for a in
                                (traj, gains, x0, sel)),
                              model=tmodel, alphas=ALPHAS,
                              reduce_ratio_min=0.0, lims=LIMS5)
    ls, rls = out.ls.numpy(), convert.stream_from_lanes(ref.ls, B)
    np.testing.assert_array_equal(ls[:2], rls[:2])
    np.testing.assert_allclose(ls[4], rls[4], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.traj.numpy(),
                               convert.stream_from_lanes(ref.traj, B),
                               rtol=1e-5, atol=1e-6)
    accepted = (ls[1] > 0.5) & (allow > 0.5)
    assert accepted.any()


# ---- the <14,7> fleet and KL against JAX's generic solvers ---------------

ARM_N, ARM_M = 14, 7
FB, FT = 3, 16
ARM_BOX = 0.6
CFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                   max_iter=3, iter_cap=4)


def _arm_spec(seed=3):
    """A stable random LTI at the arm's shape in numpy f64, cast to f32."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((ARM_N, ARM_N))
    return jl.LTISpec(
        A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), F32),
        B=jnp.asarray(0.3 * rng.standard_normal((ARM_N, ARM_M)), F32),
        Q=jnp.asarray(0.5 * np.eye(ARM_N), F32),
        R=jnp.asarray(0.05 * np.eye(ARM_M), F32),
        x0=jnp.ones((ARM_N,), F32),
        u0=jnp.asarray(0.1 * rng.standard_normal((FT, ARM_M)), F32))


@pytest.fixture(scope="module")
def arm():
    spec = _arm_spec()
    x0s = (np.ones((FB, ARM_N)) * np.linspace(0.5, 2.0, FB)[:, None]).astype(
        F32)
    u0s = np.tile(3.0 * np.asarray(spec.u0), (FB, 1, 1)).astype(F32)
    lims = ((-ARM_BOX, ARM_BOX),) * ARM_M
    problem = jl.make_lti_problem(spec, FT)
    jlims = jnp.asarray(lims, jnp.float32)
    ref = jax.vmap(lambda a, b: jax_ilqg(problem, a, b, lims=jlims,
                                         cfg=CFG))(jnp.asarray(x0s),
                                                   jnp.asarray(u0s))
    return (convert.lti_spec_from_jax(spec, device="cpu"), x0s, u0s, lims,
            dict(cost_total=np.asarray(jnp.sum(ref.cost, -1)),
                 reason=np.asarray(ref.reason),
                 n_accepted=np.asarray(ref.n_accepted),
                 x=np.asarray(ref.x), u=np.asarray(ref.u)))


@pytest.mark.parametrize("kind", ["tiles", "packed"])
def test_arm_fleet_matches_jax_generic(arm, kind):
    """⟨14,7⟩: the fleet with the LTI tiles (LoweredTiles on the card) and
    with the packed stream (Packed<14,7>) against JAX's generic ilqg
    vmapped over the lanes: costs within 1e-4 relative, reasons and
    accepted counts equal; the trajectory to 5e-4, the JAX package's
    tolerance for its lane kernel's masked box QP (8 iterations) against
    the generic boxqp (tests/test_pallas_kernels.py,
    test_backward_kernel_limits_m_gt_2); the box binds."""
    tspec, x0s, u0s, lims, ref = arm
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tl.lti_lanes(tspec),
        tl.lti_packed_derivs(tspec) if kind == "packed" else None,
        torch.from_numpy(x0s), torch.from_numpy(u0s), lims=lims,
        cfg=convert.config_from_jax(CFG),
        derivs_tiles=tl.lti_derivs_tiles(tspec) if kind == "tiles" else None))
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=5e-4, atol=5e-4)
    assert (out["n_accepted"] >= 1).all()
    assert (np.abs(out["u"]) == F32(ARM_BOX)).any()


def test_arm_kl_fleet_matches_jax_generic():
    """KL on the ⟨14,7⟩ LTI (K4 at n=14 and K1's GPS policy at m=7 on the
    card), KL-LTI's kl_step 100, no limits: the port's fleet from its plain
    pre-roll against JAX's generic ilqg_kl vmapped over the lanes
    (cost_total rtol 5e-3, η rtol 1e-2, satisfied flags equal)."""
    spec = _arm_spec(seed=5)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    n, m = ARM_N, ARM_M
    rng = np.random.default_rng(0)
    x0 = (np.ones((FB, n)) * np.linspace(0.5, 2.0, FB)[:, None]).astype(F32)
    u0 = (0.3 * rng.standard_normal((FB, FT, m))).astype(F32)
    gains = torch.cat([to_streams(torch.from_numpy(u0)),
                       torch.zeros((FT, m * n, FB))], dim=1)
    ro = fk.forward_lanes_ref(torch.zeros((FT, n + m + 1, FB)), gains,
                              torch.from_numpy(x0.T.copy()),
                              torch.ones((1, FB)), model=tl.lti_lanes(tspec),
                              lims=None, emit_traj=True)
    eye = np.broadcast_to(np.eye(m, dtype=F32), (FB, FT, m, m))
    prev = JPolicy(K=jnp.zeros((FB, FT, m, n), jnp.float32),
                   k=jnp.asarray(from_streams(ro.traj[:, n:n + m],
                                              (m,)).numpy()),
                   sigma=jnp.asarray(eye), sigma_inv=jnp.asarray(eye))
    x = from_streams(ro.traj[:, :n], (n,)).numpy()
    cost = ro.traj[:, n + m].T.contiguous().numpy()
    cfg = JKLConfig(kl_step=100.0, max_iter=4)
    problem = jl.make_lti_problem(spec, FT)
    jm = jl.SimpleLTVModel.from_lti(spec.A, spec.B, FT)
    ref = jax.vmap(lambda a, p, c: jax_ilqg_kl(problem, a, p, jm, c,
                                               cfg=cfg))(
        jnp.asarray(x), prev, jnp.asarray(cost))
    fx = np.broadcast_to(np.asarray(spec.A), (FB, FT, n, n)).copy()
    out = tkl.ilqgkl_batch_lanes(
        tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec), torch.from_numpy(x),
        convert.policy_from_jax(prev, device="cpu"), torch.from_numpy(fx),
        ro.totals[0], cfg=convert.kl_config_from_jax(cfg))
    assert out.policy.K.shape == (FB, FT, m, n)
    np.testing.assert_allclose(out.cost_total.numpy(),
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=5e-3)
    np.testing.assert_allclose(out.eta.numpy(), np.asarray(ref.eta),
                               rtol=1e-2)
    np.testing.assert_array_equal(out.satisfied.numpy(),
                                  np.asarray(ref.satisfied))


# ---- the drivers at m = 5 and 7 -------------------------------------------

DN, DT = 4, 6


def _driver_lti(m, seed=3):
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((DN, DN))
    spec = tl.LTISpec(
        A=torch.tensor(expm(0.3 * (Mm - Mm.T)), dtype=torch.float32),
        B=torch.tensor(0.3 * rng.standard_normal((DN, m)),
                       dtype=torch.float32),
        Q=0.5 * torch.eye(DN), R=0.05 * torch.eye(m), x0=torch.ones(DN),
        u0=torch.zeros((DT, m)))
    x0s = torch.ones((B, DN)) * torch.linspace(0.5, 2.0, B)[:, None]
    u0s = torch.tensor(0.3 * rng.standard_normal((B, DT, m)),
                       dtype=torch.float32)
    return spec, x0s, u0s


DRIVER_CFG = dict(alphas=default_alphas(0.2, -3.0, 3), reg_type=1,
                  max_iter=6, iter_cap=7)


@pytest.mark.parametrize("m", [5, 7])
def test_drivers_at_m(m):
    """The fleet scheduler (chunks of 2 iterations) equal to its lock-step
    call in every field; two MPC steps inside the box; the sharded entry's
    reduce_stats the sums of the unsharded call's fields."""
    spec, x0s, u0s = _driver_lti(m)
    lims = ((-BOX, BOX),) * m
    model, tiles = tl.lti_lanes(spec), tl.lti_derivs_tiles(spec)
    kw = dict(lims=lims, cfg=ILQGConfig(**DRIVER_CFG), derivs_tiles=tiles)
    ref = ilqg_batch_lanes(model, None, x0s, u0s, **kw)
    fl = fleet.ilqg_fleet(model, None, x0s, u0s, chunk_iters=2,
                          chunk_growth=1.0, **kw)
    for name in ("cost_total", "reason", "n_accepted", "n_iters", "x", "u",
                 "Vx", "Vxx"):
        assert torch.equal(getattr(fl, name), getattr(ref, name)), name
    assert torch.equal(fl.policy.K, ref.policy.K)
    A, Bm = spec.A, spec.B
    x, u, xs, us, costs = mpc_rollout_lanes(
        model, None, x0s, u0s, lambda x_, u_: x_ @ A.T + u_ @ Bm.T, 2,
        lims=lims, cfg=ILQGConfig(**DRIVER_CFG), derivs_tiles=tiles)
    assert us.shape == (2, B, m) and u.shape == (B, DT, m)
    assert torch.isfinite(costs).all() and (us.abs() <= BOX).all()
    res, stats = M.ilqg_batch_sharded(model, None, x0s, u0s,
                                      mesh=M.make_mesh(2, device="cpu"),
                                      reduce_stats=True, **kw)
    assert torch.equal(res.cost_total, ref.cost_total)
    solved = ((ref.reason == 1) | (ref.reason == 2)).sum()
    np.testing.assert_allclose(
        stats.numpy(), [ref.cost_total.sum().item(),
                        ref.n_iters.sum().item(), solved.item()], rtol=1e-6)


def _spd_stream(rng, m, Tn=T):
    G = rng.standard_normal((Tn, B, m, m))
    S = np.einsum("tbij,tbkj->tbik", G, G) + 0.3 * np.eye(m)
    return np.moveaxis(S.reshape(Tn, B, m * m), 1, 2).astype(F32)


@pytest.mark.parametrize("m", [5, 7])
def test_logdet_and_kl_at_m(m):
    """_logdet_tiles (an m×m Cholesky per step) and kl_div_wiki_lanes at
    m ∈ {5, 7} against JAX's: the PD flags exactly, the values to 1e-5."""
    n = 4
    rng = np.random.default_rng(m)
    S = _spd_stream(rng, m)
    S[2, :, 3] = -5.0
    rl, rok = jkl._logdet_tiles(jnp.asarray(S), m)
    ol, ook = tkl._logdet_tiles(torch.from_numpy(S), m)
    np.testing.assert_array_equal(ook.numpy(), np.asarray(rok))
    assert not ook.all() and ook.any()
    np.testing.assert_allclose(ol.numpy(), np.asarray(rl), rtol=1e-5,
                               atol=1e-5)
    args = (rng.standard_normal((T, n, B)).astype(F32), _spd_stream(rng, n),
            rng.standard_normal((T, m, B)).astype(F32),
            rng.standard_normal((T, m * n, B)).astype(F32),
            _spd_stream(rng, m), rng.standard_normal((T, m, B)).astype(F32),
            rng.standard_normal((T, m * n, B)).astype(F32),
            _spd_stream(rng, m))
    rk, rpd = jkl.kl_div_wiki_lanes(*map(jnp.asarray, args), n=n, m=m)
    ok, opd = tkl.kl_div_wiki_lanes(*map(torch.from_numpy, args), n=n, m=m)
    np.testing.assert_array_equal(opd.numpy(), np.asarray(rpd))
    np.testing.assert_allclose(ok.numpy(), np.asarray(rk), rtol=1e-5,
                               atol=1e-5)


# ---- the plans, the ceiling and the emitted source -----------------------

@pytest.mark.parametrize("m", [5, 7, 8, 16])
def test_plans_at_m(m):
    """K1 (every emission, GPS mode), K2 and K3 have a plan at n ∈ {6, 14,
    16} for each m up to the ceiling, within a block's shared memory; K1's
    GPS ring at ⟨16,16⟩ (561 slots a step beside the four warps' exchange)
    takes one stage."""
    assert m <= plan.MAX_CONTROLS
    for n in (6, 14, 16):
        for gps, emit in ((False, "gains"), (False, "full"),
                          (False, "policy"), (True, "full"),
                          (True, "policy")):
            p = plan.backward_plan(n, m, gps, emit, 1000, 4096)
            assert p.smem <= plan.MAX_SMEM and p.tc >= 1
            # four compute warps at m > 4 wherever n ≥ 8, in every emission
            assert p.threads == plan.RING_W * (1 + (4 if n >= 8 else 1))
            assert p.stages == (1 if (n, m, gps) == (16, 16, True) else 2)
        for p in (plan.linesearch_plan(n, m, 11, 1000, 4096),
                  plan.forward_plan(n, m, 8, 1000, 4096, emit=True)):
            assert p.smem <= plan.MAX_SMEM and p.stages == 2
    assert plan.backward_plan(10, m, False, "gains", 1000, 4096,
                              packed=True).smem <= plan.MAX_SMEM


@pytest.mark.parametrize("entry", ["backward", "forward", "linesearch",
                                   "packed"])
def test_m_above_ceiling_refused(entry):
    """m = 33 > plan.MAX_CONTROLS on tensors off the CPU (the meta device,
    which needs no card): each entry raises NotImplementedError naming the
    ceiling before anything is lowered or built."""
    n, m = 4, 33
    spec = tl.random_lti(0, n=n, m=m, T=T, device="cpu")
    meta = dict(device="meta")
    traj = torch.zeros((T, n + m + 1, B), **meta)
    x0 = torch.zeros((n, B), **meta)
    gains = torch.zeros((T, m + m * n, B), **meta)
    lims = ((-1.0, 1.0),) * m
    n0 = bk.backward_lanes.launches
    with pytest.raises(NotImplementedError, match="MAX_CONTROLS = 32"):
        if entry == "backward":
            bk.backward_lanes(traj, torch.zeros(B, **meta), n=n, m=m,
                              reg_type=1, lims=lims,
                              derivs_tiles=tl.lti_derivs_tiles(spec))
        elif entry == "forward":
            fk.forward_lanes(traj, gains, x0, torch.ones((1, B), **meta),
                             model=tl.lti_lanes(spec), lims=lims)
        elif entry == "linesearch":
            fk.linesearch_lanes(traj, gains, x0,
                                torch.zeros((4, B), **meta),
                                model=tl.lti_lanes(spec), alphas=ALPHAS,
                                reduce_ratio_min=0.0, lims=lims)
        else:
            from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack \
                import DerivLayout
            D = DerivLayout(n, m).D
            bk.backward_lanes(torch.zeros((T, D + m, B), **meta),
                              torch.zeros(B, **meta), n=n, m=m, reg_type=1,
                              lims=lims, derivs_tiles=None)
    assert bk.backward_lanes.launches == n0


def test_emitted_source_at_m7():
    """The LTI ⟨14,7⟩'s lowered tiles and model: their generated sources
    build for m = 7 (DDP_MAX_M before the headers), the packed K1's too;
    at m ≤ 4 no define, so those libraries' sources stay as they were;
    every library built for m > 4 rolls its loops (DDP_ROLLED)."""
    spec = tl.random_lti(0, n=ARM_N, m=ARM_M, T=T, device="cpu")
    lt = lower.lower_tiles(tl.lti_derivs_tiles(spec), ARM_N, ARM_M)
    struct = lt.struct()
    assert "static constexpr int M = 7;" in struct
    for group in ("t1", "t1_gps", "t1_so"):
        src = _build.lowered_source(struct, group)
        assert src.index("#define DDP_MAX_M 7") < src.index("#include")
    low = lower.lower(tl.lti_lanes(spec))
    src = _build.lowered_source(low.struct(True), "fwd")
    assert src.index("#define DDP_MAX_M 7") < src.index("#include")
    assert "ddp_forward_lanes" not in src and "Lowered" in src
    psrc = _build.packed_source(10, 8)
    assert psrc.index("#define DDP_MAX_M 8") < psrc.index("#include")
    small = tl.random_lti(0, n=6, m=4, T=T, device="cpu")
    s4 = lower.lower_tiles(tl.lti_derivs_tiles(small), 6, 4).struct()
    assert "DDP_MAX_M" not in _build.lowered_source(s4, "t1")
    assert "DDP_MAX_M" not in _build.packed_source(5, 4)
    assert _build.max_m_define(plan.LIBRARY_MAX_M) == ""
    assert "DDP_ROLLED" not in _build.packed_source(5, 4)
    for m in (5, 7, 16):
        assert _build.max_m_define(m) == (f"#define DDP_MAX_M {m}\n"
                                          "#define DDP_ROLLED 1\n")
    assert src.index("#define DDP_ROLLED 1") < src.index("#include")
    assert psrc.index("#define DDP_ROLLED 1") < psrc.index("#include")
