"""The LTI model at sizes the kernel library does not hold, on the CPU,
against the JAX package.

- The descriptor routing: ``lti_lanes`` and ``lti_derivs_tiles`` carry
  model id 2's descriptor only at ⟨10,2⟩ and ⟨10,3⟩; elsewhere they carry
  none, so the card runs their lowering (K1 ``LoweredTiles``, K2/K3
  ``Lowered``), which traces at n=8.
- The fleet solve at ⟨3,1⟩ and ⟨3,2⟩ against JAX's ``ilqg_batch_lanes`` in
  interpret mode (B=8, T=6, k_t=1), with limits that bind. At ⟨8,2⟩ JAX's
  lane fleet takes three minutes to compile in interpret mode here (and its
  KL fleet two), so the port's fleet, its packed solve
  (``lti_packed_derivs``) and its KL fleet are held to JAX's generic
  solvers vmapped over the lanes, to the fleet-against-generic tolerances
  of the JAX package's own tests (``tests/test_batch_driver.py``,
  ``tests/test_batch_kl.py:43-52``).
- K4's plain version at n = 3 and 5 against JAX's Pallas kernel in
  interpret mode, and at n = 8 against JAX's ``forward_covariance`` (a
  ``lax.scan``).

Specs are built in numpy f64 from a seeded Generator and cast to f32 for
both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.ops.forward import (
    forward_covariance as jax_forward_covariance)
from differentialdynamicprogramming_jl_tpu.ops.pallas.covariance_kernel \
    import covariance_lanes as jax_covariance_lanes
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import ilqg as jax_ilqg
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ILQGKLConfig as JKLConfig, ilqg_kl as jax_ilqg_kl)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    covariance_kernel as ck, forward_kernel as fk, lower)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    from_streams, to_streams)
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

from test_torch_kl import check_outcomes

B, T = 8, 6
# (n, m, spec seed): at <3,1> seed 3 ends one lane's third iteration at
# its cost's f32 noise floor (an accepted Δcost of 9.5e-7, one ulp of its
# 12.41), where the last bits decide between exits; seed 6 ends every lane
# above it with reasons 0 and 4
SIZES = ((3, 1, 6), (3, 2, 3))
CFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                   max_iter=3, iter_cap=4)


def _spec(n, m, seed=3):
    """A stable random LTI in numpy f64 (random_lti's construction at a
    larger step), cast to f32, as a JAX LTISpec."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((n, n))
    f = jnp.float32
    return jl.LTISpec(A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), f),
                      B=jnp.asarray(0.3 * rng.standard_normal((n, m)), f),
                      Q=jnp.asarray(0.5 * np.eye(n), f),
                      R=jnp.asarray(0.05 * np.eye(m), f),
                      x0=jnp.ones((n,), f),
                      u0=jnp.asarray(0.1 * rng.standard_normal((T, m)), f))


def _lims(m):
    return ((-0.3, 0.3), (-0.1, 0.4))[:m]


def _inputs(spec):
    n, m = spec.B.shape
    x0s = (np.ones((B, n)) * np.linspace(0.5, 2.0, B)[:, None]).astype(
        np.float32)
    u0s = np.tile(3.0 * np.asarray(spec.u0), (B, 1, 1)).astype(np.float32)
    return x0s, u0s


def test_lti_descriptor_routing():
    """The hand-written LTI's descriptor at ⟨10,2⟩ and ⟨10,3⟩ only: at
    ⟨8,2⟩ and ⟨3,1⟩ both lane objects carry none, and the model and the
    tiles lower."""
    for n, m in ((10, 2), (10, 3)):
        spec = tl.random_lti(0, n=n, m=m, T=8, device="cpu")
        lanes, tiles = tl.lti_lanes(spec), tl.lti_derivs_tiles(spec)
        assert lanes.device.model_id == tiles.device.model_id == tl.MODEL_ID
        assert (tl.MODEL_ID, n, m) in fk.CUDA_MODELS
    for n, m in ((8, 2), (3, 1)):
        spec = tl.random_lti(0, n=n, m=m, T=8, device="cpu")
        lanes, tiles = tl.lti_lanes(spec), tl.lti_derivs_tiles(spec)
        assert lanes.device is None and tiles.device is None
        low = lower.lower(lanes)
        assert (low.n, low.m) == (n, m) and "terminal" not in low.fns
        lt = lower.lower_tiles(tiles, n, m)
        assert not lt.second_order and lt.consts.size > 0


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def solved(request):
    n, m, seed = request.param
    spec = _spec(n, m, seed)
    x0s, u0s = _inputs(spec)
    lims = _lims(m)
    ref = J.ilqg_batch_lanes(
        jl.lti_lanes(spec), None, jnp.asarray(x0s), jnp.asarray(u0s),
        lims=lims, cfg=CFG, derivs_tiles=jl.lti_derivs_tiles(spec),
        kt_backward=1, kt_forward=1, interpret=True)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    out = ilqg_batch_lanes(
        tl.lti_lanes(tspec), None, torch.from_numpy(x0s),
        torch.from_numpy(u0s), lims=lims, cfg=convert.config_from_jax(CFG),
        derivs_tiles=tl.lti_derivs_tiles(tspec))
    return (n, m), tspec, convert.result_to_numpy(ref), \
        convert.result_to_numpy(out)


def _same_outcomes(out, ref):
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


def test_lti_sizes_fleet_matches_jax(solved):
    """Costs within 1e-4 relative (XLA's contractions on the host), reasons,
    accepted counts and iterations equal; the trajectory and the gains to
    1e-4; each control binds somewhere."""
    (n, m), _, ref, out = solved
    _same_outcomes(out, ref)
    assert out["x"].shape == (B, T, n) and out["u"].shape == (B, T, m)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["policy"]["K"], ref["policy"]["K"],
                               rtol=1e-4, atol=1e-5)
    for i, (lo, hi) in enumerate(_lims(m)):
        u = out["u"][..., i]
        assert np.any((u == np.float32(lo)) | (u == np.float32(hi)))


def _generic(spec, x0s, u0s, lims):
    """JAX's generic ilqg vmapped over the lanes (XLA, no Pallas)."""
    Tn = u0s.shape[1]
    problem = jl.make_lti_problem(spec, Tn)
    jl_ = jnp.asarray(lims, jnp.float32)
    ref = jax.vmap(lambda a, b: jax_ilqg(problem, a, b, lims=jl_, cfg=CFG))(
        jnp.asarray(x0s), jnp.asarray(u0s))
    return dict(cost_total=np.asarray(jnp.sum(ref.cost, -1)),
                reason=np.asarray(ref.reason),
                n_accepted=np.asarray(ref.n_accepted),
                x=np.asarray(ref.x))


@pytest.fixture(scope="module")
def lti8():
    spec = _spec(8, 2)
    x0s, u0s = _inputs(spec)
    return spec, convert.lti_spec_from_jax(spec, device="cpu"), x0s, u0s, \
        _generic(spec, x0s, u0s, _lims(2))


@pytest.mark.parametrize("kind", ["tiles", "packed"])
def test_lti8_fleet_matches_jax_generic(lti8, kind):
    """⟨8,2⟩: the fleet with the LTI tiles (LoweredTiles on the card) and
    with the packed stream (Packed<8,2> on the card) against JAX's generic
    ilqg vmapped over the lanes: costs within 1e-4 relative, reasons and
    accepted counts equal (the JAX package's lane-against-generic
    tolerances), the trajectory to 1e-4."""
    spec, tspec, x0s, u0s, ref = lti8
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tl.lti_lanes(tspec),
        tl.lti_packed_derivs(tspec) if kind == "packed" else None,
        torch.from_numpy(x0s), torch.from_numpy(u0s), lims=_lims(2),
        cfg=convert.config_from_jax(CFG),
        derivs_tiles=tl.lti_derivs_tiles(tspec) if kind == "tiles" else None))
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-4, atol=1e-5)
    assert (out["n_accepted"] >= 1).all()


KB, KT = 3, 16


def test_lti8_kl_fleet_matches_jax_generic():
    """KL at ⟨8,2⟩ (K4 at n=8 on the card), KL-LTI's kl_step 100: the
    port's fleet on the CPU from its plain pre-roll against JAX's generic
    ilqg_kl vmapped over the lanes with SimpleLTVModel.from_lti, to the
    fleet-against-generic tolerances (cost_total rtol 5e-3, η rtol 1e-2)
    and the same satisfied flags."""
    spec = _spec(8, 2, seed=5)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    n, m = 8, 2
    rng = np.random.default_rng(0)
    x0 = (np.ones((KB, n)) * np.linspace(0.5, 2.0, KB)[:, None]).astype(
        np.float32)
    u0 = (0.3 * rng.standard_normal((KB, KT, m))).astype(np.float32)
    gains = torch.cat([to_streams(torch.from_numpy(u0)),
                       torch.zeros((KT, m * n, KB))], dim=1)
    ro = fk.forward_lanes_ref(torch.zeros((KT, n + m + 1, KB)), gains,
                              torch.from_numpy(x0.T.copy()),
                              torch.ones((1, KB)), model=tl.lti_lanes(tspec),
                              lims=None, emit_traj=True)
    eye = np.broadcast_to(np.eye(m, dtype=np.float32), (KB, KT, m, m))
    prev = JPolicy(K=jnp.zeros((KB, KT, m, n), jnp.float32),
                   k=jnp.asarray(from_streams(ro.traj[:, n:n + m],
                                              (m,)).numpy()),
                   sigma=jnp.asarray(eye), sigma_inv=jnp.asarray(eye))
    x = from_streams(ro.traj[:, :n], (n,)).numpy()
    cost = ro.traj[:, n + m].T.contiguous().numpy()
    cfg = JKLConfig(kl_step=100.0, max_iter=6)
    problem = jl.make_lti_problem(spec, KT)
    jm = jl.SimpleLTVModel.from_lti(spec.A, spec.B, KT)
    ref = jax.vmap(lambda a, p, c: jax_ilqg_kl(problem, a, p, jm, c,
                                               cfg=cfg))(
        jnp.asarray(x), prev, jnp.asarray(cost))
    fx = np.broadcast_to(np.asarray(spec.A), (KB, KT, n, n)).copy()
    out = tkl.ilqgkl_batch_lanes(
        tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec), torch.from_numpy(x),
        convert.policy_from_jax(prev, device="cpu"), torch.from_numpy(fx),
        ro.totals[0], cfg=convert.kl_config_from_jax(cfg))
    assert out.policy.K.shape == (KB, KT, m, n)
    np.testing.assert_allclose(out.cost_total.numpy(),
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=5e-3)
    np.testing.assert_allclose(out.eta.numpy(), np.asarray(ref.eta),
                               rtol=1e-2)
    np.testing.assert_array_equal(out.satisfied.numpy(),
                                  np.asarray(ref.satisfied))


CB, CT = 8, 5


@pytest.mark.parametrize("n", [3, 5, 8])
def test_covariance_ref_matches_jax(n):
    """K4's plain version at n = 3, 5 and 8 (built at first use on the
    card) against JAX's Pallas kernel in interpret mode at n = 3 and 5, and
    at n = 8 (30 s to trace the kernel here) against JAX's
    forward_covariance, the Σxx block of its lax.scan; with an SPD R1,
    each slot within 1e-6 of its largest magnitude over the horizon."""
    rng = np.random.default_rng(n)
    F = 0.6 * np.eye(n) + (0.3 / np.sqrt(n)) * rng.standard_normal(
        (CT, CB, n, n))
    fx = np.moveaxis(F.reshape(CT, CB, n * n), 1, 2).astype(np.float32)
    A = rng.standard_normal((n, n))
    r1 = tuple(tuple(float(np.float32(v)) for v in row)
               for row in A @ A.T + 0.5 * np.eye(n))
    if n < 8:
        ref = convert.stream_from_lanes(jax_covariance_lanes(
            jnp.asarray(convert.stream_to_lanes(fx)), n=n, r1=r1, k_t=1,
            interpret=True), CB)
    else:
        # the joint (x, u) covariance with a zero policy and m = 1: its xx
        # block is Σxx[t+1] = F·Σxx·Fᵀ + R1
        Fb = np.moveaxis(fx.reshape(CT, n, n, CB), 3, 0)
        pol = JPolicy(K=jnp.zeros((CB, CT, 1, n), jnp.float32),
                      k=jnp.zeros((CB, CT, 1), jnp.float32),
                      sigma=jnp.ones((CB, CT, 1, 1), jnp.float32),
                      sigma_inv=jnp.ones((CB, CT, 1, 1), jnp.float32))
        full = jax.vmap(lambda f, p: jax_forward_covariance(
            f, jnp.asarray(r1, jnp.float32), p))(jnp.asarray(Fb), pol)
        ref = np.moveaxis(np.asarray(full)[:, :, :n, :n].reshape(
            CB, CT, n * n), 0, 2)
    out = ck.covariance_lanes(torch.from_numpy(fx), n=n, r1=r1).numpy()
    np.testing.assert_array_equal(out[0], np.float32(r1).reshape(n * n, 1)
                                  .repeat(CB, axis=1))
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    assert np.isfinite(out).all()
    assert (np.abs(out - ref) / scale).max() <= 1e-6
