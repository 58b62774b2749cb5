"""The KL/GPS path on the LTI model at m=2: the port's plain versions (CPU)
against the JAX package.

- K1 in GPS mode at n=4, m=2 against the JAX Pallas kernel in interpret mode
  (B=8, T=7, k_t=2), shapes and tolerances of ``test_torch_lti_kernels.py``;
- K4's plain version at n=10 against JAX ``ops/forward.py::
  forward_covariance`` (a ``lax.scan``, no Pallas), and the port's
  ``forward_covariance`` and ``SimpleLTVModel`` against JAX's;
- the fleet ``ilqgkl_batch_lanes`` on LTI n=4, m=2 against JAX
  ``ilqgkl_batch_lanes(interpret=True)`` with scalar η (the reference demo's
  ``kl_step=100``) and per-step η, and two outer iterations of
  ``gps_rollout_lanes``, with ``test_torch_kl.py``'s outcome tolerances;
- the slice at n=10: the port's fleet solve (B=3, T=16) against JAX's
  generic ``ilqg_kl`` vmapped over the lanes with
  ``SimpleLTVModel.from_lti``, with the fleet-against-generic tolerances of
  ``tests/test_batch_kl.py:43-52``.

Inputs are made once in numpy f64 with a seeded Generator and cast to f32;
the pre-rolls come from the port's plain K3 and are handed to both packages
as numpy arrays. Each JAX function is compiled once per module: the
derivative tiles and the configurations are module constants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.ops.forward import (
    forward_covariance as jax_forward_covariance)
from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel import (
    backward_lanes as jax_backward_lanes)
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ILQGKLConfig as JKLConfig, ilqg_kl as jax_ilqg_kl)
from differentialdynamicprogramming_jl_tpu_torch import (
    GaussianPolicy, SimpleLTVModel, convert, forward_covariance)
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    covariance_kernel as ck, forward_kernel as fk)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
    import OutLayout, backward_lanes
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    from_streams, to_streams)
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl

from test_torch_kl import check_outcomes
from test_torch_lti_kernels import (B, LIMS_ASYM, M, N, T, _check, _lanes,
                                    _spec, _stream, _tspec)

SPEC = _spec()
JTILES = jl.lti_derivs_tiles(SPEC)        # one object: one JAX compile
TSPEC = _tspec(SPEC)


# ---------------------------------------------------------------------------
# K1 in GPS mode at m=2
# ---------------------------------------------------------------------------

def _gps_inputs(per_step, seed=4):
    """Previous-policy stream [k, K, Σ⁻¹] with Σ⁻¹ positive definite, and η
    per lane (scalar) or per step, in 0.5..2 so that the 1/η scaling stays
    well conditioned; a few zeros, which count as 1."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((T, B, M, M))
    Si = np.einsum("tbij,tbkj->tbik", A, A) + 0.5 * np.eye(M)
    prev = np.concatenate([rng.standard_normal((T, M, B)),
                           0.5 * rng.standard_normal((T, M * N, B)),
                           np.moveaxis(Si.reshape(T, B, M * M), 1, 2)],
                          axis=1).astype(np.float32)
    eta = (2.0 ** rng.uniform(-1, 1, (T, B)) if per_step
           else np.broadcast_to(2.0 ** rng.uniform(-1, 1, B), (T, B)).copy())
    eta[::3, ::5] = 0.0
    return prev, eta.astype(np.float32)


@pytest.mark.parametrize("emit", ["policy", "full"])
@pytest.mark.parametrize("lims", [LIMS_ASYM, None])
@pytest.mark.parametrize("per_step", [False, True])
def test_backward_gps_m2_matches_jax(per_step, lims, emit):
    """GPS mode at m=2: the m×m KL expansion (JAX read_kl), the m×m
    boundary Quu = cuu/η + Σ⁻¹ and the symmetrised GPS Quu, through the 9-set
    enumeration (limits) or the 2×2 Cholesky solve (none)."""
    stream = _stream(seed=6)
    prev, eta = _gps_inputs(per_step)
    lam = np.zeros(B, np.float32)
    ref = jax_backward_lanes(
        _lanes(stream), _lanes(lam), n=N, m=M, reg_type=1, lims=lims, k_t=2,
        derivs_tiles=JTILES, prev=_lanes(prev), eta=_lanes(eta[:, None]),
        emit=emit, interpret=True)
    out = backward_lanes(
        torch.from_numpy(stream), torch.from_numpy(lam), n=N, m=M,
        reg_type=1, lims=lims, derivs_tiles=tl.lti_derivs_tiles(TSPEC),
        prev=torch.from_numpy(prev), eta=torch.from_numpy(eta), emit=emit)
    ro, rs = (convert.stream_from_lanes(ref.out, B),
              convert.stream_from_lanes(ref.stats, B))
    oo, os_ = out.out.numpy(), out.stats.numpy()
    assert oo.shape == (T, OutLayout(N, M, emit).S, B)
    if lims is not None:
        _check(ro, rs, oo, os_, near_tie=True)
    else:
        # the KL expansion adds terms of order one to Qxx, Qux and Qu, and
        # the value update then cancels them to small off-diagonal Vxx and
        # Vx entries, where XLA's multiply-add contraction on the host
        # shows: each slot is held to 1e-5 of its largest magnitude
        # (measured ≤1.7e-6), on top of rtol 1e-5
        scale = np.abs(ro).max(axis=(0, 2), keepdims=True)
        assert np.all(np.abs(oo - ro) <= 1e-5 * (np.abs(ro) + scale))
        np.testing.assert_array_equal(os_[2:], rs[2:])
        np.testing.assert_allclose(os_[:2], rs[:2], rtol=1e-5, atol=1e-6)
    # the boundary's emitted Quu is cuu/η + Σ⁻¹_prev, 2×2 (JAX :418-429)
    lay = OutLayout(N, M, emit)
    e = np.where(eta[-1] == 0, np.float32(1), eta[-1])
    R = np.asarray(SPEC.R, np.float32).reshape(M * M, 1)
    np.testing.assert_allclose(oo[-1, lay.quu:lay.quu + M * M],
                               R / e + prev[-1, M + M * N:], rtol=1e-6)


# ---------------------------------------------------------------------------
# K4 at n=10, forward_covariance, SimpleLTVModel
# ---------------------------------------------------------------------------

N10, T10, B10 = 10, 6, 3


def _lti10(seed=7, T=T10):
    """The reference demo's random LTI construction in numpy f64
    (src/demo_linear.jl:9-26, h = 0.01), cast to f32."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((N10, N10))
    h = 0.01
    f = np.float32
    return dict(A=expm(h * (Mm - Mm.T)).astype(f),
                B=(h * rng.standard_normal((N10, 2))).astype(f),
                Q=(h * np.eye(N10)).astype(f), R=(0.1 * h * np.eye(2)).astype(f),
                x0=np.ones(N10, f),
                u0=(0.1 * rng.standard_normal((T, 2))).astype(f))


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return (A @ A.T / n + 0.5 * np.eye(n)).astype(np.float32)


def test_covariance_n10_matches_jax_forward_covariance():
    """K4's plain version at n=10 holds the Σxx block of JAX's generic
    forward_covariance; both propagate F·Σ·Fᵀ + R1 in f32, XLA's dot in
    its own sum order: rtol 1e-5 of each slot's scale."""
    rng = np.random.default_rng(8)
    F = (_lti10()["A"][None, None]
         + 0.1 * rng.standard_normal((B10, T10, N10, N10))).astype(np.float32)
    R1 = _spd(rng, N10)
    pol = JPolicy.zeros(T10, N10, 2, jnp.float32)
    ref = jax.vmap(lambda f: jax_forward_covariance(f, jnp.asarray(R1), pol))(
        jnp.asarray(F))
    ref = np.asarray(ref)[..., :N10, :N10]                # (B, T, n, n)
    out = ck.covariance_lanes(to_streams(torch.from_numpy(F).reshape(
        B10, T10, -1)), n=N10, r1=tuple(map(tuple, R1.tolist())))
    out = from_streams(out, (N10, N10)).numpy()
    scale = np.abs(ref).max(axis=(0, 1), keepdims=True)
    assert np.all(np.abs(out - ref) <= 1e-5 * scale)
    assert np.abs(ref[:, -1]).max() > 2 * np.abs(ref[:, 0]).max()


def test_forward_covariance_and_simple_ltv_model_match_jax():
    rng = np.random.default_rng(9)
    d = _lti10()
    jm = jl.SimpleLTVModel.from_lti(jnp.asarray(d["A"]), jnp.asarray(d["B"]),
                                    T10)
    tm = SimpleLTVModel.from_lti(torch.from_numpy(d["A"]),
                                 torch.from_numpy(d["B"]), T10)
    assert tm.fx.shape == (T10, N10, N10) and tm.fu.shape == (T10, N10, 2)
    np.testing.assert_array_equal(tm.fx.numpy(), np.asarray(jm.fx))
    np.testing.assert_array_equal(tm.fu.numpy(), np.asarray(jm.fu))
    u = np.zeros((T10 - 2, 2), np.float32)
    np.testing.assert_array_equal(tm.fx_at(None, torch.from_numpy(u)).numpy(),
                                  np.asarray(jm.fx_at(None, jnp.asarray(u))))
    np.testing.assert_array_equal(tm.covariance().numpy(),
                                  np.asarray(jm.covariance()))
    R1 = _spd(rng, N10)
    tm1 = SimpleLTVModel(tm.fx, tm.fu, torch.from_numpy(R1))
    np.testing.assert_array_equal(tm1.covariance().numpy(), R1)
    pol = dict(K=0.3 * rng.standard_normal((T10, 2, N10)),
               k=rng.standard_normal((T10, 2)),
               sigma=np.stack([_spd(rng, 2) for _ in range(T10)]),
               sigma_inv=np.zeros((T10, 2, 2)))
    pol = {k: v.astype(np.float32) for k, v in pol.items()}
    ref = jax_forward_covariance(jm.fx, jnp.asarray(R1), JPolicy(
        **{k: jnp.asarray(v) for k, v in pol.items()}))
    out = forward_covariance(tm.fx, torch.from_numpy(R1), GaussianPolicy(
        **{k: torch.from_numpy(v) for k, v in pol.items()}))
    assert out.shape == (T10, N10 + 2, N10 + 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the fleet KL solve and GPS rollout on LTI n=4, m=2
# ---------------------------------------------------------------------------

KB, KT = 8, 8
# the reference demo's kl_step=100 takes this fleet's bracket down to
# η=1e-4, where the GPS recursion (each step's Q terms divided by η again,
# src/backward_pass.jl:293-299) grows V by 1/η a step and the two packages'
# f32 roundings part (1e-3 of the cost at η=1e-3, 65% at 1e-4, measured);
# kl_step=40 keeps every iterate at η ≥ 0.01 and meets the bound on three
# of the eight lanes. The n=10 case below runs the demo's kl_step.
CFG_SCALAR = JKLConfig(kl_step=40.0, max_iter=4)
CFG_PER_STEP = JKLConfig(kl_step=2.0, max_iter=4, constrain_per_step=True,
                         gd_alpha=0.01)


def _pre_roll(tspec, x0, u0):
    """The KL path's pre-roll by the port's plain K3 (k := u0, α=1, no
    limits): x (B, T, n), the zero-gain unit-Σ previous policy with k = u,
    cost0 (B,) and the per-step costs (B, T), as numpy."""
    Bn, Tn, m = u0.shape
    n = x0.shape[1]
    model = tl.lti_lanes(tspec)
    gains = torch.cat([to_streams(torch.from_numpy(u0)),
                       torch.zeros((Tn, m * n, Bn))], dim=1)
    ro = fk.forward_lanes_ref(torch.zeros((Tn, n + m + 1, Bn)), gains,
                              torch.from_numpy(x0.T.copy()),
                              torch.ones((1, Bn)), model=model, lims=None,
                              emit_traj=True)
    eye = np.broadcast_to(np.eye(m, dtype=np.float32), (Bn, Tn, m, m))
    policy = dict(K=np.zeros((Bn, Tn, m, n), np.float32),
                  k=from_streams(ro.traj[:, n:n + m], (m,)).numpy(),
                  sigma=eye.copy(), sigma_inv=eye.copy())
    return dict(x=from_streams(ro.traj[:, :n], (n,)).numpy(), policy=policy,
                cost0=ro.totals[0].numpy(),
                cost=ro.traj[:, n + m].T.contiguous().numpy())


@pytest.fixture(scope="module")
def fleet_inputs():
    rng = np.random.default_rng(0)
    x0 = (np.ones((KB, N)) * np.linspace(0.5, 2.0, KB)[:, None]).astype(
        np.float32)
    u0 = (0.3 * rng.standard_normal((KB, KT, M))).astype(np.float32)
    inp = _pre_roll(convert.lti_spec_from_jax(SPEC, device="cpu"), x0, u0)
    inp["fx"] = np.broadcast_to(np.asarray(SPEC.A), (KB, KT, N, N)).copy()
    return inp


def _solve_both(inp, jcfg):
    jprev = JPolicy(**{k: jnp.asarray(v) for k, v in inp["policy"].items()})
    ref = jkl.ilqgkl_batch_lanes(
        jl.lti_lanes(SPEC), JTILES, jnp.asarray(inp["x"]), jprev,
        jnp.asarray(inp["fx"]), jnp.asarray(inp["cost0"]), cfg=jcfg, kt=2,
        interpret=True)
    out = tkl.ilqgkl_batch_lanes(
        tl.lti_lanes(TSPEC), tl.lti_derivs_tiles(TSPEC),
        torch.from_numpy(inp["x"]),
        convert.policy_from_jax(jprev, device="cpu"),
        torch.from_numpy(inp["fx"]), torch.from_numpy(inp["cost0"]),
        cfg=convert.kl_config_from_jax(jcfg))
    return convert.result_to_numpy(ref), convert.result_to_numpy(out)


@pytest.mark.parametrize("jcfg", [CFG_SCALAR, CFG_PER_STEP],
                         ids=["scalar", "per-step"])
def test_kl_lti_fleet_matches_jax(fleet_inputs, jcfg):
    """Outcome flags exact; cost, η and KL to rtol 1e-4. The policy to
    rtol 1e-4 plus 1e-4 of each field's largest magnitude: at η≈0.1 the GPS
    recursion grows Vxx ten-fold a step, and Σ⁻¹ = Quu = R/η + Σ⁻¹_prev +
    fuᵀVxx·fu/η carries the rounding of that growth into its small
    off-diagonal entries (measured 5.2e-5 of Quu's scale, 1.3e-3 of the
    entry)."""
    ref, out = _solve_both(fleet_inputs, jcfg)
    check_outcomes(ref, out)
    for name in ("K", "sigma", "sigma_inv"):
        a, b = out["policy"][name], ref["policy"][name]
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)
    np.testing.assert_array_equal(out["policy"]["k"], out["u"])
    assert out["policy"]["sigma"].shape == (KB, KT, M, M)
    assert out["x"].shape == (KB, KT, N) and out["u"].shape == (KB, KT, M)
    if not jcfg.constrain_per_step:
        assert 0 < out["satisfied"].sum() < KB
        assert (out["eta"] >= 1e-2).all()


def test_gps_rollout_lti_matches_jax(fleet_inputs):
    """Two outer GPS iterations, each re-centred on the last solve, at the
    per-step configuration."""
    inp = fleet_inputs
    A = np.asarray(SPEC.A)
    jprev = JPolicy(**{k: jnp.asarray(v) for k, v in inp["policy"].items()})
    jx, jpol, jper = jkl.gps_rollout_lanes(
        jl.lti_lanes(SPEC), JTILES, jnp.asarray(inp["x"]), jprev,
        jnp.asarray(inp["cost0"]),
        lambda x, u: jnp.broadcast_to(jnp.asarray(A), x.shape[:2] + A.shape),
        2, cfg=CFG_PER_STEP, kt=2, unroll=1, interpret=True)
    tm = SimpleLTVModel.from_lti(TSPEC.A, TSPEC.B, KT)
    tx, tpol, tper = tkl.gps_rollout_lanes(
        tl.lti_lanes(TSPEC), tl.lti_derivs_tiles(TSPEC),
        torch.from_numpy(inp["x"]),
        convert.policy_from_jax(jprev, device="cpu"),
        torch.from_numpy(inp["cost0"]),
        lambda x, u: tm.fx.expand(x.shape[:1] + tm.fx.shape), 2,
        cfg=convert.kl_config_from_jax(CFG_PER_STEP))
    names = ("cost_total", "eta", "divergence", "satisfied", "kl_violated")
    for name, r, o in zip(names, jper, tper):
        assert o.shape == (2, KB), name
        if r.dtype == jnp.bool_:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                       err_msg=name)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    for name in ("K", "sigma"):
        np.testing.assert_allclose(getattr(tpol, name).numpy(),
                                   np.asarray(getattr(jpol, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the slice at n=10: fleet against JAX's generic ilqg_kl
# ---------------------------------------------------------------------------

def test_kl_lti_n10_fleet_matches_generic_ilqg_kl():
    """The reference demo (demo_linear_kl: random_lti n=10, m=2,
    kl_step=100, SimpleLTVModel.from_lti) at B=3, T=16, 6 iterations: the
    port's fleet solve against JAX's generic ilqg_kl vmapped over the lanes,
    to the fleet-against-generic tolerances of tests/test_batch_kl.py:43-52
    (cost_total rtol 5e-3, η rtol 1e-2) and the same satisfied flags."""
    Tn, Bn = 16, 3
    d = _lti10(T=Tn)
    jspec = jl.LTISpec(**{k: jnp.asarray(v) for k, v in d.items()})
    tspec = convert.lti_spec_from_jax(jspec, device="cpu")
    x0 = (np.ones((Bn, N10)) * np.linspace(0.5, 2.0, Bn)[:, None]).astype(
        np.float32)
    inp = _pre_roll(tspec, x0, np.broadcast_to(d["u0"], (Bn, Tn, 2)).copy())
    cfg = JKLConfig(kl_step=100.0, max_iter=6)
    problem = jl.make_lti_problem(jspec, Tn)
    jm = jl.SimpleLTVModel.from_lti(jspec.A, jspec.B, Tn)
    jprev = JPolicy(**{k: jnp.asarray(v) for k, v in inp["policy"].items()})
    ref = jax.vmap(lambda x, p, c: jax_ilqg_kl(problem, x, p, jm, c,
                                               cfg=cfg))(
        jnp.asarray(inp["x"]), jprev, jnp.asarray(inp["cost"]))
    tm = SimpleLTVModel.from_lti(tspec.A, tspec.B, Tn)
    out = tkl.ilqgkl_batch_lanes(
        tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec),
        torch.from_numpy(inp["x"]),
        convert.policy_from_jax(jprev, device="cpu"),
        tm.fx.expand(Bn, Tn, N10, N10), torch.from_numpy(inp["cost0"]),
        cfg=convert.kl_config_from_jax(cfg))
    assert out.policy.K.shape == (Bn, Tn, 2, N10)
    np.testing.assert_allclose(out.cost_total.numpy(),
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=5e-3)
    np.testing.assert_allclose(out.eta.numpy(), np.asarray(ref.eta),
                               rtol=1e-2)
    np.testing.assert_array_equal(out.satisfied.numpy(),
                                  np.asarray(ref.satisfied))
