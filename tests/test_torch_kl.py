"""The port's fleet KL/GPS solver (plain versions, CPU) against the JAX
package's ``ilqgkl_batch_lanes`` with its Pallas kernels in interpret mode,
and the KL helpers and the pendcart Problem against their JAX
counterparts.

Shapes follow ``tests/test_batch_kl.py`` (B=8, T=10, ``max_iter`` ≤ 4,
``kt=4``; ``kl_step`` 2, or 0.05 where a trace is compared row by row).
Inputs are made once in numpy f64 with a
seeded Generator and cast to f32; the pre-roll, the previous policy and
the linearisations are computed once and handed to both packages as numpy
arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.ops.forward import forward_pass
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ILQGKLConfig as JKLConfig)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl

B, T = 8, 10
SPEC = jpc.PendCartSpec()


def kl_inputs(B=B, T=T, seed=0, bad_sigma=()):
    """Pre-rolled pendcart trajectories around the swing-up and a zero
    previous policy with k = u0 (``bench.py:114-131``), as numpy f32:
    x (B, T, 4), policy leaves, fx (B, T, 4, 4), cost0 (B,). Lanes in
    ``bad_sigma`` get a negative definite previous Σ."""
    rng = np.random.default_rng(seed)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.1 * rng.standard_normal((B, 4))).astype(np.float32)
    u0s = (0.2 * rng.standard_normal((B, T, 1))).astype(np.float32)
    problem = jpc.make_pendcart_problem(SPEC, derivs="euler",
                                        dtype=jnp.float32)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b))(
        jnp.asarray(x0s), jnp.asarray(u0s))
    fx = jax.vmap(problem.make_derivs())(ro.x, ro.u).fx
    sig = np.ones((B, T, 1, 1), np.float32)
    for i, lane in enumerate(bad_sigma):
        sig[lane] = -1.0 - i
    policy = dict(K=np.zeros((B, T, 1, 4), np.float32),
                  k=np.array(ro.u), sigma=sig, sigma_inv=1.0 / sig)
    return dict(x=np.array(ro.x), policy=policy, fx=np.array(fx),
                cost0=np.array(jnp.sum(ro.cost, -1)))


def solve_both(inp, jcfg, record_trace=False):
    jprev = JPolicy(**{k: jnp.asarray(v) for k, v in inp["policy"].items()})
    ref = jkl.ilqgkl_batch_lanes(
        jpc.pendcart_lanes(SPEC), jpc.pendcart_derivs_tiles(SPEC),
        jnp.asarray(inp["x"]), jprev, jnp.asarray(inp["fx"]),
        jnp.asarray(inp["cost0"]), cfg=jcfg, kt=4, interpret=True,
        record_trace=record_trace)
    tspec = convert.spec_from_jax(SPEC)
    out = tkl.ilqgkl_batch_lanes(
        tpc.pendcart_lanes(tspec), tpc.pendcart_derivs_tiles(tspec),
        torch.from_numpy(inp["x"]),
        convert.policy_from_jax(jprev, device="cpu"),
        torch.from_numpy(inp["fx"]), torch.from_numpy(inp["cost0"]),
        cfg=convert.kl_config_from_jax(jcfg), record_trace=record_trace)
    return convert.result_to_numpy(ref), convert.result_to_numpy(out)


def check_outcomes(ref, out, lanes=slice(None)):
    for name in ("satisfied", "pd_failed", "done", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for name in ("cost_total", "eta", "divergence"):
        np.testing.assert_allclose(out[name][lanes], ref[name][lanes],
                                   rtol=1e-4, err_msg=name)


def check_policy(ref, out):
    for name in ("K", "sigma", "sigma_inv"):
        np.testing.assert_allclose(out["policy"][name], ref["policy"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out["policy"]["k"], out["u"])


@pytest.fixture(scope="module")
def scalar():
    # kl_step=0.05 keeps every iterate at η ≥ 1.3 and satisfies 7 of the 8
    # lanes by the last iteration. At kl_step=2 the second iterate runs at
    # η=0.1, where V grows ~10× per step and the rollout leaves the swing-up
    # (cost 25 → 2.9e6); in that one trace row the two packages' f32
    # roundings (XLA contracts multiply-adds on the CPU, the port rounds
    # each operation) part by up to 3e-4. kl_step=2 is covered by the
    # per-step and pd_failed cases, compared by outcome and policy.
    return solve_both(kl_inputs(), JKLConfig(kl_step=0.05, max_iter=4),
                      record_trace=True)


@pytest.fixture(scope="module")
def per_step():
    return solve_both(kl_inputs(), JKLConfig(
        kl_step=2.0, max_iter=3, constrain_per_step=True, gd_alpha=0.01))


@pytest.fixture(scope="module")
def pd_failed():
    return solve_both(kl_inputs(bad_sigma=(2, 5)),
                      JKLConfig(kl_step=2.0, max_iter=4))


def test_kl_scalar_outcomes_match_jax(scalar):
    ref, out = scalar
    check_outcomes(ref, out)
    assert 0 < out["satisfied"].sum() < B
    np.testing.assert_allclose(out["bracket"], ref["bracket"], rtol=1e-4)
    assert out["x"].shape == (B, T, 4) and out["cost"].shape == (B, T)
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-5, atol=1e-5)


def test_kl_scalar_policy_matches_jax(scalar):
    check_policy(*scalar)


def test_kl_scalar_trace_matches_jax(scalar):
    ref, out = scalar
    rt, ot = ref["trace"], out["trace"]
    assert ot["cost"].shape == (B, 5)
    for name in ("cost", "improvement", "divergence", "eta"):
        np.testing.assert_allclose(ot[name], rt[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # reduce_ratio = improvement / expected with expected = -(dV1+dV2) of
    # order 1e-3 here: a ratio carries the improvement's absolute error
    # (cost0 - cost cancels 25 down to 0.02) divided by expected, so it is
    # held in cost units, as improvement is
    with np.errstate(divide="ignore", invalid="ignore"):
        expected = np.where(rt["reduce_ratio"] != 0,
                            rt["improvement"] / rt["reduce_ratio"], 0.0)
    np.testing.assert_allclose(ot["reduce_ratio"] * expected,
                               rt["reduce_ratio"] * expected, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ot["reduce_ratio"], rt["reduce_ratio"],
                               rtol=1e-3)


def test_kl_per_step_matches_jax(per_step):
    """The per-step η variant: ADAM on log η with the bias correction at the
    global iteration count (JAX batch_kl.py:428-447)."""
    ref, out = per_step
    check_outcomes(ref, out)
    check_policy(ref, out)
    assert out["bracket"].shape == (B, 3, T)
    for name in ("bracket", "adam"):
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_kl_pd_failure_matches_jax(pd_failed):
    """An indefinite previous Σ on lanes 2 and 5 flags pd_failed at the
    first KL measurement, and those lanes are not satisfied
    (``tests/test_batch_kl.py:142-186``)."""
    ref, out = pd_failed
    bad = np.zeros(B, bool)
    bad[[2, 5]] = True
    np.testing.assert_array_equal(out["pd_failed"], bad)
    # the flagged lanes end on an iterate whose Quu = R + fuᵀVxx·fu - 1
    # nearly cancels (Σ⁻¹_prev = -1), so their gains, cost and KL are not
    # reproducible between two f32 implementations: they are held by their
    # flags, the healthy lanes by value
    ok = ~bad
    check_outcomes(ref, out, ok)
    np.testing.assert_array_equal(out["eta"], ref["eta"])
    assert not out["satisfied"][bad].any()
    assert np.all(out["n_iters"][bad] == 1)
    for name in ("K", "sigma", "sigma_inv"):
        np.testing.assert_allclose(out["policy"][name][ok],
                                   ref["policy"][name][ok], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kwargs,option", [
    (dict(bracket0=np.tile(np.float32([1e-8, 1.0, 1e16]), (B, 1))),
     "bracket0"),
    (dict(delta0_in=np.full(B, 1e-4, np.float32)), "delta0_in"),
    (dict(adam0_in=np.ones((B, 2, 4), np.float32)), "adam0_in"),
    (dict(it0=3), "it0"),
    (dict(max_steps=2), "max_steps"),
])
def test_kl_out_of_slice_options_raise(kwargs, option):
    """The KL fleet scheduler's resume inputs, which raised before the
    scheduler was ported, are taken. Each alone, at the state a solve
    starts from, gives the plain solve: the default bracket and increment;
    ADAM moments, ignored with scalar η; ``it0`` only shifts the global
    iteration count (no bias correction with scalar η), so ``max_iter - 3``
    plain iterations with n_iters + 3; ``max_steps`` bounds the loop as
    ``max_iter`` does."""
    inp = kl_inputs(B=B, T=4)
    tspec = convert.spec_from_jax(SPEC)

    def solve(max_iter, **kw):
        return tkl.ilqgkl_batch_lanes(
            tpc.pendcart_lanes(tspec), tpc.pendcart_derivs_tiles(tspec),
            torch.from_numpy(inp["x"]),
            convert.policy_from_jax(type("P", (), inp["policy"]),
                                    device="cpu"),
            torch.from_numpy(inp["fx"]), torch.from_numpy(inp["cost0"]),
            cfg=convert.kl_config_from_jax(JKLConfig(kl_step=0.05,
                                                     max_iter=max_iter)),
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})

    out = convert.result_to_numpy(solve(6, **kwargs))
    ref = convert.result_to_numpy(solve(
        {"it0": 3, "max_steps": 2}.get(option, 6)))
    if option == "it0":
        np.testing.assert_array_equal(out.pop("n_iters"),
                                      ref.pop("n_iters") + 3)
    for name in ("cost_total", "eta", "divergence", "satisfied", "done",
                 "n_iters", "x", "u", "bracket", "delta"):
        if name in ref:
            np.testing.assert_array_equal(out[name], ref[name],
                                          err_msg=name)
    np.testing.assert_array_equal(out["policy"]["K"], ref["policy"]["K"])


# ---------------------------------------------------------------------------
# KL helpers
# ---------------------------------------------------------------------------

def _spd_stream(rng, m, Tn=5, Bn=16, shift=0.5):
    A = rng.standard_normal((Tn, Bn, m, m))
    S = np.einsum("tbij,tbkj->tbik", A, A) + shift * np.eye(m)
    return np.moveaxis(S.reshape(Tn, Bn, m * m), 1, 2).astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_logdet_tiles_matches_jax(m):
    """Closed form for m ≤ 2, Cholesky diagonal above; an indefinite entry
    gives ok=False on both sides."""
    rng = np.random.default_rng(m)
    S = _spd_stream(rng, m)
    S[0, ::m + 1, :3] -= 20.0          # indefinite on 3 lanes at t=0
    ref, rok = jkl._logdet_tiles(jnp.asarray(S), m)
    out, ok = tkl._logdet_tiles(torch.from_numpy(S), m)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert not ok[0, :3].any() and ok[1:].all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _kl_args(rng, Tn=6, Bn=16, n=4, m=1):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    sxx = _spd_stream(rng, n, Tn, Bn)
    S_n = np.abs(f(Tn, 1, Bn)) + 0.1
    Si_p = np.abs(f(Tn, 1, Bn)) + 0.1
    return [f(Tn, n, Bn), sxx, f(Tn, m, Bn), f(Tn, m * n, Bn), S_n,
            f(Tn, m, Bn), f(Tn, m * n, Bn), Si_p]


def test_kl_div_wiki_lanes_matches_jax():
    rng = np.random.default_rng(0)
    args = _kl_args(rng)
    args[4][0, 0, :2] = -1.0            # indefinite new Σ: ok=False, kl ≥ 0
    args[1][1, 3, 0] = np.nan           # a NaN in Σxx stays NaN
    ref, rok = jkl.kl_div_wiki_lanes(*map(jnp.asarray, args), n=4, m=1)
    out, ok = tkl.kl_div_wiki_lanes(*map(torch.from_numpy, args), n=4, m=1)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert not ok[0, :2].any()
    assert np.isnan(out[1, 0].item()) and np.isnan(np.asarray(ref)[1, 0])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert (out.numpy()[~np.isnan(out.numpy())] >= 0).all()


def test_calc_eta_lanes_matches_jax():
    rng = np.random.default_rng(1)
    div = np.concatenate([rng.uniform(0, 4, 12), [2.1, 1.95, np.nan, 0.0]])
    lo = 10.0 ** rng.uniform(-8, -1, 16)
    mid = lo * 10.0 ** rng.uniform(0, 6, 16)
    br = np.stack([lo, mid, mid * 10.0 ** rng.uniform(0, 20, 16)]
                  ).astype(np.float32)
    div = div.astype(np.float32)
    rbr, rsat = jkl.calc_eta_lanes(jnp.asarray(div), jnp.asarray(br),
                                   jnp.float32(2.0))
    obr, osat = tkl.calc_eta_lanes(torch.from_numpy(div),
                                   torch.from_numpy(br), torch.tensor(2.0))
    np.testing.assert_array_equal(osat.numpy(), np.asarray(rsat))
    assert osat[12] and osat[13] and not osat[14]
    np.testing.assert_allclose(obr.numpy(), np.asarray(rbr), rtol=1e-5)


# ---------------------------------------------------------------------------
# Problem, pendcart "euler" scheme
# ---------------------------------------------------------------------------

def test_make_pendcart_problem_matches_jax():
    rng = np.random.default_rng(2)
    x = (np.array([np.pi, 0, 0, 0]) + rng.standard_normal((3, 7, 4))
         ).astype(np.float32)
    u = (3.0 * rng.standard_normal((3, 7, 1))).astype(np.float32)
    jp = jpc.make_pendcart_problem(SPEC, derivs="euler", dtype=jnp.float32)
    tp = tpc.make_pendcart_problem(convert.spec_from_jax(SPEC),
                                   derivs="euler", device="cpu")
    jd = jax.vmap(jp.make_derivs())(jnp.asarray(x), jnp.asarray(u))
    td = tp.make_derivs()(torch.from_numpy(x), torch.from_numpy(u))
    for name in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu"):
        a, b = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(
        tp.traj_cost(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
        np.asarray(jax.vmap(jp.traj_cost)(jnp.asarray(x), jnp.asarray(u))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tp.dynamics(torch.from_numpy(x[:, 0]), torch.from_numpy(u[:, 0]),
                    0).numpy(),
        np.asarray(jax.vmap(lambda a, b: jp.dynamics(a, b, 0))(
            jnp.asarray(x[:, 0]), jnp.asarray(u[:, 0]))), rtol=1e-6)


def test_problem_trajectory_cost_without_traj_cost():
    """A Problem without ``traj_cost`` stacks its running cost over T."""
    tp = tpc.make_pendcart_problem(derivs="euler", device="cpu")
    bare = tpc.Problem(dynamics=tp.dynamics, cost=tp.cost)
    x, u = torch.randn(3, 5, 4), torch.randn(3, 5, 1)
    c = bare.trajectory_cost(x, u)
    assert c.shape == (3, 5)
    torch.testing.assert_close(c, tp.traj_cost(x, u)[:, :5], rtol=0, atol=0)
    # without derivs it differentiates its own functions: the Euler
    # Jacobians up to f32 rounding of the chain rule's products
    d, e = bare.make_derivs()(x, u), tp.make_derivs()(x, u)
    for name in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu"):
        torch.testing.assert_close(getattr(d, name), getattr(e, name),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scheme,exc", [("zoh", None), ("x", ValueError)])
def test_make_pendcart_problem_other_schemes_raise(scheme, exc):
    """An unknown scheme raises; "zoh" (ported with the generic tier)
    builds its derivative function."""
    if exc is None:
        assert tpc.make_pendcart_problem(derivs=scheme,
                                         device="cpu").derivs is not None
        return
    with pytest.raises(exc, match=scheme):
        tpc.make_pendcart_problem(derivs=scheme, device="cpu")


def test_kl_config_and_policy_convert():
    jcfg = JKLConfig(kl_step=0.5, constrain_per_step=True, max_iter=7,
                     eta_bracket=(1e-6, 2.0, 1e12), retry_cap=9)
    cfg = convert.kl_config_from_jax(jcfg)
    assert (cfg.kl_step, cfg.max_iter, cfg.retry_cap) == (0.5, 7, 9)
    assert cfg.constrain_per_step and cfg.eta_bracket == (1e-6, 2.0, 1e12)
    pol = JPolicy.zeros(5, 4, 1, jnp.float32)
    tpol = convert.policy_from_jax(pol, device="cpu")
    assert tpol.K.shape == (5, 1, 4) and tpol.K.dtype == torch.float32
    np.testing.assert_array_equal(tpol.sigma.numpy(), 1.0)
