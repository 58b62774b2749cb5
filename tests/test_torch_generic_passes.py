"""The port's backward pass, forward pass, line search and parallel Riccati
scan against the JAX package's on the same numpy-seeded inputs, in f64 on
the CPU.

Tolerance: rtol 1e-9 (atol 1e-10) on every output. The two packages run the
same recursion; the order of matrix products and LAPACK's factorisations
differ in the last bits, and a 12-step Riccati recursion carries that. The
parallel scan combines in another tree than ``lax.associative_scan``, so it
is held to the same tolerance, not bit for bit. Flags and indices must be
equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.ops import backward as tbw
from differentialdynamicprogramming_jl_tpu_torch.ops import forward as tfw
from differentialdynamicprogramming_jl_tpu_torch.ops.riccati_scan import (
    parallel_riccati)
from differentialdynamicprogramming_jl_tpu_torch.policy import Derivs
from differentialdynamicprogramming_jl_tpu_torch.problem import Problem

T, N = 12, 4
RTOL, ATOL = 1e-9, 1e-10


def derivs_np(m, seed=0, second_order=False, concave_at=None):
    rng = np.random.default_rng(seed)
    n = N
    d = dict(fx=np.eye(n) + 0.15 * rng.standard_normal((T, n, n)),
             fu=0.3 * rng.standard_normal((T, n, m)),
             cx=rng.standard_normal((T, n)), cu=rng.standard_normal((T, m)),
             cxx=np.broadcast_to(np.eye(n), (T, n, n)).copy(),
             cxu=0.05 * rng.standard_normal((T, n, m)),
             cuu=np.broadcast_to(0.5 * np.eye(m), (T, m, m)).copy())
    if concave_at is not None:
        d["cuu"][concave_at] = -5.0 * np.eye(m)
    if second_order:
        for name, shape in (("fxx", (n, n)), ("fxu", (n, m)),
                            ("fuu", (m, m))):
            a = 0.05 * rng.standard_normal((T, n) + shape)
            if shape[0] == shape[1]:
                a = 0.5 * (a + np.swapaxes(a, -1, -2))
            d[name] = a
    return d


def kl_np(m, seed=1):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((T, m, m))
    return dict(cx=rng.standard_normal((T, N)), cu=rng.standard_normal((T, m)),
                cxx=np.broadcast_to(0.3 * np.eye(N), (T, N, N)).copy(),
                cxu=0.1 * rng.standard_normal((T, m, N)),
                cuu=A @ np.swapaxes(A, -1, -2) + np.eye(m))


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _same_bw(jo, to):
    assert bool(jo.diverged) == bool(to.diverged)
    assert int(jo.diverge_idx) == int(to.diverge_idx)
    for name in ("k", "K", "sigma", "sigma_inv"):
        _close(getattr(to.policy, name).numpy(),
               getattr(jo.policy, name), name)
    for name in ("Vx", "Vxx", "dV"):
        _close(getattr(to, name).numpy(), getattr(jo, name), name)


LIMS = {1: np.array([[-0.4, 0.4]]), 2: np.array([[-0.4, 0.4], [-0.2, 0.3]])}
BACKWARD = {   # name: (m, reg_type, limits, second order, GPS η)
    "reg1": (2, 1, False, False, None),
    "reg2": (2, 2, False, False, None),
    "m1_limits": (1, 2, True, False, None),
    "m2_limits": (2, 1, True, False, None),
    "second_order": (2, 1, False, True, None),
    "second_order_reg2": (2, 2, False, True, None),
    "gps_scalar": (2, 1, False, False, "scalar"),
    "gps_per_step": (2, 1, False, False, "per_step"),
    "gps_m2_limits": (2, 1, True, False, "scalar"),
}


def _run_both(m, reg_type, limits, so, gps, d, lam=0.3):
    u = np.random.default_rng(9).standard_normal((T, m))
    kw = dict(reg_type=reg_type, use_limits=limits)
    jkw, tkw = dict(kw), dict(kw)
    if limits:
        jkw["lims"], tkw["lims"] = jnp.asarray(LIMS[m]), torch.tensor(LIMS[m])
    if gps is not None:
        eta = 0.7 if gps == "scalar" else np.linspace(0.5, 2.0, T)
        kl = kl_np(m)
        jkw.update(gps_mode=True, eta=jnp.asarray(eta),
                   kl_terms=J.KLTerms(**{k: jnp.asarray(v)
                                         for k, v in kl.items()}))
        tkw.update(gps_mode=True,
                   eta=torch.as_tensor(eta, dtype=torch.float64),
                   kl_terms=convert.kl_terms_from_jax(
                       type("K", (), kl), torch.float64, "cpu"))
    jd = J.Derivs(**{k: jnp.asarray(v) for k, v in d.items()})
    td = convert.derivs_from_jax(type("D", (), d), torch.float64, "cpu")
    jo = J.backward_pass(jd, jnp.asarray(u), lam, **jkw)
    to = tbw.backward_pass(td, torch.tensor(u), lam, **tkw)
    return jo, to


@pytest.mark.parametrize("case", list(BACKWARD))
def test_backward_pass_matches_jax(case):
    m, reg_type, limits, so, gps = BACKWARD[case]
    jo, to = _run_both(m, reg_type, limits, so, gps,
                       derivs_np(m, second_order=so))
    assert not bool(jo.diverged)
    _same_bw(jo, to)


@pytest.mark.parametrize("case", ["reg1", "m1_limits", "m2_limits"])
def test_non_pd_diverges_as_jax(case):
    """A concave control cost at two steps: the first failure met going
    backward (the later step) is latched, as in JAX."""
    m, reg_type, limits, so, gps = BACKWARD[case]
    d = derivs_np(m, concave_at=[3, 8])
    jo, to = _run_both(m, reg_type, limits, so, gps, d, lam=0.0)
    assert bool(jo.diverged) and int(jo.diverge_idx) == 9
    assert bool(to.diverged) and int(to.diverge_idx) == 9


def test_backward_batched_lanes_with_own_lambda():
    """Leading dims are independent problems, each with its own λ: lane b
    equals the single call with λ_b."""
    d = derivs_np(2)
    td = convert.derivs_from_jax(type("D", (), d), torch.float64, "cpu")
    u = torch.tensor(np.random.default_rng(3).standard_normal((3, T, 2)))
    lam = torch.tensor([0.0, 0.3, 5.0], dtype=torch.float64)
    out = tbw.backward_pass(td, u, lam, reg_type=2)
    for b in range(3):
        one = tbw.backward_pass(td, u[b], lam[b], reg_type=2)
        np.testing.assert_allclose(out.policy.K[b].numpy(),
                                   one.policy.K.numpy(), rtol=1e-12)
        np.testing.assert_allclose(out.dV[b].numpy(), one.dV.numpy(),
                                   rtol=1e-12)


def _lti(m=2, seed=4):
    rng = np.random.default_rng(seed)
    A = np.eye(N) + 0.1 * rng.standard_normal((N, N))
    Bm = 0.2 * rng.standard_normal((N, m))
    jp = J.Problem(dynamics=lambda x, u, t: jnp.asarray(A) @ x
                   + jnp.asarray(Bm) @ u,
                   cost=lambda x, u, t: 0.5 * (x @ x + 0.1 * u @ u))
    At, Bt = torch.tensor(A), torch.tensor(Bm)
    tp = Problem(dynamics=lambda x, u, t: x @ At.T + u @ Bt.T,
                 cost=lambda x, u, t: 0.5 * ((x * x).sum(-1)
                                             + 0.1 * (u * u).sum(-1)))
    return jp, tp


def _policy(m, seed=5):
    rng = np.random.default_rng(seed)
    pol = dict(K=0.2 * rng.standard_normal((T, m, N)),
               k=rng.standard_normal((T, m)),
               sigma=np.broadcast_to(np.eye(m), (T, m, m)).copy(),
               sigma_inv=np.broadcast_to(np.eye(m), (T, m, m)).copy())
    return (J.GaussianPolicy(**{k: jnp.asarray(v) for k, v in pol.items()}),
            convert.policy_from_jax(type("P", (), pol), torch.float64,
                                    "cpu"))


@pytest.mark.parametrize("with_policy", [False, True])
def test_forward_pass_matches_jax(with_policy):
    jp, tp = _lti()
    rng = np.random.default_rng(6)
    x0, u = rng.standard_normal(N), rng.standard_normal((T, 2))
    x_old = rng.standard_normal((T, N))
    jpol, tpol = _policy(2) if with_policy else (None, None)
    lims = LIMS[2]
    jr = J.forward_pass(jp, jnp.asarray(x0), jnp.asarray(u),
                        jnp.asarray(x_old), 0.5, jpol, jnp.asarray(lims))
    tr = tfw.forward_pass(tp, torch.tensor(x0), torch.tensor(u),
                          torch.tensor(x_old), 0.5, tpol, torch.tensor(lims))
    for name in ("x", "u", "cost"):
        _close(getattr(tr, name).numpy(), getattr(jr, name), name)


def _sqrt_problem():
    """n = m = 1, x' = x + u, cost √(1 - u²) + x²: NaN where |u| > 1."""
    jp = J.Problem(dynamics=lambda x, u, t: x + u,
                   cost=lambda x, u, t: jnp.sqrt(1.0 - u[0] ** 2) + x @ x)
    tp = Problem(dynamics=lambda x, u, t: x + u,
                 cost=lambda x, u, t: torch.sqrt(1.0 - u[..., 0] ** 2)
                 + (x * x).sum(-1))
    return jp, tp


@pytest.mark.parametrize("dV", [(-1.0, 0.5), (0.2, 0.1)])
def test_line_search_with_nan_candidate_matches_jax(dV):
    """The α=1 candidate's controls leave |u| ≤ 1 and its cost is NaN. With
    a negative expected reduction (dV > 0) the ratio is sign(Δcost): NaN in
    JAX, which the port keeps (``torch.sign(nan)`` is 0, which
    ``reduce_ratio_min=-0.5`` would accept)."""
    jp, tp = _sqrt_problem()
    Tl = 6
    x0, u = np.array([0.3]), np.full((Tl, 1), 0.1)
    k = np.full((Tl, 1), 1.5)
    pol = dict(K=np.zeros((Tl, 1, 1)), k=k,
               sigma=np.ones((Tl, 1, 1)), sigma_inv=np.ones((Tl, 1, 1)))
    jpol = J.GaussianPolicy(**{a: jnp.asarray(v) for a, v in pol.items()})
    tpol = convert.policy_from_jax(type("P", (), pol), torch.float64, "cpu")
    x_old = np.zeros((Tl, 1))
    alphas = (1.0, 0.3, 0.1)
    jro = J.forward_pass(jp, jnp.asarray(x0), jnp.asarray(u))
    c_old = float(jnp.sum(jro.cost)) + 100.0
    jl = J.line_search(jp, jnp.asarray(x0), jnp.asarray(u),
                       jnp.asarray(x_old), c_old, jpol, jnp.asarray(dV),
                       alphas, reduce_ratio_min=-0.5)
    tl = tfw.line_search(tp, torch.tensor(x0), torch.tensor(u),
                         torch.tensor(x_old),
                         torch.tensor(c_old, dtype=torch.float64), tpol,
                         torch.tensor(dV, dtype=torch.float64), alphas,
                         reduce_ratio_min=-0.5)
    assert bool(jl.done) and bool(tl.done)
    assert float(jl.alpha) == float(tl.alpha) == 0.3
    assert not np.isnan(float(jl.reduce_ratio))
    for name in ("x", "u", "cost", "dcost", "expected", "reduce_ratio"):
        _close(getattr(tl, name).numpy(), getattr(jl, name), name)


def test_line_search_matches_jax():
    jp, tp = _lti()
    rng = np.random.default_rng(8)
    x0, u = rng.standard_normal(N), rng.standard_normal((T, 2))
    jpol, tpol = _policy(2)
    jro = J.forward_pass(jp, jnp.asarray(x0), jnp.asarray(u),
                         lims=jnp.asarray(LIMS[2]))
    u = np.asarray(jro.u)
    alphas = J.default_alphas()
    dV = np.array([-2.0, 0.5])
    # an old cost that the full steps miss and the shorter ones reach
    c_old = float(jnp.sum(jro.cost)) + 3.0
    jl = J.line_search(jp, jnp.asarray(x0), jnp.asarray(u), jro.x, c_old,
                       jpol, jnp.asarray(dV), alphas, jnp.asarray(LIMS[2]))
    tl = tfw.line_search(tp, torch.tensor(x0), torch.tensor(u),
                         torch.tensor(np.asarray(jro.x)),
                         torch.tensor(c_old, dtype=torch.float64), tpol,
                         torch.tensor(dV), alphas, torch.tensor(LIMS[2]))
    assert bool(jl.done) and bool(tl.done)
    assert float(jl.alpha) == float(tl.alpha) < 1.0
    for name in ("x", "u", "cost", "dcost", "expected", "reduce_ratio"):
        _close(getattr(tl, name).numpy(), getattr(jl, name), name)


def test_parallel_riccati_matches_jax_and_sequential():
    d = derivs_np(2, seed=11)
    u = np.random.default_rng(12).standard_normal((T, 2))
    jd = J.Derivs(**{k: jnp.asarray(v) for k, v in d.items()})
    td = convert.derivs_from_jax(type("D", (), d), torch.float64, "cpu")
    jo = J.parallel_riccati(jd, jnp.asarray(u))
    to = parallel_riccati(td, torch.tensor(u))
    _same_bw(jo, to)
    seq = tbw.backward_pass(td, torch.tensor(u), 0.0)
    for name in ("k", "K", "sigma"):
        _close(getattr(to.policy, name).numpy(),
               getattr(seq.policy, name).numpy(), name)
    for name in ("Vx", "Vxx", "dV"):
        _close(getattr(to, name).numpy(), getattr(seq, name).numpy(), name)
    # batched: two problems in one scan
    tb = parallel_riccati(Derivs(*(None if a is None else
                                   torch.stack([a, a]) for a in td)),
                          torch.tensor(u).expand(2, T, 2))
    np.testing.assert_allclose(tb.policy.K[1].numpy(), to.policy.K.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_parallel_riccati_non_pd_matches_jax():
    d = derivs_np(2, seed=13, concave_at=[2, 7])
    u = np.zeros((T, 2))
    jo = J.parallel_riccati(J.Derivs(**{k: jnp.asarray(v)
                                        for k, v in d.items()}),
                            jnp.asarray(u))
    to = parallel_riccati(convert.derivs_from_jax(type("D", (), d),
                                                  torch.float64, "cpu"),
                          torch.tensor(u))
    assert bool(jo.diverged) and bool(to.diverged)
    assert int(jo.diverge_idx) == int(to.diverge_idx)
