"""The port's LTI model (``models/linear.py``) against the JAX package's, at
the LTI fleet's width n=10, m=2: the lane model, the in-kernel derivative
tiles, ``make_lti_problem``, ``broadcast_derivs`` and ``lti_spec_from_jax``.

Specs and states are made once in numpy f64 from a seeded Generator and
cast to f32 for both packages. No Pallas kernel runs here. The lane
functions and the derivative tiles are elementwise chains of f32 products
and sums in one order on both sides: they agree bit for bit (XLA on the
host evaluates these elementwise ops one by one). ``make_lti_problem``
uses matrix products, whose summation order is the BLAS library's on each
side: held to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.problem import (
    broadcast_derivs as jax_broadcast_derivs)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.problem import (
    broadcast_derivs)

B, T = 256, 7
N, M = 10, 2


def _spec(seed=0, n=N, m=M, sparse=False):
    """A JAX LTISpec by random_lti's construction, from numpy f64; with
    ``sparse``, some entries of A, B and Q exactly 0 and a dense Q."""
    rng = np.random.default_rng(seed)
    h = 0.01
    Mm = rng.standard_normal((n, n))
    A = expm(h * (Mm - Mm.T))
    Bm = h * rng.standard_normal((n, m))
    Q = h * np.eye(n)
    if sparse:
        A[rng.uniform(size=(n, n)) < 0.3] = 0.0
        Bm[0] = 0.0
        Q = Q + 0.001 * (rng.uniform(size=(n, n)) < 0.2)
    f = jnp.float32
    return jl.LTISpec(A=jnp.asarray(A, f), B=jnp.asarray(Bm, f),
                      Q=jnp.asarray(Q, f),
                      R=jnp.asarray(0.1 * h * np.eye(m), f),
                      x0=jnp.ones((n,), f),
                      u0=jnp.asarray(0.1 * rng.standard_normal((T, m)), f))


def _states(seed=1, n=N, m=M):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, B)).astype(np.float32),
            (0.5 * rng.standard_normal((m, B))).astype(np.float32))


def _lists(x, u):
    return ([jnp.asarray(v) for v in x], [jnp.asarray(v) for v in u],
            [torch.from_numpy(v) for v in x], [torch.from_numpy(v) for v in u])


@pytest.mark.parametrize("sparse", [False, True])
def test_lti_lanes_match_jax_bitwise(sparse):
    spec = _spec(sparse=sparse)
    jm = jl.lti_lanes(spec)
    tm = tl.lti_lanes(convert.lti_spec_from_jax(spec, device="cpu"))
    jx, ju, tx, tu = _lists(*_states())
    assert (tm.n, tm.m) == (jm.n, jm.m) == (N, M)
    assert tm.terminal is None and jm.terminal is None
    for i, (a, b) in enumerate(zip(tm.dynamics(tx, tu, 0),
                                   jm.dynamics(jx, ju, 0))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"dynamics[{i}]")
    np.testing.assert_array_equal(tm.cost(tx, tu, 0).numpy(),
                                  np.asarray(jm.cost(jx, ju, 0)))


@pytest.mark.parametrize("sparse", [False, True])
def test_lti_derivs_tiles_match_jax_bitwise(sparse):
    spec = _spec(seed=2, sparse=sparse)
    jx, ju, tx, tu = _lists(*_states(seed=3))
    jd = jl.lti_derivs_tiles(spec)(jx, ju, 0)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    td = tl.lti_derivs_tiles(tspec)(tx, tu, 0)
    assert set(td) == set(jd)

    def flat(v):
        return ([np.asarray(v)] if not isinstance(v, list)
                else [a for w in v for a in flat(w)])

    for key in jd:
        a, b = np.stack(flat(td[key])), np.stack(flat(jd[key]))
        assert a.shape == b.shape == (len(a), B), key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_zero_skip_keeps_inf_out_of_nan():
    """The zero-skipping rule: a term whose constant is 0 is left out, so an
    infinite state does not turn 0·Inf into NaN (the reason-5 lanes of the
    fleet solver rely on it), and a zero row gives +0."""
    one = jnp.ones((2, 2), jnp.float32)
    A = jnp.asarray([[1e30, 0.0], [0.0, 0.0]], jnp.float32)
    spec = jl.LTISpec(A=A, B=jnp.asarray([[1.0], [0.0]], jnp.float32),
                      Q=one * jnp.eye(2), R=jnp.ones((1, 1), jnp.float32),
                      x0=jnp.zeros(2), u0=jnp.zeros((T, 1)))
    tm = tl.lti_lanes(convert.lti_spec_from_jax(spec, device="cpu"))
    x = [torch.tensor([np.inf, 1.0]), torch.tensor([-np.inf, 2.0])]
    u = [torch.tensor([1.0, -0.0])]
    xn = tm.dynamics(x, u, 0)
    assert not torch.isnan(xn[0]).any() and torch.isinf(xn[0][0])
    assert torch.equal(xn[1], torch.zeros(2))
    assert not torch.signbit(xn[1]).any()
    jm = jl.lti_lanes(spec)
    jn = jm.dynamics([jnp.asarray(v.numpy()) for v in x],
                     [jnp.asarray(u[0].numpy())], 0)
    np.testing.assert_array_equal(xn[0].numpy(), np.asarray(jn[0]))


def test_make_lti_problem_matches_jax():
    spec = _spec(seed=4)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    jp = jl.make_lti_problem(spec, T)
    tp = tl.make_lti_problem(tspec, T)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, T, N)).astype(np.float32)
    u = rng.standard_normal((3, T, M)).astype(np.float32)
    jd = jax.vmap(jp.make_derivs())(jnp.asarray(x), jnp.asarray(u))
    td = tp.make_derivs()(torch.from_numpy(x), torch.from_numpy(u))
    for name in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu"):
        a, b = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=name)
    for fn in ("dynamics", "cost"):
        a = getattr(tp, fn)(torch.from_numpy(x[:, 0]),
                            torch.from_numpy(u[:, 0]), 0).numpy()
        b = np.asarray(jax.vmap(lambda p, q: getattr(jp, fn)(p, q, 0))(
            jnp.asarray(x[:, 0]), jnp.asarray(u[:, 0])))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=fn)
    # use_autodiff=True: both packages differentiate the same functions;
    # the gradients' f32 sums may round differently, so rtol 1e-5
    ap = tl.make_lti_problem(tspec, T, use_autodiff=True)
    assert ap.derivs is None
    jd = jax.vmap(jl.make_lti_problem(spec, T, use_autodiff=True)
                  .make_derivs())(jnp.asarray(x), jnp.asarray(u))
    td = ap.make_derivs()(torch.from_numpy(x), torch.from_numpy(u))
    for name in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_broadcast_derivs_matches_jax():
    rng = np.random.default_rng(6)
    arrs = dict(fx=rng.standard_normal((3, 3)),
                fu=rng.standard_normal((T, 3, 2)), cx=rng.standard_normal(3),
                cu=rng.standard_normal((T, 2)), cxx=np.eye(3),
                cxu=np.zeros((3, 2)), cuu=np.eye(2),
                fxx=rng.standard_normal((3, 3, 3)))
    jd = jax_broadcast_derivs(T, **{k: jnp.asarray(v)
                                    for k, v in arrs.items()})
    td = broadcast_derivs(T, **{k: torch.from_numpy(v)
                                for k, v in arrs.items()})
    for name in td._fields:
        a, b = getattr(td, name), getattr(jd, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
        assert a.device.type == "cpu"
    with pytest.raises(ValueError, match="leading axis"):
        broadcast_derivs(T, **{**{k: torch.from_numpy(v)
                                  for k, v in arrs.items()},
                               "cu": torch.zeros((T + 1, 2))})


def test_lti_spec_from_jax_and_device_descriptor():
    spec = _spec(seed=7)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    for name in jl.LTISpec._fields:
        a = getattr(tspec, name)
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(spec, name)))
    for obj in (tl.lti_lanes(tspec), tl.lti_derivs_tiles(tspec)):
        dm = obj.device
        assert dm.model_id == 2 and dm.consts.dtype == np.float32
        assert dm.consts.size == 2 * N * N + N * M + M * M == 224
        np.testing.assert_array_equal(dm.consts, np.concatenate(
            [np.asarray(getattr(spec, k)).ravel() for k in "ABQR"]))


def test_random_lti_construction():
    spec = tl.random_lti(3, n=N, m=M, T=T, device="cpu")
    A = spec.A.double()
    assert spec.A.dtype == torch.float32
    assert spec.u0.shape == (T, M) and spec.B.shape == (N, M)
    # A = expm(h(M - Mᵀ)) is orthogonal
    torch.testing.assert_close(A @ A.T, torch.eye(N, dtype=torch.float64),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(spec.Q, 0.01 * torch.eye(N))
    torch.testing.assert_close(spec.R, 0.001 * torch.eye(M))
    assert torch.equal(spec.x0, torch.ones(N))
    again = tl.random_lti(torch.Generator().manual_seed(3), n=N, m=M, T=T,
                          device="cpu")
    for a, b in zip(spec, again):
        assert torch.equal(a, b)
