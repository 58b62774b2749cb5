"""The port's autodiff derivatives against the JAX package's: the lane
tiles (``autodiff_derivs_tiles``) for the quadrotor and pendcart, the AD
pendcart tiles against the port's analytic ones, ``make_autodiff_derivs``
behind the Problems of all three models in f64, the pendcart fleet solve
with AD tiles against JAX (``tests/test_autodiff_tiles.py:74-90``), and
what stays out of this slice.

Inputs are made in numpy f64 from a seeded Generator and cast for both
packages; the JAX kernels run in interpret mode, as its own tests run them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.models import quadrotor as jq
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_autodiff_tiles)
from differentialdynamicprogramming_jl_tpu.problem import (
    make_autodiff_derivs as jax_make_autodiff_derivs)
from differentialdynamicprogramming_jl_tpu_torch import (
    Problem, autodiff_derivs_tiles, convert, make_autodiff_derivs)
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    autodiff_tiles as tat, backward_kernel as bk)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import LanesModel
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.lower import (
    LOWERED_ID)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

KEYS = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")
MODELS = {
    "quadrotor": (lambda: jq.quadrotor_lanes(jq.QuadrotorSpec()),
                  lambda: tq.quadrotor_lanes(tq.QuadrotorSpec()), 2.45),
    "pendcart": (lambda: jpc.pendcart_lanes(jpc.PendCartSpec()),
                 lambda: tpc.pendcart_lanes(tpc.PendCartSpec()), 0.0),
}


def _inputs(n, m, u_mid, seed=0, size=256):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((n, size))).astype(np.float32)
    u = (u_mid + 3.0 * rng.standard_normal((m, size))).astype(np.float32)
    return x, u


def _leaves(d):
    return np.stack([np.asarray(v) for v in _pytree.tree_leaves(d)])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_autodiff_tiles_match_jax(name):
    """Per key, f32 on both sides. The tangent programs form the same
    products in the same order; XLA on the CPU may contract a multiply-add
    and its sin/cos may differ from PyTorch's by an ulp, so rtol 1e-5,
    atol 1e-6 (measured: the cost terms equal, fx/fu within 3e-8)."""
    jm, tm, u_mid = (f() if callable(f) else f for f in MODELS[name])
    x, u = _inputs(tm.n, tm.m, u_mid)
    jd = jax_autodiff_tiles(jm)([jnp.asarray(v) for v in x],
                                [jnp.asarray(v) for v in u], 3)
    td = autodiff_derivs_tiles(tm)([torch.from_numpy(v) for v in x],
                                   [torch.from_numpy(v) for v in u], 3)
    assert set(td) == set(jd) == set(KEYS)
    for key in KEYS:
        a = _leaves(td[key])
        b = np.stack([np.broadcast_to(np.asarray(v), a.shape[1:])
                      for v in jax.tree_util.tree_leaves(jd[key])])
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=key)


def test_autodiff_pendcart_tiles_match_analytic():
    """The AD expansion of pendcart against the port's hand-written one,
    at the JAX test's tolerance (``tests/test_autodiff_tiles.py:41-58``)."""
    spec = tpc.PendCartSpec()
    x, u = _inputs(4, 1, 0.0, seed=1)
    tx, tu = [torch.from_numpy(v) for v in x], [torch.from_numpy(u[0])]
    ad = autodiff_derivs_tiles(tpc.pendcart_lanes(spec))(tx, tu, 0)
    an = tpc.pendcart_derivs_tiles(spec)(tx, tu, 0)
    for key in KEYS:
        a = _leaves(ad[key])
        b = np.stack([np.broadcast_to(v.numpy(), a.shape[1:])
                      for v in _pytree.tree_leaves(an[key])])
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=key)


def test_autodiff_tiles_descriptor_and_cache():
    """The AD tiles carry the model's descriptor marked autodiff, one
    function object per model; a model without a descriptor gets a lowered
    one (ops/hopper/lower.py), which names the model and is lowered only at
    a launch on the card."""
    tm = tq.quadrotor_lanes(tq.QuadrotorSpec())
    tiles = autodiff_derivs_tiles(tm)
    assert tiles is autodiff_derivs_tiles(tm, second_order=False)
    assert tiles.device.autodiff and not tm.device.autodiff
    assert tiles.device.model_id == 3
    np.testing.assert_array_equal(tiles.device.consts, tm.device.consts)
    bare = LanesModel(n=tm.n, m=tm.m, dynamics=tm.dynamics, cost=tm.cost)
    low = autodiff_derivs_tiles(bare).device
    assert low.lanes is bare and low.autodiff and not low.second_order
    assert low.model_id == LOWERED_ID and low.consts.size == 0
    assert not tpc.pendcart_derivs_tiles(tpc.PendCartSpec()).device.autodiff


def test_autodiff_out_of_slice_raises():
    tm = tq.quadrotor_lanes(tq.QuadrotorSpec())
    # second-order tiles and the packed generator are ported: they build,
    # marked for K1's second-order instance; tiles of a model with
    # per-scenario parameters take them (test_torch_lowered_models.py
    # holds them against JAX), while the packed stream, which carries no
    # params into K1, still refuses such a model
    so = autodiff_derivs_tiles(tm, second_order=True)
    assert so.device.autodiff and so.device.second_order
    assert so is not autodiff_derivs_tiles(tm)
    assert callable(tat.autodiff_packed_derivs(tm))
    tpm = tpc.pendcart_lanes_param(tpc.PendCartSpec())
    assert autodiff_derivs_tiles(tpm).n_params == 2
    with pytest.raises(NotImplementedError, match="params"):
        tat.autodiff_packed_derivs(tpm)
    # the generic tier's full-DDP derivatives and the zoh scheme are ported
    tp = tq.make_quadrotor_problem(tq.QuadrotorSpec(), device="cpu")
    d = make_autodiff_derivs(tp.dynamics, tp.cost, second_order=True)(
        torch.zeros(1, 3, tm.n), torch.ones(1, 3, tm.m))
    assert d.fxx.shape == (1, 3, tm.n, tm.n, tm.n)
    assert d.fuu.shape == (1, 3, tm.n, tm.m, tm.m)
    assert tpc.make_pendcart_problem(derivs="zoh",
                                     device="cpu").derivs is not None


@pytest.mark.parametrize("emit,gps", [("gains", False), ("full", False),
                                      ("policy", False), ("gains", True)])
def test_backward_lanes_without_instance_raises_off_cpu(emit, gps):
    """On tensors off the CPU (here the meta device, which needs no card)
    K1 runs a built instance or raises NotImplementedError naming what is
    missing, before it touches the kernel library. The autodiff instances
    of the LTI (with its descriptor), the quadrotor and the pendcart run
    "gains" and "full" without GPS mode: those reach the launch, which
    refuses meta tensors. None has "policy" emission without GPS mode, nor
    "gains" in it: those raise. Nothing falls back to the plain version, to
    analytic derivatives or to a lowering."""
    spec = tl.random_lti(0, n=10, m=2, T=8, device="cpu")
    Tt, Bb = 8, 4
    cases = [(autodiff_derivs_tiles(tl.lti_lanes(spec)), 10, 2),
             (autodiff_derivs_tiles(tq.quadrotor_lanes()), 6, 2),
             (autodiff_derivs_tiles(tpc.pendcart_lanes()), 4, 1)]
    built = emit in ("gains", "full") and not gps
    for tiles, n_, m_ in cases:
        traj = torch.zeros((Tt, n_ + m_ + 1, Bb), device="meta")
        kw = dict(prev=torch.zeros((Tt, m_ + m_ * n_ + m_ * m_, Bb),
                                   device="meta"),
                  eta=torch.ones((Tt, Bb), device="meta")) if gps else {}
        with pytest.raises(
                ValueError if built else NotImplementedError,
                match=("no kernel for tensors on meta" if built
                       else "no CUDA kernel.*autodiff")):
            bk.backward_lanes(traj, torch.zeros(Bb, device="meta"), n=n_,
                              m=m_, reg_type=2, lims=None,
                              derivs_tiles=tiles, emit=emit, **kw)
    assert bk.CUDA_BACKWARD[2, 10, 2, True, False] == ("gains", "full")
    assert bk.CUDA_BACKWARD[3, 6, 2, True, True] == ("full", "policy")
    assert (3, 6, 2, False, False) not in bk.CUDA_BACKWARD


def _derivs_pair(name):
    """(port Problem, JAX Problem, n, m, u scale) in f64 for each model
    whose derivatives come from autodiff."""
    if name == "quadrotor":
        return (tq.make_quadrotor_problem(dtype=torch.float64, device="cpu"),
                jq.make_quadrotor_problem(dtype=jnp.float64), 6, 2)
    if name == "pendcart":
        return (tpc.make_pendcart_problem(derivs="autodiff",
                                          dtype=torch.float64, device="cpu"),
                jpc.make_pendcart_problem(derivs="autodiff",
                                          dtype=jnp.float64), 4, 1)
    rng = np.random.default_rng(3)
    M = rng.standard_normal((5, 5))
    jspec = jl.LTISpec(A=jnp.asarray(np.eye(5) + 0.1 * (M - M.T)),
                       B=jnp.asarray(0.2 * rng.standard_normal((5, 2))),
                       Q=jnp.asarray(np.diag(rng.uniform(0.5, 2.0, 5))),
                       R=jnp.asarray(0.1 * np.eye(2)),
                       x0=jnp.ones((5,)), u0=jnp.zeros((6, 2)))
    return (tl.make_lti_problem(convert.lti_spec_from_jax(
                jspec, dtype=torch.float64, device="cpu"), 6,
                use_autodiff=True),
            jl.make_lti_problem(jspec, 6, use_autodiff=True), 5, 2)


@pytest.mark.parametrize("name", ["quadrotor", "pendcart", "lti"])
def test_make_autodiff_derivs_matches_jax_f64(name):
    """Problem.make_derivs with derivs=None against the JAX package's, on
    a batch of f64 trajectories with a T+1-row state (the last row
    unused)."""
    tp, jp, n, m = _derivs_pair(name)
    assert tp.derivs is None and jp.derivs is None
    rng = np.random.default_rng(4)
    T = 6
    x = rng.standard_normal((3, T + 1, n))
    u = rng.standard_normal((3, T, m))
    td = tp.make_derivs()(torch.from_numpy(x), torch.from_numpy(u))
    jd = jax.vmap(jp.make_derivs())(jnp.asarray(x), jnp.asarray(u))
    for key in KEYS:
        a, b = getattr(td, key).numpy(), np.asarray(getattr(jd, key))
        assert a.shape == b.shape == (3, T) + a.shape[2:], key
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14,
                                   err_msg=key)
    # one trajectory without a batch axis gives the same rows
    one = tp.make_derivs()(torch.from_numpy(x[1]), torch.from_numpy(u[1]))
    for key in KEYS:
        np.testing.assert_allclose(getattr(one, key).numpy(),
                                   getattr(td, key)[1].numpy(), rtol=1e-15,
                                   atol=0, err_msg=key)


def test_autodiff_problem_matches_analytic_derivs():
    """The port's autodiff Problems against their own analytic ones: the
    pendcart Euler Jacobians and the LTI (A, B, Q, R), f64."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 7, 4)))
    u = torch.from_numpy(rng.standard_normal((2, 6, 1)))
    kw = dict(dtype=torch.float64, device="cpu")
    ad = tpc.make_pendcart_problem(derivs="autodiff", **kw).make_derivs()(x, u)
    an = tpc.make_pendcart_problem(derivs="euler", **kw).make_derivs()(x, u)
    for key in KEYS:
        torch.testing.assert_close(getattr(ad, key), getattr(an, key),
                                   rtol=1e-12, atol=1e-14)
    spec = tl.random_lti(1, n=4, m=2, T=6, dtype=torch.float64, device="cpu")
    x = torch.from_numpy(rng.standard_normal((6, 4)))
    u = torch.from_numpy(rng.standard_normal((6, 2)))
    ad = tl.make_lti_problem(spec, 6, use_autodiff=True).make_derivs()(x, u)
    an = tl.make_lti_problem(spec, 6).make_derivs()(x, u)
    for key in KEYS:
        torch.testing.assert_close(getattr(ad, key), getattr(an, key),
                                   rtol=1e-12, atol=1e-14)
    # a bare Problem gets the same autodiff
    bare = Problem(dynamics=tl.make_lti_problem(spec, 6).dynamics,
                   cost=tl.make_lti_problem(spec, 6).cost)
    torch.testing.assert_close(bare.make_derivs()(x, u).cxx, an.cxx)


@pytest.fixture(scope="module")
def pendcart_solved():
    """The pendcart fleet with AD tiles in both packages, the analytic
    tiles in the port (JAX ``tests/test_autodiff_tiles.py:74-90``:
    B=8, T=9, ±5, a 4-α ladder, max_iter 3, k_t 3)."""
    spec = jpc.PendCartSpec()
    B, T = 8, 9
    rng = np.random.default_rng(0)
    x0s = (np.asarray(jpc.default_x0(jnp.float64))[None, :]
           + 0.1 * rng.standard_normal((B, 4)) * np.array([1, 0, 0, 0])
           ).astype(np.float32)
    u0s = (0.2 * rng.standard_normal((B, T, 1))).astype(np.float32)
    jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 4), reg_type=2,
                        lam_max=1e15, max_iter=3)
    lims = ((-5.0, 5.0),)
    jm = jpc.pendcart_lanes(spec)
    ref = J.ilqg_batch_lanes(jm, None, jnp.asarray(x0s), jnp.asarray(u0s),
                             lims=lims, cfg=jcfg,
                             derivs_tiles=jax_autodiff_tiles(jm),
                             kt_backward=3, kt_forward=3, interpret=True)
    tspec = convert.spec_from_jax(spec)
    tm = tpc.pendcart_lanes(tspec)
    kw = dict(lims=lims, cfg=convert.config_from_jax(jcfg))
    x0t, u0t = torch.from_numpy(x0s), torch.from_numpy(u0s)
    ad = ilqg_batch_lanes(tm, None, x0t, u0t,
                          derivs_tiles=autodiff_derivs_tiles(tm), **kw)
    an = ilqg_batch_lanes(tm, None, x0t, u0t,
                          derivs_tiles=tpc.pendcart_derivs_tiles(tspec), **kw)
    return tuple(convert.result_to_numpy(r) for r in (ref, ad, an))


def test_pendcart_autodiff_solve_matches_jax(pendcart_solved):
    ref, ad, _ = pendcart_solved
    np.testing.assert_allclose(ad["cost_total"], ref["cost_total"],
                               rtol=1e-4, atol=1e-4)
    for name in ("reason", "n_accepted"):
        np.testing.assert_array_equal(ad[name], ref[name], err_msg=name)
    np.testing.assert_allclose(ad["Vx"], ref["Vx"], rtol=5e-3, atol=5e-3)


def test_pendcart_autodiff_solve_matches_analytic(pendcart_solved):
    """The same solve in the port with the analytic tiles: the expansions
    differ in the last bits (2·(Q/2)·dx against Q·dx), the outcomes not."""
    _, ad, an = pendcart_solved
    np.testing.assert_allclose(ad["cost_total"], an["cost_total"],
                               rtol=1e-4, atol=1e-4)
    for name in ("reason", "n_accepted"):
        np.testing.assert_array_equal(ad[name], an[name], err_msg=name)
    np.testing.assert_allclose(ad["Vx"], an["Vx"], rtol=5e-3, atol=5e-3)
