"""K1's packed-derivatives input: the port against the JAX package.

- ``pack_derivs`` and ``pack_backward_inputs``, bit for bit against JAX's
  lane stacks read back as streams (``convert.stream_from_lanes``);
- the packed generators ``pendcart_packed_derivs`` and ``lti_packed_derivs``
  (1e-6) and ``autodiff_packed_derivs`` (2e-5, PyTorch's forward-mode
  autodiff against JAX's);
- K1 on the packed stream (``backward_lanes(derivs_tiles=None)``, the plain
  version on CPU tensors) against JAX's ``backward_lanes`` in interpret mode
  at B=8, T=10, k_t=2: reg_type 1 and 2, with and without limits, m=1
  (pendcart) and m=2 (an LTI at n=4), "gains" (the k/K prefix of JAX's
  "full") and "full"; and packed against in-kernel tiles on one trajectory;
- ``backward_pass_pallas`` against JAX's: parity and the divergence latch
  (as ``tests/test_pallas_kernels.py:60-90``; GPS mode is in
  ``tests/test_torch_packed_fleet.py``);
- the life of the fleet driver's derivative stream, the unbuilt CUDA
  combinations (on the meta device, which needs no card), and the TPU
  keywords of the fleet entries.

Inputs are made once in numpy f64 with a seeded Generator and cast to f32.
The direct K1 calls and ``backward_pass_pallas`` pass JAX the same static
arguments, so they share its compiled programs (≈8 s each).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.models import quadrotor as jq
from differentialdynamicprogramming_jl_tpu.ops.pallas import (
    backward_kernel as jbk, pack as jpack)
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_packed_derivs as jax_autodiff_packed)
from differentialdynamicprogramming_jl_tpu.policy import (
    Derivs as JDerivs, GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
import differentialdynamicprogramming_jl_tpu_torch as P
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    backward_kernel as bk, pack)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_packed_derivs
from differentialdynamicprogramming_jl_tpu_torch.policy import Derivs
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes, ilqg_iteration_lanes, mpc_rollout_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)

B, T = 8, 10
LIMS = ((-5.0, 5.0),)
LIMS_BIND = ((0.5, 5.0),)          # excludes u=0: the clamp binds
LIMS_M2 = ((-0.05, 0.05), (-0.02, 0.08))
SPEC = jpc.PendCartSpec()
TSPEC = convert.spec_from_jax(SPEC)


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(a))


def _pend_stream(seed=0, Tn=T):
    """(T, 5, B) [x, u] around the swing-up, u wide enough that the limits
    bind."""
    rng = np.random.default_rng(seed)
    x = (np.array([np.pi - 0.6, 0.0, 0.0, 0.0])[None, :, None]
         + np.array([0.5, 1.0, 0.3, 0.5])[None, :, None]
         * rng.standard_normal((Tn, 4, B)))
    u = rng.uniform(-6.0, 6.0, (Tn, 1, B))
    return np.concatenate([x, u], axis=1).astype(np.float32)


def _lti_spec(n=4, m=2, seed=0):
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((n, n))
    f = jnp.float32
    return jl.LTISpec(A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), f),
                      B=jnp.asarray(0.3 * rng.standard_normal((n, m)), f),
                      Q=jnp.asarray(0.5 * np.eye(n), f),
                      R=jnp.asarray(0.05 * np.eye(m), f),
                      x0=jnp.ones((n,), f), u0=jnp.zeros((T, m), f))


def _lti_stream(n=4, m=2, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((T, n, B)),
                           0.1 * rng.standard_normal((T, m, B))],
                          axis=1).astype(np.float32)


def _random_derivs(rng, n, m):
    f = np.float32
    return dict(fx=rng.standard_normal((B, T, n, n)).astype(f),
                fu=rng.standard_normal((B, T, n, m)).astype(f),
                cx=rng.standard_normal((B, T, n)).astype(f),
                cu=rng.standard_normal((B, T, m)).astype(f),
                cxx=rng.standard_normal((B, T, n, n)).astype(f),
                cxu=rng.standard_normal((B, T, n, m)).astype(f),
                cuu=rng.standard_normal((B, T, m, m)).astype(f))


@pytest.mark.parametrize("what", ["pack_derivs", "pack_backward_inputs"])
def test_packing_is_bit_equal_to_jax(what):
    rng = np.random.default_rng(0)
    d = _random_derivs(rng, 4, 1)
    u = rng.standard_normal((B, T, 1)).astype(np.float32)
    jd = JDerivs(**{k: jnp.asarray(v) for k, v in d.items()})
    td = Derivs(**{k: torch.from_numpy(v) for k, v in d.items()})
    if what == "pack_derivs":
        ref, out = jpack.pack_derivs(jd, B), pack.pack_derivs(td, B)
    else:
        ref = jbk.pack_backward_inputs(jd, jnp.asarray(u), B)
        out = pack.pack_backward_inputs(td, torch.from_numpy(u), B)
        assert bk.pack_backward_inputs is pack.pack_backward_inputs
    ref = convert.stream_from_lanes(ref, B)
    assert out.shape == ref.shape == (T, 46 + (what != "pack_derivs"), B)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_packed_generators_match_jax():
    """pendcart ⟨4,1⟩ (47 slots) and LTI ⟨10,2⟩ (258 slots), 1e-6: the
    port forms -g/l and the like in f32 from its descriptor, JAX from
    Python floats; LTI's cx/cu sum from the first nonzero term, JAX's from
    0."""
    st = _pend_stream()
    ref = jpc.pendcart_packed_derivs(SPEC)(_lanes(st[:, :4]), _lanes(st[:, 4:]))
    out = tpc.pendcart_packed_derivs(TSPEC)(torch.from_numpy(st[:, :4]),
                                            torch.from_numpy(st[:, 4:]))
    assert out.shape == (T, 47, B)
    np.testing.assert_allclose(out.numpy(), convert.stream_from_lanes(ref, B),
                               rtol=1e-6, atol=1e-6)
    spec = _lti_spec(10, 2)
    st = _lti_stream(10, 2)
    ref = jl.lti_packed_derivs(spec)(_lanes(st[:, :10]), _lanes(st[:, 10:]))
    out = tl.lti_packed_derivs(convert.lti_spec_from_jax(spec, device="cpu"))(
        torch.from_numpy(st[:, :10]), torch.from_numpy(st[:, 10:]))
    assert out.shape == (T, 258, B)
    np.testing.assert_allclose(out.numpy(), convert.stream_from_lanes(ref, B),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["pendcart", "quadrotor"])
def test_autodiff_packed_derivs_matches_jax(name):
    if name == "pendcart":
        st, n, m = _pend_stream(Tn=4), 4, 1
        jm, tm = jpc.pendcart_lanes(SPEC), tpc.pendcart_lanes(TSPEC)
    else:
        rng = np.random.default_rng(2)
        st = np.concatenate([
            np.array([1.0, 0, 0, 0, 0.3, 0])[None, :, None]
            + 0.3 * rng.standard_normal((4, 6, B)),
            2.4525 + rng.standard_normal((4, 2, B))], 1).astype(np.float32)
        n, m = 6, 2
        jm = jq.quadrotor_lanes(jq.QuadrotorSpec())
        tm = tq.quadrotor_lanes(convert.quadrotor_spec_from_jax(
            jq.QuadrotorSpec()))
    ref = jax_autodiff_packed(jm)(_lanes(st[:, :n]), _lanes(st[:, n:]))
    gen = autodiff_packed_derivs(tm)
    assert gen is P.autodiff_packed_derivs(tm)
    out = gen(torch.from_numpy(st[:, :n]), torch.from_numpy(st[:, n:]))
    assert out.shape == (4, bk.InLayout(n, m).DU, B)
    np.testing.assert_allclose(out.numpy(), convert.stream_from_lanes(ref, B),
                               rtol=2e-5, atol=2e-5)


def _close(a, b, tol=1e-5, tie_tol=1e-3, share=0.0):
    """Each slot within tol of JAX (relative to the slot's largest value),
    except at most ``share`` of the elements within tie_tol: the m=2 box
    QP's near-ties (tests/test_torch_lti_kernels.py)."""
    d = np.abs(a.astype(np.float64) - b)
    scale = np.maximum(np.abs(b).max(axis=(0, 2), keepdims=True), 1e-30)
    r = d / scale
    assert (r > tol).mean() <= share, (r.max(), (r > tol).mean())
    assert r.max() <= tie_tol, r.max()


# (m, reg_type, lims): reg_type 1 and 2, with and without limits, at m=1
# (pendcart) and m=2 (LTI n=4, where the 9-set enumeration reads u from the
# packed slots); each case checks "gains" and "full". Three cases, not the
# eight of the product: each is one JAX compile of ≈8-13 s
CASES = {"m1-reg1-nolims": (1, 1, None), "m1-reg2-lims": (1, 2, LIMS_BIND),
         "m2-reg1-lims": (2, 1, LIMS_M2)}


def _packed_input(m):
    if m == 1:
        st = _pend_stream()
        return 4, tpc.pendcart_packed_derivs(TSPEC)(
            torch.from_numpy(st[:, :4]), torch.from_numpy(st[:, 4:])), st
    st = _lti_stream()
    spec = convert.lti_spec_from_jax(_lti_spec(), device="cpu")
    return 4, tl.lti_packed_derivs(spec)(torch.from_numpy(st[:, :4]),
                                         torch.from_numpy(st[:, 4:])), st


def _jax_packed(dp, lam, n, m, reg_type, lims):
    """JAX's K1 on the packed stream as backward_pass_pallas calls it, so
    that the two share a compiled program."""
    r = jbk.backward_lanes(_lanes(dp), _lanes(lam), n=n, m=m,
                           reg_type=reg_type, lims=lims, k_t=2, prev=None,
                           eta=None, interpret=True)
    return convert.stream_from_lanes(r.out, B), convert.stream_from_lanes(
        r.stats, B)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_packed_matches_jax(case):
    m, reg_type, lims = CASES[case]
    n, dp, _ = _packed_input(m)
    lam = np.linspace(0.0, 2.0, B).astype(np.float32)
    ro, rs = _jax_packed(dp.numpy(), lam, n, m, reg_type, lims)
    share = 0.01 if m == 2 and lims else 0.0
    for emit in ("gains", "full"):
        out = bk.backward_lanes(dp, torch.from_numpy(lam), n=n, m=m,
                                reg_type=reg_type, lims=lims, emit=emit)
        S = bk.OutLayout(n, m, emit).S
        assert out.out.shape == (T, S, B)
        _close(out.out.numpy(), ro[:, :S], share=share)
        np.testing.assert_array_equal(out.stats[2:].numpy(), rs[2:])
        _close(out.stats.numpy()[:2, None], rs[:2, None], share=share)
    if lims is not None:
        # the limits bind: some k sits on a bound relative to u_t
        k = out.out[:-1, :m].numpy()
        u = dp[:-1, bk.InLayout(n, m).u:].numpy()
        assert np.isclose(k + u, np.array([lo for lo, _ in lims])[:, None],
                          atol=1e-5).any() or np.isclose(
            k + u, np.array([hi for _, hi in lims])[:, None], atol=1e-5).any()


def test_backward_packed_matches_tiles():
    """One trajectory, the packed stream against in-kernel tiles (JAX
    tests/test_pallas_kernels.py:184, 1e-5): the generator stacks the tiles'
    own values, so the two agree."""
    n, dp, st = _packed_input(1)
    lam = torch.ones(B)
    kw = dict(n=4, m=1, reg_type=2, lims=LIMS, emit="full")
    a = bk.backward_lanes(dp, lam, **kw)
    b = bk.backward_lanes(torch.from_numpy(st), lam,
                          derivs_tiles=tpc.pendcart_derivs_tiles(TSPEC), **kw)
    torch.testing.assert_close(a.out, b.out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a.stats, b.stats, rtol=1e-5, atol=1e-5)


def _derivs_np(dp):
    """The packed stream's fields as batch-major derivatives (B, T, ...)."""
    lay = bk.InLayout(4, 1)
    a = np.transpose(dp, (2, 0, 1))
    cut = lambda off, size, shape: a[..., off:off + size].reshape(
        (B, T) + shape)
    return dict(fx=cut(lay.fx, 16, (4, 4)), fu=cut(lay.fu, 4, (4, 1)),
                cx=cut(lay.cx, 4, (4,)), cu=cut(lay.cu, 1, (1,)),
                cxx=cut(lay.cxx, 16, (4, 4)), cxu=cut(lay.cxu, 4, (4, 1)),
                cuu=cut(lay.cuu, 1, (1, 1))), cut(lay.u, 1, (1,))


def _pallas_both(d, u, lam, **kw):
    jkw = dict(kw)
    if "traj_prev" in kw:
        jkw["traj_prev"] = JPolicy(**{k: jnp.asarray(v)
                                      for k, v in kw["traj_prev"].items()})
        kw["traj_prev"] = convert.policy_from_jax(jkw["traj_prev"],
                                                  device="cpu")
        jkw["eta"] = jnp.asarray(kw["eta"])
        kw["eta"] = torch.from_numpy(kw["eta"])
    ref = jbk.backward_pass_pallas(
        JDerivs(**{k: jnp.asarray(v) for k, v in d.items()}), jnp.asarray(u),
        jnp.asarray(lam), k_t=2, interpret=True, **jkw)
    out = bk.backward_pass_pallas(
        Derivs(**{k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in d.items()}),
        torch.from_numpy(np.ascontiguousarray(u)), torch.from_numpy(lam),
        k_t=2, interpret=True, **kw)
    return convert.result_to_numpy(ref), convert.result_to_numpy(out)


def _cmp_pallas(ref, out, tol=1e-5):
    for name in ("Vx", "Vxx", "dV"):
        np.testing.assert_allclose(out[name], ref[name], rtol=tol, atol=tol,
                                   err_msg=name)
    for name in ("k", "K", "sigma", "sigma_inv"):
        np.testing.assert_allclose(out["policy"][name], ref["policy"][name],
                                   rtol=tol, atol=tol, err_msg=name)
    for name in ("diverged", "diverge_idx"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


@pytest.mark.parametrize("reg_type,use_limits", [(1, False), (2, True)])
def test_backward_pass_pallas_matches_jax(reg_type, use_limits):
    _, dp, _ = _packed_input(1)
    d, u = _derivs_np(dp.numpy())
    lam = np.ones(B, np.float32)
    lims = np.asarray(LIMS_BIND, np.float32) if use_limits else None
    ref, out = _pallas_both(d, u, lam, reg_type=reg_type, lims=lims,
                            use_limits=use_limits)
    assert out["policy"]["K"].shape == (B, T, 1, 4)
    _cmp_pallas(ref, out)


def test_backward_pass_pallas_latch_matches_jax():
    """A concave control cost (cuu < 0) with λ=0: every lane latches, at
    the same step in both (tests/test_pallas_kernels.py:75-90)."""
    _, dp, _ = _packed_input(1)
    d, u = _derivs_np(dp.numpy())
    d["cuu"] = -d["cuu"]
    ref, out = _pallas_both(d, u, np.zeros(B, np.float32), reg_type=1)
    np.testing.assert_array_equal(out["diverged"], ref["diverged"])
    np.testing.assert_array_equal(out["diverge_idx"], ref["diverge_idx"])
    assert out["diverged"].all()


def test_packed_stream_life_in_the_fleet_driver():
    """The generator runs once at init, once after each iteration in which
    some lane accepted (never for a λ-retry), and once for the final replay
    (JAX solvers/batch.py:380-381, :550-556, :590-592); the solve equals the
    in-kernel-tiles solve."""
    calls = []
    gen = tpc.pendcart_packed_derivs(TSPEC)

    def counted(x, u):
        calls.append(1)
        return gen(x, u)

    rng = np.random.default_rng(0)
    x0 = torch.tensor(np.array([np.pi - 0.6, 0, 0, 0])[None, :]
                      + 0.1 * rng.standard_normal((B, 4)),
                      dtype=torch.float32)
    u0 = torch.tensor(0.1 * rng.standard_normal((B, 6, 1)),
                      dtype=torch.float32)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=4, iter_cap=6, lam=1e-4, lam_min=1e-6)
    model = tpc.pendcart_lanes(TSPEC)
    r = ilqg_batch_lanes(model, counted, x0, u0, lims=LIMS, cfg=cfg,
                         record_trace=True)
    acc = r.trace.accepted.numpy()
    iters_with_accept = int((acc[:, 1:].max(axis=0) > 0.5).sum())
    assert 0 < iters_with_accept
    assert len(calls) == 1 + iters_with_accept + 1
    t = ilqg_batch_lanes(model, None, x0, u0, lims=LIMS, cfg=cfg,
                         derivs_tiles=tpc.pendcart_derivs_tiles(TSPEC))
    for name in ("cost_total", "reason", "n_accepted", "n_iters"):
        torch.testing.assert_close(getattr(r, name), getattr(t, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(r.policy.K, t.policy.K, rtol=0, atol=0)


@pytest.mark.parametrize("key,gps,emit", [
    ((6, 2), True, "full"), ((10, 2), True, "policy"), ((4, 1), False,
                                                       "policy"),
    ((4, 1), True, "gains")])
def test_packed_without_instance_raises_off_cpu(key, gps, emit):
    """On tensors off the CPU (here the meta device, which needs no card)
    a packed combination with no CUDA instance raises NotImplementedError
    naming the built ones, before it touches the kernel library."""
    n, m = key
    assert emit not in bk.CUDA_PACKED.get((n, m, gps), ())
    dp = torch.zeros((T, bk.InLayout(n, m).DU, B), device="meta")
    kw = dict(prev=torch.zeros((T, m + m * n + m * m, B), device="meta"),
              eta=torch.ones((T, B), device="meta")) if gps else {}
    with pytest.raises(NotImplementedError, match="packed-derivatives"):
        bk.backward_lanes(dp, torch.zeros(B, device="meta"), n=n, m=m,
                          reg_type=1, lims=None, emit=emit, **kw)


# the fleet entries' TPU keywords (JAX's names and defaults)
TPU_KEYWORDS = {"ilqg_batch_lanes": ("kt_backward", "kt_forward", "interpret"),
                "ilqg_iteration_lanes": ("kt_backward", "kt_forward",
                                         "interpret"),
                "mpc_rollout_lanes": ("kt_backward", "kt_forward",
                                      "interpret"),
                "ilqgkl_batch_lanes": ("kt", "interpret"),
                "gps_rollout_lanes": ("kt", "unroll", "interpret")}


@pytest.mark.parametrize("name", list(TPU_KEYWORDS))
def test_fleet_entries_take_jax_signatures(name):
    """Every parameter of the JAX entry is one of the port's, in JAX's order
    and kind; the TPU keywords have JAX's defaults."""
    jf = getattr(J, name, None) or getattr(jkl, name)
    tf = getattr(P, name, None) or getattr(tkl, name)
    jp = inspect.signature(jf).parameters
    tp = inspect.signature(tf).parameters
    assert list(jp) == [p for p in tp if p in jp], (list(jp), list(tp))
    for p in jp:
        assert tp[p].kind == jp[p].kind, p
    for p in TPU_KEYWORDS[name]:
        assert tp[p].default == jp[p].default, p


def _fleet_inputs():
    rng = np.random.default_rng(3)
    x0 = torch.tensor(np.array([np.pi - 0.6, 0, 0, 0])[None, :]
                      + 0.1 * rng.standard_normal((B, 4)),
                      dtype=torch.float32)
    u0 = torch.tensor(0.1 * rng.standard_normal((B, 6, 1)),
                      dtype=torch.float32)
    return x0, u0


def _same(a, b):
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("name", list(TPU_KEYWORDS))
def test_jax_style_call_equals_plain_call(name):
    """A call that passes the TPU keywords as JAX callers do gives the
    result of the same call without them."""
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=2, iter_cap=3)
    model, tiles = tpc.pendcart_lanes(TSPEC), tpc.pendcart_derivs_tiles(TSPEC)
    x0, u0 = _fleet_inputs()
    tpu = {k: v for k, v in dict(kt_backward=2, kt_forward=2, kt=4,
                                 unroll=1, interpret=True).items()
           if k in TPU_KEYWORDS[name]}
    if name == "ilqg_batch_lanes":
        def run(**kw):
            return ilqg_batch_lanes(model, None, x0, u0, lims=LIMS, cfg=cfg,
                                    derivs_tiles=tiles, **kw)
    elif name == "mpc_rollout_lanes":
        plant = tpc.make_pendcart_problem(TSPEC, "euler", device="cpu")

        def run(**kw):
            return mpc_rollout_lanes(
                model, None, x0, u0, lambda x, u: plant.dynamics(x, u, 0), 2,
                lims=LIMS, cfg=cfg, derivs_tiles=tiles, **kw)
    elif name == "ilqg_iteration_lanes":
        r = ilqg_batch_lanes(model, None, x0, u0, lims=LIMS, cfg=cfg,
                             derivs_tiles=tiles)
        st = torch.cat([pack.to_streams(r.x), pack.to_streams(r.u),
                        pack.to_streams(r.cost[..., None])], dim=1)

        def run(**kw):
            step = ilqg_iteration_lanes(model, None, LIMS, cfg,
                                        derivs_tiles=tiles, **kw)
            return step(st.clone(), r.cost_total, r.lam)
    else:
        from test_torch_kl import SPEC as KSPEC, kl_inputs
        inp = kl_inputs(B=B, T=4)
        kspec = convert.spec_from_jax(KSPEC)
        prev = convert.policy_from_jax(type("P", (), inp["policy"]),
                                       device="cpu")
        kcfg = tkl.ILQGKLConfig(kl_step=0.05, max_iter=2)
        km, kt = tpc.pendcart_lanes(kspec), tpc.pendcart_derivs_tiles(kspec)
        x, fx = torch.from_numpy(inp["x"]), torch.from_numpy(inp["fx"])
        c0 = torch.from_numpy(inp["cost0"])
        if name == "ilqgkl_batch_lanes":
            def run(**kw):
                return tkl.ilqgkl_batch_lanes(km, kt, x, prev, fx, c0,
                                              cfg=kcfg, **kw)
        else:
            def run(**kw):
                return tkl.gps_rollout_lanes(km, kt, x, prev, c0,
                                             lambda xx, uu: fx, 1, cfg=kcfg,
                                             **kw)
    _same(run(**tpu), run())


@pytest.mark.parametrize("key", sorted(bk.CUDA_PACKED))
@pytest.mark.parametrize("T_, B_", [(2, 1), (17, 37), (1000, 4096)])
def test_packed_plans_fit_and_cover(key, T_, B_):
    """The packed instances' launch plans: the ring stages the D+m slots
    (and GPS mode's) of K1_PACKED_BUDGET, within a block's shared memory,
    its chunks cover T and its blocks B."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    n, m, gps = key
    for emit in bk.CUDA_PACKED[key]:
        p = plan.backward_plan(n, m, gps, emit, T_, B_, packed=True)
        F = plan.k1_slots(n, m, gps, packed=True)
        assert F == bk.InLayout(n, m).DU + ((m + m * n + m * m + 1)
                                            if gps else 0)
        G = plan.k1_warps(n, emit, gps)
        extra = plan.RING_W * plan.k1_exchange(n, m) if G > 1 else 0
        assert p.smem == plan.ring_bytes(p.stages, p.tc, F, extra)
        assert p.smem <= plan.MAX_SMEM
        assert p.tc == 1 or p.smem <= plan.K1_PACKED_BUDGET
        assert p.chunks * p.tc >= T_ > (p.chunks - 1) * p.tc
        assert p.blocks * plan.RING_W >= B_ and p.threads == plan.RING_W * (
            G + 1)
