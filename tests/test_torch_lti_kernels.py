"""K1, K3 and K2 on the LTI model at m=2: the port's plain versions against
the JAX Pallas kernels in interpret mode, at n=4, m=2, B=8, T=7.

K1 runs the m=2 paths: the exact 9-active-set box QP with its K rows
(limits), and the unrolled 2×2 Cholesky solve (no limits). Inputs are made
once in numpy f64 with a seeded Generator and cast to f32; the JAX side
gets them in its lane layout (``convert.stream_to_lanes``). The JAX kernels
run with k_t=2.

Tolerance: rtol 1e-5, atol 1e-6 on every output slot (k, K, Vx, Vxx, Quu,
Quu⁻¹ and dV), exact on diverged/diverge_idx and on the line search's
decisions; XLA on the host contracts some products into multiply-adds, so
the two differ in the last bits (measured ≤2e-7 of each output's scale).
With limits, one more difference is allowed on at most 1% of the elements:
where one control is clamped, the clipped unconstrained candidate and the
one-face candidate of the enumeration lie Δk apart with objective values
only a·Δk²/2 apart, below the f32 resolution of the objective. An ulp then
decides which one is taken, in JAX as in the port, and k moves by up to
Δk ≈ sqrt(2·ulp(v)/a), ~5e-5 here (measured); the Vx and dV that carry k
move with it. Those elements are held to 1e-3 of their slot's largest
magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel import (
    backward_lanes as jax_backward_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    forward_lanes as jax_forward_lanes, linesearch_lanes as jax_linesearch)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
    import OutLayout, backward_lanes, backward_lanes_ref
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import forward_lanes, forward_lanes_ref, linesearch_lanes
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    default_alphas)

N, M, B, T = 4, 2, 8, 7
# asymmetric per control, tight enough that each control's limit binds
LIMS_ASYM = ((-0.05, 0.05), (-0.02, 0.08))
ALPHAS = default_alphas(0.2, -3.0, 4)


def _spec(R=0.05, seed=0):
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((N, N))
    f = jnp.float32
    return jl.LTISpec(A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), f),
                      B=jnp.asarray(0.3 * rng.standard_normal((N, M)), f),
                      Q=jnp.asarray(0.5 * np.eye(N), f),
                      R=jnp.asarray(R * np.eye(M), f), x0=jnp.ones((N,), f),
                      u0=jnp.zeros((T, M), f))


def _stream(seed=1):
    """(T, n+m+1, B) [x, u, c] stream."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((T, N, B)),
                           0.1 * rng.standard_normal((T, M, B)),
                           np.zeros((T, 1, B))], axis=1).astype(np.float32)


def _lanes(a):
    return jnp.asarray(convert.stream_to_lanes(a))


def _tspec(spec):
    return convert.lti_spec_from_jax(spec, device="cpu")


def _backward_both(spec, stream, lam, reg_type, emit, lims):
    ref = jax_backward_lanes(
        _lanes(stream), _lanes(lam), n=N, m=M, reg_type=reg_type, lims=lims,
        k_t=2, derivs_tiles=jl.lti_derivs_tiles(spec), emit=emit,
        interpret=True)
    out = backward_lanes(torch.from_numpy(stream), torch.from_numpy(lam),
                         n=N, m=M, reg_type=reg_type, lims=lims,
                         derivs_tiles=tl.lti_derivs_tiles(_tspec(spec)),
                         emit=emit)
    return (convert.stream_from_lanes(ref.out, B),
            convert.stream_from_lanes(ref.stats, B), out.out.numpy(),
            out.stats.numpy())


def _close(a, b, near_tie, rtol=1e-5):
    if not near_tie:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6)
        return
    scale = np.abs(b).max(axis=(0, -1) if a.ndim == 3 else -1,
                          keepdims=True)
    assert np.all(np.abs(a - b) <= rtol * np.abs(b) + 1e-3 * scale)


def _check(ro, rs, oo, os_, near_tie=False, rtol=1e-5):
    assert oo.shape == ro.shape
    if near_tie:
        assert np.isclose(oo, ro, rtol=rtol, atol=1e-6).mean() >= 0.99
    _close(oo, ro, near_tie, rtol)
    np.testing.assert_array_equal(os_[2:], rs[2:])
    _close(os_[:2], rs[:2], near_tie, rtol)


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("emit", ["gains", "full"])
@pytest.mark.parametrize("lims", [LIMS_ASYM, None])
def test_backward_m2_matches_jax(reg_type, emit, lims):
    stream = _stream()
    lam = np.linspace(0.0, 2.0, B).astype(np.float32)
    ro, rs, oo, os_ = _backward_both(_spec(), stream, lam, reg_type, emit,
                                     lims)
    assert oo.shape == (T, OutLayout(N, M, emit).S, B)
    _check(ro, rs, oo, os_, near_tie=lims is not None)
    if lims is not None:
        # k on a limit of control 0, of control 1, and of both at once:
        # the enumeration's edge and corner candidates are exercised
        k, u = oo[:-1, :M], stream[:-1, N:N + M]
        lo = np.float32([lo for lo, _ in lims])[None, :, None]
        hi = np.float32([hi for _, hi in lims])[None, :, None]
        on = (k == lo - u) | (k == hi - u)
        assert on[:, 0].any() and on[:, 1].any()
        assert (on[:, 0] & on[:, 1]).any()
        assert (on[:, 0] ^ on[:, 1]).any()


@pytest.mark.parametrize("lims", [None, LIMS_ASYM])
def test_backward_m2_latch_matches_jax(lims):
    """R negative definite with λ from 1e-3 to 1e4: the lanes whose
    λ·BᵀB cannot lift Quu latch (no limits); with limits, a lane whose two
    controls are clamped stays OK whatever QuuF is (JAX
    backward_kernel.py:231-234). Where Quu = R + Bᵀ·Vxx·B nears 0, the
    solve amplifies an ulp of its terms: rtol 1e-4 (measured 3e-5). Quu⁻¹
    is not compared: on these steps an ulp decides the sign of Quu and
    with it whether the 1e-30 pivot guard returns 1e30."""
    lam = np.geomspace(1e-3, 1e4, B).astype(np.float32)
    ro, rs, oo, os_ = _backward_both(_spec(R=-0.05), _stream(seed=2), lam, 2,
                                     "full", lims)
    q = OutLayout(N, M, "full").quui
    _check(ro[:, :q], rs, oo[:, :q], os_, near_tie=lims is not None,
           rtol=1e-4)
    if lims is None:
        assert 0 < rs[2].sum() < B


def _rollout_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((N, B)).astype(np.float32)
    gains = np.concatenate(
        [0.3 * rng.standard_normal((T, M, B)),
         0.5 * rng.standard_normal((T, M * N, B))], axis=1).astype(np.float32)
    return x0, _stream(seed), gains


@pytest.mark.parametrize("A,emit,lims", [(4, False, LIMS_ASYM),
                                         (1, True, LIMS_ASYM),
                                         (1, True, None)])
def test_forward_m2_matches_jax(A, emit, lims):
    spec = _spec()
    x0, traj, gains = _rollout_inputs()
    alphas = np.broadcast_to(np.float32(ALPHAS[:A])[:, None], (A, B)).copy()
    ref = jax_forward_lanes(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(alphas),
        model=jl.lti_lanes(spec), lims=lims, gk=0, gK=M, emit_traj=emit,
        k_t=2, interpret=True)
    out = forward_lanes(*(torch.from_numpy(a) for a in
                          (traj, gains, x0, alphas)),
                        model=tl.lti_lanes(_tspec(spec)), lims=lims,
                        emit_traj=emit)
    np.testing.assert_allclose(out.totals.numpy(),
                               convert.stream_from_lanes(ref.totals, B),
                               rtol=1e-5, atol=1e-6)
    if emit:
        o = out.traj.numpy()
        np.testing.assert_allclose(o, convert.stream_from_lanes(ref.traj, B),
                                   rtol=1e-5, atol=1e-6)
        if lims is not None:
            u = o[:, N:N + M]
            assert np.all(u[:, 0] >= np.float32(-0.05))
            assert np.any(u[:, 1] == np.float32(0.08))


@pytest.mark.parametrize("rr_min", [0.0, 0.6])
def test_linesearch_m2_matches_jax(rr_min):
    spec = _spec()
    x0, _, _ = _rollout_inputs()
    tspec = _tspec(spec)
    tmodel = tl.lti_lanes(tspec)
    # a rolled-out stream and the backward pass's gains on it
    gains0 = np.concatenate([np.float32(0.1) * np.ones((T, M, B), np.float32),
                             np.zeros((T, M * N, B), np.float32)], axis=1)
    ro = forward_lanes(torch.zeros((T, N + M, B)), torch.from_numpy(gains0),
                       torch.from_numpy(x0), torch.ones((1, B)),
                       model=tmodel, lims=LIMS_ASYM, emit_traj=True)
    bo = backward_lanes(ro.traj, torch.ones(B), n=N, m=M, reg_type=2,
                        lims=LIMS_ASYM,
                        derivs_tiles=tl.lti_derivs_tiles(tspec),
                        emit="gains")
    traj, gains = ro.traj.numpy(), bo.out.numpy()
    allow = (np.arange(B) % 2 == 0).astype(np.float32)
    sel = np.stack([bo.stats[0].numpy(), bo.stats[1].numpy(),
                    ro.totals[0].numpy(), allow])
    ref = jax_linesearch(
        _lanes(traj), _lanes(gains), _lanes(x0), _lanes(sel),
        model=jl.lti_lanes(spec), alphas=ALPHAS, reduce_ratio_min=rr_min,
        lims=LIMS_ASYM, gk=0, gK=M, emit_echo=False, k_t=2, interpret=True)
    out = linesearch_lanes(*(torch.from_numpy(a) for a in
                             (traj, gains, x0, sel)),
                           model=tmodel, alphas=ALPHAS,
                           reduce_ratio_min=rr_min, lims=LIMS_ASYM)
    ls, rls = out.ls.numpy(), convert.stream_from_lanes(ref.ls, B)
    np.testing.assert_array_equal(ls[:2], rls[:2])
    np.testing.assert_allclose(ls[4], rls[4], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.traj.numpy(),
                               convert.stream_from_lanes(ref.traj, B),
                               rtol=1e-5, atol=1e-6)
    accepted = (ls[1] > 0.5) & (allow > 0.5)
    assert accepted.any() and not accepted.all()
    np.testing.assert_array_equal(out.traj.numpy()[..., ~accepted],
                                  traj[..., ~accepted])


def test_m3_and_gps_at_m2_raise():
    """m = 3 (the masked-Newton box QP), which used to raise here, now runs:
    on CPU tensors K1 and K3 return their plain versions' results, finite,
    with the box binding. K1's GPS mode at m = 2 runs likewise."""
    spec3 = tl.random_lti(0, n=N, m=3, T=T, device="cpu")
    rng = np.random.default_rng(5)
    traj = torch.tensor(np.concatenate(
        [rng.standard_normal((T, N, B)), 0.1 * rng.standard_normal((T, 3, B)),
         np.zeros((T, 1, B))], axis=1), dtype=torch.float32)
    kw3 = dict(n=N, m=3, reg_type=1, lims=((-0.05, 0.05),) * 3,
               derivs_tiles=tl.lti_derivs_tiles(spec3), emit="gains")
    out = backward_lanes(traj, torch.ones(B), **kw3)
    ref = backward_lanes_ref(traj, torch.ones(B), **kw3)
    assert torch.equal(out.out, ref.out) and torch.equal(out.stats, ref.stats)
    assert torch.isfinite(out.out).all()
    k, u = out.out[:-1, :3], traj[:-1, N:N + 3]
    assert ((k == -0.05 - u) | (k == 0.05 - u)).any()
    fkw = dict(model=tl.lti_lanes(spec3), lims=((-0.05, 0.05),) * 3,
               emit_traj=True)
    fo = forward_lanes(traj, out.out, traj[0, :N].contiguous(),
                       torch.ones((1, B)), **fkw)
    fr = forward_lanes_ref(traj, out.out, traj[0, :N].contiguous(),
                           torch.ones((1, B)), **fkw)
    assert torch.equal(fo.traj, fr.traj) and torch.equal(fo.totals, fr.totals)
    spec2 = _tspec(_spec())
    prev = torch.zeros((T, M + M * N + M * M, B))
    prev[:, M + M * N] = prev[:, M + M * N + 3] = 1.0          # Σ⁻¹ = I
    kw = dict(n=N, m=M, reg_type=1, lims=None,
              derivs_tiles=tl.lti_derivs_tiles(spec2), prev=prev,
              eta=torch.ones((T, B)), emit="policy")
    traj = torch.from_numpy(_stream())
    out = backward_lanes(traj, torch.ones(B), **kw)
    ref = backward_lanes_ref(traj, torch.ones(B), **kw)
    assert out.out.shape == (T, OutLayout(N, M, "policy").S, B)
    assert torch.equal(out.out, ref.out) and torch.equal(out.stats, ref.stats)
    assert torch.isfinite(out.out).all()
    with pytest.raises(ValueError, match="one \\(lo, hi\\) per control"):
        backward_lanes(torch.zeros((T, N + M + 1, B)), torch.ones(B), n=N,
                       m=M, reg_type=1, lims=((-1.0, 1.0),),
                       derivs_tiles=tl.lti_derivs_tiles(spec2))
