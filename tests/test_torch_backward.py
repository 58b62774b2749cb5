"""K1, the backward pass: the port's plain version against the JAX Pallas
kernel in interpret mode, with in-kernel pendcart derivatives.

Inputs are made once in numpy f64 with a seeded Generator and cast to f32;
the JAX side gets them in its lane layout (``convert.stream_to_lanes``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel import (
    backward_lanes as jax_backward_lanes)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
    import OutLayout, backward_lanes, backward_lanes_ref

B, T = 8, 13
LIMS = ((-5.0, 5.0),)
# limits that exclude u=0: the unconstrained optimum sits near 0 at these
# states, so these make the clamp and the KKT free mask bind on many steps
LIMS_BIND = ((0.5, 5.0),)


def _stream(seed=0):
    """(T, 6, B) [x, u, c] stream around the swing-up, with controls large
    enough that the ±5 limits bind on some steps."""
    rng = np.random.default_rng(seed)
    x = (np.array([np.pi - 0.6, 0.0, 0.0, 0.0])[None, :, None]
         + np.array([0.5, 1.0, 0.3, 0.5])[None, :, None]
         * rng.standard_normal((T, 4, B)))
    u = rng.uniform(-6.0, 6.0, (T, 1, B))
    c = np.zeros((T, 1, B))
    return np.concatenate([x, u, c], axis=1).astype(np.float32)


def _prev_stream(seed=2):
    """(T, 6, B) previous-policy stream [k, K(4), Σ⁻¹] with Σ⁻¹ > 0, and a
    per-step dual η (T, B) with some zeros, which count as 1. η stays ≥ 0.5:
    V grows by ~1/η per step, and at η ≈ 0.04 it reaches 1e14 within these
    13 steps, where the two packages' f32 roundings part by percents."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((T, 1, B))
    K = 0.5 * rng.standard_normal((T, 4, B))
    si = rng.uniform(0.5, 2.0, (T, 1, B))
    eta = 10.0 ** rng.uniform(-0.3, 1, (T, B))
    eta[::4, ::3] = 0.0
    return (np.concatenate([k, K, si], axis=1).astype(np.float32),
            eta.astype(np.float32))


def _both(spec, stream, lam, reg_type, emit, lims=LIMS, prev=None,
          eta=None):
    gps = {}
    if prev is not None:
        gps = dict(prev=jnp.asarray(convert.stream_to_lanes(prev)),
                   eta=jnp.asarray(convert.stream_to_lanes(eta[:, None])))
    ref = jax_backward_lanes(
        jnp.asarray(convert.stream_to_lanes(stream)),
        jnp.asarray(convert.stream_to_lanes(lam)), n=4, m=1,
        reg_type=reg_type, lims=lims, k_t=4,
        derivs_tiles=jpc.pendcart_derivs_tiles(spec), emit=emit,
        interpret=True, **gps)
    tspec = convert.spec_from_jax(spec)
    out = backward_lanes(torch.from_numpy(stream), torch.from_numpy(lam),
                         n=4, m=1, reg_type=reg_type, lims=lims,
                         derivs_tiles=tpc.pendcart_derivs_tiles(tspec),
                         emit=emit,
                         **{k: torch.from_numpy(v) for k, v in
                            (("prev", prev), ("eta", eta)) if v is not None})
    return (convert.stream_from_lanes(ref.out, B),
            convert.stream_from_lanes(ref.stats, B),
            out.out.numpy(), out.stats.numpy())


def _check(ro, rs, oo, os_):
    assert oo.shape == ro.shape
    np.testing.assert_allclose(oo, ro, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(os_[2:], rs[2:])
    np.testing.assert_allclose(os_[:2], rs[:2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("emit", ["gains", "full"])
def test_backward_matches_jax(reg_type, emit):
    stream = _stream()
    lam = np.linspace(0.0, 2.0, B).astype(np.float32)
    ro, rs, oo, os_ = _both(jpc.PendCartSpec(), stream, lam, reg_type, emit,
                            LIMS_BIND)
    assert oo.shape == (T, OutLayout(4, 1, emit).S, B) == ro.shape
    _check(ro, rs, oo, os_)
    # the limits bind: some k sits on the lower bound relative to u_t, and
    # some K is zeroed by the free mask there
    u_new = stream[:-1, 4] + oo[:-1, 0]
    on_lo = np.isclose(u_new, 0.5, atol=1e-5)
    assert on_lo.any()
    assert np.any(on_lo & np.all(oo[:-1, 1:5] == 0.0, axis=1))


def test_backward_latch_matches_jax():
    """A concave control cost (R=-1) with λ=0 makes Quu non-PD: the latch
    must give identical diverged/diverge_idx, and the recursion goes on with
    zeroed gains (JAX backward_kernel.py:570-572, :605-612)."""
    stream = _stream(seed=1)
    lam = np.zeros(B, np.float32)
    ro, rs, oo, os_ = _both(jpc.PendCartSpec(R=-1.0), stream, lam, 1, "full")
    np.testing.assert_array_equal(os_[2:], rs[2:])
    assert np.all(os_[2] == 1.0)
    np.testing.assert_array_equal(oo[:, :5], ro[:, :5])
    np.testing.assert_allclose(oo, ro, rtol=1e-5, atol=1e-5)


def test_backward_wrapper_is_the_plain_version_on_cpu():
    stream = torch.from_numpy(_stream())
    lam = torch.ones(B)
    tiles = tpc.pendcart_derivs_tiles(tpc.PendCartSpec())
    before = backward_lanes.launches
    a = backward_lanes(stream, lam, n=4, m=1, reg_type=2, lims=LIMS,
                       derivs_tiles=tiles, emit="gains")
    b = backward_lanes_ref(stream, lam, n=4, m=1, reg_type=2, lims=LIMS,
                           derivs_tiles=tiles, emit="gains")
    assert backward_lanes.launches == before
    torch.testing.assert_close(a.out, b.out, rtol=0, atol=0)
    # the gains stream is the k/K prefix of the full stream, bit for bit
    full = backward_lanes_ref(stream, lam, n=4, m=1, reg_type=2, lims=LIMS,
                              derivs_tiles=tiles, emit="full")
    torch.testing.assert_close(a.out, full.out[:, :5], rtol=0, atol=0)
    torch.testing.assert_close(a.stats, full.stats, rtol=0, atol=0)


@pytest.mark.parametrize("eta_kind", ["scalar", "per_step"])
@pytest.mark.parametrize("lims", [None, LIMS])
@pytest.mark.parametrize("emit", ["policy", "full"])
def test_backward_gps_matches_jax(eta_kind, lims, emit):
    """GPS mode (JAX backward_kernel.py:370-392, :418-429, :483-497): Q terms
    scaled by 1/η plus the KL expansion of the previous policy, λ unused,
    with and without limits, in policy and full emission."""
    stream = _stream(seed=3)
    prev, eta = _prev_stream()
    if eta_kind == "scalar":
        eta = np.broadcast_to(eta[:1], (T, B)).copy()
    lam = np.linspace(0.0, 2.0, B).astype(np.float32)   # ignored by GPS
    ro, rs, oo, os_ = _both(jpc.PendCartSpec(), stream, lam, 1, emit, lims,
                            prev, eta)
    assert oo.shape[1] == OutLayout(4, 1, emit).S
    _check(ro, rs, oo, os_)


@pytest.mark.parametrize("reg_type", [1, 2])
def test_backward_unconstrained_matches_jax(reg_type):
    """lims=None: the unrolled-Cholesky solve k = ((-Qu)/L)/L (JAX
    :514-522), zeroed on non-PD steps; with a concave R, the lanes of
    small λ latch."""
    stream = _stream(seed=4)
    lam = np.geomspace(1e-3, 1e4, B).astype(np.float32)
    ro, rs, oo, os_ = _both(jpc.PendCartSpec(R=-0.05), stream, lam,
                            reg_type, "full", None)
    _check(ro, rs, oo, os_)
    assert 0 < rs[2].sum() < B


@pytest.mark.parametrize("kwargs,option,exc", [
    # the packed-derivatives input is ported: a stream of the wrong slot
    # count (a trajectory where D+m = 47 slots are due) is refused
    (dict(derivs_tiles=None), "packed-derivatives", ValueError),
    (dict(prev=torch.zeros((T, 6, B))), "both prev and eta", ValueError),
    (dict(prev=torch.zeros((T, 5, B)), eta=torch.ones((T, B))), "prev",
     ValueError),
])
def test_backward_out_of_slice_options_raise(kwargs, option, exc):
    call = dict(n=4, m=1, reg_type=2, lims=LIMS,
                derivs_tiles=tpc.pendcart_derivs_tiles(tpc.PendCartSpec()))
    call.update(kwargs)
    with pytest.raises(exc, match=option):
        backward_lanes(torch.from_numpy(_stream()), torch.ones(B), **call)
