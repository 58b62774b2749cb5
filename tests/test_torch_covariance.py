"""K4, the covariance propagation: the port's plain version against the JAX
Pallas kernel in interpret mode.

fx streams are made once in numpy f64 with a seeded Generator and cast to
f32. Σ grows fast along an unstable linearisation (the pendcart's Euler fx
near θ≈π grows it ~1e10-fold over T=500), so each slot is held by its error
relative to that slot's largest magnitude over the horizon.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.ops.pallas.covariance_kernel \
    import covariance_lanes as jax_covariance_lanes
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper \
    .covariance_kernel import (covariance_lanes, covariance_lanes_ref,
                               identity_r1)

B, T, N = 8, 13, 4


def _fx(seed=0, n=N):
    """Pendcart-like linearisations I + h·A with an unstable θ row, plus
    noise, (T, n², B)."""
    rng = np.random.default_rng(seed)
    F = np.broadcast_to(np.eye(n), (T, B, n, n)).copy()
    F[..., 0, 1] = F[..., 2, 3] = 0.01
    F[..., 1, 0] = rng.uniform(-0.1, 0.3, (T, B))
    F[..., 1, 1] = 0.9901
    F += 0.05 * rng.standard_normal((T, B, n, n))
    return np.moveaxis(F.reshape(T, B, n * n), 1, 2).astype(np.float32)


def _spd_r1(seed=1, n=N):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    R = A @ A.T + 0.5 * np.eye(n)
    return tuple(tuple(float(np.float32(v)) for v in row) for row in R)


def _close_per_slot(out, ref, rtol):
    """|out - ref| ≤ rtol · (largest |ref| of the slot over t and B)."""
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    err = np.abs(out - ref) / scale
    assert np.isfinite(out).all() and err.max() <= rtol, err.max()


@pytest.mark.parametrize("r1, n", [(None, N), ("spd", N), ("spd", 6)])
def test_covariance_matches_jax(r1, n):
    """n=4 (pendcart) and n=6 (quadrotor), state sizes the kernel is built
    for beside LTI's n=10 (minutes to trace here). JAX traces one kernel per
    (n, R1), ≈12 s at n=6, so n=6 takes the SPD R1 alone."""
    fx = _fx(n=n)
    r1 = identity_r1(n) if r1 is None else _spd_r1(n=n)
    ref = convert.stream_from_lanes(jax_covariance_lanes(
        jnp.asarray(convert.stream_to_lanes(fx)), n=n, r1=r1, k_t=4,
        interpret=True), B)
    out = covariance_lanes(torch.from_numpy(fx), n=n, r1=r1).numpy()
    assert out.shape == (T, n * n, B)
    np.testing.assert_array_equal(out[0], np.float32(r1).reshape(n * n, 1)
                                  .repeat(B, axis=1))
    _close_per_slot(out, ref, 1e-6)


def test_covariance_wrapper_is_the_plain_version_on_cpu():
    fx = torch.from_numpy(_fx(seed=2))
    before = covariance_lanes.launches
    a = covariance_lanes(fx, n=N)
    b = covariance_lanes_ref(fx, n=N, r1=identity_r1(N))
    assert covariance_lanes.launches == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("fx_shape,r1", [((T, 15, B), None),
                                         ((T, 16, B), ((1.0, 0.0),) * 2)])
def test_covariance_refuses_bad_shapes(fx_shape, r1):
    with pytest.raises(ValueError, match="covariance_lanes"):
        covariance_lanes(torch.zeros(fx_shape), n=N, r1=r1)


def test_covariance_launches_only_on_cuda_tensors():
    """A tensor neither on the CPU nor on a card gets no launch."""
    before = covariance_lanes.launches
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        covariance_lanes(torch.zeros((T, N * N, B), device="meta"), n=N)
    assert covariance_lanes.launches == before
