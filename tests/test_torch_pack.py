"""The port's stream layout against the JAX package's lane layout
(``ops/pallas/pack.py``): a lane array reshaped and cut to B is the port's
stream, exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu.ops.pallas import pack as jpack
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import pack


@pytest.mark.parametrize("B,trailing", [(8, (4,)), (1030, (1, 4)),
                                        (5, ())])
def test_stream_equals_lanes(B, trailing):
    T = 7
    a = (np.random.default_rng(B).standard_normal((B, T) + trailing)
         .astype(np.float32))
    lanes = np.asarray(jpack.to_lanes(jnp.asarray(a), B))
    stream = pack.to_streams(torch.from_numpy(a)).numpy()
    assert stream.shape == (T, int(np.prod(trailing)), B)
    assert stream.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(convert.stream_from_lanes(lanes, B), stream)
    np.testing.assert_array_equal(convert.stream_to_lanes(stream), lanes)
    np.testing.assert_array_equal(
        pack.from_streams(torch.from_numpy(stream), trailing).numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(jpack.from_lanes(jnp.asarray(lanes), B, trailing)), a)


def test_vectors_and_stats_convert():
    B = 9
    v = np.arange(B, dtype=np.float32)
    lanes = np.asarray(jpack.vec_to_lanes(jnp.asarray(v)))
    np.testing.assert_array_equal(convert.stream_from_lanes(lanes, B), v)
    np.testing.assert_array_equal(
        pack.vec_from_streams(pack.vec_to_streams(torch.from_numpy(v))), v)
    stats = np.stack([lanes] * 4)                     # (4, nB, 8, 128)
    assert convert.stream_from_lanes(stats, B).shape == (4, B)


@pytest.mark.parametrize("n,m", [(4, 1), (10, 2)])
def test_deriv_layout_matches_jax(n, m):
    a, b = pack.DerivLayout(n, m), jpack.DerivLayout(n, m)
    for name in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu", "D"):
        assert getattr(a, name) == getattr(b, name), name
