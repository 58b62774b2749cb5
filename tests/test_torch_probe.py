"""The probe K5 (``ops/hopper/probe_kernel.py``) on CPU tensors: the plain
version against a step-by-step numpy f32 evaluation of the same running sum
(reverse t, the terms in order, acc = 0 and multiplier 1 at the start), and
the wrapper's checks. The JAX probe (``tools/probe_kernel_cost.py``) runs
only on a TPU and reads uninitialised scratch, so it is no reference here;
the kernel itself is held against this plain version on the card
(``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    probe_kernel as pk)

T, B = 6, 5


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (T, pk.S_IN, B)).astype(np.float32)


@pytest.mark.parametrize("mode", ["copy", "light", "full"])
def test_probe_plain_version_matches_numpy(mode):
    x = _x()
    out = pk.probe_lanes(torch.from_numpy(x), mode).numpy()
    assert out.shape == (T, pk.S_OUT, B)
    if mode == "copy":
        np.testing.assert_array_equal(out, x[:, :pk.S_OUT])
        return
    acc = np.zeros(B, np.float32)
    ref = np.empty((T, pk.S_OUT, B), np.float32)
    for t in range(T - 1, -1, -1):
        for i in range(pk.MODES[mode]):
            acc = acc + x[t, i % pk.S_IN] * np.float32(pk.MULT)
        ref[t] = acc
    np.testing.assert_array_equal(out, ref)


def test_probe_refuses_other_shapes_and_modes():
    n0 = pk.probe_lanes.launches
    with pytest.raises(ValueError, match="probe_lanes"):
        pk.probe_lanes(torch.zeros((T, 46, B)), "copy")
    with pytest.raises(ValueError, match="mode"):
        pk.probe_lanes(torch.zeros((T, pk.S_IN, B)), "half")
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        pk.probe_lanes(torch.zeros((T, pk.S_IN, B), device="meta"), "copy")
    assert pk.probe_lanes.launches == n0
