"""The lowering's later ops (abs, log, pow, relu, minimum, maximum, clamp,
comparisons, logic on booleans, where) against PyTorch and the JAX package
on the CPU.

- ``powc_`` (``csrc/autodiff.cuh``), the form the lowering emits for
  ``x ** e``, compiled with the host's ``g++`` against ``torch.pow`` on CPU
  tensors: bit-equal at the exponents PyTorch special-cases (½ and -½
  against the correctly rounded sqrt, which PyTorch's CPU sqrt misses by
  an ulp on some lanes), and within 1 ulp of the correctly rounded power
  at the others.
- What stays outside the op set raises, naming the op.
- The tie table: the derivatives of ``abs`` at 0, of a clamp on its bound
  and of ``maximum`` at a tie, in each package.
- The rail model (``tools_torch/rail.py``, the pendcart on a finite rail)
  written in torch and in jnp: the port's autodiff tiles (what K1's
  ``Autodiff<Lowered>`` is held to on the card) against JAX's, away from
  ties, and the fleet solve on the CPU against JAX's ``ilqg_batch_lanes``
  in interpret mode (B=8, T=6, k_t=1).

``tests/test_torch_lower.py`` holds a model with every op of the set
against its lowered struct and ``Autodiff<Lowered>`` on the host.
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_autodiff_tiles)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    LanesModel as JLanesModel)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    _build, lower)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_derivs_tiles
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import LanesModel
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)
from tools_torch import rail

B, T = 8, 6
JSPEC = jpc.PendCartSpec()
SPEC = convert.spec_from_jax(JSPEC)
LIMS = ((-5.0, 5.0),)

# ---------------------------------------------------------------------------
# pow's emitted form against torch.pow
# ---------------------------------------------------------------------------

# the exponents PyTorch's pow special-cases (0, 1, ½, -½, -1, 2, 3, -2),
# whose emitted forms give its bits, and three that go to powf
SPECIAL = (0.0, 1.0, 0.5, -0.5, -1.0, 2.0, 3.0, -2.0)
GENERAL = (1.5, 0.3, -1.7)

POW_HARNESS = """
#include "autodiff.cuh"
extern "C" void pow_all(const float* x, int n, float e, float* y) {
  for (int i = 0; i < n; ++i) y[i] = ddp::powc_(x[i], e);
}
"""
SHIM = """#pragma once
#include <math.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
"""


@pytest.fixture(scope="module")
def pow_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs the host's g++ to compile powc_")
    d = tmp_path_factory.mktemp("pow")
    (d / "shim").mkdir()
    (d / "shim" / "cuda_runtime.h").write_text(SHIM)
    (d / "pow.cpp").write_text(POW_HARNESS)
    r = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{d / 'shim'}", f"-I{_build.CSRC}", "-o", str(d / "pow.so"),
         str(d / "pow.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "pow.so"))
    lib.pow_all.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                            ctypes.c_void_p)
    return lib


def _pow_inputs():
    rng = np.random.default_rng(11)
    x = np.concatenate([np.abs(rng.standard_normal(4000)) * 3.0,
                        10.0 ** rng.uniform(-6, 6, 2000),
                        [0.0, 1.0, 2.0, 0.25]]).astype(np.float32)
    return x


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia, ib = (v.view(np.int32).astype(np.int64) for v in (a, b))
    return np.abs(ia - ib)


def _rn(v: np.ndarray) -> np.ndarray:
    """f64 values rounded to f32: the correctly rounded result."""
    return v.astype(np.float32)


@pytest.mark.parametrize("e", SPECIAL + GENERAL)
def test_pow_emitted_form_matches_torch_pow(pow_lib, e):
    """powc_ at exponent e against torch.pow(x, e) on CPU tensors: 0 and 1
    fill and copy, and -1, 2, 3, -2 are bit-equal. ½ and -½ go to sqrt:
    PyTorch's CPU sqrt is not correctly rounded on some vector lanes, so
    there powc_ is held bit for bit to the correctly rounded sqrt (and its
    reciprocal) and PyTorch within 1 ulp of it. The other exponents go to
    powf: glibc's within 1 ulp of the correctly rounded power, PyTorch's
    CPU pow (vectorised) within 8. On the card both take libdevice's
    powf, and chip_smoke.py's ops phase holds them bit for bit."""
    x = _pow_inputs()
    y = np.empty_like(x)
    pow_lib.pow_all(x.ctypes.data, x.size, ctypes.c_float(e), y.ctypes.data)
    ref = torch.pow(torch.from_numpy(x), e).numpy()
    assert np.array_equal(np.isnan(y), np.isnan(ref))
    ok = np.isfinite(ref) & (ref != 0)
    x64 = x.astype(np.float64)
    if e in (0.5, -0.5):
        root = _rn(np.sqrt(x64))
        exact = root if e == 0.5 else np.float32(1.0) / root
        np.testing.assert_array_equal(y[ok], exact[ok])
        assert _ulps(ref[ok], exact[ok]).max() <= 1
    elif e in SPECIAL:
        np.testing.assert_array_equal(y, ref)
    else:
        exact = _rn(np.power(x64, np.float64(np.float32(e))))
        assert _ulps(y[ok], exact[ok]).max() <= 1
        assert _ulps(ref[ok], exact[ok]).max() <= 8


def test_pow_lowers_with_the_rules_exponents():
    """x ** e emits powc_ with e, e-1 and e-2 formed in double, then
    rounded, as pow_backward's Scalar arithmetic forms them."""
    def dynamics(x, u, t):
        return [x[0] + 0.1 * x[1] ** 2, x[1] + 0.1 * u[0] ** 0.3]

    def cost(x, u, t):
        return torch.square(x[0]) + x[1] ** -1

    low = lower.lower(LanesModel(n=2, m=1, dynamics=dynamics, cost=cost))
    src = low.struct(False)
    assert "powc_(x[1], 2.0f, 1.0f, 0.0f)" in src
    e = float(np.float32(0.3))
    assert (f"powc_(u[0], {e!r}f, {float(np.float32(0.3 - 1.0))!r}f, "
            f"{float(np.float32(0.3 - 2.0))!r}f)") in src
    assert "powc_(x[0], 2.0f, 1.0f, 0.0f)" in src      # torch.square
    assert "powc_(x[1], -1.0f, -2.0f, -3.0f)" in src


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------

OUTSIDE = {
    "atan2": lambda x: torch.atan2(x[0], x[1]),
    "erf": lambda x: torch.erf(x[0]),
    "floor": lambda x: torch.floor(x[0]),
    "sign": lambda x: torch.sign(x[0]),
    "pow.Tensor_Tensor": lambda x: x[0] ** x[1],
}


@pytest.mark.parametrize("op", sorted(OUTSIDE))
def test_op_outside_the_set_raises_naming_it(op):
    def cost(x, u, t):
        return OUTSIDE[op](x) + u[0]

    model = LanesModel(n=2, m=1, dynamics=lambda x, u, t: [x[0], x[1]],
                       cost=cost)
    with pytest.raises(NotImplementedError, match=r"cost.*" + op.split(".")[0]):
        lower.lower(model)


def test_boolean_output_and_tensor_clamp_bounds_raise():
    def cost(x, u, t):
        return torch.clamp(x[0], min=x[1]) + u[0]

    model = LanesModel(n=2, m=1, dynamics=lambda x, u, t: [x[0], x[1]],
                       cost=cost)
    with pytest.raises(NotImplementedError, match="clamp"):
        lower.lower(model)

    def dyn(x, u, t):
        return [x[0] > 0.0, x[1]]

    model = LanesModel(n=2, m=1, dynamics=dyn, cost=lambda x, u, t: u[0])
    with pytest.raises(NotImplementedError, match="dynamics.*boolean"):
        lower.lower(model)


# ---------------------------------------------------------------------------
# the tie table
# ---------------------------------------------------------------------------

def test_tie_table():
    """The derivative at a tie, where the packages' rules differ: |x|' at
    0 is 0 in torch (sgn) and 1 in JAX (select(x >= 0, g, -g)); a clamp's
    derivative on its bound is 1 in torch and ½ in JAX's clip
    (minimum(maximum(·)) with balanced ties); maximum at a tie is ½ in
    both. K1's autodiff follows torch (csrc/autodiff.cuh)."""
    jv = jax.jvp
    one = jnp.float32(1.0)
    tj = torch.tensor(1.0)

    def tj_(f, x):
        return torch.func.jvp(f, (torch.tensor(x),), (tj,))[1].item()

    table = {
        "abs at 0": (tj_(torch.abs, 0.0),
                     float(jv(jnp.abs, (jnp.float32(0.0),), (one,))[1])),
        "clamp on its bound": (
            tj_(lambda v: torch.clamp(v, -1.0, 1.0), 1.0),
            float(jv(lambda v: jnp.clip(v, -1.0, 1.0), (jnp.float32(1.0),),
                     (one,))[1])),
        "maximum at a tie": (
            torch.func.jvp(torch.maximum, (torch.tensor(2.0),
                                           torch.tensor(2.0)),
                           (tj, torch.tensor(0.0)))[1].item(),
            float(jv(jnp.maximum, (jnp.float32(2.0), jnp.float32(2.0)),
                     (one, jnp.float32(0.0)))[1])),
    }
    assert table == {"abs at 0": (0.0, 1.0),
                     "clamp on its bound": (1.0, 0.5),
                     "maximum at a tie": (0.5, 0.5)}


# ---------------------------------------------------------------------------
# the rail model against JAX
# ---------------------------------------------------------------------------

def _models():
    return (rail.rail_lanes(torch, LanesModel, tpc.pendcart_lanes(SPEC)),
            rail.rail_lanes(jnp, JLanesModel, jpc.pendcart_lanes(JSPEC)))


def _flat(d):
    out = []

    def walk(k, v):
        if isinstance(v, (list, tuple)):
            for w in v:
                walk(k, w)
        else:
            out.append((k, np.broadcast_to(np.asarray(v), (64,))))

    for k in sorted(d):
        walk(k, d[k])
    return out


def test_rail_autodiff_tiles_match_jax():
    """The rail model's autodiff tiles, torch against jnp, on f32 points
    where every branch is live and none is at a tie: |p| on both sides of
    the rail's end, |u| on both sides of the band; 1e-5 relative (XLA's
    contractions and log against PyTorch's)."""
    rng = np.random.default_rng(2)
    x = np.stack([rng.uniform(2.0, 4.0, 64), rng.standard_normal(64),
                  rng.uniform(-2.5, 2.5, 64), 2.0 * rng.standard_normal(64)]
                 ).astype(np.float32)
    u = rng.uniform(-5.0, 5.0, (1, 64)).astype(np.float32)
    assert (np.abs(x[2]) > rail.RAIL).any() and (np.abs(x[2]) < 1.4).any()
    assert (np.abs(u) > rail.BAND).any() and (np.abs(u) < 3.9).any()
    tm, jm = _models()
    tiles = autodiff_derivs_tiles(tm)
    out = tiles([torch.from_numpy(v) for v in x],
                [torch.from_numpy(v) for v in u], 0)
    ref = jax_autodiff_tiles(jm)([jnp.asarray(v) for v in x],
                                 [jnp.asarray(v) for v in u], 0)
    got, want = _flat(out), _flat(ref)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)
    # the rail and the band are live in the Hessian: 100·2 past the end
    cxx = np.asarray(out["cxx"][2][2]) - np.asarray(tiles(
        [torch.from_numpy(v) for v in np.zeros_like(x)],
        [torch.zeros(64)], 0)["cxx"][2][2])
    assert (cxx[np.abs(x[2]) > rail.RAIL] > 100.0).all()


CFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                   max_iter=3, iter_cap=5)


def test_rail_fleet_matches_jax():
    """The rail fleet (a Python-only model: autodiff tiles, lowered on the
    card) on the CPU against JAX's ilqg_batch_lanes in interpret mode with
    JAX's autodiff tiles: costs within 1e-4 relative, reasons, accepted
    counts and iterations equal; some lanes start past the rail's end and
    some controls reach the band."""
    rng = np.random.default_rng(5)
    x0s = np.stack([np.pi - 0.5 + 0.2 * rng.standard_normal(B),
                    0.3 * rng.standard_normal(B),
                    np.linspace(-2.2, 2.2, B),
                    rng.standard_normal(B)], axis=1).astype(np.float32)
    u0s = (4.5 * rng.standard_normal((B, T, 1))).astype(np.float32)
    tm, jm = _models()
    ref = convert.result_to_numpy(J.ilqg_batch_lanes(
        jm, None, jnp.asarray(x0s), jnp.asarray(u0s), lims=LIMS, cfg=CFG,
        derivs_tiles=jax_autodiff_tiles(jm), kt_backward=1, kt_forward=1,
        interpret=True))
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tm, None, torch.from_numpy(x0s), torch.from_numpy(u0s), lims=LIMS,
        cfg=convert.config_from_jax(CFG), derivs_tiles=autodiff_derivs_tiles(
            tm)))
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert (out["n_accepted"] >= 1).any()
    assert rail.leaves_rail(torch.from_numpy(out["x"])) > 0
    assert (np.abs(u0s) > rail.BAND).any()
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-4, atol=1e-5)
