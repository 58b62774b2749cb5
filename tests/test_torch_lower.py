"""The lowering of Python lane models (``ops/hopper/lower.py``) on the CPU.

- The lowering's graph, interpreted with torch, against each of the port's
  five lane models' own functions, bit for bit at B=64.
- The emitted C++ struct compiled with the host's ``g++`` (``__device__``
  and ``__forceinline__`` defined away, ``-ffp-contract=off``) and called
  through ctypes: bit-equal for LTI (additions and products only), within
  1e-6 relative where sin/cos enter (glibc's against PyTorch's).
- ``Autodiff<Lowered>`` (``csrc/autodiff.cuh``) compiled for the host the
  same way: bit-equal to the hand-written ``Autodiff<Quadrotor>`` on the
  lowered quadrotor, and against the plain autodiff tiles on models with
  params and with tanh, exp and sqrt.
- What raises, the digest, and that CPU tensors never lower.
- ``params`` through the autodiff tiles against JAX's tiles (plain jnp),
  and the fleet solve of ``pendcart_lanes_param`` with them against JAX's
  fleet in interpret mode (B=8, T=6, k_t=2).

``tests/test_torch_lowered_models.py`` holds the other lowered paths (diff,
KL on the quadrotor) against the JAX package. The compiled checks skip
only where ``g++`` is absent.
"""
import ctypes
import dataclasses
import math
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_autodiff_tiles)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    _build, backward_kernel as bk, forward_kernel as fk, lower)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_derivs_tiles
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import LanesModel
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)
from tools_torch import opset

B = 64
CSRC = _build.CSRC


def wrap_diff(x, x_old):
    """Angle wrapping of the quadrotor's attitude θ (state 4) into [-π, π),
    Python's remainder as PyTorch and jnp compute it."""
    d = [x[i] - x_old[i] for i in range(len(x))]
    d[4] = torch.remainder(d[4] + math.pi, 2 * math.pi) - math.pi
    return d


def _lti(seed=0, m=2, zero=None):
    spec = tl.random_lti(seed, n=10, m=m, T=8, device="cpu")
    if zero is not None:
        Bm = spec.B.clone()
        Bm[zero] = 0.0
        spec = spec._replace(B=Bm)
    return tl.lti_lanes(spec)


def _opset():
    """The op-set model of tools_torch/opset.py: every op the lowering
    gained beyond the arithmetic and sin, cos, tanh, exp, sqrt."""
    return opset.opset_lanes(LanesModel)


MODELS = {
    "opset": _opset,
    "pendcart": lambda: tpc.pendcart_lanes(tpc.PendCartSpec()),
    "pendcart_param": lambda: tpc.pendcart_lanes_param(tpc.PendCartSpec()),
    "lti_10_2": lambda: _lti(),
    "lti_10_3": lambda: _lti(m=3),
    "quadrotor": lambda: tq.quadrotor_lanes(tq.QuadrotorSpec()),
}
# models whose functions hold only additions and products: the compiled
# struct is bit-equal to them
EXACT = ("lti_10_2", "lti_10_3")


def bare(model, **kw):
    """The model with its descriptor removed: Python functions only."""
    return dataclasses.replace(model, device=None, **kw)


def _inputs(model, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((model.n, B)).astype(np.float32)
    u = (1.0 + rng.standard_normal((model.m, B))).astype(np.float32)
    par = np.stack([rng.uniform(0.25, 0.55, B), rng.uniform(0.5, 1.5, B)]
                   )[:model.n_params].astype(np.float32)
    return x, u, par


def _rows(a):
    return [torch.from_numpy(np.ascontiguousarray(r)) for r in a]


def _own(model, x, u, par):
    """The model's own functions on (B,) tensors."""
    xs, us = _rows(x), _rows(u)
    pa = (_rows(par),) if model.n_params else ()
    out = dict(dynamics=model.dynamics(xs, us, 0, *pa),
               cost=model.cost(xs, us, 0, *pa))
    if model.terminal is not None:
        out["terminal"] = model.terminal(xs, *pa)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_lowered_graph_equals_model(name):
    model = MODELS[name]()
    low = lower.lower(bare(model))
    x, u, par = _inputs(model)
    own = _own(model, x, u, par)
    for fn, ref in own.items():
        got = low.interpret(fn, _rows(x), _rows(u), _rows(par))
        for a, b in zip(got if fn == "dynamics" else [got],
                        ref if fn == "dynamics" else [ref]):
            assert torch.equal(a.expand(B), b.expand(B)), (name, fn)
    assert set(low.fns) == set(own)
    assert low.consts.dtype == np.float32


# ---------------------------------------------------------------------------
# the emitted struct, compiled for the host
# ---------------------------------------------------------------------------

def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs the host's g++ to compile the emitted struct")
    return gxx


def _compile(tmp_path, name, source, includes=()):
    src = tmp_path / f"{name}.cpp"
    src.write_text(source)
    so = tmp_path / f"{name}.so"
    r = subprocess.run(
        [_gxx(), "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
         "-fPIC", *[f"-I{d}" for d in includes], "-o", str(so), str(src)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return ctypes.CDLL(str(so))


def _make(low, cls="Lowered", var="L"):
    """C++ that constructs ``cls`` from ``mc`` and lane b's parameters."""
    if low.n_params:
        return (f"float pb[P]; for (int p = 0; p < P; ++p) "
                f"pb[p] = par[p * B + b]; {cls} {var}(mc, pb);")
    return f"{cls} {var}(mc);"


STRUCT_HARNESS = """
#include "autodiff.cuh"
namespace ddp {
%(struct)s
}
using ddp::Lowered;
constexpr int N = Lowered::N, M = Lowered::M, P = Lowered::N_PARAMS;
extern "C" void eval(const float* c, const float* par, const float* x,
                     const float* u, const float* xo, int B, int t,
                     float* xn, float* cost, float* term, float* dx) {
  Lowered::Consts mc;
  for (int i = 0; i < Lowered::N_CONSTS; ++i) mc.c[i] = c[i];
  for (int b = 0; b < B; ++b) {
    %(make)s
    float xb[N], ub[M], ob[N], yb[N], db[N];
    for (int i = 0; i < N; ++i) { xb[i] = x[i * B + b]; ob[i] = xo[i * B + b]; }
    for (int i = 0; i < M; ++i) ub[i] = u[i * B + b];
    L.dynamics(xb, ub, t, yb);
    for (int i = 0; i < N; ++i) xn[i * B + b] = yb[i];
    cost[b] = L.cost(xb, ub, t);
    term[b] = L.terminal(xb);
    %(diff)s
  }
}
"""


def _shim(tmp_path):
    """The directory of the host's stand-in cuda_runtime.h."""
    (tmp_path / "shim").mkdir(exist_ok=True)
    (tmp_path / "shim" / "cuda_runtime.h").write_text(SHIM)
    return tmp_path / "shim"


def _eval_struct(tmp_path, name, low, x, u, par, xo, t=0):
    """The emitted struct (with autodiff.cuh, whose helpers it calls)
    compiled for the host and run on lanes x, u, par, xo at step t."""
    lib = _compile(tmp_path, name, STRUCT_HARNESS % dict(
        struct=low.struct(True), make=_make(low),
        diff=("L.diff(xb, ob, db); for (int i = 0; i < N; ++i) "
              "dx[i * B + b] = db[i];" if low.has_diff else "")),
        includes=(_shim(tmp_path), CSRC))
    n = low.n
    out = dict(dynamics=np.zeros((n, B), np.float32),
               cost=np.zeros(B, np.float32),
               terminal=np.zeros(B, np.float32),
               diff=np.zeros((n, B), np.float32))
    fp = ctypes.POINTER(ctypes.c_float)

    def p(a):
        return np.ascontiguousarray(a, np.float32).ctypes.data_as(fp)

    consts = low.consts_for(True)
    keep = [np.ascontiguousarray(a, np.float32)
            for a in (consts, par if par.size else np.zeros(1), x, u, xo)]
    lib.eval(*[p(a) for a in keep], ctypes.c_int(B), ctypes.c_int(t),
             *[out[k].ctypes.data_as(fp)
               for k in ("dynamics", "cost", "terminal", "diff")])
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_emitted_struct_compiles_and_matches_model(tmp_path, name):
    model = MODELS[name]()
    low = lower.lower(bare(model))
    x, u, par = _inputs(model, seed=1)
    got = _eval_struct(tmp_path, name, low, x, u, par, x)
    for fn, ref in _own(model, x, u, par).items():
        ref = (np.stack([r.expand(B).numpy() for r in ref])
               if fn == "dynamics" else ref.expand(B).numpy())
        if name in EXACT:
            np.testing.assert_array_equal(got[fn], ref, err_msg=fn)
        else:
            np.testing.assert_allclose(got[fn], ref, rtol=1e-6, atol=0,
                                       err_msg=fn)
    if model.terminal is None:
        np.testing.assert_array_equal(got["terminal"], 0.0)


def test_emitted_diff_wraps_angles(tmp_path):
    """The quadrotor with the angle-wrapping diff: the struct's diff (a
    remainder, emitted as fmod and the sign fix) equals the Python diff bit
    for bit, on differences beyond ±π too."""
    model = bare(tq.quadrotor_lanes(), diff=wrap_diff)
    low = lower.lower(model)
    x, u, _ = _inputs(model, seed=2)
    xo = x + np.float32(5.0) * np.random.default_rng(3).standard_normal(
        x.shape).astype(np.float32)
    got = _eval_struct(tmp_path, "quad_diff", low, x, u, np.zeros(0), xo)
    ref = np.stack([d.numpy() for d in wrap_diff(_rows(x), _rows(xo))])
    np.testing.assert_array_equal(got["diff"], ref)
    assert np.abs(ref[4]).max() <= np.pi and np.abs(x[4] - xo[4]).max() > 4
    assert "fmodf" in low.struct(True) and "fmodf" not in low.struct(False)
    assert low.consts_for(False).size == low.n_consts_model < low.consts.size


# ---------------------------------------------------------------------------
# Autodiff<Lowered>, compiled for the host
# ---------------------------------------------------------------------------

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

AD_HARNESS = """
#include "autodiff.cuh"
#include "quadrotor.cuh"
namespace ddp {
%(struct)s
}
using namespace ddp;
constexpr int N = Lowered::N, M = Lowered::M, P = Lowered::N_PARAMS;
using Hand = %(hand)s;
using AD = Autodiff<Lowered, true>;
constexpr int NH = AD::NH;
// per lane: fx (N·N), fu (N·M), cx, cu, the cost Hessian and the
// V-contracted dynamics Hessians (upper triangles), of the lowered struct
// and, where a hand-written one is named, of it
extern "C" void derivs(const float* c, const float* hc, const float* par,
                       const float* x, const float* u, const float* V,
                       int B, float* out, float* hand) {
  constexpr int S = N * N + N * M + N + M + 2 * NH;
  AD::Consts mc;
  for (int i = 0; i < AD::N_CONSTS; ++i) mc.c[i] = c[i];
  for (int b = 0; b < B; ++b) {
    %(make)s
    float xb[N], ub[M], vb[N];
    for (int i = 0; i < N; ++i) { xb[i] = x[i * B + b]; vb[i] = V[i * B + b]; }
    for (int i = 0; i < M; ++i) ub[i] = u[i * B + b];
    AD::Derivs d;
    A.derivs_so(xb, ub, 0, vb, d);
    float* o = out + (size_t)b * S;
    for (int i = 0; i < N; ++i) for (int j = 0; j < N; ++j) *o++ = d.fx[i][j];
    for (int i = 0; i < N; ++i) for (int j = 0; j < M; ++j) *o++ = d.fu[i][j];
    for (int i = 0; i < N; ++i) *o++ = d.cx[i];
    for (int i = 0; i < M; ++i) *o++ = d.cu[i];
    for (int i = 0; i < NH; ++i) *o++ = d.H[i];
    for (int i = 0; i < NH; ++i) *o++ = d.HV[i];
    if (hand != nullptr) {
      Hand::Consts hm;
      for (int i = 0; i < Hand::N_CONSTS; ++i) hm.c[i] = hc[i];
      Autodiff<Hand, true> Hd(hm);
      Autodiff<Hand, true>::Derivs e;
      Hd.derivs_so(xb, ub, 0, vb, e);
      static_assert(sizeof(e) == sizeof(d), "same layout");
      __builtin_memcpy(hand + (size_t)b * S, &e.fx[0][0], S * sizeof(float));
    }
  }
}
"""


def _host_autodiff(tmp_path, name, low, x, u, par, V, hand=None):
    """Autodiff<Lowered, true>'s expansion on the host, (B, S) per lane;
    with ``hand`` (descriptor consts of the hand-written Quadrotor) the
    hand-written Autodiff<Quadrotor, true>'s too."""
    lib = _compile(tmp_path, name, AD_HARNESS % dict(
        struct=low.struct(False), make=_make(low, "AD", "A"),
        hand="Quadrotor" if hand is not None else "Lowered"),
        includes=(_shim(tmp_path), CSRC))
    n, m = low.n, low.m
    nh = (n + m) * (n + m + 1) // 2
    S = n * n + n * m + n + m + 2 * nh
    out = np.zeros((B, S), np.float32)
    hout = np.zeros((B, S), np.float32) if hand is not None else None
    fp = ctypes.POINTER(ctypes.c_float)
    keep = [np.ascontiguousarray(a, np.float32) for a in (
        low.consts_for(False), hand if hand is not None else np.zeros(1),
        par if par.size else np.zeros(1), x, u, V)]
    lib.derivs(*[a.ctypes.data_as(fp) for a in keep], ctypes.c_int(B),
               out.ctypes.data_as(fp),
               hout.ctypes.data_as(fp) if hout is not None else None)
    return out, hout


def test_host_autodiff_lowered_quadrotor_is_the_hand_written(tmp_path):
    """The lowered quadrotor's Autodiff expansion (first and second order,
    the V′ contraction included) equals the hand-written Autodiff<Quadrotor>
    bit for bit: the same f32 operations in the same order."""
    tm = tq.quadrotor_lanes(tq.QuadrotorSpec())
    low = lower.lower(bare(tm))
    x, u, _ = _inputs(tm, seed=4)
    V = np.random.default_rng(5).standard_normal((6, B)).astype(np.float32)
    out, hand = _host_autodiff(tmp_path, "adq", low, x, u, np.zeros(0), V,
                               hand=tm.device.consts)
    np.testing.assert_array_equal(out, hand)
    assert np.isfinite(out).all() and np.abs(out).max() > 0


def _exotic():
    """A model with per-scenario params and tanh, exp and sqrt in its
    dynamics and cost."""
    def dynamics(x, u, t, par):
        a, k = par
        return [x[0] + 0.1 * x[1],
                x[1] + 0.1 * (torch.tanh(u[0] * a) - k * torch.sin(x[0])),
                x[2] + 0.05 * torch.exp(-x[2] * x[2]) * u[0]]

    def cost(x, u, t, par):
        return (torch.sqrt(1.0 + x[0] * x[0] + x[2] * x[2]) + 0.5 * x[1]
                * x[1] + par[0] * u[0] * u[0])

    return LanesModel(n=3, m=1, dynamics=dynamics, cost=cost, n_params=2)


@pytest.mark.parametrize("name", ["pendcart_param", "exotic", "opset"])
def test_host_autodiff_lowered_matches_plain_tiles(tmp_path, name):
    """Autodiff<Lowered> with params, through the tanh, exp and sqrt rules,
    and through every rule of the op set's later ops (pow, abs, log, relu,
    minimum, maximum, clamp, where), against the plain autodiff tiles
    (torch.func): fx, fu, cx, cu, the cost Hessian and Σ_a V[a]·∂²f_a.
    Tolerance 1e-5 relative: glibc's sin/tanh/exp/log/powf against
    PyTorch's."""
    model = (bare(MODELS[name]()) if name in MODELS and name != "opset"
             else _opset() if name == "opset" else _exotic())
    low = lower.lower(model)
    x, u, par = _inputs(model, seed=6)
    V = np.random.default_rng(7).standard_normal(
        (model.n, B)).astype(np.float32)
    out, _ = _host_autodiff(tmp_path, name, low, x, u, par, V)
    tiles = autodiff_derivs_tiles(model, second_order=True)
    d = tiles(_rows(x), _rows(u), 0,
              *((_rows(par),) if model.n_params else ()))
    n, m = model.n, model.m
    nm = n + m

    def h(i, j):
        return d["cxx"][i][j] if j < n else (
            d["cxu"][i][j - n] if i < n else d["cuu"][i - n][j - n])

    def hv(i, j):
        def f2(a):
            return (d["fxx"][a][i][j] if j < n else (
                d["fxu"][a][i][j - n] if i < n
                else d["fuu"][a][i - n][j - n]))
        s = torch.from_numpy(V[0]) * f2(0)
        for a in range(1, n):
            s = s + torch.from_numpy(V[a]) * f2(a)
        return s

    pairs = [(i, j) for i in range(nm) for j in range(i, nm)]
    ref = ([d["fx"][i][j] for i in range(n) for j in range(n)]
           + [d["fu"][i][j] for i in range(n) for j in range(m)]
           + list(d["cx"]) + list(d["cu"])
           + [h(i, j) for i, j in pairs] + [hv(i, j) for i, j in pairs])
    ref = np.stack([r.expand(B).numpy() for r in ref], axis=1)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# what raises, the digest, and CPU tensors
# ---------------------------------------------------------------------------

def _model_with(dynamics=None, cost=None):
    base = tpc.pendcart_lanes(tpc.PendCartSpec())
    return LanesModel(n=4, m=1, dynamics=dynamics or base.dynamics,
                      cost=cost or base.cost)


def test_unsupported_op_raises_naming_it():
    def dynamics(x, u, t):
        return [torch.atan2(x[0], x[1]), x[1], x[2], x[3] + u[0]]

    with pytest.raises(NotImplementedError, match=r"dynamics.*atan2"):
        lower.lower(_model_with(dynamics=dynamics))

    def cost(x, u, t):   # remainder is diff's alone: K1 differentiates cost
        return torch.remainder(x[0], 2.0) + u[0]

    with pytest.raises(NotImplementedError, match=r"cost.*remainder"):
        lower.lower(_model_with(cost=cost))


def test_function_reading_t_raises():
    """t lowers (test_function_reading_t_lowers), but an integer operation
    other than add, sub, mul and neg raises naming it, and so does an
    integer-valued output."""
    def cost(x, u, t):
        return x[0] * x[0] + u[0] * u[0] * torch.remainder(t, 2)

    with pytest.raises(NotImplementedError,
                       match=r"cost.*remainder.*integer value"):
        lower.lower(_model_with(cost=cost))

    def dynamics(x, u, t):
        return [x[0], x[1], x[2], t + 1]

    with pytest.raises(NotImplementedError, match=r"dynamics.*integer"):
        lower.lower(_model_with(dynamics=dynamics))


def _tracking(int_arith=False):
    """The pendcart whose cost tracks a θ reference r(t) = 0.5·sin(π·h·t)
    and weighs u by (1 + 0.01·t) (with ``int_arith``, by 0.01·(t + 1),
    integer arithmetic first)."""
    base = tpc.pendcart_lanes(tpc.PendCartSpec())

    def cost(x, u, t):
        r = 0.5 * torch.sin(t * float(np.float32(math.pi * 0.01)))
        w = (t + 1) * 0.01 if int_arith else 1.0 + t * 0.01
        return (x[0] - r) * (x[0] - r) + w * u[0] * u[0] + x[1] * x[1]

    return LanesModel(n=4, m=1, dynamics=base.dynamics, cost=cost)


@pytest.mark.parametrize("int_arith", [False, True])
def test_function_reading_t_lowers(tmp_path, int_arith):
    """A cost that reads t lowers: t is the struct's int argument,
    converted where torch promotes it (``static_cast<float>(t) * k``, the
    f32 product), integer arithmetic kept as ints. The interpreted graph
    equals the model's cost bit for bit at int32 t, and the struct compiled
    for the host equals it within glibc's sinf against PyTorch's (1e-6)
    at steps whose f32 and f64 products of t·0.01 differ (t = 5, 9, 10)."""
    model = _tracking(int_arith)
    low = lower.lower(model)
    src = low.struct(False)
    assert "int t" in src and "static_cast<float>(t)" in src
    assert ("t + 1" in src) == int_arith
    x, u, par = _inputs(model, seed=9)
    for t in (5, 9, 10):
        tt = torch.tensor(t, dtype=torch.int32)
        ref = model.cost(_rows(x), _rows(u), tt)
        got = low.interpret("cost", _rows(x), _rows(u), t=tt)
        assert torch.equal(got.expand(B), ref.expand(B)), t
        host = _eval_struct(tmp_path, f"track{int(int_arith)}_{t}", low, x,
                            u, par, x, t=t)
        np.testing.assert_allclose(host["cost"], ref.numpy(), rtol=1e-6,
                                   atol=0)


def test_branch_on_a_value_raises():
    def dynamics(x, u, t):
        if bool((x[0] > 0).all()):
            return [x[0], x[1], x[2], x[3] + u[0]]
        return [x[0], x[1], x[2], x[3] - u[0]]

    with pytest.raises(NotImplementedError,
                       match=r"dynamics.*cannot be traced"):
        lower.lower(_model_with(dynamics=dynamics))


def test_hand_written_descriptor_with_diff_raises():
    """The quadrotor's struct has no diff: K2 and K3 refuse a model that
    has both, off the CPU (here the meta device, which needs no card),
    before any library is touched; without the descriptor it lowers."""
    model = dataclasses.replace(tq.quadrotor_lanes(), diff=wrap_diff)
    T, Bm = 4, 8
    meta = dict(device="meta")
    traj = torch.zeros((T, 9, Bm), **meta)
    gains = torch.zeros((T, 14, Bm), **meta)
    x0 = torch.zeros((6, Bm), **meta)
    with pytest.raises(ValueError, match="descriptor.*diff"):
        fk.forward_lanes(traj, gains, x0, torch.ones((1, Bm), **meta),
                         model=model, lims=model_lims())
    with pytest.raises(ValueError, match="descriptor.*diff"):
        fk.linesearch_lanes(traj, gains, x0, torch.zeros((4, Bm), **meta),
                            model=model, alphas=(1.0, 0.5),
                            lims=model_lims())
    assert lower.lower(bare(model)).has_diff


def model_lims():
    return tq.QuadrotorSpec().lims


def test_digest_follows_the_graph_structure():
    """Two quadrotor specs emit one source (one build of each group);
    their constants differ. An LTI with another zero pattern emits another
    source, as its sums skip other terms."""
    other = tq.QuadrotorSpec(mass=0.7, inertia=0.02, h=0.05,
                             Q=(2.0, 0.2, 1.5, 0.3, 1.0, 0.1), R=0.1)
    a = lower.lower(bare(tq.quadrotor_lanes(tq.QuadrotorSpec())))
    b = lower.lower(bare(tq.quadrotor_lanes(other)))
    assert a.struct(False) == b.struct(False)
    assert not np.array_equal(a.consts, b.consts)

    def path(low, group="k1"):
        return _build._lowered_path(
            _build.lowered_source(low.struct(group == "fwd"), group))

    assert path(a) == path(b) and path(a, "fwd") == path(b, "fwd")
    assert path(a) != path(a, "k1_gps")
    dense = [lower.lower(bare(_lti(seed))) for seed in (0, 1)]
    sparse = lower.lower(bare(_lti(0, zero=(3, 1))))
    assert path(dense[0]) == path(dense[1])
    assert path(sparse) != path(dense[0])
    assert sparse.consts.size == dense[0].consts.size - 1


def test_cpu_tensors_never_lower(monkeypatch):
    """A model without a descriptor on CPU tensors runs the plain versions
    (the same bits as the model with its descriptor) and never lowers or
    touches a library."""
    def refuse(*a, **k):
        raise AssertionError("lowered or built for CPU tensors")

    monkeypatch.setattr(lower, "lower", refuse)
    monkeypatch.setattr(_build, "build_lowered", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    tm = tq.quadrotor_lanes(tq.QuadrotorSpec())
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     lam_max=1e15, max_iter=2, iter_cap=3)
    rng = np.random.default_rng(8)
    x0s = torch.tensor(np.asarray(tq.default_x0(device="cpu"))[None, :]
                       + 0.3 * rng.standard_normal((4, 6)),
                       dtype=torch.float32)
    u0s = torch.full((4, 5, 2), tq.QuadrotorSpec().u_hover)
    launches = (bk.backward_lanes.launches, fk.forward_lanes.launches,
                fk.linesearch_lanes.launches)
    res = [ilqg_batch_lanes(m, None, x0s, u0s, lims=model_lims(), cfg=cfg,
                            derivs_tiles=autodiff_derivs_tiles(m))
           for m in (tm, bare(tm))]
    for name in ("cost_total", "x", "u", "reason"):
        assert torch.equal(getattr(res[0], name), getattr(res[1], name))
    assert launches == (bk.backward_lanes.launches, fk.forward_lanes.launches,
                        fk.linesearch_lanes.launches)


# ---------------------------------------------------------------------------
# params through the autodiff tiles, against JAX
# ---------------------------------------------------------------------------

JPSPEC = jpc.PendCartSpec()
PSPEC = convert.spec_from_jax(JPSPEC)


def _par_inputs(Bn=8, Tn=6, seed=0):
    rng = np.random.default_rng(seed)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.1 * rng.standard_normal((Bn, 4)))
    u0s = 0.3 * rng.standard_normal((Bn, Tn, 1))
    params = np.stack([rng.uniform(0.25, 0.55, Bn),
                       rng.uniform(0.5, 1.5, Bn)], axis=1)
    return (x0s.astype(np.float32), u0s.astype(np.float32),
            params.astype(np.float32))


def _flat(d):
    out = []

    def walk(k, v):
        if isinstance(v, (list, tuple)):
            for w in v:
                walk(k, w)
        else:
            out.append((k, np.broadcast_to(np.asarray(v), (B,))))

    for k in sorted(d):
        walk(k, d[k])
    return out


def test_param_autodiff_tiles_match_jax():
    """pendcart_lanes_param's autodiff tiles with per-scenario [l, d]: the
    port's (torch.func, what the lowered Autodiff<Lowered> is held to on the
    card) against JAX's, on the same f32 inputs; 1e-6 relative."""
    rng = np.random.default_rng(1)
    x = (np.array([np.pi - 0.6, 0, 0, 0])[:, None]
         + rng.standard_normal((4, B))).astype(np.float32)
    u = rng.standard_normal((1, B)).astype(np.float32)
    par = np.stack([rng.uniform(0.25, 0.55, B),
                    rng.uniform(0.5, 1.5, B)]).astype(np.float32)
    tiles = autodiff_derivs_tiles(bare(tpc.pendcart_lanes_param(PSPEC)))
    assert tiles.n_params == 2 and tiles.device.lanes is not None
    out = tiles([torch.from_numpy(v) for v in x],
                [torch.from_numpy(v) for v in u], 0,
                [torch.from_numpy(v) for v in par])
    ref = jax_autodiff_tiles(jpc.pendcart_lanes_param(JPSPEC))(
        [jnp.asarray(v) for v in x], [jnp.asarray(v) for v in u], 0,
        [jnp.asarray(v) for v in par])
    got, want = _flat(out), _flat(ref)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=k)


PB, PT = 8, 6
PCFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                    max_iter=3, iter_cap=5)


def test_param_fleet_with_autodiff_tiles_matches_jax():
    """The heterogeneous pendcart (per-scenario [l, d]) solved with autodiff
    tiles and params, against JAX's fleet with its autodiff tiles: costs
    within 1e-5, reasons and accepted counts equal (every lane ends at the
    3-iteration budget, above the f32 noise floor)."""
    x0s, u0s, params = _par_inputs(PB, PT)
    jm = jpc.pendcart_lanes_param(JPSPEC)
    ref = convert.result_to_numpy(J.ilqg_batch_lanes(
        jm, None, jnp.asarray(x0s), jnp.asarray(u0s), lims=((-5.0, 5.0),),
        cfg=PCFG, derivs_tiles=jax_autodiff_tiles(jm),
        params=jnp.asarray(params), kt_backward=2, kt_forward=2,
        interpret=True))
    tm = bare(tpc.pendcart_lanes_param(PSPEC))
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tm, None, torch.from_numpy(x0s), torch.from_numpy(u0s),
        lims=((-5.0, 5.0),), cfg=convert.config_from_jax(PCFG),
        derivs_tiles=autodiff_derivs_tiles(tm),
        params=torch.from_numpy(params)))
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-5)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert (out["n_accepted"] >= 1).all()
    np.testing.assert_allclose(out["x"], ref["x"], rtol=1e-4, atol=1e-5)


