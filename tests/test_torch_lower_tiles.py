"""The lowering of a user's derivative tiles (``ops/hopper/lower.py``
``lower_tiles``, the struct ``LoweredTiles``) on the CPU.

On CUDA tensors, K1 runs a ``DerivsTiles`` without a descriptor as its own
analytic expansion: the tiles function traced with ``make_fx`` and emitted
as ``derivs`` (``derivs_so`` and ``vh`` for second-order tiles) with the
accessors of ``csrc/common.cuh``. Here:

- the emitted source: constant entries in the descriptor, ``zeros_like``
  entries as the literal 0 (the accessors' default), the rest in the
  step's Derivs; the digest follows the structure, not the constants;
- the lowering interpreted with torch equals the tiles bit for bit, and
  the struct compiled with the host's ``g++`` (``-ffp-contract=off``)
  equals them bit for bit where they hold additions and products only
  (LTI), within 1e-6 relative where sin/cos enter (glibc's against
  PyTorch's), second order (the V′ contraction) and params included;
- what raises, naming what is missing, before any library is touched;
- the tiles-lti and tiles-so paths on CPU tensors: a user's tiles with no
  descriptor solve as the hand-written ones do, bit for bit.
"""
import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    _build, backward_kernel as bk, lower)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
    import DerivsTiles
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import LanesModel
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, default_alphas)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "tools_torch"))
import tracking  # noqa: E402

B = 64
FIRST = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")


def user(tiles, n_params=0):
    """A user's tiles: the function alone, no device descriptor."""
    return DerivsTiles(fn=tiles.fn if isinstance(tiles, DerivsTiles)
                       else tiles, n_params=n_params)


def _lti_spec(seed=0, n=10, m=2, zero=None):
    spec = tl.random_lti(seed, n=n, m=m, T=8, device="cpu")
    if zero is not None:
        Bm = spec.B.clone()
        Bm[zero] = 0.0
        spec = spec._replace(B=Bm)
    return spec


def _track():
    spec = _lti_spec(1, n=4, m=2)
    _, tiles = tracking.lti_track(torch, LanesModel, spec.A, spec.B,
                                  spec.Q, spec.R, 0.05)
    return user(tiles)


# name -> (tiles, n, m, exact: additions and products only)
CASES = {
    "lti": (lambda: user(tl.lti_derivs_tiles(_lti_spec())), 10, 2, True),
    "pendcart": (lambda: user(tpc.pendcart_derivs_tiles(
        tpc.PendCartSpec())), 4, 1, False),
    "pendcart_so": (lambda: user(tpc.pendcart_derivs_tiles_so(
        tpc.PendCartSpec())), 4, 1, False),
    "pendcart_param": (lambda: user(tpc.pendcart_derivs_tiles_param(
        tpc.PendCartSpec()), n_params=2), 4, 1, False),
    "lti_track": (_track, 4, 2, False),
}


def _inputs(n, m, P, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, B)).astype(np.float32)
    u = (1.0 + rng.standard_normal((m, B))).astype(np.float32)
    par = np.stack([rng.uniform(0.25, 0.55, B), rng.uniform(0.5, 1.5, B)]
                   )[:P].astype(np.float32)
    V = rng.standard_normal((n, B)).astype(np.float32)
    return x, u, par, V


def _rows(a):
    return [torch.from_numpy(np.ascontiguousarray(r)) for r in a]


def _entries(d, fields):
    """Every entry of ``fields`` row-major, broadcast to (B,)."""
    def flat(v):
        return ([e for w in v for e in flat(w)]
                if isinstance(v, (list, tuple)) else [v])
    return [torch.as_tensor(e, dtype=torch.float32).expand(B)
            for f in fields for e in flat(d[f])]


def _vh(d, V, n, m):
    """Σ_a V[a]·∂²f_a over x×x, x×u, u×u, a from 0 (K1's plain order)."""
    Vt = [torch.from_numpy(v) for v in V]
    out = []

    def contract(get):
        s = Vt[0] * get(0)
        for a in range(1, n):
            s = s + Vt[a] * get(a)
        return s.expand(B)

    for i in range(n):
        for j in range(n):
            out.append(contract(lambda a: d["fxx"][a][i][j]))
    for i in range(n):
        for mi in range(m):
            out.append(contract(lambda a: d["fxu"][a][i][mi]))
    for mi in range(m):
        for mj in range(m):
            out.append(contract(lambda a: d["fuu"][a][mi][mj]))
    return out


def test_tiles_emitted_source():
    """LTI tiles: fx, fu, cxx, cuu are constants (descriptor reads), the
    zero cxu and off-diagonal Q entries literal zeros (no case of their
    accessors' switch), cx and cu the step's Derivs; the descriptor holds
    only what the struct reads. Another spec of the same zero pattern
    emits the same source; a zero in B emits another."""
    lt = lower.lower_tiles(CASES["lti"][0](), 10, 2)
    src = lt.struct()
    assert not lt.second_order and lt.fields == FIRST
    kinds = {f: {k for k, _ in lt.entries[f]} for f in FIRST}
    assert kinds["fx"] == kinds["fu"] == {"k"}
    assert kinds["cxu"] == {"lit"} and kinds["cxx"] == {"k", "lit"}
    assert kinds["cx"] == kinds["cu"] == {"d"}
    # A (100), B (20), the diagonals of Q and R twice (cx = Q·x and cxx)
    assert lt.consts.size == 100 + 20 + 2 * (10 + 2)
    assert "float v[12];" in src and "derivs_so" not in src
    cxu = src[src.index("float cxu("):src.index("float cuu(")]
    assert "case" not in cxu and "default: return 0.0f;" in cxu
    other = lower.lower_tiles(user(tl.lti_derivs_tiles(_lti_spec(3))), 10,
                              2)
    assert other.struct() == src
    assert not np.array_equal(other.consts, lt.consts)
    sparse = lower.lower_tiles(user(tl.lti_derivs_tiles(_lti_spec(
        0, zero=(3, 1)))), 10, 2)
    assert sparse.struct() != src and sparse.consts.size == lt.consts.size - 1

    def path(low, group):
        return _build._lowered_path(_build.lowered_source(low.struct(),
                                                          group))

    assert path(lt, "t1") == path(other, "t1") != path(lt, "t1_gps")
    so = lower.lower_tiles(CASES["pendcart_so"][0](), 4, 1)
    assert so.second_order and "derivs_so" in so.struct()


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_interpret_equals_fn(name):
    make, n, m, _ = CASES[name]
    tiles = make()
    lt = lower.lower_tiles(tiles, n, m)
    x, u, par, _ = _inputs(n, m, tiles.n_params)
    t = torch.tensor(5, dtype=torch.int32)
    pa = (_rows(par),) if tiles.n_params else ()
    ref = tiles(_rows(x), _rows(u), t, *pa)
    got = lt.interpret(_rows(x), _rows(u), t, *pa)
    for a, b in zip(_entries(got, lt.fields), _entries(ref, lt.fields)):
        assert torch.equal(a, b), name


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs the host's g++ to compile the emitted struct")
    return gxx


HARNESS = """
#include <math.h>
#define __device__
#define __forceinline__ inline
namespace ddp {
%(struct)s
}
using ddp::LoweredTiles;
constexpr int N = LoweredTiles::N, M = LoweredTiles::M;
constexpr int P = LoweredTiles::N_PARAMS;
// per lane: every accessor's entries in DerivLayout order, then (second
// order) vh over x×x, x×u, u×u
extern "C" void tiles(const float* c, const float* par, const float* x,
                      const float* u, const float* V, int B, int t,
                      int S, float* out) {
  LoweredTiles::Consts mc;
  for (int i = 0; i < LoweredTiles::N_CONSTS; ++i) mc.c[i] = c[i];
  for (int b = 0; b < B; ++b) {
    %(make)s
    float xb[N], ub[M], vb[N];
    for (int i = 0; i < N; ++i) { xb[i] = x[i * B + b]; vb[i] = V[i * B + b]; }
    for (int i = 0; i < M; ++i) ub[i] = u[i * B + b];
    LoweredTiles::Derivs d;
    %(derivs)s;
    float* o = out + (size_t)b * S;
    for (int i = 0; i < N; ++i) for (int j = 0; j < N; ++j) *o++ = L.fx(d, i, j);
    for (int i = 0; i < N; ++i) for (int j = 0; j < M; ++j) *o++ = L.fu(d, i, j);
    for (int i = 0; i < N; ++i) *o++ = L.cx(d, i);
    for (int i = 0; i < M; ++i) *o++ = L.cu(d, i);
    for (int i = 0; i < N; ++i) for (int j = 0; j < N; ++j) *o++ = L.cxx(d, i, j);
    for (int i = 0; i < N; ++i) for (int j = 0; j < M; ++j) *o++ = L.cxu(d, i, j);
    for (int i = 0; i < M; ++i) for (int j = 0; j < M; ++j) *o++ = L.cuu(d, i, j);
    %(vh)s
  }
}
"""

VH = """
    for (int i = 0; i < N; ++i) for (int j = 0; j < N; ++j) *o++ = L.vh(d, i, j);
    for (int i = 0; i < N; ++i) for (int j = 0; j < M; ++j) *o++ = L.vh(d, i, N + j);
    for (int i = 0; i < M; ++i) for (int j = 0; j < M; ++j) *o++ = L.vh(d, N + i, N + j);
"""


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_struct_compiles_and_matches_fn(tmp_path, name):
    make, n, m, exact = CASES[name]
    tiles = make()
    lt = lower.lower_tiles(tiles, n, m)
    P = tiles.n_params
    make_l = ("float pb[P]; for (int p = 0; p < P; ++p) pb[p] = "
              "par[p * B + b]; LoweredTiles L(mc, pb);" if P
              else "LoweredTiles L(mc);")
    derivs = ("L.derivs_so(xb, ub, t, vb, d)" if lt.second_order
              else "L.derivs(xb, ub, t, d)")
    src = tmp_path / f"{name}.cpp"
    src.write_text(HARNESS % dict(struct=lt.struct(), make=make_l,
                                  derivs=derivs,
                                  vh=VH if lt.second_order else ""))
    so = tmp_path / f"{name}.so"
    r = subprocess.run([_gxx(), "-std=c++17", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    x, u, par, V = _inputs(n, m, P, seed=1)
    t = 5
    pa = (_rows(par),) if P else ()
    d = tiles(_rows(x), _rows(u), torch.tensor(t, dtype=torch.int32), *pa)
    ref = _entries(d, FIRST) + (_vh(d, V, n, m) if lt.second_order else [])
    ref = np.stack([r.numpy() for r in ref], axis=1)
    out = np.zeros_like(ref)
    fp = ctypes.POINTER(ctypes.c_float)
    keep = [np.ascontiguousarray(a, np.float32) for a in (
        lt.consts, par if par.size else np.zeros(1), x, u, V)]
    lib.tiles(*[a.ctypes.data_as(fp) for a in keep], ctypes.c_int(B),
              ctypes.c_int(t), ctypes.c_int(ref.shape[1]),
              out.ctypes.data_as(fp))
    if exact:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    assert np.abs(out).max() > 0


def test_tiles_that_cannot_lower_raise():
    """Missing fields, only some of fxx/fxu/fuu, a float entry and an op
    outside the set raise NotImplementedError naming what is missing."""
    base = tl.lti_derivs_tiles(_lti_spec(n=4, m=1)).fn

    def drop(x, u, t):
        d = base(x, u, t)
        del d["cuu"]
        return d

    def partial(x, u, t):
        return dict(base(x, u, t), fxx=[[[x[0]] * 4] * 4] * 4)

    def number(x, u, t):
        return dict(base(x, u, t), cuu=[[0.1]])

    def outside(x, u, t):
        d = base(x, u, t)
        d["cx"][0] = torch.atan2(x[0], x[1])
        return d

    for fn, what in ((drop, r"K1 needs.*cuu"), (partial, r"all of.*fxu"),
                     (number, r"entry 0 of cuu is float"),
                     (outside, r"tiles.*atan2")):
        with pytest.raises(NotImplementedError, match=what):
            lower.lower_tiles(user(fn), 4, 1)


def test_tiles_dispatch_raises_what_has_no_instance():
    """On a device that is not the CPU (here the meta device, which needs
    no card), a user's tiles lower before any library is touched: GPS
    "gains", first or second order, has no LoweredTiles instance and raises
    naming the table; a built instance, second order in GPS mode ("full",
    "policy") among them, reaches the launch (which refuses meta
    tensors)."""
    T, Bm = 4, 8
    meta = dict(device="meta")
    traj = torch.zeros((T, 5, Bm), **meta)
    lam = torch.zeros((Bm,), **meta)
    prev = torch.zeros((T, 1 + 4 + 1, Bm), **meta)
    eta = torch.ones((T, Bm), **meta)
    first = CASES["pendcart"][0]()
    second = CASES["pendcart_so"][0]()
    with pytest.raises(NotImplementedError,
                       match=r"user's lowered tiles' K1 \(first-order, "
                             r"in GPS mode\) has no emit='gains'"):
        bk.backward_lanes(traj, lam, n=4, m=1, derivs_tiles=first,
                          prev=prev, eta=eta, emit="gains")
    with pytest.raises(NotImplementedError, match=r"second-order.*in GPS"):
        bk.backward_lanes(traj, lam, n=4, m=1, derivs_tiles=second,
                          prev=prev, eta=eta, emit="gains")
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        bk.backward_lanes(traj, lam, n=4, m=1, derivs_tiles=first,
                          emit="gains")
    # second order in GPS mode ("full", "policy") has its group, t1_so_gps
    for emit in ("full", "policy"):
        with pytest.raises(ValueError, match="no kernel for tensors on meta"):
            bk.backward_lanes(traj, lam, n=4, m=1, derivs_tiles=second,
                              prev=prev, eta=eta, emit=emit)


# ---------------------------------------------------------------------------
# the tiles-lti and tiles-so paths on CPU tensors
# ---------------------------------------------------------------------------

def bare(model):
    return dataclasses.replace(model, device=None)


def test_tiles_lti_solve_is_the_hand_written():
    """The LTI fleet (n=10, m=2, ±0.6) with a Python-only model and the
    user's tiles (the hand-written function, no descriptor) solves as the
    hand-written LTI does, bit for bit: on CPU tensors both run the plain
    versions on the same functions."""
    spec = _lti_spec(2)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=3, iter_cap=4)
    rng = np.random.default_rng(5)
    x0s = torch.tensor(rng.standard_normal((4, 10)), dtype=torch.float32)
    u0s = torch.tensor(0.1 * rng.standard_normal((4, 6, 2)),
                       dtype=torch.float32)
    lims = ((-0.6, 0.6),) * 2
    hand = ilqg_batch_lanes(tl.lti_lanes(spec), None, x0s, u0s, lims=lims,
                            cfg=cfg, derivs_tiles=tl.lti_derivs_tiles(spec))
    mine = ilqg_batch_lanes(bare(tl.lti_lanes(spec)), None, x0s, u0s,
                            lims=lims, cfg=cfg,
                            derivs_tiles=user(tl.lti_derivs_tiles(spec)))
    for name in ("cost_total", "reason", "n_accepted", "u"):
        assert torch.equal(getattr(hand, name), getattr(mine, name)), name
    assert torch.equal(hand.policy.K, mine.policy.K)


def test_tiles_so_solve_is_the_hand_written():
    """Full DDP on the pendcart with the user's second-order tiles (no
    descriptor) against PendCartSO's descriptor, bit for bit on CPU
    tensors."""
    spec = tpc.PendCartSpec()
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     lam_max=1e15, max_iter=3, iter_cap=4)
    rng = np.random.default_rng(6)
    x0s = (tpc.default_x0(device="cpu")[None, :]
           + torch.tensor(0.2 * rng.standard_normal((4, 4)),
                          dtype=torch.float32))
    u0s = torch.zeros((4, 6, 1))
    model = tpc.pendcart_lanes(spec)
    hand = ilqg_batch_lanes(model, None, x0s, u0s, lims=((-5.0, 5.0),),
                            cfg=cfg,
                            derivs_tiles=tpc.pendcart_derivs_tiles_so(spec))
    mine = ilqg_batch_lanes(
        bare(model), None, x0s, u0s, lims=((-5.0, 5.0),), cfg=cfg,
        derivs_tiles=user(tpc.pendcart_derivs_tiles_so(spec)))
    for name in ("cost_total", "reason", "n_accepted", "u"):
        assert torch.equal(getattr(hand, name), getattr(mine, name)), name
    assert torch.equal(hand.policy.K, mine.policy.K)
