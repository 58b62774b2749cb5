"""Every public derivative source through the fleet iLQG and KL entries.

K1's CUDA instances now cover every derivative source a public entry can
pass, in the modes the entries launch (``"gains"`` and ``"full"`` without
GPS mode for ``ilqg_batch_lanes``, GPS ``"policy"`` for
``ilqgkl_batch_lanes``): ``Autodiff<LTI>`` at ⟨10,2⟩ and ⟨10,3⟩,
``Autodiff<PendCartParam>``, the pendcart's autodiff and full-DDP tiles in
GPS mode, the quadrotor's full-DDP tiles in GPS mode, and the lowered
models' and a user's second-order tiles in GPS mode. Here, on the CPU:

- the dispatch on the meta device (no card needed): every such
  combination reaches the kernel launch ("no kernel for tensors on
  meta"), and the modes still left out raise NotImplementedError naming
  themselves before anything is lowered, built or launched;
- the plain twin of ``Autodiff<LTI>``'s zero-skipping: the port's
  ``autodiff_derivs_tiles(lti_lanes(spec))`` equals ``lti_derivs_tiles``
  bit for bit, first and second order; and ``Autodiff<LTI, true>`` and
  ``Autodiff<PendCartParam, true>`` compiled for the host against the
  plain autodiff tiles;
- the paths against the JAX package: KL on the pendcart with autodiff
  tiles and with ``pendcart_derivs_tiles_so`` and the heterogeneous fleet
  with autodiff ``PendCartParam`` tiles, JAX in interpret mode at B ≤ 8,
  T ≤ 10, k_t = 2; iLQG and KL on the LTI ⟨10,2⟩ through
  ``autodiff_derivs_tiles``, held to JAX's XLA tier (its generic solvers
  vmapped over the lanes), since an interpret-mode trace at n=10 takes
  minutes here.

Tolerances: costs within 1e-4 relative, exit reasons and accepted counts
equal; for KL the outcomes of ``test_torch_kl.check_outcomes`` (satisfied,
pd_failed, done and iterations equal; cost, η and the KL within 1e-4).
Each JAX call structure is traced once.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles as jax_autodiff_tiles)
from differentialdynamicprogramming_jl_tpu.policy import (
    GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers import batch_kl as jkl
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import ilqg as jax_ilqg
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ILQGKLConfig as JKLConfig, ilqg_kl as jax_ilqg_kl)
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.models import pendcart as tpc
from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor as tq
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    backward_kernel as bk, forward_kernel as fk)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
    import autodiff_derivs_tiles
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import LanesModel
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    _flat, from_streams, to_streams)
from differentialdynamicprogramming_jl_tpu_torch.solvers import batch_kl as tkl
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

from test_torch_kl import check_outcomes, kl_inputs
from test_torch_lower import CSRC, _compile, _shim

JSPEC = jpc.PendCartSpec()
SPEC = convert.spec_from_jax(JSPEC)
META = dict(device="meta")


# ---------------------------------------------------------------------------
# the dispatch on the meta device
# ---------------------------------------------------------------------------

def _lti(m, so=False, n=10):
    spec = tl.random_lti(0, n=n, m=m, T=8, device="cpu")
    return autodiff_derivs_tiles(tl.lti_lanes(spec), second_order=so), n, m


def _user_so_tiles():
    """A user's second-order tiles without a descriptor (the pendcart's
    analytic full-DDP expansion as a plain function)."""
    so = tpc.pendcart_derivs_tiles_so(SPEC)
    return bk.DerivsTiles(fn=so.fn), 4, 1


def _lowered_so():
    """Second-order autodiff tiles of a model without a descriptor."""
    lanes = tpc.pendcart_lanes(SPEC)
    bare = LanesModel(n=4, m=1, dynamics=lanes.dynamics, cost=lanes.cost,
                      terminal=lanes.terminal)
    return autodiff_derivs_tiles(bare, second_order=True), 4, 1


SOURCES = {
    "lti_ad_10_2": lambda: _lti(2),
    "lti_ad_10_3": lambda: _lti(3),
    "lti_ad_so_10_2": lambda: _lti(2, True),
    "lti_ad_so_10_3": lambda: _lti(3, True),
    "pendcart_ad": lambda: (autodiff_derivs_tiles(tpc.pendcart_lanes(SPEC)),
                            4, 1),
    "pendcart_ad_so": lambda: (autodiff_derivs_tiles(
        tpc.pendcart_lanes(SPEC), second_order=True), 4, 1),
    "pendcart_so": lambda: (tpc.pendcart_derivs_tiles_so(SPEC), 4, 1),
    "quad_ad_so": lambda: (autodiff_derivs_tiles(
        tq.quadrotor_lanes(tq.QuadrotorSpec()), second_order=True), 6, 2),
    "param_ad": lambda: (autodiff_derivs_tiles(
        tpc.pendcart_lanes_param(SPEC)), 4, 1),
    "param_ad_so": lambda: (autodiff_derivs_tiles(
        tpc.pendcart_lanes_param(SPEC), second_order=True), 4, 1),
    "lowered_so": _lowered_so,
    "user_so": _user_so_tiles,
}
# (source, emission, GPS mode): every row and mode of the public entries
RUNS = ([(s, e, False) for s in SOURCES for e in ("gains", "full")
         if s not in ("lowered_so", "user_so")]
        + [(s, "policy", True) for s in SOURCES
           if not s.startswith("param")]
        + [("lowered_so", "full", True), ("user_so", "full", True)])


def _meta_call(tiles, n, m, emit, gps):
    """backward_lanes on meta tensors: T=6, B=8, per-scenario parameters
    where the tiles take them."""
    T, Bm = 6, 8
    kw = {}
    if gps:
        kw = dict(prev=torch.zeros((T, m + m * n + m * m, Bm), **META),
                  eta=torch.ones((T, Bm), **META))
    if tiles.n_params:
        kw["params"] = torch.ones((tiles.n_params, Bm), **META)
    return bk.backward_lanes(
        torch.zeros((T, n + m + 1, Bm), **META), torch.zeros(Bm, **META),
        n=n, m=m, reg_type=2, lims=((-0.6, 0.6),) * m,
        derivs_tiles=tiles, emit=emit, **kw)


@pytest.mark.parametrize("source,emit,gps", RUNS,
                         ids=[f"{s}-{e}{'-gps' if g else ''}"
                              for s, e, g in RUNS])
def test_every_source_reaches_its_instance(source, emit, gps):
    """Each public derivative source, in each mode its entry launches,
    resolves to a CUDA instance: the wrapper gets as far as the kernel
    launch, which refuses meta tensors, and raises no
    NotImplementedError."""
    tiles, n, m = SOURCES[source]()
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        _meta_call(tiles, n, m, emit, gps)


def test_instance_tables_hold_the_entries_modes():
    """The tables list each new instance in the entries' modes."""
    for key in ((2, 10, 2, True), (2, 10, 3, True)):
        for table in (bk.CUDA_BACKWARD, bk.CUDA_BACKWARD_SO):
            assert table[key + (False,)] == ("gains", "full")
            assert table[key + (True,)] == ("policy",)
    assert bk.CUDA_BACKWARD[1, 4, 1, True, True] == ("policy",)
    assert bk.CUDA_BACKWARD[4, 4, 1, True, False] == ("gains", "full")
    assert bk.CUDA_BACKWARD_SO[4, 4, 1, True, False] == ("gains", "full")
    for key in ((1, 4, 1, False), (1, 4, 1, True), (3, 6, 2, True)):
        assert bk.CUDA_BACKWARD_SO[key + (True,)] == ("policy",)
    # the heaviest are the sources library's, built at their first launch
    for so, key in bk.SOURCE_LIBRARY_K1:
        assert key in (bk.CUDA_BACKWARD_SO if so else bk.CUDA_BACKWARD)
    assert (False, (2, 10, 2, True, False)) in bk.SOURCE_LIBRARY_K1
    assert (True, (3, 6, 2, True, True)) in bk.SOURCE_LIBRARY_K1
    assert bk.LOWERED_K1[True, True] == {"full": "k1_so_gps",
                                         "policy": "k1_so_gps"}
    assert bk.LOWERED_TILES_K1[True, True] == {"full": "t1_so_gps",
                                               "policy": "t1_so_gps"}


def _packed(n, m):
    return None, n, m


# (what, source, emission, GPS mode, the message's pattern): the modes no
# public entry launches, and second order where K1 takes its wide design
LEFT_OUT = [
    ("lti_ad GPS gains", lambda: _lti(2), "gains", True,
     r"autodiff first-order derivatives, in GPS mode, emit='gains'"),
    ("lti_ad policy", lambda: _lti(2), "policy", False,
     r"autodiff first-order derivatives, without GPS mode, emit='policy'"),
    ("lti_ad_so GPS full", lambda: _lti(3, True), "full", True,
     r"autodiff second-order derivatives, in GPS mode, emit='full'"),
    ("pendcart_so policy", lambda: (tpc.pendcart_derivs_tiles_so(SPEC), 4, 1),
     "policy", False,
     r"analytic second-order derivatives, without GPS mode, emit='policy'"),
    ("param_ad GPS policy", lambda: (autodiff_derivs_tiles(
        tpc.pendcart_lanes_param(SPEC)), 4, 1), "policy", True,
     r"model id 4 .* in GPS mode, emit='policy'"),
    ("quad_ad GPS gains", lambda: (autodiff_derivs_tiles(
        tq.quadrotor_lanes(tq.QuadrotorSpec())), 6, 2), "gains", True,
     r"in GPS mode, emit='gains'"),
    ("lowered_so GPS gains", _lowered_so, "gains", True,
     r"lowered model's K1 \(second-order, in GPS mode\) has no "
     r"emit='gains'"),
    ("user_so GPS gains", _user_so_tiles, "gains", True,
     r"user's lowered tiles' K1 \(second-order, in GPS mode\) has no "
     r"emit='gains'"),
    ("packed <6,2> GPS full", lambda: _packed(6, 2), "full", True,
     r"packed-derivatives stream at n=6, m=2 .* not in GPS mode, "
     r"emit='full'"),
    ("packed <4,1> policy", lambda: _packed(4, 1), "policy", False,
     r"packed-derivatives stream at n=4, m=1, without GPS mode, "
     r"emit='policy'"),
    ("wide second order", lambda: _lti(2, True, n=30), "full", False,
     r"second-order tiles \(full DDP\) at n=30, m=2"),
]


@pytest.mark.parametrize("what,make,emit,gps,pattern", LEFT_OUT,
                         ids=[c[0] for c in LEFT_OUT])
def test_left_out_modes_still_raise(what, make, emit, gps, pattern):
    """The modes only direct calls reach, and second order in the wide
    design, still raise NotImplementedError naming the mode, on meta
    tensors: before any lowering, build or launch."""
    tiles, n, m = make()
    if tiles is None:
        D = bk.InLayout(n, m).DU
        T, Bm = 6, 8
        kw = (dict(prev=torch.zeros((T, m + m * n + m * m, Bm), **META),
                   eta=torch.ones((T, Bm), **META)) if gps else {})
        with pytest.raises(NotImplementedError, match=pattern):
            bk.backward_lanes(torch.zeros((T, D, Bm), **META),
                              torch.zeros(Bm, **META), n=n, m=m,
                              derivs_tiles=None, emit=emit, **kw)
        return
    with pytest.raises(NotImplementedError, match=pattern):
        _meta_call(tiles, n, m, emit, gps)


# ---------------------------------------------------------------------------
# the plain twin of Autodiff<LTI>, and the new bodies on the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 3])
def test_autodiff_lti_tiles_are_the_analytic_ones(m):
    """``autodiff_derivs_tiles(lti_lanes(spec))`` gives
    ``lti_derivs_tiles(spec)``'s expansion bit for bit (the int32 view: the
    signs of zeros too), first and second order, the dynamics Hessians of
    the second order all +0: the zero-skipping rule carried into the
    tangents, which Autodiff<LTI> applies in K1."""
    spec = tl.random_lti(0, n=10, m=m, T=8, device="cpu")
    rng = np.random.default_rng(m)
    x = [torch.from_numpy((3.0 * rng.standard_normal(16)).astype(np.float32))
         for _ in range(10)]
    u = [torch.from_numpy(rng.standard_normal(16).astype(np.float32))
         for _ in range(m)]
    t = torch.tensor(3, dtype=torch.int32)
    ref = tl.lti_derivs_tiles(spec)(x, u, t)

    def flat(v):
        return torch.stack([torch.broadcast_to(e, (16,)) for e in _flat(v)])

    for so in (False, True):
        got = autodiff_derivs_tiles(tl.lti_lanes(spec), second_order=so)(
            x, u, t)
        for f in ref:
            assert torch.equal(flat(got[f]).view(torch.int32),
                               flat(ref[f]).view(torch.int32)), (f, so)
        if so:
            for f in ("fxx", "fxu", "fuu"):
                assert (flat(got[f]).view(torch.int32) == 0).all(), f


HOST_HARNESS = """
#include "autodiff.cuh"
#include "lti.cuh"
#include "pendcart.cuh"
using namespace ddp;
using AD = Autodiff<%(body)s, true>;
constexpr int N = AD::N, M = AD::M, NH = AD::NH, P = AD::N_PARAMS;
// per lane: fx, fu, cx, cu, the cost Hessian and Σ_a V[a]·∂²f_a (upper
// triangles), as K1 reads them
extern "C" void derivs(const float* c, const float* par, const float* x,
                       const float* u, const float* V, int B, float* out) {
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
  }
}
"""

HB = 32


def _host_and_plain(tmp_path, name, body, model, x, u, par, V):
    """Autodiff<body, true>'s expansion compiled for the host (rolled
    passes and all), and the same fields from the plain autodiff tiles,
    each (B, S)."""
    make = ("float pb[P]; for (int p = 0; p < P; ++p) pb[p] = par[p * B + "
            "b]; AD A(mc, pb);" if par.size else "AD A(mc);")
    lib = _compile(tmp_path, name, HOST_HARNESS % dict(body=body, make=make),
                   includes=(_shim(tmp_path), CSRC))
    n, m = model.n, model.m
    nm = n + m
    pairs = [(i, j) for i in range(nm) for j in range(i, nm)]
    out = np.zeros((HB, n * n + n * m + nm + 2 * len(pairs)), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    keep = [np.ascontiguousarray(a, np.float32) for a in (
        model.device.consts, par if par.size else np.zeros(1), x, u, V)]
    lib.derivs(*[a.ctypes.data_as(fp) for a in keep], ctypes.c_int(HB),
               out.ctypes.data_as(fp))

    def rows(a):
        return [torch.from_numpy(r.copy()) for r in a]

    d = autodiff_derivs_tiles(model, second_order=True)(
        rows(x), rows(u), torch.tensor(0, dtype=torch.int32),
        *((rows(par),) if par.size else ()))

    def h(f, i, j):
        return (d[f + "xx"][i][j] if j < n else (
            d[f + "xu"][i][j - n] if i < n else d[f + "uu"][i - n][j - n]))

    def hv(i, j):
        # Σ_a V[a]·∂²f_a from a = 0, K1's order
        s = None
        for a in range(n):
            f2 = (d["fxx"][a][i][j] if j < n else (
                d["fxu"][a][i][j - n] if i < n
                else d["fuu"][a][i - n][j - n]))
            term = torch.from_numpy(V[a]) * f2
            s = term if s is None else s + term
        return s

    ref = ([d["fx"][i][j] for i in range(n) for j in range(n)]
           + [d["fu"][i][j] for i in range(n) for j in range(m)]
           + list(d["cx"]) + list(d["cu"])
           + [h("c", i, j) for i, j in pairs] + [hv(i, j) for i, j in pairs])
    return out, np.stack([torch.broadcast_to(r, (HB,)).numpy() for r in ref],
                         axis=1)


def test_host_autodiff_lti_matches_plain_tiles(tmp_path):
    """Autodiff<LTI<10, 2>, true> (rolled passes, the zero-skipping rule on
    Dual and Jet) compiled for the host equals the plain autodiff tiles of
    ``lti_lanes`` bit for bit: fx, fu, cx, cu, the cost Hessian and the
    V′-contraction of the (zero) dynamics Hessians."""
    spec = tl.random_lti(0, n=10, m=2, T=8, device="cpu")
    model = tl.lti_lanes(spec)
    rng = np.random.default_rng(11)
    x = (3.0 * rng.standard_normal((10, HB))).astype(np.float32)
    u = rng.standard_normal((2, HB)).astype(np.float32)
    V = rng.standard_normal((10, HB)).astype(np.float32)
    out, ref = _host_and_plain(tmp_path, "lti_ad", "LTI<10, 2>", model, x, u,
                               np.zeros(0), V)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert np.abs(out).max() > 0


def test_host_autodiff_pendcart_param_matches_plain_tiles(tmp_path):
    """Autodiff<PendCartParam, true> on the host, each lane's [l, d] a
    constant of the passes, against the plain autodiff tiles of
    ``pendcart_lanes_param`` with params: within 1e-5 relative (glibc's
    sinf/cosf against PyTorch's, an ulp)."""
    model = tpc.pendcart_lanes_param(SPEC)
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((4, HB))
         + np.array([[np.pi - 0.6], [0], [0], [0]])).astype(np.float32)
    u = (2.0 * rng.standard_normal((1, HB))).astype(np.float32)
    par = np.stack([rng.uniform(0.25, 0.55, HB),
                    rng.uniform(0.5, 1.5, HB)]).astype(np.float32)
    V = rng.standard_normal((4, HB)).astype(np.float32)
    out, ref = _host_and_plain(tmp_path, "param_ad", "PendCartParam", model,
                               x, u, par, V)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    assert np.abs(out).max() > 0


# ---------------------------------------------------------------------------
# the paths against the JAX package
# ---------------------------------------------------------------------------

KL_CFG = JKLConfig(kl_step=0.05, max_iter=4)
KL_T = 6


def _kl_both(jtiles, ttiles, inp):
    """KL on the pendcart (``kl_inputs`` at B=8, T=6) with the given tiles
    in both packages; JAX in interpret mode at k_t=2."""
    jprev = JPolicy(**{k: jnp.asarray(v) for k, v in inp["policy"].items()})
    ref = jkl.ilqgkl_batch_lanes(
        jpc.pendcart_lanes(JSPEC), jtiles, jnp.asarray(inp["x"]), jprev,
        jnp.asarray(inp["fx"]), jnp.asarray(inp["cost0"]), cfg=KL_CFG, kt=1,
        interpret=True)
    out = tkl.ilqgkl_batch_lanes(
        tpc.pendcart_lanes(SPEC), ttiles, torch.from_numpy(inp["x"]),
        convert.policy_from_jax(jprev, device="cpu"),
        torch.from_numpy(inp["fx"]), torch.from_numpy(inp["cost0"]),
        cfg=convert.kl_config_from_jax(KL_CFG))
    return convert.result_to_numpy(ref), convert.result_to_numpy(out)


@pytest.mark.parametrize("source", ["autodiff", "full_ddp"])
def test_kl_pendcart_sources_match_jax(source):
    """KL on the pendcart with autodiff tiles (K1 Autodiff<PendCart> GPS
    ``policy`` on the card) and with the full-DDP tiles
    ``pendcart_derivs_tiles_so`` (PendCartSO GPS ``policy``) against
    JAX's ``ilqgkl_batch_lanes`` with the same source: the KL outcomes
    (satisfied, done, iterations equal; cost, η and the KL within 1e-4)
    and the gains."""
    inp = kl_inputs(T=KL_T)
    if source == "autodiff":
        jt = jax_autodiff_tiles(jpc.pendcart_lanes(JSPEC))
        tt = autodiff_derivs_tiles(tpc.pendcart_lanes(SPEC))
    else:
        jt, tt = (jpc.pendcart_derivs_tiles_so(JSPEC),
                  tpc.pendcart_derivs_tiles_so(SPEC))
    ref, out = _kl_both(jt, tt, inp)
    check_outcomes(ref, out)
    assert out["satisfied"].any()
    np.testing.assert_allclose(out["policy"]["K"], ref["policy"]["K"],
                               rtol=1e-4, atol=1e-5)


# the heterogeneous fleet (test_torch_hetero.py's param fleet at B=4, T=6)
PB, PT = 4, 6
PCFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                    max_iter=3, iter_cap=5)


def test_hetero_fleet_autodiff_tiles_match_jax():
    """The heterogeneous fleet (per-scenario [l, d] and limits) with
    autodiff ``PendCartParam`` tiles (K1 Autodiff<PendCartParam> on the
    card) against JAX's with its autodiff tiles of the same model: costs
    within 1e-4 relative, reasons, accepted counts and iterations equal."""
    rng = np.random.default_rng(0)
    x0s = (np.array([np.pi - 0.6, 0, 0, 0])[None, :]
           + 0.1 * rng.standard_normal((PB, 4))).astype(np.float32)
    u0s = (0.3 * rng.standard_normal((PB, PT, 1))).astype(np.float32)
    params = np.stack([rng.uniform(0.25, 0.55, PB),
                       rng.uniform(0.5, 1.5, PB)], axis=1).astype(np.float32)
    h = np.linspace(0.8, 6.0, PB)
    lims = np.stack([-h, h], axis=-1)[:, None, :].astype(np.float32)
    jm = jpc.pendcart_lanes_param(JSPEC)
    ref = convert.result_to_numpy(J.ilqg_batch_lanes(
        jm, None, jnp.asarray(x0s), jnp.asarray(u0s),
        lims=jnp.asarray(lims), cfg=PCFG,
        derivs_tiles=jax_autodiff_tiles(jm), params=jnp.asarray(params),
        kt_backward=1, kt_forward=1, interpret=True))
    tm = tpc.pendcart_lanes_param(SPEC)
    out = convert.result_to_numpy(ilqg_batch_lanes(
        tm, None, torch.from_numpy(x0s), torch.from_numpy(u0s),
        lims=torch.from_numpy(lims), cfg=convert.config_from_jax(PCFG),
        derivs_tiles=autodiff_derivs_tiles(tm),
        params=torch.from_numpy(params)))
    np.testing.assert_allclose(out["cost_total"], ref["cost_total"],
                               rtol=1e-4)
    for name in ("reason", "n_accepted", "n_iters"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert (out["n_accepted"] >= 1).any()


# the LTI ⟨10,2⟩ (random_lti's construction, numpy f64 from a seed)
LB, LT = 4, 8
LCFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                    max_iter=3, iter_cap=4)
LLIMS = ((-0.6, 0.6), (-0.6, 0.6))


def _lti_spec(T, seed=0, n=10, m=2, h=0.01):
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((n, n))
    from scipy.linalg import expm
    f = jnp.float32
    return jl.LTISpec(A=jnp.asarray(expm(h * (Mm - Mm.T)), f),
                      B=jnp.asarray(h * rng.standard_normal((n, m)), f),
                      Q=jnp.asarray(h * np.eye(n), f),
                      R=jnp.asarray(0.1 * h * np.eye(m), f),
                      x0=jnp.ones((n,), f),
                      u0=jnp.asarray(0.1 * rng.standard_normal((T, m)), f))


def test_lti_autodiff_fleet_matches_jax_generic():
    """iLQG on the LTI ⟨10,2⟩ (±0.6) with ``autodiff_derivs_tiles
    (lti_lanes(spec))`` (K1 Autodiff<LTI<10,2>> on the card) against JAX's
    generic ``ilqg`` vmapped over the lanes: costs within 1e-4 relative,
    reasons and accepted counts equal, the trajectory to 1e-4; and bit for
    bit the port's solve with the analytic tiles."""
    spec = _lti_spec(LT)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    x0s = (np.ones((LB, 10)) * np.linspace(0.5, 2.0, LB)[:, None]).astype(
        np.float32)
    u0s = np.tile(30.0 * np.asarray(spec.u0), (LB, 1, 1)).astype(np.float32)
    problem = jl.make_lti_problem(spec, LT)
    jlims = jnp.asarray(LLIMS, jnp.float32)
    ref = jax.vmap(lambda a, b: jax_ilqg(problem, a, b, lims=jlims,
                                         cfg=LCFG))(
        jnp.asarray(x0s), jnp.asarray(u0s))
    lanes = tl.lti_lanes(tspec)
    kw = dict(lims=LLIMS, cfg=convert.config_from_jax(LCFG))
    out = ilqg_batch_lanes(lanes, None, torch.from_numpy(x0s),
                           torch.from_numpy(u0s),
                           derivs_tiles=autodiff_derivs_tiles(lanes), **kw)
    ana = ilqg_batch_lanes(lanes, None, torch.from_numpy(x0s),
                           torch.from_numpy(u0s),
                           derivs_tiles=tl.lti_derivs_tiles(tspec), **kw)
    o = convert.result_to_numpy(out)
    np.testing.assert_allclose(o["cost_total"],
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=1e-4)
    np.testing.assert_array_equal(o["reason"], np.asarray(ref.reason))
    np.testing.assert_array_equal(o["n_accepted"],
                                  np.asarray(ref.n_accepted))
    np.testing.assert_allclose(o["x"], np.asarray(ref.x), rtol=1e-4,
                               atol=1e-5)
    assert (o["n_accepted"] >= 1).all()
    assert np.any(np.abs(o["u"]) == np.float32(0.6))
    for f in ("cost_total", "reason", "n_accepted", "u", "x"):
        assert torch.equal(getattr(out, f), getattr(ana, f)), f


KB, KT = 3, 8


def test_lti_autodiff_kl_matches_jax_generic():
    """KL on the LTI ⟨10,2⟩ (KL-LTI's kl_step 100, no limits) with
    ``autodiff_derivs_tiles(lti_lanes(spec))`` (K1 Autodiff<LTI<10,2>> GPS
    ``policy`` on the card) from the port's plain pre-roll, against JAX's
    generic ``ilqg_kl`` vmapped over the lanes: satisfied equal, cost and η
    within 1e-4 relative; and bit for bit the port's KL with the analytic
    tiles."""
    n, m = 10, 2
    spec = _lti_spec(KT, seed=5)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    rng = np.random.default_rng(0)
    x0 = (np.ones((KB, n)) * np.linspace(0.5, 2.0, KB)[:, None]).astype(
        np.float32)
    u0 = (0.3 * rng.standard_normal((KB, KT, m))).astype(np.float32)
    gains = torch.cat([to_streams(torch.from_numpy(u0)),
                       torch.zeros((KT, m * n, KB))], dim=1)
    lanes = tl.lti_lanes(tspec)
    ro = fk.forward_lanes_ref(torch.zeros((KT, n + m + 1, KB)), gains,
                              torch.from_numpy(x0.T.copy()),
                              torch.ones((1, KB)), model=lanes, lims=None,
                              emit_traj=True)
    eye = np.broadcast_to(np.eye(m, dtype=np.float32), (KB, KT, m, m))
    prev = JPolicy(K=jnp.zeros((KB, KT, m, n), jnp.float32),
                   k=jnp.asarray(from_streams(ro.traj[:, n:n + m],
                                              (m,)).numpy()),
                   sigma=jnp.asarray(eye), sigma_inv=jnp.asarray(eye))
    x = from_streams(ro.traj[:, :n], (n,)).numpy()
    cost = ro.traj[:, n + m].T.contiguous().numpy()
    cfg = JKLConfig(kl_step=100.0, max_iter=4)
    problem = jl.make_lti_problem(spec, KT)
    jm = jl.SimpleLTVModel.from_lti(spec.A, spec.B, KT)
    ref = jax.vmap(lambda a, p, c: jax_ilqg_kl(problem, a, p, jm, c,
                                               cfg=cfg))(
        jnp.asarray(x), prev, jnp.asarray(cost))
    fx = torch.from_numpy(
        np.broadcast_to(np.asarray(spec.A), (KB, KT, n, n)).copy())

    def solve(tiles):
        return tkl.ilqgkl_batch_lanes(
            lanes, tiles, torch.from_numpy(x),
            convert.policy_from_jax(prev, device="cpu"), fx, ro.totals[0],
            cfg=convert.kl_config_from_jax(cfg))

    out = solve(autodiff_derivs_tiles(lanes))
    ana = solve(tl.lti_derivs_tiles(tspec))
    np.testing.assert_array_equal(out.satisfied.numpy(),
                                  np.asarray(ref.satisfied))
    np.testing.assert_allclose(out.cost_total.numpy(),
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=1e-4)
    np.testing.assert_allclose(out.eta.numpy(), np.asarray(ref.eta),
                               rtol=1e-4)
    for f in ("cost_total", "eta", "satisfied", "u", "x"):
        assert torch.equal(getattr(out, f), getattr(ana, f)), f
    assert torch.equal(out.policy.K, ana.policy.K)
