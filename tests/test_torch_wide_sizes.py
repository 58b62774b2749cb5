"""Sizes past K1's lane design (the wide K1) and past K2's and K3's
two-stage ring, on the CPU, against the parent's plans and the JAX
package.

- The plan: every (n, m, emission, GPS mode) of a grid up to ⟨28,16⟩ that
  planned before keeps its launch plan (:data:`PARENT_PLANS`, the values
  the lane design gave at T=500, B=4096); the wide design (``tc == 0``) is
  chosen exactly where the lane design's ring of one stage does not fit,
  for every n ≤ ``plan.MAX_STATES`` and m ≤ ``plan.MAX_CONTROLS``, and no
  K1, K2 or K3 plan raises up to them. Above them every CUDA entry raises
  NotImplementedError naming the ceiling before anything is lowered or
  built (tensors on the meta device, the build and the lowering patched
  to fail if called).
- K1 on CPU tensors (its plain version, which the wide kernel is held to
  bit for bit on the card) at ⟨30,6⟩ and ⟨54,21⟩ against JAX's XLA
  ``backward_pass`` vmapped over the lanes, on the same derivatives.
- The stream the wide K1 reads: the port's ``packed_from_tiles`` of the
  LTI tiles at ⟨54,21⟩ against JAX's ``pack_derivs``, bit for bit.
- The fleet at ⟨30,6⟩ against JAX's generic ``ilqg`` vmapped over the
  lanes.

Inputs are made in numpy f64 from seeded Generators and cast to f32. No
JAX interpret-mode kernel runs here: its trace at these sizes takes
minutes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import linear as jl
from differentialdynamicprogramming_jl_tpu.ops.backward import (
    backward_pass as jax_backward_pass)
from differentialdynamicprogramming_jl_tpu.ops.kl import grad_kl
from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import (
    pack_derivs as jax_pack_derivs)
from differentialdynamicprogramming_jl_tpu.policy import (
    Derivs as JDerivs, GaussianPolicy as JPolicy)
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import ilqg as jax_ilqg
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.models import linear as tl
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
    _build, backward_kernel as bk, forward_kernel as fk, lower, plan)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
    DerivLayout, from_streams, packed_from_tiles, to_streams)
from differentialdynamicprogramming_jl_tpu_torch.policy import Derivs
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    ilqg_batch_lanes)

F32 = np.float32
MODES = (("gains", False), ("full", False), ("policy", False),
         ("full", True), ("policy", True))

# K1's lane-design plans before the wide design (T=500, B=4096): (n, m) ->
# (threads / 32, tc, stages, shared bytes), per (emission, GPS mode)
PARENT_PLANS = {
    ("gains", False): {
        (1, 1): (2, 32, 2, 16384), (1, 2): (2, 32, 2, 24576),
        (1, 4): (2, 32, 2, 40960), (1, 5): (2, 32, 2, 49152),
        (1, 8): (2, 16, 2, 36864), (1, 16): (2, 8, 2, 34816),
        (4, 1): (2, 32, 2, 40960), (4, 2): (2, 32, 2, 49152),
        (4, 4): (2, 16, 2, 32768), (4, 5): (2, 16, 2, 36864),
        (4, 8): (2, 16, 2, 49152), (4, 16): (2, 8, 2, 40960),
        (8, 1): (2, 16, 2, 36864), (8, 2): (2, 16, 2, 40960),
        (8, 4): (2, 16, 2, 49152), (8, 5): (5, 8, 2, 48128),
        (8, 8): (5, 4, 2, 40960), (8, 16): (5, 2, 2, 45056),
        (12, 1): (2, 8, 2, 26624), (12, 2): (2, 8, 2, 28672),
        (12, 4): (2, 8, 2, 32768), (12, 5): (5, 1, 2, 48896),
        (12, 8): (5, 1, 2, 54272), (12, 16): (5, 1, 2, 68608),
        (16, 1): (2, 8, 2, 34816), (16, 2): (2, 8, 2, 36864),
        (16, 4): (2, 8, 2, 40960), (16, 5): (5, 1, 2, 81152),
        (16, 8): (5, 1, 2, 88064), (16, 16): (5, 1, 2, 106496),
        (20, 1): (2, 8, 2, 43008), (20, 2): (2, 8, 2, 45056),
        (20, 4): (2, 8, 2, 49152), (20, 5): (5, 1, 2, 121600),
        (20, 8): (5, 1, 2, 130048), (20, 16): (5, 1, 2, 152576),
        (24, 1): (2, 4, 2, 25600), (24, 2): (2, 4, 2, 26624),
        (24, 4): (2, 4, 2, 28672), (24, 5): (5, 1, 2, 170240),
        (24, 8): (5, 1, 2, 180224), (24, 16): (5, 1, 2, 206848),
        (28, 1): (2, 4, 2, 29696), (28, 2): (2, 4, 2, 30720),
        (28, 4): (2, 4, 2, 32768), (28, 5): (5, 1, 2, 227072),
    },
    ("full", False): {
        (1, 1): (2, 32, 2, 16384), (1, 2): (2, 32, 2, 24576),
        (1, 4): (2, 32, 2, 40960), (1, 5): (2, 32, 2, 49152),
        (1, 8): (2, 16, 2, 36864), (1, 16): (2, 8, 2, 34816),
        (4, 1): (2, 32, 2, 40960), (4, 2): (2, 32, 2, 49152),
        (4, 4): (2, 16, 2, 32768), (4, 5): (2, 16, 2, 36864),
        (4, 8): (2, 16, 2, 49152), (4, 16): (2, 8, 2, 40960),
        (8, 1): (5, 8, 2, 35840), (8, 2): (5, 8, 2, 38912),
        (8, 4): (5, 8, 2, 45056), (8, 5): (5, 8, 2, 48128),
        (8, 8): (5, 4, 2, 40960), (8, 16): (5, 2, 2, 45056),
        (12, 1): (5, 2, 2, 45056), (12, 2): (5, 2, 2, 47104),
        (12, 4): (5, 1, 2, 47104), (12, 5): (5, 1, 2, 48896),
        (12, 8): (5, 1, 2, 54272), (12, 16): (5, 1, 2, 68608),
        (16, 1): (5, 1, 2, 71936), (16, 2): (5, 1, 2, 74240),
        (16, 4): (5, 1, 2, 78848), (16, 5): (5, 1, 2, 81152),
        (16, 8): (5, 1, 2, 88064), (16, 16): (5, 1, 2, 106496),
        (20, 1): (5, 1, 2, 110336), (20, 2): (5, 1, 2, 113152),
        (20, 4): (5, 1, 2, 118784), (20, 5): (5, 1, 2, 121600),
        (20, 8): (5, 1, 2, 130048), (20, 16): (5, 1, 2, 152576),
        (24, 1): (5, 1, 2, 156928), (24, 2): (5, 1, 2, 160256),
        (24, 4): (5, 1, 2, 166912), (24, 5): (5, 1, 2, 170240),
        (24, 8): (5, 1, 2, 180224), (24, 16): (5, 1, 2, 206848),
        (28, 1): (5, 1, 2, 211712), (28, 2): (5, 1, 2, 215552),
        (28, 4): (5, 1, 2, 223232), (28, 5): (5, 1, 2, 227072),
    },
    ("policy", False): {
        (1, 1): (2, 32, 2, 16384), (1, 2): (2, 32, 2, 24576),
        (1, 4): (2, 32, 2, 40960), (1, 5): (2, 32, 2, 49152),
        (1, 8): (2, 16, 2, 36864), (1, 16): (2, 8, 2, 34816),
        (4, 1): (2, 32, 2, 40960), (4, 2): (2, 32, 2, 49152),
        (4, 4): (2, 16, 2, 32768), (4, 5): (2, 16, 2, 36864),
        (4, 8): (2, 16, 2, 49152), (4, 16): (2, 8, 2, 40960),
        (8, 1): (2, 16, 2, 36864), (8, 2): (2, 16, 2, 40960),
        (8, 4): (2, 16, 2, 49152), (8, 5): (5, 8, 2, 48128),
        (8, 8): (5, 4, 2, 40960), (8, 16): (5, 2, 2, 45056),
        (12, 1): (2, 8, 2, 26624), (12, 2): (2, 8, 2, 28672),
        (12, 4): (2, 8, 2, 32768), (12, 5): (5, 1, 2, 48896),
        (12, 8): (5, 1, 2, 54272), (12, 16): (5, 1, 2, 68608),
        (16, 1): (2, 8, 2, 34816), (16, 2): (2, 8, 2, 36864),
        (16, 4): (2, 8, 2, 40960), (16, 5): (5, 1, 2, 81152),
        (16, 8): (5, 1, 2, 88064), (16, 16): (5, 1, 2, 106496),
        (20, 1): (2, 8, 2, 43008), (20, 2): (2, 8, 2, 45056),
        (20, 4): (2, 8, 2, 49152), (20, 5): (5, 1, 2, 121600),
        (20, 8): (5, 1, 2, 130048), (20, 16): (5, 1, 2, 152576),
        (24, 1): (2, 4, 2, 25600), (24, 2): (2, 4, 2, 26624),
        (24, 4): (2, 4, 2, 28672), (24, 5): (5, 1, 2, 170240),
        (24, 8): (5, 1, 2, 180224), (24, 16): (5, 1, 2, 206848),
        (28, 1): (2, 4, 2, 29696), (28, 2): (2, 4, 2, 30720),
        (28, 4): (2, 4, 2, 32768), (28, 5): (5, 1, 2, 227072),
    },
    ("full", True): {
        (1, 1): (2, 32, 2, 49152), (1, 2): (2, 16, 2, 49152),
        (1, 4): (2, 4, 2, 30720), (1, 5): (2, 4, 2, 43008),
        (1, 8): (2, 2, 2, 46080), (1, 16): (2, 1, 2, 78336),
        (4, 1): (2, 16, 2, 49152), (4, 2): (2, 8, 2, 43008),
        (4, 4): (2, 4, 2, 46080), (4, 5): (2, 2, 2, 30720),
        (4, 8): (2, 1, 2, 29952), (4, 16): (2, 1, 2, 91392),
        (8, 1): (5, 4, 2, 37888), (8, 2): (5, 2, 2, 35328),
        (8, 4): (5, 1, 2, 37120), (8, 5): (5, 1, 2, 43008),
        (8, 8): (5, 1, 2, 63744), (8, 16): (5, 1, 2, 141568),
        (12, 1): (5, 1, 2, 45568), (12, 2): (5, 1, 2, 51456),
        (12, 4): (5, 1, 2, 64768), (12, 5): (5, 1, 2, 72192),
        (12, 8): (5, 1, 2, 97536), (12, 16): (5, 1, 2, 187648),
        (16, 1): (5, 1, 2, 76800), (16, 2): (5, 1, 2, 84224),
        (16, 4): (5, 1, 2, 100608), (16, 5): (5, 1, 2, 109568),
        (16, 8): (5, 1, 2, 139520), (16, 16): (5, 1, 1, 170112),
        (20, 1): (5, 1, 2, 116224), (20, 2): (5, 1, 2, 125184),
        (20, 4): (5, 1, 2, 144640), (20, 5): (5, 1, 2, 155136),
        (20, 8): (5, 1, 2, 189696), (20, 16): (5, 1, 1, 223872),
        (24, 1): (5, 1, 2, 163840), (24, 2): (5, 1, 2, 174336),
        (24, 4): (5, 1, 2, 196864), (24, 5): (5, 1, 2, 208896),
        (24, 8): (5, 1, 1, 210048), (28, 1): (5, 1, 2, 219648),
        (28, 2): (5, 1, 2, 231680),
    },
    ("policy", True): {
        (1, 1): (2, 32, 2, 49152), (1, 2): (2, 16, 2, 49152),
        (1, 4): (2, 4, 2, 30720), (1, 5): (2, 4, 2, 43008),
        (1, 8): (2, 2, 2, 46080), (1, 16): (2, 1, 2, 78336),
        (4, 1): (2, 16, 2, 49152), (4, 2): (2, 8, 2, 43008),
        (4, 4): (2, 4, 2, 46080), (4, 5): (2, 2, 2, 30720),
        (4, 8): (2, 1, 2, 29952), (4, 16): (2, 1, 2, 91392),
        (8, 1): (5, 4, 2, 37888), (8, 2): (5, 2, 2, 35328),
        (8, 4): (5, 1, 2, 37120), (8, 5): (5, 1, 2, 43008),
        (8, 8): (5, 1, 2, 63744), (8, 16): (5, 1, 2, 141568),
        (12, 1): (5, 1, 2, 45568), (12, 2): (5, 1, 2, 51456),
        (12, 4): (5, 1, 2, 64768), (12, 5): (5, 1, 2, 72192),
        (12, 8): (5, 1, 2, 97536), (12, 16): (5, 1, 2, 187648),
        (16, 1): (5, 1, 2, 76800), (16, 2): (5, 1, 2, 84224),
        (16, 4): (5, 1, 2, 100608), (16, 5): (5, 1, 2, 109568),
        (16, 8): (5, 1, 2, 139520), (16, 16): (5, 1, 1, 170112),
        (20, 1): (5, 1, 2, 116224), (20, 2): (5, 1, 2, 125184),
        (20, 4): (5, 1, 2, 144640), (20, 5): (5, 1, 2, 155136),
        (20, 8): (5, 1, 2, 189696), (20, 16): (5, 1, 1, 223872),
        (24, 1): (5, 1, 2, 163840), (24, 2): (5, 1, 2, 174336),
        (24, 4): (5, 1, 2, 196864), (24, 5): (5, 1, 2, 208896),
        (24, 8): (5, 1, 1, 210048), (28, 1): (5, 1, 2, 219648),
        (28, 2): (5, 1, 2, 231680),
    },
}


@pytest.mark.parametrize("emit,gps", MODES)
def test_plans_that_fit_are_kept(emit, gps):
    """Every size of the grid that planned before keeps its plan; the rest
    of the grid takes the wide design."""
    kept = PARENT_PLANS[(emit, gps)]
    for n in (1, 4, 8, 12, 16, 20, 24, 28):
        for m in (1, 2, 4, 5, 8, 16):
            p = plan.backward_plan(n, m, gps, emit, 500, 4096)
            if (n, m) in kept:
                assert (p.threads // 32, p.tc, p.stages, p.smem) == kept[
                    (n, m)], (n, m)
                assert p.blocks == 128 and p.chunks == -(-500 // p.tc)
            else:
                assert p.tc == 0, (n, m)


def _lane_fits(n, m, gps, emit):
    """The lane design's rule: its ring of one stage of one step, and the
    compute warps' exchange, fit a block."""
    G = plan.k1_warps(n, emit, gps, m)
    ex = plan.RING_W * plan.k1_exchange(n, m) if G > 1 else 0
    return plan.ring_bytes(1, 1, plan.k1_slots(n, m, gps), ex) <= plan.MAX_SMEM


@pytest.mark.parametrize("emit,gps", MODES)
def test_wide_exactly_where_the_lanes_do_not_fit(emit, gps):
    """Up to the ceilings: the wide design exactly where the lane design
    does not fit, its scenarios' terms within a block (at least one a
    block, at most WIDE_MAX_WARPS); never a launch-plan ValueError."""
    for n in range(1, plan.MAX_STATES + 1):
        for m in range(1, plan.MAX_CONTROLS + 1):
            p = plan.backward_plan(n, m, gps, emit, 100, 512)
            assert (p.tc == 0) == (not _lane_fits(n, m, gps, emit)), (n, m)
            assert 0 < p.smem <= plan.MAX_SMEM
            if p.tc == 0:
                S = p.threads // plan.RING_W
                assert 1 <= S <= plan.WIDE_MAX_WARPS
                assert p.smem == S * 4 * plan.wide_floats(n, m)
                assert p.blocks == -(-512 // S)
    # the humanoid: three scenarios a block; the ceiling: two
    assert plan.backward_plan(54, 21, gps, emit, 100, 512).threads == 96
    assert plan.backward_plan(64, 32, gps, emit, 2, 512).threads == 64


def test_k23_plans_up_to_the_ceilings():
    """K2 and K3 plan at every (n, m) up to the ceilings: two ring stages
    where they fit, one stage where only one does (⟨54,21⟩: 1230 slots,
    157,440 bytes a stage), and past that the direct-K ring of n+2m slots
    (⟨64,32⟩)."""
    for n in range(1, plan.MAX_STATES + 1, 3):
        for m in range(1, plan.MAX_CONTROLS + 1):
            for p in ([plan.linesearch_plan(n, m, A, 100, 512)
                       for A in (1, 6, 11, 64)]
                      + [plan.forward_plan(n, m, A, 100, 512, e)
                         for A in (1, 6, 8) for e in (False, True)]):
                assert p.smem <= plan.MAX_SMEM and p.tc >= 1
    assert not plan.k23_direct(54, 21) and plan.k23_direct(64, 32)
    p = plan.linesearch_plan(54, 21, 6, 100, 512)
    assert (p.tc, p.stages, p.smem) == (1, 1, 4 * (1230 * 32 + 6 * 32))
    p = plan.forward_plan(54, 21, 1, 100, 512, emit=True)
    assert (p.tc, p.stages) == (1, 1)
    p = plan.forward_plan(64, 32, 1, 2, 512, emit=True)
    assert p.stages == 2 and p.smem == plan.ring_bytes(
        2, p.tc, 64 + 2 * 32, plan.k3_out_floats(64, 32, p.tc))


@pytest.fixture
def no_build(monkeypatch):
    """The build and the lowering patched to fail if called."""
    def fail(*a, **k):
        raise AssertionError("built or lowered before the size was refused")
    for name in ("build", "build_generated", "library", "wide_library",
                 "lowered_library", "packed_library"):
        monkeypatch.setattr(_build, name, fail)
    monkeypatch.setattr(lower, "lower", fail)
    monkeypatch.setattr(lower, "lower_tiles", fail)


@pytest.mark.parametrize("entry", ["backward", "packed", "forward",
                                   "linesearch"])
@pytest.mark.parametrize("n,m,what", [(65, 2, "MAX_STATES = 64"),
                                      (4, 33, "MAX_CONTROLS = 32")])
def test_above_the_ceilings_refused(no_build, entry, n, m, what):
    """n = 65 or m = 33 on tensors off the CPU (the meta device, which
    needs no card): each CUDA entry raises NotImplementedError naming its
    ceiling before anything is lowered or built."""
    T, B = 4, 8
    spec = tl.random_lti(0, n=n, m=m, T=T, device="cpu")
    meta = dict(device="meta")
    traj = torch.zeros((T, n + m + 1, B), **meta)
    x0 = torch.zeros((n, B), **meta)
    gains = torch.zeros((T, m + m * n, B), **meta)
    with pytest.raises(NotImplementedError, match=what):
        if entry == "backward":
            bk.backward_lanes(traj, torch.zeros(B, **meta), n=n, m=m,
                              derivs_tiles=tl.lti_derivs_tiles(spec))
        elif entry == "packed":
            bk.backward_lanes(torch.zeros((T, DerivLayout(n, m).D + m, B),
                                          **meta), torch.zeros(B, **meta),
                              n=n, m=m)
        elif entry == "forward":
            fk.forward_lanes(traj, gains, x0, torch.ones((1, B), **meta),
                             model=tl.lti_lanes(spec))
        else:
            fk.linesearch_lanes(traj, gains, x0, torch.zeros((4, B), **meta),
                                model=tl.lti_lanes(spec), alphas=(1.0, 0.5))


# ---- K1 at wide sizes against JAX's generic backward pass ----------------

KB, KT = 2, 2


def _k1_inputs(n, m, seed):
    """A derivative stack (B, T, ...) in numpy f64: a stable fx, fu =
    0.3·N(0,1), cx, cu, an SPD cxx, cxu = 0, cuu = 0.05·I; controls u."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((n, n))
    G = rng.standard_normal((n, n)) / np.sqrt(n)

    def rep(a):
        return np.broadcast_to(a, (KB, KT) + a.shape).astype(F32)

    d = dict(fx=rep(expm(0.3 * (Mm - Mm.T))),
             fu=rep(0.3 * rng.standard_normal((n, m))),
             cx=rng.standard_normal((KB, KT, n)).astype(F32),
             cu=(0.1 * rng.standard_normal((KB, KT, m))).astype(F32),
             cxx=rep(0.5 * np.eye(n) + G @ G.T), cxu=rep(np.zeros((n, m))),
             cuu=rep(0.05 * np.eye(m)))
    u = (0.1 * rng.standard_normal((KB, KT, m))).astype(F32)
    return d, u


def _cmp(pairs, tol):
    """Each (name, JAX's, the port's) within tol of the largest |JAX|."""
    for name, a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("n,m", [(30, 6), (54, 21)])
def test_k1_wide_sizes_match_jax(n, m):
    """K1 (reg_type 2, no limits, "full" emission, T=2, B=2) on CPU
    tensors against JAX's XLA backward_pass vmapped over the lanes: k, K,
    Vx, Vxx and dV within 2e-5 of each output's largest magnitude (f32
    sums of up to 54 terms, which XLA orders and fuses otherwise)."""
    assert plan.backward_plan(n, m, False, "full", KT, KB).tc == 0
    d, u = _k1_inputs(n, m, seed=n + m)
    lam = np.array([0.1, 0.0], F32)
    ref = jax.vmap(lambda dd, uu, ll: jax_backward_pass(
        dd, uu, lam=ll, reg_type=2))(JDerivs(**{
            k: jnp.asarray(v) for k, v in d.items()}), jnp.asarray(u),
        jnp.asarray(lam))
    out = bk.backward_pass_pallas(
        Derivs(**{k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in d.items()}), torch.from_numpy(u),
        torch.from_numpy(lam), reg_type=2)
    assert not out.diverged.any() and not np.asarray(ref.diverged).any()
    _cmp([("k", ref.policy.k, out.policy.k), ("K", ref.policy.K,
          out.policy.K), ("Vx", ref.Vx, out.Vx), ("Vxx", ref.Vxx, out.Vxx),
          ("dV", ref.dV, out.dV)], 2e-5)


def test_k1_wide_gps_policy_matches_jax():
    """K1 in GPS mode at ⟨30,6⟩ ("policy" emission: k, K, Quu, Quu⁻¹;
    per-step η, the previous policy's KL expansion) against JAX's XLA
    backward_pass in GPS mode: k, K, Σ, dV within 2e-5 of each output's
    largest magnitude."""
    n, m = 30, 6
    d, u = _k1_inputs(n, m, seed=5)
    rng = np.random.default_rng(9)
    G = rng.standard_normal((KB, KT, m, m)) / np.sqrt(m)
    Si = np.einsum("btij,btkj->btik", G, G) + 0.5 * np.eye(m)
    pK = (0.3 * rng.standard_normal((KB, KT, m, n))).astype(F32)
    pk = (0.2 * rng.standard_normal((KB, KT, m))).astype(F32)
    eta = (0.5 + rng.uniform(0.0, 1.0, (KB, KT))).astype(F32)
    prev = JPolicy(K=jnp.asarray(pK), k=jnp.asarray(pk),
                   sigma=jnp.asarray(np.linalg.inv(Si), F32),
                   sigma_inv=jnp.asarray(Si, F32))
    ref = jax.vmap(lambda dd, uu, pv, et: jax_backward_pass(
        dd, uu, lam=0.0, reg_type=1, eta=et, kl_terms=grad_kl(pv),
        gps_mode=True))(JDerivs(**{k: jnp.asarray(v) for k, v in d.items()}),
                        jnp.asarray(u), prev, jnp.asarray(eta))
    stream = torch.cat([to_streams(torch.from_numpy(np.ascontiguousarray(
        d[f]))) for f in ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")]
        + [to_streams(torch.from_numpy(u))], dim=1)
    prev_s = to_streams(torch.cat([torch.from_numpy(pk),
                                   torch.from_numpy(pK).reshape(KB, KT, -1),
                                   torch.from_numpy(Si.astype(F32)).reshape(
                                       KB, KT, -1)], dim=-1))
    assert plan.backward_plan(n, m, True, "policy", KT, KB).tc == 0
    res = bk.backward_lanes(stream, torch.zeros(KB), n=n, m=m, reg_type=1,
                            prev=prev_s, eta=torch.from_numpy(eta.T.copy()),
                            emit="policy")
    lay = bk.OutLayout(n, m, "policy")
    o = res.out
    _cmp([("k", ref.policy.k, from_streams(o[:, :m], (m,))),
          ("K", ref.policy.K, from_streams(o[:, lay.K:lay.K + m * n],
                                           (m, n))),
          ("sigma", ref.policy.sigma, from_streams(
              o[:, lay.quui:lay.quui + m * m], (m, m))),
          ("dV", ref.dV, res.stats[:2].T)], 2e-5)
    assert not (res.stats[2] > 0.5).any()


def _spec(n, m, T, seed=3):
    """A stable random LTI in numpy f64 (random_lti's construction at a
    larger step), cast to f32, as a JAX LTISpec."""
    rng = np.random.default_rng(seed)
    Mm = rng.standard_normal((n, n))
    return jl.LTISpec(A=jnp.asarray(expm(0.3 * (Mm - Mm.T)), F32),
                      B=jnp.asarray(0.3 * rng.standard_normal((n, m)), F32),
                      Q=jnp.asarray(0.5 * np.eye(n), F32),
                      R=jnp.asarray(0.05 * np.eye(m), F32),
                      x0=jnp.ones((n,), F32),
                      u0=jnp.asarray(0.1 * rng.standard_normal((T, m)), F32))


def test_wide_stream_matches_jax_pack_derivs():
    """The stream the wide K1 reads at ⟨54,21⟩: the port's
    packed_from_tiles of the LTI tiles against JAX's pack_derivs of the
    LTI problem's derivatives along the same trajectory, bit for bit (Q
    and R are diagonal, so each cx and cu element is one product on both
    sides)."""
    n, m = 54, 21
    T, Bs = 3, 5
    spec = _spec(n, m, T)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((Bs, T, n)).astype(F32)
    u = rng.standard_normal((Bs, T, m)).astype(F32)
    d = jax.vmap(jl.make_lti_problem(spec, T).make_derivs())(
        jnp.asarray(x), jnp.asarray(u))
    ref = convert.stream_from_lanes(jax_pack_derivs(d, Bs), Bs)
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    out = packed_from_tiles(tl.lti_derivs_tiles(tspec), n, m)(
        to_streams(torch.from_numpy(x)), to_streams(torch.from_numpy(u)))
    D = DerivLayout(n, m).D
    assert out.shape == (T, D + m, Bs) and ref.shape == (T, D, Bs)
    assert np.array_equal(out[:, :D].numpy(), ref)
    assert torch.equal(out[:, D:], to_streams(torch.from_numpy(u)))


FB, FT = 2, 6
CFG = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 3), reg_type=2,
                   max_iter=3, iter_cap=4)


def test_wide_fleet_matches_jax_generic():
    """The fleet at ⟨30,6⟩ (T=6, B=2, three iterations, no limits; K1 takes
    the wide design on the card at this size in "full" emission) on CPU
    tensors against JAX's generic ilqg vmapped over the lanes: final costs
    within 1e-4 relative, reasons and accepted counts equal, and both below
    the initial rollout's cost."""
    n, m = 30, 6
    assert plan.backward_plan(n, m, False, "full", FT, FB).tc == 0
    spec = _spec(n, m, FT)
    x0s = (np.ones((FB, n)) * np.linspace(0.5, 2.0, FB)[:, None]).astype(F32)
    u0s = np.tile(3.0 * np.asarray(spec.u0), (FB, 1, 1)).astype(F32)
    ref = jax.vmap(lambda a, b: jax_ilqg(jl.make_lti_problem(spec, FT), a, b,
                                         cfg=CFG))(jnp.asarray(x0s),
                                                   jnp.asarray(u0s))
    tspec = convert.lti_spec_from_jax(spec, device="cpu")
    out = ilqg_batch_lanes(tl.lti_lanes(tspec), None, torch.from_numpy(x0s),
                           torch.from_numpy(u0s),
                           cfg=convert.config_from_jax(CFG),
                           derivs_tiles=tl.lti_derivs_tiles(tspec),
                           record_trace=True)
    ref_cost = np.asarray(jnp.sum(ref.cost, -1))
    np.testing.assert_allclose(out.cost_total.numpy(), ref_cost, rtol=1e-4)
    np.testing.assert_array_equal(out.reason.numpy(), np.asarray(ref.reason))
    np.testing.assert_array_equal(out.n_accepted.numpy(),
                                  np.asarray(ref.n_accepted))
    init = out.trace.cost[:, 0].numpy()
    assert (out.cost_total.numpy() < init).all() and (ref_cost < init).all()
