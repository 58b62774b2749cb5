"""The launch plans of the ring-fed kernels K1-K5
(``ops/hopper/plan.py``), for every instance the kernels are built for, at
the shapes of every path that launches them and of the card tests, with
A = 1..64 candidates for K2 and 1..8 a launch for K3 (a longer ladder in
groups of eight): each plan fits the shared memory a block may have,
its chunks cover T exactly, and its grid covers B; K5's copy grid stays
within its bound. Plain Python: no card, no JAX."""
import pytest

from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel import (
    CUDA_BACKWARD)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.covariance_kernel import (
    CUDA_N)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel import (
    CUDA_MODELS, MAX_A)

# (T, B): the iLQG headline, the heterogeneous fleet and KL (500, 4096),
# the MPC tier (300), the quadrotor (400), LTI and KL on LTI (1000); the
# card tests' ragged shapes; a T and a B one past a chunk and a block; the
# m=3 group's kernel checks at ⟨10,3⟩ (T two chunks and a step of K1
# gains, and of K1 full) and its CPU check's 64 lanes
SHAPES = [(500, 4096), (300, 4096), (400, 4096), (1000, 4096), (2, 1),
          (40, 37), (40, 200), (33, 200), (17, 37), (5, 1), (1, 33),
          (129, 4097), (17, 4096), (9, 4096), (9, 4090), (40, 64)]


def _check(p: plan.LaunchPlan, T: int, B: int, threads: int, slots: int,
           extra: int) -> None:
    assert p.smem <= plan.MAX_SMEM == 232_448
    assert p.smem == 4 * (p.stages * p.tc * slots * plan.RING_W + extra)
    assert 2 <= p.stages <= plan.MAX_STAGES and 1 <= p.tc <= T
    # the chunks' steps add up to T, none empty
    steps = [min(p.tc, T - c * p.tc) for c in range(p.chunks)]
    assert sum(steps) == T and min(steps) >= 1
    # the blocks' columns cover B, none empty
    cols = [min(plan.RING_W, B - k * plan.RING_W) for k in range(p.blocks)]
    assert sum(cols) == B and min(cols) >= 1
    assert p.threads == threads and p.launcher_args() == tuple(p)[:5]


@pytest.mark.parametrize("key", sorted(CUDA_MODELS))
@pytest.mark.parametrize("T, B", SHAPES)
def test_linesearch_plan_fits_and_covers(key, T, B):
    _, n, m = key
    assert MAX_A == plan.MAX_A == 64
    for A in range(1, MAX_A + 1):
        p = plan.linesearch_plan(n, m, A, T, B)
        _check(p, T, B, plan.RING_W * min(A, plan.K2_MAX_WARPS),
               plan.k2_slots(n, m), plan.RING_W * A)


@pytest.mark.parametrize("key", sorted(CUDA_MODELS))
@pytest.mark.parametrize("T, B", SHAPES)
def test_forward_plan_fits_and_covers(key, T, B):
    _, n, m = key
    for A in range(1, plan.K3_MAX_A + 1):
        warps = plan.k3_warps(A)
        assert A < warps <= plan.K3_MAX_WARPS   # one producer at least
        for emit in (False, True):
            p = plan.forward_plan(n, m, A, T, B, emit)
            _check(p, T, B, plan.RING_W * warps, plan.k2_slots(n, m),
                   plan.k3_out_floats(n, m, p.tc) if emit else 0)


@pytest.mark.parametrize("T, B", SHAPES + [(1, 1), (1, 4096), (2, 4096)])
def test_probe_plan_fits_and_covers(T, B):
    for mode in ("light", "full"):
        p = plan.probe_plan(mode, T, B)
        _check(p, T, B, plan.RING_W * (1 + plan.PROBE_PRODUCERS),
               plan.PROBE_SLOTS, 0)
        assert p.stages == plan.PROBE_STAGES
    p = plan.probe_plan("copy", T, B)
    # a grid of 1..PROBE_COPY_BLOCKS blocks, no ring; no block without a
    # unit of the (T, 27, B) copy
    units = T * plan.PROBE_OUT_SLOTS * -(-B // plan.PROBE_COPY_SPAN)
    assert 1 <= p.blocks == min(units, plan.PROBE_COPY_BLOCKS)
    assert p.threads == plan.PROBE_COPY_THREADS
    assert (p.tc, p.stages, p.smem, p.chunks) == (0, 0, 0, 0)


@pytest.mark.parametrize("stage_out", [0, 1])
@pytest.mark.parametrize("n", CUDA_N)
@pytest.mark.parametrize("T, B", SHAPES + [(1, 1), (1, 4096), (2, 4096),
                                           (401, 4090)])
def test_covariance_plan_fits_and_covers(n, T, B, stage_out, monkeypatch):
    """K4, with Σ stored by the compute warps or by the producers: its
    chunks cover the T-1 steps that read an F (none at T=1), with Σ after
    the ring: two slots, or two chunks when the producers store it."""
    monkeypatch.setitem(plan.COV_STAGE_OUT, n, stage_out)
    p = plan.covariance_plan(n, T, B)
    G, P = plan.COV_WARPS[n], plan.COV_PRODUCERS[n]
    assert 1 <= G <= n and 1 <= P <= 4      # csrc COV_MAX_PRODUCERS
    sigma = (2 * p.tc if stage_out else 2) * n * n * plan.RING_W
    assert plan.cov_sigma_floats(n, p.tc) == sigma
    assert p.smem <= plan.MAX_SMEM
    assert p.smem == 4 * (p.stages * p.tc * n * n * plan.RING_W + sigma)
    assert 2 <= p.stages == plan.COV_STAGES[n] <= plan.MAX_STAGES
    assert 1 <= p.tc <= max(T - 1, 1)
    steps = [min(p.tc, T - 1 - c * p.tc) for c in range(p.chunks)]
    assert sum(steps) == T - 1 and (not steps or min(steps) >= 1)
    cols = [min(plan.RING_W, B - k * plan.RING_W) for k in range(p.blocks)]
    assert sum(cols) == B and min(cols) >= 1
    assert p.threads == plan.RING_W * (G + P)


# K4 at the state sizes built at first use: the ring design up to
# COV_RING_MAX_N, Σ in device memory beyond, and the largest n it takes
DERIVED_N = (1, 2, 3, 5, 8, 12, 16, 17, 21, 32, 64)


@pytest.mark.parametrize("n", DERIVED_N)
@pytest.mark.parametrize("T, B", SHAPES + [(1, 1), (2, 4096), (401, 4090)])
def test_covariance_derived_plan_fits_and_covers(n, T, B):
    """K4 at an n the kernel library does not hold: up to COV_RING_MAX_N,
    one (n ≤ 6) or two rows a compute warp, two producers, a two-stage
    ring whose chunks cover the T-1 steps and two Σ slots after it, within
    a block's shared memory; beyond, Σ in device memory: min(n, 16)
    compute warps, no ring, no shared memory."""
    p = plan.covariance_plan(n, T, B)
    shape = plan.cov_shape(n)
    cols = [min(plan.RING_W, B - k * plan.RING_W) for k in range(p.blocks)]
    assert sum(cols) == B and min(cols) >= 1
    if n > plan.COV_RING_MAX_N:
        assert shape == (min(n, 16), 0, 0, plan.COV_GLOBAL)
        assert p.threads == plan.RING_W * shape.warps
        assert (p.tc, p.stages, p.smem, p.chunks) == (0, 0, 0, 0)
        return
    rows = 1 if n <= 6 else 2
    assert shape == (-(-n // rows), 2, plan.STAGES, 0)
    assert p.threads == plan.RING_W * (shape.warps + 2)
    sigma = 2 * n * n * plan.RING_W
    assert plan.cov_sigma_floats(n, p.tc) == sigma
    assert p.smem == 4 * (p.stages * p.tc * n * n * plan.RING_W + sigma)
    assert p.smem <= plan.MAX_SMEM and 1 <= p.tc <= max(T - 1, 1)
    steps = [min(p.tc, T - 1 - c * p.tc) for c in range(p.chunks)]
    assert sum(steps) == T - 1 and (not steps or min(steps) >= 1)


def test_covariance_plan_beyond_the_largest_n_raises():
    """K4 takes n up to COV_MAX_N; beyond, and at n < 1, the plan raises
    NotImplementedError naming the limit; n = 4, 6 and 10 keep their
    measured plans."""
    for n in (0, plan.COV_MAX_N + 1):
        with pytest.raises(NotImplementedError, match="COV_MAX_N"):
            plan.covariance_plan(n, 10, 64)
    for n in CUDA_N:
        assert plan.cov_shape(n) == (plan.COV_WARPS[n], plan.COV_PRODUCERS[n],
                                     plan.COV_STAGES[n],
                                     plan.COV_STAGE_OUT[n])


@pytest.mark.parametrize("key", sorted(CUDA_BACKWARD))
@pytest.mark.parametrize("T, B", [s for s in SHAPES if s[0] >= 2])
def test_backward_plan_fits_and_covers(key, T, B):
    _, n, m, _, gps = key       # K1 takes T >= 2
    for emit in CUDA_BACKWARD[key]:
        p = plan.backward_plan(n, m, gps, emit, T, B)
        G = plan.k1_warps(n, emit, gps)
        _check(p, T, B, plan.RING_W * (G + 1), plan.k1_slots(n, m, gps),
               plan.RING_W * plan.k1_exchange(n, m) if G > 1 else 0)


def test_plan_slots_and_chunk_traits():
    """The slot counts the rings stage, and the chunk length each model's
    slot count gives at a long horizon."""
    assert plan.k2_slots(4, 1) == 10 and plan.k2_slots(6, 2) == 22
    assert plan.k2_slots(10, 2) == 34
    assert plan.k1_slots(4, 1, False) == 5 and plan.k1_slots(4, 1, True) == 12
    assert plan.k1_slots(10, 2, True) == 39
    assert plan.k1_exchange(4, 1) == 36 and plan.k1_exchange(10, 2) == 220
    # four compute warps only at n >= 8 for "full" emission and GPS mode
    assert [plan.k1_warps(10, e, g) for e, g in (
        ("gains", False), ("full", False), ("policy", True),
        ("gains", True))] == [1, 4, 4, 4]
    assert plan.k1_warps(4, "full", True) == plan.k1_warps(6, "full",
                                                           False) == 1
    tc = {(n, m): plan.linesearch_plan(n, m, 6, 10_000, 4096).tc
          for n, m in ((4, 1), (6, 2), (10, 2))}
    assert tc == {(4, 1): 32, (6, 2): 16, (10, 2): 16}
    # K3 shares K2's ring: the same chunks; A candidate warps and producers
    assert {(n, m): plan.forward_plan(n, m, 6, 10_000, 4096).tc
            for n, m in tc} == tc
    assert [plan.forward_plan(4, 1, A, 500, 4096).threads // 32
            for A in (1, 2, 6, 8)] == [4, 4, 8, 10]
    # K5: 128 blocks of 32 scenarios at B=4096, a ring of 4 × 8 steps of
    # the 47 slots; copy on 8 blocks an SM of the H100
    assert plan.probe_plan("full", 500, 4096)[:5] == (
        128, 32 * (1 + plan.PROBE_PRODUCERS), 8, 4, 192_512)
    assert plan.probe_plan("copy", 500, 4096).blocks == 8 * 132
    # K4: the largest ring and Σ that fit a block; at n=4 a 4-stage ring
    # and Σ for two chunks (the producers store it), at n=6 and 10 a
    # 2-stage ring and two Σ slots
    assert [plan.covariance_plan(n, 1000, 4096)[:5] for n in CUDA_N] == [
        (128, 160, 16, 4, 196_608), (128, 256, 16, 2, 156_672),
        (128, 224, 8, 2, 230_400)]
    with pytest.raises(ValueError):
        plan.probe_plan("copy", 0, 4096)
    with pytest.raises(ValueError):
        plan.backward_plan(4, 1, False, "gains", 0, 4096)


def test_plans_at_lti_10_3():
    """⟨10,3⟩ (the m=3 LTI fleet, B=4096, T=1000): K1 stages 13 slots a
    step, 56 in GPS mode; within K1's budget a chunk is 8 steps for
    "gains", 4 for "full" (the four compute warps' exchange of 230 slots
    follows the ring) and 1 in GPS mode. K2 and K3 stage 46 slots in
    chunks of 8."""
    assert plan.k1_slots(10, 3, False) == 13
    assert plan.k1_slots(10, 3, True) == 56
    assert plan.k1_exchange(10, 3) == 230 and plan.k2_slots(10, 3) == 46
    tc = {(emit, gps): plan.backward_plan(10, 3, gps, emit, 1000, 4096)
          for emit, gps in (("gains", False), ("full", False),
                            ("policy", True))}
    assert [(p.tc, p.threads // 32, p.smem) for p in tc.values()] == [
        (8, 2, 26_624), (4, 5, 42_752), (1, 5, 43_776)]
    assert all(p.smem <= plan.K1_BUDGET and p.blocks == 128
               for p in tc.values())
    assert plan.linesearch_plan(10, 3, 6, 1000, 4096).tc == 8
    assert [plan.forward_plan(10, 3, A, 1000, 4096, A == 1)[:5] for A in
            (6, 1)] == [(128, 256, 8, 2, 94_208), (128, 128, 8, 2, 122_880)]


@pytest.mark.parametrize("key", sorted(CUDA_MODELS))
@pytest.mark.parametrize("A", [9, 11, 16, 40])
def test_plans_past_eight_candidates(key, A):
    """Ladders longer than a block's candidate warps, at every path's
    shapes: K2 keeps eight warps and rolls the A candidates in ⌈A/8⌉
    rounds, its shared memory the ring and the A candidates' totals; K3
    launches groups of at most eight, the first emitting the stream, each
    group's plan its own size's."""
    _, n, m = key
    slots = plan.k2_slots(n, m)
    groups = plan.k3_groups(A)
    assert [a0 for a0, _ in groups] == list(range(0, A, 8))
    assert sum(na for _, na in groups) == A
    assert all(1 <= na <= plan.K3_MAX_A for _, na in groups)
    for T, B in SHAPES:
        p = plan.linesearch_plan(n, m, A, T, B)
        _check(p, T, B, plan.RING_W * plan.K2_MAX_WARPS, slots,
               plan.RING_W * A)
        assert p.smem <= plan.MAX_SMEM
        for i, (a0, na) in enumerate(groups):
            for emit in (False, True):
                q = plan.forward_plan(n, m, na, T, B, emit and i == 0)
                _check(q, T, B, plan.RING_W * plan.k3_warps(na), slots,
                       plan.k3_out_floats(n, m, q.tc) if emit and i == 0
                       else 0)
    # past the bounds: K2's ladder of 65, K3's 9 in one launch
    with pytest.raises(ValueError, match="A=65"):
        plan.linesearch_plan(n, m, 65, 500, 4096)
    with pytest.raises(ValueError, match="A=9"):
        plan.forward_plan(n, m, 9, 500, 4096)
    # at the headline's shapes: eight warps, the 11-α default ladder's
    # totals after the ring
    if key == (1, 4, 1):
        p11 = plan.linesearch_plan(4, 1, 11, 500, 4096)
        assert (p11.threads, p11.tc, p11.stages) == (256, 32, 2)
        assert p11.smem == 4 * (2 * 32 * 10 * 32 + 11 * 32)
        assert [na for _, na in plan.k3_groups(11)] == [8, 3]
