"""Launch plans of the ring-fed kernels: K1 (``backward_lanes``), K2
(``linesearch_lanes``), K3 (``forward_lanes``), K4
(``covariance_lanes``) and K5's ``light`` and ``full`` modes
(``probe_lanes``), and of K5's ``copy``.

The ring-fed kernels give a block 32 scenarios (``RING_W`` columns of the
``(T, S, B)`` streams) and stage the step inputs of those scenarios in a
shared-memory ring (``csrc/ring.cuh``): ``stages`` stages of ``tc`` time
steps each, ``[step][slot][32]`` f32, so that while a chunk of steps
computes, the next ones are in flight. K1 runs ``k1_warps`` compute
warps, which split each step's n×n products by rows and, when there are
several, share them through shared memory after the ring (W and U,
n·(n+m) slots; Vraw, n·n), and a producer warp that fills the ring; K2
runs ``k2_warps(A)`` = min(A, ``K2_MAX_WARPS``) warps, all of which fill
it, and rolls its A α candidates through them in rounds; its ring is
followed by the candidates' totals (A × 32 f32). K3 runs one warp per
candidate over K2's ring slots and two or more producer warps
(``k3_warps``) that fill it and, when K3 emits its stream, store it from
an output buffer after the ring; a ladder longer than ``K3_MAX_A`` is
launched in groups (``k3_groups``). K5 ``light``/``full`` run one compute
warp and ``PROBE_PRODUCERS`` producer warps over a deeper ring of the 47
input slots. K4 runs ``COV_WARPS[n]`` compute warps, which split each
step's rows, and ``COV_PRODUCERS[n]`` producer warps over a ring of F's
n² slots; Σ follows the ring in shared memory. K5 ``copy`` has no ring: a
grid of up to ``PROBE_COPY_BLOCKS`` blocks strides over the copy.

The plan is made here and passed to the launcher, which checks it against
its instance's slot count and refuses one that does not match. ``tc`` is a
trait of the model's slot count F: the largest power of two up to
``TC_MAX`` whose ring fits the kernel's budget, cut to T.

Sizes: the CUDA entries of K1-K3 take 1 ≤ n ≤ ``MAX_STATES`` and 1 ≤ m ≤
``MAX_CONTROLS`` (:func:`check_size`). Where K1's ring and exchange do not
fit a block (from n = 21 to 30, by m and mode), :func:`backward_plan`
returns the wide design's plan (``tc == 0``, :func:`wide_plan`): one warp a
scenario, its n×n and m×n terms in shared memory (``csrc/backward_wide.cu``).
K2 and K3 take one ring stage where two do not fit, and where one stage of
[x_old, u_nom, k, K] does not fit either (:func:`k23_direct`) their ring
holds [x_old, u_nom, k] and each candidate reads its K from device memory.
"""
from __future__ import annotations

from typing import NamedTuple

from .pack import DerivLayout

RING_W = 32                # scenarios a block owns (csrc/ring.cuh)
# controls: the kernel library (csrc/*.cu) is built for m ≤ LIBRARY_MAX_M
# (csrc/common.cuh MAX_M); a library generated for a lowered model, a
# user's tiles or the packed K1 at a larger m is built for its own m
# (DDP_MAX_M), up to the ceiling MAX_CONTROLS, above which every CUDA entry
# raises before anything is lowered or built. Such a library rolls its
# loops over the model's dimensions (csrc/common.cuh DDP_ROLLED), its
# per-scenario arrays in local memory: right, not fast.
LIBRARY_MAX_M = 4
MAX_CONTROLS = 32
# states: the ceiling of K1-K3 on the card, K4's COV_MAX_N
MAX_STATES = 64
MAX_SMEM = 232_448         # shared memory a block may opt into on sm_90
MAX_STAGES = 4
TC_MAX = 32
STAGES = 2
# ring budgets, in bytes: K2's and K3's A warps share one ring, so it may
# be large; K1's stays small enough for several blocks an SM
K1_BUDGET = 48 * 1024
# K1 on the packed-derivatives stream stages D+m slots a step (47 at
# ⟨4,1⟩, 110 at ⟨6,2⟩, 258 at ⟨10,2⟩), where the tiles' ring stages n+m:
# even one step of two stages at ⟨10,2⟩ is 66 KB. Its ring may take more of
# the block's shared memory; at B=4096 a block has an SM to itself anyway
K1_PACKED_BUDGET = 128 * 1024
K2_BUDGET = 144 * 1024
# K2: at most MAX_A α values (csrc/forward.cuh passes the ladder by value),
# rolled by at most K2_MAX_WARPS warps at a time (its __launch_bounds__)
MAX_A = 64
K2_MAX_WARPS = 8
# K3: at most K3_MAX_A candidate warps a launch; the wrapper launches a
# longer ladder in groups of K3_MAX_A, on one stream
K3_MAX_A = 8
# K3: at least K3_PRODUCERS producer warps beside the A candidate warps,
# and at least K3_MIN_WARPS warps a block (three producers at A = 1), as
# many as fit in K3_MAX_WARPS (csrc/forward.cuh::launch_forward takes
# 32·(A+1) to 32·K3_MAX_WARPS threads). Measured on an H100 (PERF.md §6):
# one producer cannot keep a chunk in flight, two are best for the sweep,
# three for the rollout.
K3_PRODUCERS = 2
K3_MIN_WARPS = 4
K3_MAX_WARPS = 10
# K5 (csrc/probe.cu): light/full's producer warps and ring depth; copy's
# block and grid bound (8 blocks on each of the H100's 132 SMs)
PROBE_SLOTS, PROBE_OUT_SLOTS = 47, 27
PROBE_PRODUCERS = 3
PROBE_STAGES = 4
PROBE_COPY_THREADS = 256
PROBE_COPY_BLOCKS = 8 * 132
PROBE_COPY_SPAN = 1024     # floats (4-byte copies) a block moves a turn
# K4 (csrc/covariance.cu), at each n it is built for: compute warps G
# (warp g owns rows i ≡ g mod G), producer warps, ring stages, and whether
# the producers store Σ (1) or the compute warps do (0); the ring and Σ as
# large as a block may have. Measured on an H100 (PERF.md §6): at n=10 five
# compute warps beat 1, 2, 4 and 10 (1.57 ms against 6.6, 5.2, 1.86,
# 1.66), at n=6 six beat 1, 2 and 3; at n=4 one warp with four producers
# storing Σ (0.146 ms) beats the compute warps storing it (0.174); more
# stages change nothing where the compute warps store.
COV_WARPS = {4: 1, 6: 6, 10: 5}
COV_PRODUCERS = {4: 4, 6: 2, 10: 2}
COV_STAGES = {4: 4, 6: 2, 10: 2}
COV_STAGE_OUT = {4: 1, 6: 0, 10: 0}
# K4 at any other n (a library of its own, built at first use): up to
# COV_RING_MAX_N the ring design with a plan derived from n (cov_shape):
# one row a compute warp up to n = 6, as at n = 6, two beyond, as at n = 10
# (R rows hold 4·R·n + n floats a thread: 144 at n = 16 with two); two
# producers, a two-stage ring, the compute warps storing Σ. Beyond, Σ
# double-buffered ([2][n²][32], 256·n² bytes) and a two-stage ring of one
# step no longer fit a block from n = 22, and the rows' registers spill
# from n = 17: Σ stays in device memory (COV_GLOBAL), min(n, 16) warps a
# block, no ring. COV_MAX_N bounds the FS row a thread holds (n floats).
COV_RING_MAX_N = 16
COV_MAX_N = 64
COV_GLOBAL = 2      # the Σ mode of the device-memory kernel (csrc launcher)


class LaunchPlan(NamedTuple):
    blocks: int      # grid: ceil(B / 32) (K5 copy: its grid)
    threads: int     # block: 32·(k1_warps+1) (K1), 32·k2_warps(A) (K2),
                     # 32·k3_warps(A) (K3), 32·(1+PROBE_PRODUCERS) (K5 ring)
    tc: int          # time steps a chunk (0: no ring)
    stages: int      # chunks in the ring (0: no ring)
    smem: int        # dynamic shared bytes
    chunks: int      # chunks a pass: ceil(T / tc) (0: no ring)

    def launcher_args(self) -> tuple:
        """The five ints the C launchers take."""
        return self[:5]


def check_controls(m: int, what: str) -> None:
    """Raise NotImplementedError for an m outside 1..MAX_CONTROLS, the
    controls the CUDA kernels are built for."""
    if not 1 <= m <= MAX_CONTROLS:
        raise NotImplementedError(
            f"{what}: the CUDA kernels take 1 ≤ m ≤ plan.MAX_CONTROLS = "
            f"{MAX_CONTROLS} controls, not m={m} (the kernel library is "
            f"built for m ≤ {LIBRARY_MAX_M}, a generated library for its "
            f"own m)")


def check_size(n: int, m: int, what: str) -> None:
    """:func:`check_controls`, and NotImplementedError for an n outside
    1..MAX_STATES, the states K1-K3 take on the card."""
    check_controls(m, what)
    if not 1 <= n <= MAX_STATES:
        raise NotImplementedError(
            f"{what}: the CUDA kernels take 1 ≤ n ≤ plan.MAX_STATES = "
            f"{MAX_STATES} states, not n={n}")


def k1_slots(n: int, m: int, gps: bool, packed: bool = False) -> int:
    """Ring slots of a K1 step: x, u, or with ``packed`` the D+m slots of
    the packed-derivatives stream; in GPS mode also the previous policy's
    k, K, Σ⁻¹ and η."""
    d_in = DerivLayout(n, m).D + m if packed else n + m
    return d_in + ((m + m * n + m * m + 1) if gps else 0)


def k1_warps(n: int, emit: str, gps: bool, m: int = 1) -> int:
    """K1's compute warps (csrc/backward.cuh::K1_WARPS): four where n ≥ 8
    and a step holds n×n work beyond the recursion's own (``"full"``
    emission's Vxx stores, GPS mode's KL terms) or m > 4, else one."""
    return 4 if n >= 8 and (gps or emit == "full" or m > 4) else 1


def k1_exchange(n: int, m: int) -> int:
    """Slots of K1's exchange between its compute warps: W and U by rows,
    then Vraw."""
    return n * (n + m) + n * n


def k2_slots(n: int, m: int) -> int:
    """Ring slots of a K2 step: x_old, u_nom, k, K."""
    return n + 2 * m + m * n


def ring_bytes(stages: int, tc: int, slots: int, extra: int = 0) -> int:
    return 4 * (stages * tc * slots * RING_W + extra)


def _check_shape(T: int, B: int) -> None:
    if T < 1 or B < 1:
        raise ValueError(f"launch plan: T={T}, B={B}")


def _plan(slots: int, T: int, B: int, threads: int, budget: int,
          extra: int, stages: int = STAGES) -> LaunchPlan:
    _check_shape(T, B)
    tc = TC_MAX
    while tc > 1 and ring_bytes(stages, tc, slots, extra) > budget:
        tc //= 2
    tc = min(tc, T)
    smem = ring_bytes(stages, tc, slots, extra)
    if smem > MAX_SMEM:
        raise ValueError(f"launch plan: {smem} shared bytes > {MAX_SMEM}")
    return LaunchPlan(blocks=-(-B // RING_W), threads=threads, tc=tc,
                      stages=stages, smem=smem, chunks=-(-T // tc))


def backward_plan(n: int, m: int, gps: bool, emit: str, T: int,
                  B: int, packed: bool = False) -> LaunchPlan:
    """K1: k1_warps compute warps and a producer warp a block, the ring of
    its x,u (with ``packed``, D+m) and GPS slots, then the compute warps'
    exchange (none with one compute warp, which keeps W and Vraw in
    registers). A ring of one stage where two of one step do not fit; the
    wide design (:func:`wide_plan`, ``tc == 0``) where one does not fit
    either."""
    G = k1_warps(n, emit, gps, m)
    args = (k1_slots(n, m, gps, packed), T, B, RING_W * (G + 1),
            K1_PACKED_BUDGET if packed else K1_BUDGET,
            RING_W * k1_exchange(n, m) if G > 1 else 0)
    try:
        return _plan(*args)
    except ValueError:
        pass
    try:
        # two stages of one step do not fit beside the exchange (GPS mode
        # at large n·m: 561 slots at ⟨16,16⟩): one stage
        return _plan(*args, stages=1)
    except ValueError:
        return wide_plan(n, m, T, B)


# K1's wide design (csrc/backward_wide.cu): one warp a scenario, at most
# WIDE_MAX_WARPS a block, each scenario's terms in shared memory
# (wide_floats); one library for every (n, m), which it takes at run time
WIDE_MAX_WARPS = 8


def wide_floats(n: int, m: int) -> int:
    """Shared floats of one scenario of the wide K1, in
    csrc/backward_wide.cu's order: Vxx (Qxx, then Vraw, in place), Vx;
    the step's fx and fu; W and U; Qx, the m×n terms Qux, Qux_r (then
    Quu·K), K (GPS mode: first the previous K) and Σ⁻¹K; the m×m terms
    Quu, QuuF, L; 16 m-vectors (the box QP's three candidates among
    them) and its four values; rounded up to 16 bytes."""
    f = (n * n + n + 2 * n * (n + m) + n + 4 * m * n + 3 * m * m + 16 * m
         + 4)
    return -(-f // 4) * 4


def wide_plan(n: int, m: int, T: int, B: int) -> LaunchPlan:
    """K1's wide design: as many scenarios (warps) a block as fit in its
    shared memory, at most WIDE_MAX_WARPS; no ring (tc, stages and chunks
    0)."""
    _check_shape(T, B)
    per = 4 * wide_floats(n, m)
    S = min(WIDE_MAX_WARPS, MAX_SMEM // per)
    if S < 1:
        raise ValueError(f"launch plan: {per} shared bytes a scenario > "
                         f"{MAX_SMEM}")
    return LaunchPlan(blocks=-(-B // S), threads=RING_W * S, tc=0,
                      stages=0, smem=S * per, chunks=0)


def _check_A(A: int, most: int) -> None:
    if not 1 <= A <= most:
        raise ValueError(f"launch plan: A={A} outside 1..{most}")


def k2_warps(A: int) -> int:
    """K2's warps a block at A candidates: W = min(A, K2_MAX_WARPS), which
    roll the ladder in ⌈A/W⌉ rounds."""
    _check_A(A, MAX_A)
    return min(A, K2_MAX_WARPS)


def k23_extra_max(n: int, m: int) -> int:
    """The most floats K2 or K3 keep after their ring at one step a chunk:
    K2's MAX_A totals, K3's output buffer."""
    return max(RING_W * MAX_A, k3_out_floats(n, m, 1))


def k23_direct(n: int, m: int) -> bool:
    """Whether K2's and K3's ring holds only [x_old, u_nom, k] (n+2m
    slots) and each candidate reads its K row from device memory: where
    one stage of one step of all their slots, and the most they keep
    after it, do not fit a block (from ⟨64,14⟩; ⟨54,21⟩ fits one stage).
    csrc/forward.cuh K23_DIRECT is the same rule."""
    return ring_bytes(1, 1, k2_slots(n, m), k23_extra_max(n, m)) > MAX_SMEM


def _k23_plan(n: int, m: int, T: int, B: int, threads: int, extra: int,
              out=lambda tc: 0) -> LaunchPlan:
    """K2's and K3's ring and what follows it: ``extra`` floats within the
    ring's budget (K2's totals), ``out(tc)`` floats beyond it (K3's output
    buffer). Two stages where they fit, else one; the direct-K ring
    (:func:`k23_direct`) of two stages, its chunk cut until the ring and
    the output buffer fit the budget together."""
    if k23_direct(n, m):
        _check_shape(T, B)
        slots = n + 2 * m
        tc = TC_MAX
        while tc > 1 and ring_bytes(STAGES, tc, slots,
                                    extra + out(tc)) > K2_BUDGET:
            tc //= 2
        tc = min(tc, T)
        return LaunchPlan(blocks=-(-B // RING_W), threads=threads, tc=tc,
                          stages=STAGES, smem=ring_bytes(
                              STAGES, tc, slots, extra + out(tc)),
                          chunks=-(-T // tc))
    slots = k2_slots(n, m)
    try:
        p = _plan(slots, T, B, threads, K2_BUDGET, extra)
        smem = p.smem + 4 * out(p.tc)
        if smem <= MAX_SMEM:
            return p._replace(smem=smem)
    except ValueError:
        pass
    # two stages do not fit (⟨54,21⟩: 1230 slots, 157,440 bytes a stage)
    p = _plan(slots, T, B, threads, K2_BUDGET, extra, stages=1)
    smem = p.smem + 4 * out(p.tc)
    if smem > MAX_SMEM:
        raise ValueError(f"launch plan: {smem} shared bytes > {MAX_SMEM}")
    return p._replace(smem=smem)


def linesearch_plan(n: int, m: int, A: int, T: int, B: int) -> LaunchPlan:
    """K2: :func:`k2_warps` warps a block, the ring of its x_old, u_nom, k,
    K slots (:func:`_k23_plan`), then the A candidates' totals."""
    return _k23_plan(n, m, T, B, RING_W * k2_warps(A), RING_W * A)


def k3_warps(A: int) -> int:
    """K3's warps a block at A ≤ K3_MAX_A candidates: the candidates and
    the producers after them."""
    _check_A(A, K3_MAX_A)
    return min(max(A + K3_PRODUCERS, K3_MIN_WARPS), K3_MAX_WARPS)


def k3_groups(A: int) -> list:
    """K3's launches for a ladder of A ≥ 1 candidates: (first candidate,
    count) of each, at most K3_MAX_A a launch."""
    if A < 1:
        raise ValueError(f"launch plan: A={A}")
    return [(a, min(K3_MAX_A, A - a)) for a in range(0, A, K3_MAX_A)]


def k3_out_floats(n: int, m: int, tc: int) -> int:
    """K3's output buffer when it emits its stream: two chunks of the
    [x, u, c] slots, [2][tc][n+m+1][32] f32."""
    return 2 * tc * (n + m + 1) * RING_W


def forward_plan(n: int, m: int, A: int, T: int, B: int,
                 emit: bool = False) -> LaunchPlan:
    """K3, one launch of A ≤ K3_MAX_A candidates (:func:`k3_groups`): A
    candidate warps a block and :func:`k3_warps` in all, the ring of K2's
    x_old, u_nom, k, K slots, and with ``emit`` the output buffer after
    it."""
    return _k23_plan(n, m, T, B, RING_W * k3_warps(A), 0,
                     (lambda tc: k3_out_floats(n, m, tc)) if emit
                     else (lambda tc: 0))


def probe_plan(mode: str, T: int, B: int) -> LaunchPlan:
    """K5: ``copy`` strides a grid of up to ``PROBE_COPY_BLOCKS`` blocks
    over the (T, 27, B) copy, no ring; ``light`` and ``full`` one compute
    warp and ``PROBE_PRODUCERS`` producer warps a block, the ring of the 47
    input slots, ``PROBE_STAGES`` deep, as large as a block may have."""
    if mode == "copy":
        _check_shape(T, B)
        units = T * PROBE_OUT_SLOTS * -(-B // PROBE_COPY_SPAN)
        return LaunchPlan(blocks=min(units, PROBE_COPY_BLOCKS),
                          threads=PROBE_COPY_THREADS, tc=0, stages=0,
                          smem=0, chunks=0)
    return _plan(PROBE_SLOTS, T, B, RING_W * (1 + PROBE_PRODUCERS), MAX_SMEM,
                 0, PROBE_STAGES)


class CovShape(NamedTuple):
    warps: int       # compute warps G
    producers: int   # producer warps (0: no ring)
    stages: int      # ring stages (0: no ring)
    sigma: int       # 0: the compute warps store Σ, 1: the producers do,
                     # COV_GLOBAL: Σ in device memory


def cov_shape(n: int) -> CovShape:
    """K4's block at state size n: the measured one at n = 4, 6 and 10
    (COV_WARPS, ...), else the one derived from n (COV_RING_MAX_N). Raises
    NotImplementedError beyond COV_MAX_N."""
    if n in COV_WARPS:
        return CovShape(COV_WARPS[n], COV_PRODUCERS[n], COV_STAGES[n],
                        COV_STAGE_OUT[n])
    if not 1 <= n <= COV_MAX_N:
        raise NotImplementedError(
            f"covariance_lanes: K4 takes n from 1 to COV_MAX_N = "
            f"{COV_MAX_N}, not n={n}")
    if n <= COV_RING_MAX_N:
        rows = 1 if n <= 6 else 2
        return CovShape(-(-n // rows), 2, STAGES, 0)
    return CovShape(min(n, 16), 0, 0, COV_GLOBAL)


def cov_sigma_floats(n: int, tc: int) -> int:
    """K4's Σ buffer after the ring: [2][n²][32] f32, or where the
    producers store Σ two chunks of steps, [2·tc][n²][32]."""
    return (2 * tc if cov_shape(n).sigma == 1 else 2) * n * n * RING_W


def covariance_plan(n: int, T: int, B: int) -> LaunchPlan:
    """K4: :func:`cov_shape`'s compute warps and producer warps a block,
    the ring of F's n² slots, then Σ. Its chunks cover the T-1 steps that
    read an F (none at T = 1). With Σ in device memory: the compute warps
    alone, no ring and no shared memory."""
    _check_shape(T, B)
    shape = cov_shape(n)
    if shape.sigma == COV_GLOBAL:
        return LaunchPlan(blocks=-(-B // RING_W), threads=RING_W * shape.warps,
                          tc=0, stages=0, smem=0, chunks=0)
    slots, steps, stages = n * n, max(T - 1, 1), shape.stages
    tc = TC_MAX
    while tc > 1 and ring_bytes(stages, tc, slots,
                                cov_sigma_floats(n, tc)) > MAX_SMEM:
        tc //= 2
    tc = min(tc, steps)
    smem = ring_bytes(stages, tc, slots, cov_sigma_floats(n, tc))
    if smem > MAX_SMEM:
        raise ValueError(f"launch plan: {smem} shared bytes > {MAX_SMEM}")
    return LaunchPlan(blocks=-(-B // RING_W),
                      threads=RING_W * (shape.warps + shape.producers),
                      tc=tc, stages=stages, smem=smem,
                      chunks=-(-(T - 1) // tc))
