"""Launch plans of the ring-fed kernels: K1 (``backward_lanes``) and K2
(``linesearch_lanes``).

Both kernels give a block 32 scenarios (``RING_W`` columns of the
``(T, S, B)`` streams) and stage the step inputs of those scenarios in a
shared-memory ring (``csrc/ring.cuh``): ``stages`` stages of ``tc`` time
steps each, ``[step][slot][32]`` f32, so that while a chunk of steps
computes, the next ones are in flight. K1 runs ``k1_warps`` compute
warps, which split each step's n×n products by rows and, when there are
several, share them through shared memory after the ring (W and U,
n·(n+m) slots; Vraw, n·n), and a producer warp that fills the ring; K2
runs one warp per α candidate, all of which fill it, and its ring is
followed by the candidates' totals (A × 32 f32).

The plan is made here and passed to the launcher, which checks it against
its instance's slot count and refuses one that does not match. ``tc`` is a
trait of the model's slot count F: the largest power of two up to
``TC_MAX`` whose ring fits the kernel's budget, cut to T.
"""
from __future__ import annotations

from typing import NamedTuple

RING_W = 32                # scenarios a block owns (csrc/ring.cuh)
MAX_SMEM = 232_448         # shared memory a block may opt into on sm_90
MAX_STAGES = 4
TC_MAX = 32
STAGES = 2
# ring budgets, in bytes: K2's A warps share one ring, so it may be large;
# K1's stays small enough for several blocks an SM
K1_BUDGET = 48 * 1024
K2_BUDGET = 144 * 1024


class LaunchPlan(NamedTuple):
    blocks: int      # grid: ceil(B / 32)
    threads: int     # block: 32·(k1_warps+1) (K1), 32·A (K2)
    tc: int          # time steps a chunk
    stages: int      # chunks in the ring
    smem: int        # dynamic shared bytes
    chunks: int      # chunks a pass: ceil(T / tc)

    def launcher_args(self) -> tuple:
        """The five ints the C launchers take."""
        return self[:5]


def k1_slots(n: int, m: int, gps: bool) -> int:
    """Ring slots of a K1 step: x, u; in GPS mode also the previous
    policy's k, K, Σ⁻¹ and η."""
    return n + m + ((m + m * n + m * m + 1) if gps else 0)


def k1_warps(n: int, emit: str, gps: bool) -> int:
    """K1's compute warps (csrc/backward.cuh::K1_WARPS): four where n ≥ 8
    and a step holds n×n work beyond the recursion's own (``"full"``
    emission's Vxx stores, GPS mode's KL terms), else one."""
    return 4 if n >= 8 and (gps or emit == "full") else 1


def k1_exchange(n: int, m: int) -> int:
    """Slots of K1's exchange between its compute warps: W and U by rows,
    then Vraw."""
    return n * (n + m) + n * n


def k2_slots(n: int, m: int) -> int:
    """Ring slots of a K2 step: x_old, u_nom, k, K."""
    return n + 2 * m + m * n


def ring_bytes(stages: int, tc: int, slots: int, extra: int = 0) -> int:
    return 4 * (stages * tc * slots * RING_W + extra)


def _plan(slots: int, T: int, B: int, threads: int, budget: int,
          extra: int) -> LaunchPlan:
    if T < 1 or B < 1:
        raise ValueError(f"launch plan: T={T}, B={B}")
    tc = TC_MAX
    while tc > 1 and ring_bytes(STAGES, tc, slots, extra) > budget:
        tc //= 2
    tc = min(tc, T)
    smem = ring_bytes(STAGES, tc, slots, extra)
    if smem > MAX_SMEM:
        raise ValueError(f"launch plan: {smem} shared bytes > {MAX_SMEM}")
    return LaunchPlan(blocks=-(-B // RING_W), threads=threads, tc=tc,
                      stages=STAGES, smem=smem, chunks=-(-T // tc))


def backward_plan(n: int, m: int, gps: bool, emit: str, T: int,
                  B: int) -> LaunchPlan:
    """K1: k1_warps compute warps and a producer warp a block, the ring of
    its x,u (and GPS) slots, then the compute warps' exchange (none with
    one compute warp, which keeps W and Vraw in registers)."""
    G = k1_warps(n, emit, gps)
    return _plan(k1_slots(n, m, gps), T, B, RING_W * (G + 1), K1_BUDGET,
                 RING_W * k1_exchange(n, m) if G > 1 else 0)


def linesearch_plan(n: int, m: int, A: int, T: int, B: int) -> LaunchPlan:
    """K2: A warps a block, the ring of its x_old, u_nom, k, K slots, then
    the A candidates' totals."""
    return _plan(k2_slots(n, m), T, B, RING_W * A, K2_BUDGET, RING_W * A)
