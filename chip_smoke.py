#!/usr/bin/env python3
"""Drive the PyTorch port's fleet paths once on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA card with the CUDA toolkit (``nvcc``), and imports nothing of JAX.

Phases, each printing its own lines and its wall time; any failed check
ends the run with a non-zero exit and no result line:

1. device: torch/CUDA versions and the card's name and power limit;
2. build: the kernels from ``ops/hopper/csrc`` with nvcc, one process per
   source, and each instance's registers and spills, with the launch plan
   (blocks, threads, steps a chunk, ring stages, shared bytes) of each K1,
   K2, K3, K4 and K5 instance at its path's shapes;
3. iLQG kernels (K3, K1, K2) against their plain PyTorch versions on the
   card at the main path's shapes (B=4096, T=500), with errors and
   CUDA-event timings; pendcart and PendCartParam K1/K2/K3 (here and in
   phases 10, 21 and 23) must be bit-identical to their plain versions;
4. the iLQG main path: ``ilqg_batch_lanes`` on pendcart with the headline
   settings, with launch counts, cost statistics and ms per iteration, and
   the bit-exact α=0 retrace of rejected lanes;
5. the same solve on 64 scenarios with CUDA tensors; the CPU's solve runs
   in an ``--early-cpu`` child from the build on (with phase 9's), and
   phase 77 compares them;
6. quadrotor kernels (n=6, m=2, thrust box (0, 5)): K3, K1
   Autodiff<Quadrotor> (derivatives by forward-mode autodiff in the kernel)
   and K2 against their plain versions, timed at B=4096, T=400; K1
   Autodiff<PendCart> against the analytic pendcart K1 at B=4096, T=500;
7. the pendcart iLQG solve of phase 4 with autodiff tiles, against the
   analytic solve by outcome;
8. the quadrotor path: ``ilqg_batch_lanes`` at the JAX quadrotor tier's
   settings (``bench.py:215-254``: B=4096, T=400, 20-iteration budget),
   with launch counts, histograms, ms per iteration, peak memory, the
   thrust box and the bit-exact α=0 retrace;
9. the quadrotor solve on 64 scenarios with CUDA tensors (the CPU's in
   the ``--early-cpu`` child, compared in phase 77);
10. KL kernels against their plain versions at B=4096, T=500 on a real
    pre-roll: K3 without limits, K4 (bit for bit, with its plan and
    registers), K1 in GPS mode with policy emission; K4 at n=6 on a seeded
    contractive fx at T=400;
11. the KL path: ``ilqgkl_batch_lanes`` at the JAX KL tier's settings
    (``bench.py:114-132``), with launch counts, ms per solve and quality;
12. ``gps_rollout_lanes``, 5 outer KL solves at the same size;
13. the KL solve on 64 scenarios with CUDA tensors (the CPU's in the
    ``--early-cpu`` child, compared in phase 77);
14. LTI kernels (K3, K1 with the m=2 box-QP enumeration and without
    limits, K2) at n=10, m=2 against their plain versions, and their times
    at the LTI fleet's shapes (B=4096, T=1000);
15. the LTI path: ``ilqg_batch_lanes`` on the LTI fleet of
    ``tools/bench_fleet.py --lti`` (n=10, m=2, T=1000, B=4096, ±0.6),
    solved to convergence, with launch counts, histograms, ms per
    iteration, peak memory and the bit-exact α=0 retrace;
16. the LTI solve on 64 scenarios with CUDA tensors (the CPU's in the
    ``--early-cpu`` child, compared in phase 77);
17. KL-on-LTI kernels: K4 at n=10 (bit for bit) and K1 in GPS mode with
    policy emission at ⟨10,2⟩ against their plain versions, and their times
    at B=4096, T=1000;
18. the KL path on the LTI fleet (the reference's demo_linear_kl at fleet
    scale: kl_step=100, scalar η, no limits), with launch counts, ms per
    solve and per iteration, peak memory, quality and a torch.profiler
    split of one solve into kernel time, glue time and device idle share;
19. the 5-outer ``gps_rollout_lanes`` on the LTI fleet;
20. the KL-on-LTI solve on 64 scenarios at T=40 with CUDA tensors (the
    CPU's in the ``--early-cpu`` child, compared in phase 77);
21. heterogeneous kernels at B=4096: the PendCartParam K3, K1 (gains,
    full) and K2 (per-scenario pole length and damping) with per-scenario
    limits against their plain versions at T=500; per-scenario limits on
    the pendcart and LTI ⟨10,2⟩ instances (the m=2 enumeration reading each
    lane's box) against their plain versions; homogeneous rows bit-equal
    to the static path; K2 in place bit-equal to K2 with a fresh output;
    each timed with its bound;
22. the heterogeneous path: ``ilqg_batch_lanes`` on the parametrised
    pendcart fleet with per-scenario limits at the headline settings, each
    lane's controls held to its own box, GPU against CPU on 64 lanes (the
    CPU's in the ``--early-cpu`` child, compared in phase 77); and an LTI
    solve with a per-scenario box;
23. the MPC path's kernel instances (K3 at α=1, K1 gains and full, K2
    with the 4-α ladder fresh and in place, pendcart and PendCartParam)
    against their plain versions at its shapes, with their times and
    bounds; the MPC path at the JAX MPC tier's settings (``bench.py:149-212``:
    B=4096, T=300, 5-iteration warm re-solves, ±10, 20 steps a chunk):
    ms per MPC step from CUDA events over 5 windows of 2 chunks, launches
    and host syncs per step, a torch.profiler split of one chunk, peak
    memory; a chunk with per-scenario parameters and limits; the MPC step
    ``ilqg_iteration_lanes`` (K2 in place) on the MPC state; GPU against
    CPU on 64 lanes over 3 steps (the CPU's in the ``--early-cpu`` child,
    compared in phase 77);
24. the probe K5 (copy, light and full modes) against its plain version,
    with its times and achieved bandwidth;
25. generic boxQP (no kernel: plain PyTorch on the card, f64):
    ``demo_qp(n=500)`` on the card against the same on CPU tensors, and the
    golden QPs of ``tests/test_golden.py`` (n50's H and g from
    ``tools_torch/generic_inputs.npz``) against ``tests/golden.npz``;
26. generic ``ilqg`` on the golden pendcart ("zoh", T=300, ±10) against
    ``golden.npz``, with its iterations, exit reason, ms per iteration
    (CUDA events), host syncs per iteration and device launches per
    iteration (torch.profiler, first iterations);
27. generic ``ilqg`` on ``demo_linear`` (n=10, m=2, T=1000, JAX's spec
    from the committed file) against JAX's CPU outcome in that file, with
    ``backward="scan"`` and ``"parallel"``;
28. ``ilqg_batched`` at B=16, pendcart "zoh", T=150 (GEN_T), ±10, a
    budget of 10 accepted iterations, on the card against the same call on
    CPU tensors;
29. generic ``ilqg_kl``: the golden scalar-η and per-step problems against
    ``golden.npz``, and one ``demo_linear_kl`` outer solve cut to T=200
    (GEN_KL_T);
30. the packed / full DDP group, kernels: K1 on the packed-derivatives
    stream (Packed<4,1> gains and full at T=500 and in GPS mode,
    Packed<6,2> at T=400, Packed<10,2> at T=1000) and with second-order
    tiles (PendCartSO at T=500, Autodiff<PendCart,SO> at T=500,
    Autodiff<Quadrotor,SO> at T=400) against their plain versions (at T=500
    on the pendcart's packed and PendCartSO instances, else at the
    T_PLAIN of the model's earlier phases), timed
    with their bounds; each generator's time and device operations a call
    (``pendcart_packed_derivs``, ``autodiff_packed_derivs`` on the
    quadrotor, ``lti_packed_derivs``);
31. the packed / full DDP group, pendcart paths: the headline solve
    (B=4096, T=500, 20 iterations, ±5) with ``pendcart_packed_derivs``,
    with ``pendcart_derivs_tiles_so`` and with the autodiff second-order
    tiles: ms/iter, K1 ms a launch, the generator's calls and cost, host
    syncs an iteration, peak memory, agreement with the CPU solve on 64
    lanes;
32. the packed / full DDP group, quadrotor paths (B=4096, T=400, 20
    iterations): ``autodiff_packed_derivs`` beside the in-kernel AD solve
    of the same fleet, and full DDP by autodiff, each against the CPU
    solve on 64 lanes; the LTI fleet (B=4096, T=1000, ±0.6, to
    convergence) with ``lti_packed_derivs``, against the CPU solve on 64
    lanes; ``backward_pass_pallas`` in GPS mode at B=4096, T=500 against
    its CPU plain version;
33. the fleet group, LTI: ``ilqg_fleet`` against lock-step
    ``ilqg_batch_lanes`` on the LTI fleet of phase 15 (B=4096, T=1000,
    to convergence) with JAX's three schedules (``tools/bench_fleet.py:
    126-129``), bit for bit in cost_total, reason, n_accepted, u, x and
    policy.K; each schedule's ms (CUDA events after a warm-up), chunks,
    lanes a chunk, host syncs, peak memory and launches; whether
    ``torch.mean`` over T of a lane depends on its batch on the card;
34. the fleet group, pendcart (JAX ``tools/bench_fleet.py``'s default leg:
    T=500, ±5, x0 spread 0.4 on angle and cart, u0 = 0, max_iter 300):
    lock-step ms per iteration at B=4096, 16384 and 65536, the fleet
    against lock-step at B=4096 and B=65536 as in phase 33, and the
    stitched ``record_trace`` against lock-step's trace;
35. the fleet group, KL: ``ilqgkl_fleet`` against ``ilqgkl_batch_lanes``
    on the KL path's inputs (B=4096, T=500) with scalar and per-step η,
    bit for bit also in η, satisfied, divergence and n_iters;
36. the fleet group, sharded: a one-rank NCCL group on the card (a file
    store, no port): ``ilqg_batch_sharded`` and ``ilqg_fleet_sharded`` on
    phase 34's inputs, ``ilqgkl_batch_sharded`` and
    ``ilqgkl_fleet_sharded`` on phase 35's, ``ilqg_sharded`` on phase 28's
    cut to 3 iterations, each equal to its unsharded call and its stats to
    the local sums;
37. the m3 group, kernels: the LTI fleet with a third control (n=10,
    m=3, ±0.6): K3 sweep A=6 and rollout A=1, K1 ⟨10,3⟩ gains and full
    with the box (the masked projected-Newton box QP, warm-started) and
    without it (the 3×3 Cholesky), with ptxas's registers and stack, and
    K2 A=6 fresh and in place, each against its plain version at T=17 (two
    chunks and a step of K1's gains ring) on the same CUDA tensors, timed
    at B=4096, T=1000 with their bounds;
38. the m3 group, path: ``ilqg_batch_lanes`` on that fleet (B=4096,
    T=1000, a budget of 30 iterations; run to convergence it took
    150.6 s on an H100), once, its kernels warmed by phase 37: ms per
    solve (CUDA events), n_iters and their spread, K1 launches an
    iteration (the λ-retries),
    the share of steps with a clamp active, the box held, peak memory,
    host syncs, launches;
39. the m3 group, fleet: ``ilqg_fleet`` (JAX's first schedule) bit-equal
    to lock-step on the same fleet cut to T=100, one run of each;
40. the m3 group, KL: K1 ⟨10,3⟩ in GPS mode with policy emission (the
    3×3 Cholesky) against its plain version, then ``ilqgkl_batch_lanes``
    on the m=3 fleet pre-rolled by K3 (kl_step 100, scalar η, no limits):
    ms per solve, pd_failed, satisfied share, η;
41. the m3 group against the CPU: the iLQG and KL solves on 64 lanes at
    T=40 on the card against the same solves on CPU tensors, run by a
    child process (``chip_smoke.py --m3-cpu``) from the build on;
42. the lowered group, build: models written only in Python (the
    quadrotor, PendCartParam and LTI <10,2> with their descriptors
    removed, the quadrotor with an angle-wrapping ``diff``) lowered into
    libraries of their own (ops/hopper/lower.py, csrc/lowered.cuh), whose
    builds started in a thread after phase 2: each build's seconds and
    each instance's registers and spills;
43. the lowered group, kernels: the lowered quadrotor's K3 (sweep,
    rollout), K1 (gains, full, GPS policy and full, second order) and K2
    bit for bit to the hand-written Quadrotor / Autodiff<Quadrotor>
    instances at T=400 and against their plain versions (K1 at
    QUAD_T_PLAIN); the lowered LTI <10,2> K1 (Autodiff<Lowered>) at
    T=1000 against its plain version at T=64; the lowered PendCartParam's
    K3, K1 and K2 with params against their plain versions; times and
    bounds;
44. the lowered group, path: the quadrotor fleet (B=4096, T=400, 20
    iterations) with the lowered model, bit-equal to the hand-written
    solve in cost, reason, accepted count, u, x and K, ms/iter of both;
    the heterogeneous headline (T=500, 20 iterations) with autodiff tiles
    and params, against the ``--packed-cpu`` child's solve of 64 lanes;
45. the lowered group, quad-kl: ``ilqgkl_batch_lanes`` on the quadrotor
    (pre-rolled by K3, scalar η, no limits, T=400), hand-written and
    lowered bit for bit, launching K4 at n=6 and K1 GPS policy; against
    the child's solve of 64 lanes at T=16;
46. the lowered group, diff: K3 and K2 with the angle-wrapping diff
    against their plain versions, and a 20-iteration fleet solve;
47. the lowered group, quad-jax: the card's quadrotor solve of the 64
    lanes of ``tools_torch/quad_outcomes.npz`` (T=400, 20 iterations)
    against the JAX package's outcomes there
    (``tools_torch/make_quad_outcomes.py``): reasons and accepted counts,
    and the costs iteration by iteration (held to JAX's through
    QUAD_JAX_ITERS, where rounding does not yet decide them);
48. the tiles group, tiles-build: a user's Python derivative tiles and
    the time-varying models (``tiles_models``) lowered, their libraries
    built beside the earlier phases (LoweredTiles ``t1``, ``t1_gps``,
    ``t1_so``; Lowered ``fwd``, Autodiff<Lowered> ``k1``);
49. the tiles group, tiles-kernels: K1 LoweredTiles of
    ``lti_derivs_tiles(spec).fn`` (no descriptor) bit for bit against the
    hand-written LTI K1 (gains, full, GPS policy) at B=4096, T=1000, and
    every new instance (LoweredTiles LTI, GPS, reading t, second order;
    Autodiff<Lowered> reading t; the lowered K3 and K2 of the LTI, the
    tracking LTI and the tracking quadrotor) against its plain version at
    TILES_T_PLAIN, timed at its path's T;
50. the tiles group, tiles-lti: the LTI fleet (B=4096, T=1000, ±0.6, to
    convergence) with a Python-only model and the user's tiles against the
    hand-written solve in the same call, then KL on it (kl_step 100,
    scalar η, no limits; K1 LoweredTiles GPS policy, K4 n=10);
51. the tiles group, lti-track: the same fleet tracking r(t) =
    0.5·sin(π·h·t) on state 0 with the user's tiles reading t, against a
    CPU solve of 64 lanes at T=40 (the ``--tiles-cpu`` child);
52. the tiles group, quad-track: the quadrotor fleet (B=4096, T=400,
    thrust box, 20 iterations) tracking px = 0.5·sin(π/2·h·t) with
    autodiff tiles, against a CPU solve of 64 lanes at T=16;
53. the tiles group, tiles-so: full DDP on the headline pendcart (B=4096,
    T=500, 20 iterations) with the user's second-order tiles, bit for bit
    PendCartSO's solve;
54. the ladder group, ladder-kernels: K3 and K2 with ladders longer than
    a block's eight candidate warps (A = 9, 11, 16, 40; K2 in rounds of
    one launch, K3 in launches of at most eight) against their plain
    versions at T=33, B=4096, on the pendcart (bit for bit), LTI <10,2>,
    the quadrotor and the lowered quadrotor, with lanes accepting
    candidates past the first round; a 65-α ladder refused; K2 and K3 at
    A=11 against A=6 at the headline's shape (B=4096, T=500);
55. the ladder group, ladder-fleet: the headline fleet with
    ``ILQGConfig()``'s own 11-α ladder (B=4096, T=500, 20 iterations),
    ms/iter beside the 6-α headline's, 64 lanes against a CPU solve (the
    ``--demos-cpu`` child);
56. demos: ``demos.main``'s help and exit codes, ``main(["boxqp"])``,
    ``main(["fleet"])`` and ``main(["quadrotor"])`` at their defaults
    (B=4096), the fleet's and the quadrotor's first 64 lanes against the
    CPU child's solves (the quadrotor at T=16), demo_mpc (lanes tier) at
    its defaults, demo_linear, demo_linear_kl and demo_pendcart cut
    (DEMO_CUTS), each demo's wall;
57. aot: the headline lane solve and demo_linear's generic solve (cut to
    T=100) exported, each served from its bytes in a fresh process that
    never defined its closure, bit for bit the direct call, a wrong B
    refused, the served time against the direct one;
58. the sizes group, sizes-build: the group's libraries (the lowered rail,
    LTI <8,2>, op-set and pow models; K4 at every n of COV_NS and at
    COV_MAX_N; the packed K1 at PACKED_SIZES), one nvcc each from the
    main build on, and K4's build time one library an n against one
    library of all n;
59. the sizes group, rail: the headline fleet (B=4096, T=500, ±5, 20
    iterations, u0 = 2·N(0,1)) on a finite rail (tools_torch/rail.py, a
    Python-only model with abs, clamp, pow, log, a comparison and where):
    its K3, K1 Autodiff<Lowered> (gains, full, GPS) and K2 against their
    plain versions at T=33, the share of lanes past the rail's end before
    and after the solve, then KL on it at the KL tier's settings; 64
    lanes of each against the ``--sizes-cpu`` child's solves;
60. the sizes group, lti8: random_lti(0, n=8, m=2, T=1000) through the
    plain lti_lanes and lti_derivs_tiles (no descriptor: the lowering),
    B=4096, ±0.6: its kernels, K4 n=8 and Packed<8,2> against their plain
    versions; the fleet to convergence, KL on it (kl_step 100), the
    packed solve (20 iterations), each against the child's 64 lanes;
61. the sizes group, ops: at T=33, B=4096, the op-set model's K3, K1
    (Dual and Jet passes) and K2, pow against torch.pow at eight
    exponents, K4 at every n of COV_NS and at COV_MAX_N, Packed<5,4>,
    each against its plain version;
62. the controls group, controls-build: libraries generated for m above
    the kernel library's MAX_M = 4 (csrc/common.cuh DDP_MAX_M), started
    after the quadrotor phases with the group's CPU child: per size
    of tools_torch/controls.SIZES the lowered LTI (fwd) and its tiles'
    t1, t1_gps and second-order t1_so; the arm's fwd, t1 and t1_gps; K4
    n=14; Packed<6,5> and <10,8>; the tie model's fwd and k1; one nvcc
    each;
63. the controls group, controls-kernels: random_lti(1) at <6,5>, <10,8>
    and <16,16>, B=4096, T=17, 5 and 3: K3 (sweep, rollout), K1
    LoweredTiles (gains, full, policy; GPS full, policy; second order
    gains, full) and K2 (A=6, 11), Packed<6,5> and <10,8>, each bit for
    bit its plain version; m=33 refused before anything is lowered or
    built;
64. the controls group, arm7: random_lti(0, n=14, m=7) cut to T=100,
    B=4096, ±0.6 (a 7-joint arm's shape): its kernels and K4 n=14 bit for
    bit against their plain versions at T=9; the fleet with a budget of 10
    iterations (ms/iteration, K1 launches, λ-retries, peak memory); KL on
    it (kl_step 100, scalar η, no limits); 64 lanes of each against the
    ``--controls-cpu`` child's solves at T=8;
65. the controls group, ties: the tie model (tools_torch/ties.py, u
    clamped to ±5 in the dynamics, 0.1·|u| in the cost): K3, K1
    Autodiff<Lowered> (JAX's rules at ties, Dual and Jet) and K2 bit for
    bit against their plain versions at T=33 with the controls on their
    ties (counted), the rail's kernels still bit-equal; the headline fleet
    from u0 = 0 (B=4096, T=500, 20 iterations) against the child's 64
    lanes at T=8;
66. the humanoid group, humanoid-build: K1's wide library (one for every
    size, csrc/backward_wide.cuh) and the lowered K2/K3 of the humanoid's
    LTI <54,21> and of the ceiling <64,32>, started after the quadrotor
    phases with the group's CPU child (``--humanoid-cpu``), one nvcc each;
67. the humanoid group, wide-kernels: the wide K1 at the smallest sizes
    the plan gives it (<30,2> full; <28,8> gains, full, policy, GPS full
    and policy), T=3, B=512, bit for bit its plain version on the card;
    K3 and K2 at <54,21> (one ring stage) and at <64,32> (K read from
    device memory), T=3; the wide K1 at <54,21> (gains, GPS policy) and at
    <64,32> (gains), T=2, bit for bit the plain version in the CPU child;
    n=65 refused before anything is lowered or built;
68. the humanoid group, humanoid: random_lti(0, n=54, m=21, T=100) (the
    DeepMind Control Suite humanoid's linearisation), B=512, ±0.6 on every
    control, the LTI fleet's ILQGConfig with a budget of 10 iterations:
    ms/iteration, K1 launches, λ-retries, peak memory, the stream's bytes;
    the median cost below the initial rollout's; its kernels timed at the
    path's shapes;
69. the humanoid group, humanoid-kl: K4 n=54 bit for bit its plain
    version; KL on the humanoid (kl_step 100, scalar η, no limits), the
    wide K1 in GPS policy; kl_div_wiki_lanes timed and profiled;
70. the humanoid group, humanoid-gpu-vs-cpu: 16 lanes at T=4 of the fleet
    and of KL against the ``--humanoid-cpu`` child's plain solves;
71. the sources group, sources-kernels: every K1 instance of a public
    derivative source that the fleet entries reach (Autodiff<LTI> at
    <10,2> and <10,3>, first and second order; Autodiff<PendCartParam>,
    first and second order; the GPS policy of Autodiff<PendCart>,
    Autodiff<PendCart,SO>, PendCartSO and Autodiff<Quadrotor,SO>; the
    lowered pendcart's and a user's second-order tiles in GPS mode, their
    libraries built in a thread from the controls group's start, the
    sources library from the main build on), B=512, T=9-17, bit for bit
    its plain version on the card (out, stats);
72. the sources group, kl-ad: the KL tier (pendcart, B=4096, T=500,
    kl_step 2) with autodiff_derivs_tiles against the analytic tiles;
73. the sources group, lti-ad: the LTI fleet (<10,2>, T=1000, B=4096,
    ±0.6, to convergence) with autodiff_derivs_tiles(lti_lanes(spec)),
    then KL on it, each against lti_derivs_tiles;
74. the sources group, hetero-ad: the heterogeneous headline
    (PendCartParam, per-scenario l, d and limits, B=4096, T=500) with
    autodiff tiles against pendcart_derivs_tiles_param;
75. the sources group, kl-ddp: the KL tier with pendcart_derivs_tiles_so
    against the first-order tiles;
76. the sources group, sources-gpu-vs-cpu: each path on a lane subset
    against the ``--sources-cpu`` child's plain solves;
77. early-gpu-vs-cpu: phases 5, 9, 13, 16, 20, 22 and 23's card solves
    against the ``--early-cpu`` child's CPU solves (cost, reason and
    accepted count, for KL satisfied and iterations, on 64 lanes; the MPC
    loop's states and costs);
78. the kernel record (one entry per kernel instance, with its bound; an
    instance on no path with the launches of its check) and the result
    line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

B, T, ITERS = 4096, 500, 20
B_CPU = 64
LIMS = ((-5.0, 5.0),)
# kernel against plain version, both f32 on the card: max |a-b| over the
# output, divided by max |plain|. Kernel and plain version run the same
# operations in the same order (nvcc --fmad=false, one torch op per
# operation); only the card's sinf/cosf inside the kernel and PyTorch's
# elementwise sin/cos can differ in the last ulp, and 500 steps of the
# pendulum amplify such an ulp. 1e-4 of the output's scale bounds that.
KERNEL_TOL = 1e-4
# the device time a cuda_ms timing may spend on its repeated runs (ms):
# 1000 until the humanoid group came; 250 gave back ≈31 s of plain
# versions' repeats (those of 250-1000 ms now timed by one run)
CUDA_MS_BUDGET = 250.0
# Quu⁻¹ (full emission): where Quu = cuu + fuᵀVxx·fu nearly cancels (the
# latch check's concave R), Quu⁻¹ is large and amplifies an ulp of Quu's
# terms; measured as ~1e-5 relative on the card at small shapes
QUU_INV_TOL = 1e-3
# K1 with latched lanes (concave R): a latched lane runs the recursion with
# K = 0, the uncontrolled pendulum's Riccati recursion, whose Vxx grows
# ~e^(2·5.3·h·t) over 500 steps and amplifies the ulp differences of the
# card's sinf/cosf and PyTorch's in fx; measured 5.4e-3 of the output's
# scale on an H100
LATCH_TOL = 1e-2
# GPU solve against CPU solve (section 5): the share of lanes whose costs
# agree to COST_RTOL, and whose reasons and accepted counts agree, must each
# reach AGREE_SHARE. The two run different sin/cos implementations; over
# T=500 and 20 iterations the f32 differences can flip one line-search
# decision of a lane, which then follows another path (measured on an H100:
# 2 to 3 of 64 lanes outside 1e-3, up to 5.9e-2 apart in cost), so lanes are
# compared by outcome, not bit for bit.
COST_RTOL = 1e-3
AGREE_SHARE = 0.9
# the KL path (JAX KL tier, bench.py:114-132): scalar η, no limits
KL_STEP, KL_ITERS, GPS_OUTER = 2.0, 10, 5
# K4 against its plain version: the same f32 products and sums in the same
# order and no transcendentals, so the two should agree bit for bit; Σ grows
# ~1e10-fold along the unstable pendcart linearisation, so each slot is held
# by its error relative to that slot's largest magnitude
COV_TOL = 1e-6
# K1 in GPS mode against its plain version, each of the k, K and Quu slots
# by its error over that slot's own largest magnitude, so that a small slot
# (k) is not judged on the scale of a large one (Quu). Same operations in
# the same order on both sides; the card's sinf/cosf against PyTorch's is
# what is left, measured ≤6e-7 over the whole output's scale on an H100
GPS_SLOT_TOL = 1e-5
# the LTI fleet (tools/bench_fleet.py --lti, reference demo_linear,
# src/demo_linear.jl:9-26): the spec of random_lti at n=10, m=2, T=1000
LTI_N, LTI_M, LTI_T = 10, 2, 1000
LTI_LIMS = ((-0.6, 0.6), (-0.6, 0.6))
# the plain K1 at n=10 is ≈6.5k torch operations a step; compared at a
# short horizon, the kernels timed at the full one: three chunks of K1
# gains' ring (tc 16, two stages), so that the ring wraps
LTI_T_PLAIN = 33
# the LTI solve on 64 scenarios with the plain versions on the host: T kept
# short so that it takes well under a minute
LTI_T_CPU = 40
# the KL path on the LTI fleet: the reference's demo_linear_kl
# (src/demo_linear.jl:63-136; JAX demos.py:44-66) at fleet scale
KL_LTI_STEP = 100.0
# the probe K5 (tools/probe_kernel_cost.py): T=500 steps of a 47-slot stream
PROBE_T = 500
# the quadrotor fleet (JAX bench.py:215-254 bench_quadrotor): n=6, m=2,
# thrust box (0, 5), B=4096, T=400, a 20-iteration budget, derivatives by
# forward-mode autodiff inside K1
QUAD_T = 400
# the plain K1 with autodiff tiles is ≈50 torch.func operations and ≈2k
# torch operations a step: compared at a short horizon, timed at QUAD_T;
# three chunks of K1's ring (tc 16, two stages), so that the ring wraps
QUAD_T_PLAIN = 33
# the quadrotor solve on 64 scenarios with the plain versions on the host
# (≈0.2 s a K1 step there): a short horizon
QUAD_T_CPU = 16
# the packed / full DDP group's quadrotor fleet: x0 = default_x0 +
# 0.3·N(0,1)·[1,0,1,0,0.5,0] from its own seed, so that the child process
# of its CPU solves (packed_cpu_solves) draws the same lanes
PACKED_QUAD_SEED = 22
# K1 with autodiff tiles against its plain version, each slot by its error
# over that slot's largest magnitude, as GPS_SLOT_TOL. The kernel's Dual and
# Jet rules are PyTorch's forward-mode rules in PyTorch's order; what is
# left is the card's sinf/cosf against PyTorch's. The thrust box (0, 5) is
# active at its lower bound at rest, so the m=2 box QP meets near-ties: where
# one rotor is clamped, two candidates' objectives differ by less than an f32
# ulp and the two versions may pick different ones, k then ~sqrt(ulp) apart
# (PR 3's rule): at most TIE_SHARE of the elements may exceed AD_SLOT_TOL.
# Measured on an H100 at T=64, B=4096: bit-identical in both emissions.
AD_SLOT_TOL = 1e-5
TIE_SHARE = 0.01
# K1 Autodiff<PendCart> against K1 pendcart with analytic derivatives on
# the same trajectory: the AD expansion forms cx as 2·(Q/2)·dx and the
# Jacobians by the chain rule, a few ulps from the hand-written ones, and
# 500 steps of the Riccati recursion carry them (measured on an H100 at
# B=4096, T=500: 5.1e-6); per slot, as above
AD_ANALYTIC_TOL = 1e-4
# heterogeneous fleets: per-scenario pole length and damping in the ranges
# of tests/test_param_fleet.py:23-24, limits ±U(0.8, 6.0)
# (tests/test_heterogeneous_lims.py:66); on LTI ⟨10,2⟩ a box per lane and
# control, lo = -U(0.3, 0.9), hi = U(0.3, 0.9), about the fleet's ±0.6
PARAM_L, PARAM_D, HETERO_HI = (0.25, 0.55), (0.5, 1.5), (0.8, 6.0)
LTI_BOX = (0.3, 0.9)
# the MPC tier (JAX bench.py:149-212 bench_mpc): pendcart, ±10, a 4-α
# ladder, reg_type 2, lam_max 1e15, 5-iteration warm re-solves with iter_cap
# 9, B=4096, T=300, 20 steps a chunk; one chunk, one burn-in chunk, then 5
# timed windows of 2 chunks
MPC_T, MPC_STEPS, MPC_WINDOWS, MPC_LIMS = 300, 20, 5, ((-10.0, 10.0),)
# the MPC loop on 64 lanes with CUDA tensors and with CPU tensors
MPC_CPU_STEPS = 3
# MPC steps of ilqg_iteration_lanes (K1 gains, K2 in place) on the MPC state
ITER_STEPS = 5
# the generic tier (phases 25-29): plain PyTorch in f64, no kernel of the
# port. The golden problems of tests/test_golden.py at that test's
# tolerances; demo_qp(n=500) card against CPU to GEN_QP_RTOL; demo_linear
# at T=1000 against JAX's CPU outcome to GEN_LTI_RTOL; ilqg_batched card
# against CPU to GEN_BATCH_RTOL. A pendcart swing-up ends at the f64 noise
# floor of its cost, where the last bits decide between exit 2 (the last
# change, a few ulps of the cost, accepted) and exit 3 (rejected until
# λ > λmax): a lane whose last change is below GEN_NOISE·|cost| may take
# either of the two on the card and on the host
GEN_QP_RTOL, GEN_LTI_RTOL, GEN_BATCH_RTOL = 1e-9, 1e-8, 1e-6
GEN_B, GEN_T, GEN_PROFILE_ITERS, GEN_NOISE = 16, 150, 3, 1e-12
# the demo_linear_kl outer solve's horizon (the demo's own is 1000; the
# solve is held to finite outcomes only, and the host issues every op)
GEN_KL_T = 200
# ilqg_batched's budget of accepted iterations: the lanes' full solves take
# up to ≈310 iterations, ≈100 s a run on the host at T=300; the phase runs
# it twice
GEN_BATCH_ITERS = 10
# the m3 group: the LTI fleet with a third control (random_lti at n=10,
# m=3, the reference's construction, src/demo_linear.jl:9-26), a ±0.6 box
# on each control, which binds (the unconstrained solution's controls
# reach 3.5-17), the K1 box QP's iterations (JAX's default), the T of
# the kernel checks (two chunks and a step of K1 gains' ring, tc 8), and
# the T of the fleet's bit-equality check: the converged solve at T=1000
# takes ≈150 s on an H100 (most of it λ-retries of the whole fleet), so
# ilqg_fleet is held to lock-step at a cut horizon
M3_M = 3
M3_LIMS = ((-0.6, 0.6),) * M3_M
M3_QP_ITERS = 8
M3_T_CHECK = 17
M3_T_FLEET = 100
KERNEL_NAMES = ("backward_kernel", "backward_wide_kernel",
                "linesearch_kernel", "forward_kernel", "covariance_kernel",
                "probe_copy_kernel", "probe_ring_kernel")
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes and
# float32 operations outside the tensor cores, per millisecond
HBM_PER_MS = 3.35e12 / 1e3
# f32 instructions per millisecond when every multiply and add is its own
# instruction (nvcc --fmad=false): 132 SMs × 128 lanes × 1.755 GHz
NOFMA_PER_MS = 132 * 128 * 1.755e6
F32_PER_MS = 67e12 / 1e3
LIBRARY = ("none: no single PyTorch call computes this sequential "
           "recursion")
# GPU KL solve against CPU KL solve (section 9), by outcome as in section 5:
# the share of lanes with the same `satisfied`, the same n_iters, and
# cost_total within COST_RTOL must each reach AGREE_SHARE. The η bracket
# moves by factors of 10 on decisions taken on an f32 mean KL; an iterate
# that leaves the swing-up amplifies the card's sinf/cosf ulps against the
# host's, which can flip one such decision on a lane and send it on
# another path.


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Device time of one run of ``fn``: CUDA events around ``reps``
    back-to-back runs after one warm-up, over ``reps``; fewer runs where
    the warm-up shows that ``reps`` would take more than CUDA_MS_BUDGET ms
    (a plain version, a kernel of a library generated for a large m), and
    the warm-up's own time where it alone takes more. Back to back, the
    host's time to issue a run (the wrappers' checks) hides behind the
    device's work instead of adding to a short kernel's time."""
    first = once_ms(fn)
    if first > CUDA_MS_BUDGET:
        return first
    reps = max(1, min(reps, int(CUDA_MS_BUDGET / max(first, 1e-3))))
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def err(a: torch.Tensor, b: torch.Tensor):
    """(max abs error, max abs error / max |b|), equal values (an infinity
    of the same sign included) and NaN in the same place counting as
    equal."""
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, 0.0, (a - b).abs())
    d = torch.where(torch.isnan(d), float("inf"), d)
    scale = torch.where(torch.isfinite(b), b.abs(), 0.0).max().item()
    mx = d.max().item()
    return mx, mx / max(scale, 1e-30)


def compare(name: str, pairs, tol=KERNEL_TOL) -> float:
    worst = 0.0
    for out, (a, b) in pairs.items():
        mx, rel = err(a, b)
        print(f"  {name} {out}: max_abs_err={mx:.3e} rel={rel:.3e} "
              f"(tol {tol:.0e})")
        check(rel <= tol, f"{name} {out}: rel error {rel:.3e} > {tol:.0e}")
        worst = max(worst, mx)
    return worst


def compare_slots(name: str, a: torch.Tensor, b: torch.Tensor,
                  tol: float) -> float:
    """Stream (T, S, B) against stream: max |a-b| over each slot's largest
    |b|, the worst slot checked against tol; returns the max abs error."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    scale = b.abs().amax(dim=(0, 2), keepdim=True).clamp_min(1e-30)
    rel = (d / scale).max().item()
    mx = d.max().item()
    exact = bool(torch.equal(a, b))
    print(f"  {name}: max_abs_err={mx:.3e}, max over slots of err/slot "
          f"scale={rel:.3e} (tol {tol:.0e}); bit-identical: {exact}")
    check(torch.isfinite(a).all().item(), f"{name}: non-finite values")
    check(rel <= tol, f"{name}: slot-relative error {rel:.3e} > {tol:.0e}")
    return mx


def compare_slots_ties(name: str, a: torch.Tensor, b: torch.Tensor,
                       tol: float, share: float = TIE_SHARE) -> float:
    """As :func:`compare_slots`, but at most ``share`` of the elements may
    exceed tol: the m=2 box QP's near-ties (see AD_SLOT_TOL). Returns the
    max abs error."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    scale = b.abs().amax(dim=(0, 2), keepdim=True).clamp_min(1e-30)
    r = d / scale
    over = (r > tol).float().mean().item()
    mx = d.max().item()
    print(f"  {name}: max_abs_err={mx:.3e}, max over slots of err/slot "
          f"scale={r.max().item():.3e}, share above {tol:.0e}: {over:.3e} "
          f"(at most {share}); bit-identical: {bool(torch.equal(a, b))}")
    check(torch.isfinite(a).all().item(), f"{name}: non-finite values")
    check(over <= share, f"{name}: {over:.3e} of the elements above "
          f"{tol:.0e} (at most {share})")
    return mx


def check_bits(name: str, *pairs, to: str = "the plain version") -> None:
    """Kernel against plain version (or ``to``, another instance) where
    both run the same f32 operations in the same order and the plain
    pendcarts divide as the kernels do (``models/pendcart.py::_over``):
    every output bit for bit."""
    same = all(torch.equal(a, b) for a, b in pairs)
    print(f"  {name}: bit-identical to {to}: {same}")
    check(same, f"{name}: not bit-identical to {to}")


def compare_k1(what: str, k, p) -> float:
    """K1 ⟨4,1⟩ (pendcart or PendCartParam, gains or full emission) against
    its plain version: the stream and dV to KERNEL_TOL, Quu⁻¹ to
    QUU_INV_TOL, the divergence flags exactly, and then every output bit
    for bit. Returns the max abs error."""
    errs = [compare(what, {"out": (k.out[:, :26], p.out[:, :26]),
                           "dV": (k.stats[:2], p.stats[:2])})]
    if k.out.shape[1] == 27:
        errs.append(compare(what, {"Quu_inv": (k.out[:, 26], p.out[:, 26])},
                            QUU_INV_TOL))
    check(torch.equal(k.stats[2:], p.stats[2:]),
          f"{what}: diverged/diverge_idx differ")
    check_bits(what, (k.out, p.out), (k.stats, p.stats))
    return max(errs)


class Phases:
    """Wall time per phase, printed when the next phase starts."""

    def __init__(self):
        self.t0 = self.mark = time.perf_counter()
        self.name = None
        self.walls = {}

    def start(self, name: str, title: str = "") -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.walls[self.name] = now - self.mark
            print(f"  [{self.name}: {now - self.mark:.1f} s wall]")
        self.name, self.mark = name, now
        print(f"== {name}{': ' + title if title else ''}")

    def summary(self) -> str:
        self.start("record")
        return ", ".join(f"{k} {v:.1f} s" for k, v in self.walls.items()) + (
            f"; total {time.perf_counter() - self.t0:.1f} s")


def counted(counters, fn):
    """Run fn with every launch counter set to 0 just before; returns
    (result, {name: launches in that run})."""
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in counters}


def ptxas_summary(log: str):
    """One line per kernel instance from nvcc's ``-Xptxas -v`` report:
    kernel<model, template arguments>: registers, stack, spill bytes."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kern = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", mangled)
            targs = kern.group(2) if kern else ""
            # the model's mangled type, stripped before its template
            # arguments are read
            model = None
            for pat, nm in MANGLED_MODELS:
                if targs.startswith(pat):
                    model, targs = nm, targs[len(pat):]
                    break
            args = ([model] if model else []) + re.findall(r"L[ib](\d+)E",
                                                           targs)
            args += {"6float4": ["float4"], "f": ["float"]}.get(targs, [])
            name = (f"{kern.group(1) if kern else mangled}"
                    f"<{', '.join(args)}>")
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
            name, spill = None, ""
    return out


# the kernels' model types as nvcc mangles them (a template argument
# list's prefix), and their names here
MANGLED_MODELS = (
    ("NS_8AutodiffINS_3LTIILi10ELi2EEELb1EEE", "Autodiff<LTI<10,2>,SO>"),
    ("NS_8AutodiffINS_3LTIILi10ELi2EEELb0EEE", "Autodiff<LTI<10,2>>"),
    ("NS_8AutodiffINS_3LTIILi10ELi3EEELb1EEE", "Autodiff<LTI<10,3>,SO>"),
    ("NS_8AutodiffINS_3LTIILi10ELi3EEELb0EEE", "Autodiff<LTI<10,3>>"),
    ("NS_8AutodiffINS_13PendCartParamELb1EEE", "Autodiff<PendCartParam,SO>"),
    ("NS_8AutodiffINS_13PendCartParamELb0EEE", "Autodiff<PendCartParam>"),
    ("NS_3LTIILi10ELi2EEE", "LTI<10,2>"),
    ("NS_3LTIILi10ELi3EEE", "LTI<10,3>"),
    ("NS_8AutodiffINS_9QuadrotorELb1EEE", "Autodiff<Quadrotor,SO>"),
    ("NS_8AutodiffINS_9QuadrotorELb0EEE", "Autodiff<Quadrotor>"),
    ("NS_8AutodiffINS_8PendCartELb1EEE", "Autodiff<PendCart,SO>"),
    ("NS_8AutodiffINS_8PendCartELb0EEE", "Autodiff<PendCart>"),
    ("NS_8AutodiffINS_7LoweredELb1EEE", "Autodiff<Lowered,SO>"),
    ("NS_8AutodiffINS_7LoweredELb0EEE", "Autodiff<Lowered>"),
    ("NS_7LoweredE", "Lowered"),
    ("NS_12LoweredTilesE", "LoweredTiles"),
    ("NS_6PackedILi4ELi1EEE", "Packed<4,1>"),
    ("NS_6PackedILi6ELi2EEE", "Packed<6,2>"),
    ("NS_6PackedILi10ELi2EEE", "Packed<10,2>"),
    ("NS_10PendCartSOE", "PendCartSO"),
    ("NS_13PendCartParamE", "PendCartParam"),
    ("NS_8PendCartE", "PendCart"),
    ("NS_9QuadrotorE", "Quadrotor"))
# K1's and K2's instances: (n, m, T of the path the plan is printed for)
RING_PATHS = {"PendCart": (4, 1, T), "PendCartParam": (4, 1, T),
              "Autodiff<PendCart>": (4, 1, T), "LTI<10,2>": (10, 2, 1000),
              "LTI<10,3>": (10, 3, 1000),
              "Autodiff<Quadrotor>": (6, 2, 400), "Quadrotor": (6, 2, 400),
              "Packed<4,1>": (4, 1, T), "Packed<6,2>": (6, 2, 400),
              "Packed<10,2>": (10, 2, 1000), "PendCartSO": (4, 1, T),
              "Autodiff<PendCart,SO>": (4, 1, T),
              "Autodiff<Quadrotor,SO>": (6, 2, 400)}


def plan_text(p) -> str:
    """blocks × threads, steps a chunk, stages, shared bytes."""
    return (f"{p.blocks}×{p.threads} threads, tc {p.tc}, {p.stages} stages, "
            f"{p.smem} shared bytes")


def with_plan(line: str) -> str:
    """A ptxas line of a ring-fed instance (K1 backward_kernel, K2
    linesearch_kernel, K3 forward_kernel, K5 probe_*_kernel) with its launch
    plan (ops/hopper/plan.py) at its path's shapes: blocks × threads, steps
    a chunk, stages, shared bytes."""
    import re
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    m = re.match(r"covariance_kernel<(\d+),", line)
    if m:
        n = int(m.group(1))
        Tk = {4: T, 6: QUAD_T, 10: LTI_T}[n]
        return (f"{line} | plan at B={B}, T={Tk}: "
                f"{plan_text(plan.covariance_plan(n, Tk, B))}")
    m = re.match(r"probe_(copy|ring)_kernel<(\w*)>", line)
    if m:
        mode = ("copy" if m.group(1) == "copy" else
                {"60": "light", "600": "full"}.get(m.group(2)))
        return (f"{line} | plan at B={B}, T={PROBE_T}: "
                f"{plan_text(plan.probe_plan(mode, PROBE_T, B))}"
                if mode else line)
    m = re.match(r"(backward|linesearch|forward)_kernel<(Autodiff<\w+"
                 r"(?:,SO)?>|LTI<\d+,\d+>|Packed<\d+,\d+>|\w+)(?:, (\d+))?"
                 r"(?:, (\d+))?>", line)
    if not m or m.group(2) not in RING_PATHS:
        return line
    n, mm, Tp = RING_PATHS[m.group(2)]
    if m.group(1) == "backward":
        emit = ("gains", "full", "policy")[int(m.group(3))]
        plans = [("", plan.backward_plan(n, mm, m.group(4) == "1", emit, Tp,
                                         B, m.group(2).startswith("Packed")))]
    elif m.group(1) == "linesearch":
        plans = [("A=6 ", plan.linesearch_plan(n, mm, 6, Tp, B))]
    else:
        emit = m.group(3) == "1"
        plans = [(f"A={A} ", plan.forward_plan(n, mm, A, Tp, B, emit))
                 for A in (6, 1)]
    return f"{line} | plan at B={B}, T={Tp}: " + "; ".join(
        f"{at}{plan_text(p)}" for at, p in plans)


def print_k3_plans(what: str, n: int, m: int, T_path: int) -> None:
    """K3's launch plans (ops/hopper/plan.py) at a path's shapes: the
    6-candidate sweep and the 1-candidate rollout that emits its stream."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    print(f"  {what} K3 plans at B={B}, T={T_path}: " + "; ".join(
        f"A={A}{' emit' if A == 1 else ''} "
        f"{plan_text(plan.forward_plan(n, m, A, T_path, B, A == 1))}"
        for A in (6, 1)))


def once_ms(fn) -> float:
    """Device time of one run of ``fn``, from CUDA events."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


# ---- the least time the card could take: the larger of the bytes a call
#      must move (each input read once, each output written once) over the
#      HBM rate and its float32 operations over the f32 peak. Operations
#      count one per multiply, add, divide, square root and transcendental,
#      and where the work depends on the data (LTI terms whose constant is 0
#      are skipped) what this run's data needs.

def bound(nbytes: float, flops: float) -> dict:
    tb, tf = nbytes / HBM_PER_MS, flops / F32_PER_MS
    return dict(bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf
                else "operations", bound_bytes=nbytes, bound_flops=flops)


def model_ops(model) -> dict:
    """Operations of one model evaluation: ``step`` (running cost and
    dynamics), ``derivs`` (the expansion K1 forms at (x, u)) and ``so``
    (the nonzero dynamics Hessian entries of full DDP); a model without a
    descriptor: its lowered graph's (graph_ops)."""
    if model.device is None:
        return graph_ops(model)
    if model.device.model_id in (1, 4):
        # pendcart: θ̈ (sin, cos, 3 multiplies, a divide, 2 adds) and the
        # Euler step (8), the cost (2 + 4·4); a21, fu1 and cx, cu (20). The
        # parametrised one forms -g/l and 1-h·d once per scenario, not
        # counted. Full DDP: ∂²f₁/∂θ² (a divide, 3 multiplies, a subtract)
        # and ∂²f₁/∂θ∂u (a multiply), sin and cos shared
        return dict(step=34, derivs=20, so=6)
    if model.device.model_id == 3:
        # quadrotor: thrust, sin, cos, ax, az, α (12) and the Euler step
        # (12), the cost (6·3 + 5 and 2·4); the ANALYTIC expansion any
        # implementation must form: thrust, sin, cos, fx[1][4], fx[3][4]
        # (7), fu[1][·], fu[3][·] (4), cx, cu (16). Autodiff's passes are
        # not counted, so the bound does not depend on how K1 derives. Full
        # DDP: ∂²vx/∂θ², ∂²vz/∂θ² and their ∂θ∂u_j (6 entries, ≈3
        # operations each)
        return dict(step=55, derivs=30, so=18)
    c = model.device.consts
    n, m = model.n, model.m
    nz = [int(np.count_nonzero(c[a:b])) for a, b in (
        (0, n * n), (n * n, n * n + n * m), (n * n + n * m, 2 * n * n + n * m),
        (2 * n * n + n * m, 2 * n * n + n * m + m * m))]
    nA, nB, nQ, nR = nz
    # linear dynamics: full DDP's Hessian entries are zeros, formed by no
    # operation (their contraction is counted by k1_work)
    return dict(step=2 * (nA + nB) + 4 * (nQ + nR), derivs=2 * (nQ + nR),
                so=0)


def rollout_ops(model) -> int:
    """One candidate, one step: dx, the control law, cost and dynamics."""
    n, m = model.n, model.m
    return n + m * (2 + 2 * n) + model_ops(model)["step"] + 1


def lane_bytes(model, B: int, lanes: bool) -> int:
    """The per-scenario reads: P parameters and, with per-scenario limits,
    2m limits, each an f32 read once."""
    return 4 * B * (model.n_params + (2 * model.m if lanes else 0))


def k1_work(model, T: int, B: int, emit: str, reg_type: int, lims,
            gps: bool = False, lanes: bool = False, packed: bool = False,
            so: bool = False) -> dict:
    """K1's bound. ``packed``: the D+m slots of the packed stream are read
    and no expansion is formed; ``so``: full DDP's Hessian entries and
    their contraction with V′x into Qxx, Qux and Quu (2n operations an
    entry)."""
    n, m = model.n, model.m
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk)
    S = bk.OutLayout(n, m, emit).S
    d_in = bk.InLayout(n, m).DU if packed else n + m
    f = (0 if packed else model_ops(model)["derivs"])
    if so:
        f += model_ops(model)["so"] + 2 * n * (n * n + n * m + m * m)
    f += (2 * n * n + 2 * m * n                                     # Qx, Qu
         + 2 * n ** 3 + 2 * n * n * m                               # W, U
         + 2 * n ** 3 + 2 * m * m * n + 2 * m * n * n)              # Qxx..
    f += (2 * m * n * n + 2 * m * n + 2 * m * m * n + 2 * m * m
          if reg_type == 2 and not gps else m)
    if gps:
        # 1/η; Σ⁻¹k, Σ⁻¹K and the KL cx, cxx (sums over m); the Q terms
        # scaled and shifted; Quu symmetrised
        f += (1 + (2 * m - 1) * (m + m * n + n + n * n)
              + 2 * (n + m + n * n + m * n + m * m) + 2 * m * m)
    if lims is None:
        f += 3 * m * m + 4 * m * m * (n + 1)          # Cholesky, solves
    elif m == 1:
        f += 8 + 2 * n
    elif m == 2:
        f += 9 * 22 + 10 + 8 * n                      # 9 candidates, K rows
    else:
        f += boxqp_masked_ops(m, n, M3_QP_ITERS)
    f += (2 * m * m + 4 * m + 2 * m * m * n + n * (5 * m + 1)
          + n * n * (6 * m + 1) + 2 * n * n + 4)      # value update, latch
    if emit != "gains":
        f += 10 * m * m                               # Quu⁻¹
    nbytes = 4 * (T * B * (d_in + S) + B * 5) + lane_bytes(model, B, lanes)
    if gps:
        nbytes += 4 * T * B * (m + m * n + m * m + 1)     # prev and η
    return bound(nbytes, f * T * B)


def boxqp_masked_ops(m: int, n: int, iters: int) -> int:
    """Operations of K1's m > 2 gain solve with limits (backward.cuh
    boxqp_masked and the K rows): per iteration the gradient, the masked
    Cholesky (its identity padding, pivots, square roots and divisions),
    the Newton solve, the objective at x and at three clipped candidates;
    then the final gradient and factor, the stuck test, and K's n solves
    on the free subspace."""
    chol = sum(2 * j + 2 + (m - 1 - j) * (2 * j + 1) for j in range(m))
    solve = 2 * m * m + m                 # two substitutions, negations
    grad = m * (2 * m + 1)
    val = 2 * m + 4 * m * m
    it = grad + m * m + chol + solve + val + 3 * (4 * m + val + 1)
    return (2 * m                         # the box relative to u
            + iters * it + grad + m * m + chol + 4 * m + 3
            + n * solve)


def k3_work(model, T: int, B: int, A: int, emit: bool,
            lanes: bool = False) -> dict:
    n, m = model.n, model.m
    nbytes = 4 * (T * B * (n + 2 * m + m * n) + B * (n + 3 * A)
                  + (T * B * (n + m + 1) if emit else 0))
    return bound(nbytes + lane_bytes(model, B, lanes),
                 A * T * B * rollout_ops(model))


def k2_work(model, T: int, B: int, A: int, lanes: bool = False) -> dict:
    """In place or not: the same bytes, the stream read and written once."""
    n, m = model.n, model.m
    nbytes = 4 * (T * B * (2 * n + 3 * m + m * n + 1) + B * (n + 9))
    return bound(nbytes + lane_bytes(model, B, lanes),
                 (A + 1) * T * B * rollout_ops(model) + 12 * A * B)


def k4_work(n: int, T: int, B: int) -> dict:
    return bound(4 * 2 * n * n * T * B, (4 * n ** 3 + n * n) * T * B)


def k4_fx(n: int, T: int, B: int, seed: int, dev) -> torch.Tensor:
    """A contractive fx stream (T, n², B): F = 0.6·I + 0.3·N(0,1)/√n per
    scenario-step, from a numpy seed (tools_torch/kernel_ab.py::k4_fx)."""
    rng = np.random.default_rng(seed)
    F = 0.6 * np.eye(n) + (0.3 / np.sqrt(n)) * rng.standard_normal(
        (T, n * n, B)).reshape(T, n, n, B).transpose(0, 3, 1, 2)
    return torch.tensor(F.transpose(0, 2, 3, 1).reshape(T, n * n, B),
                        dtype=torch.float32, device=dev)


def k4_check(rec, key: str, fx: torch.Tensor, n: int, r1=None) -> dict:
    """K4 at n on fx against its plain version, to COV_TOL and bit for bit,
    with its plan and registers (``rec["ptxas"]``); timed. Records and
    returns the entry."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        covariance_kernel as ck, plan)
    T = fx.shape[0]
    r1 = ck.identity_r1(n) if r1 is None else r1
    kc = ck.covariance_lanes(fx, n=n, r1=r1)
    pc = ck.covariance_lanes_ref(fx, n=n, r1=r1)
    err = compare_slots(f"K4 n={n} Σxx", kc, pc, COV_TOL)
    check_bits(f"K4 n={n}", (kc, pc))
    growth = kc[-1].abs().amax(dim=0) / kc[0].abs().amax(dim=0)
    print(f"  K4 n={n} Σ growth over the horizon: median "
          f"{growth.median().item():.3e}, max {growth.max().item():.3e}")
    shape = plan.cov_shape(n)
    print(f"  K4 n={n} plan at B={B}, T={T}: "
          f"{plan_text(plan.covariance_plan(n, T, B))}, "
          f"{shape.warps} compute warps, "
          + ("Σ in device memory" if shape.sigma == plan.COV_GLOBAL else
             f"{'producers' if shape.sigma else 'compute warps'} storing Σ")
          + "; " + "; ".join(line for line in rec["ptxas"] if line.startswith(
              (f"covariance_kernel<{n},",
               f"covariance_global_kernel<{n},"))))
    del kc, pc
    ms = cuda_ms(lambda: ck.covariance_lanes(fx, n=n, r1=r1), 20)
    plain = cuda_ms(lambda: ck.covariance_lanes_ref(fx, n=n, r1=r1), 3)
    w = k4_work(n, T, B)
    print(f"  K4 n={n}: kernel {ms:.4f} ms, plain {plain:.1f} ms, bound "
          f"{w['bound_ms']:.4f} ms ({w['bound_by']}: "
          f"{w['bound_bytes'] / 1e6:.1f} MB, "
          f"{w['bound_flops'] / 1e9:.2f} GFLOP; one instruction each under "
          f"--fmad=false: {w['bound_flops'] / NOFMA_PER_MS:.4f} ms), "
          f"{w['bound_ms'] / ms:.3f} of the bound")
    rec[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                    **w)
    return rec[key]


def k5_work(mode: str, T: int, B: int) -> dict:
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        probe_kernel as pk)
    s_read = pk.S_OUT if mode == "copy" else pk.S_IN
    return bound(4 * T * B * (s_read + pk.S_OUT), 2 * pk.MODES[mode] * T * B)


def k5_chain_ms(T: int) -> float:
    """K5 full's latency bound: each scenario's running sum is a chain of
    600 dependent f32 adds a step, T steps long, 4 cycles an add, at an
    SM clock of 1.755 GHz (the clock is not read in this run)."""
    return T * 600 * 4 / 1.755e6


def profile_split(fn):
    """One run of ``fn`` under torch.profiler: device time in the port's
    kernels (namespace ddp), in everything else on the device (torch glue:
    elementwise kernels, reductions, copies), and the device's idle share of
    the profiled wall time. None when the profiler recorded no device
    events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, (cs, ce) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > ce:
            busy, cs, ce = busy + ce - cs, a, b
        else:
            ce = max(ce, b)
    busy += ce - cs
    by_kernel, glue_us, n_glue = {}, 0.0, 0
    for e in evs:
        us = e.time_range.end - e.time_range.start
        name = next((k for k in KERNEL_NAMES if "ddp" in e.name and k in e.name),
                    None)
        if name is None:
            glue_us, n_glue = glue_us + us, n_glue + 1
        else:
            ms, n = by_kernel.get(name, (0.0, 0))
            by_kernel[name] = (ms + us / 1e3, n + 1)
    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3,
                kernel_ms=sum(v[0] for v in by_kernel.values()),
                glue_ms=glue_us / 1e3, glue_launches=n_glue,
                by_kernel=by_kernel, idle_share=1.0 - busy / 1e3 / wall_ms)


def kl_phases(ph, dev, rec, counters, model, tiles, spec,
              early_gpu: dict) -> dict:
    """Phases 10-13: the KL/GPS path's kernels against their plain versions,
    the KL solve, the GPS rollout, and the KL solve of B_CPU lanes that
    early-gpu-vs-cpu compares with the CPU's (``early_gpu["kl"]``). Adds
    the KL measurements to ``rec``; returns the launches of the KL and GPS
    paths."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        default_x0, make_pendcart_problem)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        gps_rollout_lanes, ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)

    ph.start("kl-kernels", f"vs plain versions, B={B}, T={T}, no limits")
    # the KL tier's inputs (bench.py:121-131): x0 = default_x0 +
    # 0.2·N(0,1)·[1,1,0,0], u0 = 0.2·N(0,1), from numpy seeds
    rng = np.random.default_rng(1)
    x0_np = np.asarray(default_x0(device="cpu").numpy(),
                       np.float64)[None, :] + (
        0.2 * rng.standard_normal((B, 4)) * np.array([1.0, 1.0, 0, 0]))
    u0_np = 0.2 * rng.standard_normal((B, T, 1))
    x0_l = torch.tensor(x0_np.T.copy(), dtype=torch.float32, device=dev)
    u0 = torch.tensor(u0_np, dtype=torch.float32, device=dev)
    # pre-roll by K3 at α=1 with k := u0, u_nom := 0; its totals are cost0
    zeros_traj = torch.zeros((T, 5, B), device=dev)
    gains_u0 = torch.cat([to_streams(u0), torch.zeros((T, 4, B),
                                                      device=dev)], dim=1)
    ones = torch.ones((1, B), device=dev)

    def pre_roll(plain):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(zeros_traj, gains_u0, x0_l, ones, model=model, lims=None,
                 emit_traj=True)

    k, p = pre_roll(False), pre_roll(True)
    e_k3 = compare("K3 pre-roll, no limits", {
        "totals": (k.totals, p.totals), "traj": (k.traj, p.traj)})
    check_bits("K3 pre-roll", (k.totals, p.totals), (k.traj, p.traj))
    print_k3_plans("KL", model.n, model.m, T)
    traj_pre, cost0 = k.traj, k.totals[0]
    ms3 = cuda_ms(lambda: pre_roll(False), 20)
    plain_ms3 = cuda_ms(lambda: pre_roll(True), 3)
    print(f"  K3 pre-roll A=1, no limits: kernel {ms3:.3f} ms, plain "
          f"{plain_ms3:.1f} ms")
    x_pre = from_streams(traj_pre[:, :4], (4,))
    u_pre = from_streams(traj_pre[:, 4:5], (1,))
    problem = make_pendcart_problem(spec, derivs="euler", device=dev)
    fx = problem.derivs(x_pre, u_pre).fx                    # (B, T, 4, 4)
    fx_s = to_streams(fx)

    # K4 on the pre-roll's fx; at n=6 (the quadrotor's state, no path
    # launches it yet) on a seeded contractive fx at the quadrotor's T
    k4_check(rec, "k4_4", fx_s, 4)
    # no path launches K4 at n=6: its launches are those of this check
    _, n6 = counted(counters, lambda: k4_check(
        rec, "k4_6", k4_fx(6, QUAD_T, B, 11, dev), 6))
    rec["k4_6"]["phase_launches"] = n6["covariance_lanes"]

    # K1 in GPS mode, policy emission, no limits, on the pre-roll: a
    # previous policy with every KL term non-zero, and η scalar (1, where
    # the solve starts) or per step (1..10)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((T, 1, B)), 0.5 * rng.standard_normal((T, 4, B)),
        rng.uniform(0.5, 2.0, (T, 1, B))], axis=1), dtype=torch.float32,
        device=dev)
    etas = {"scalar η=1": torch.ones((T, B), device=dev),
            "per-step η": torch.tensor(10.0 ** rng.uniform(0, 1, (T, B)),
                                       dtype=torch.float32, device=dev)}
    lam0 = torch.zeros(B, device=dev)

    def gps_bwd(eta, plain):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(traj_pre, lam0, n=4, m=1, reg_type=1, lims=None,
                 derivs_tiles=tiles, prev=prev, eta=eta, emit="policy")

    lay = bk.OutLayout(4, 1, "policy")
    errs = []
    for what, eta in etas.items():
        k, p = gps_bwd(eta, False), gps_bwd(eta, True)
        errs.append(compare_slots(f"K1 GPS policy {what}: k, K, Quu",
                                  k.out[:, :lay.quui], p.out[:, :lay.quui],
                                  GPS_SLOT_TOL))
        errs.append(compare(f"K1 GPS policy {what}", {
            "dV": (k.stats[:2], p.stats[:2])}))
        errs.append(compare(f"K1 GPS policy {what}", {
            "Quu_inv": (k.out[:, lay.quui], p.out[:, lay.quui])},
            QUU_INV_TOL))
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"K1 GPS {what}: diverged/diverge_idx differ")
        print(f"  K1 GPS policy {what}: {int((k.stats[2] > 0.5).sum())} "
              f"latched lanes in both")
    gains = k.out
    # the KL loop's α=1 re-roll from the pre-rolled centre with GPS gains
    k3 = fk.forward_lanes(traj_pre, gains, x0_l, ones, model=model,
                          lims=None, emit_traj=True)
    p3 = fk.forward_lanes_ref(traj_pre, gains, x0_l, ones, model=model,
                              lims=None, emit_traj=True)
    e_k3 = max(e_k3, compare("K3 α=1 re-roll with GPS gains", {
        "totals": (k3.totals, p3.totals), "traj": (k3.traj, p3.traj)}))
    eta1 = etas["scalar η=1"]
    ms1 = cuda_ms(lambda: gps_bwd(eta1, False), 20)
    plain_ms1 = cuda_ms(lambda: gps_bwd(eta1, True), 3)
    print(f"  K1 GPS policy: kernel {ms1:.3f} ms, plain {plain_ms1:.1f} ms")
    rec["k1_pendcart_gps"] = dict(
        max_abs_err=max(errs), ms=ms1, plain_ms=plain_ms1, library_ms=None,
        **k1_work(model, T, B, "policy", 1, None, gps=True))
    w3p = k3_work(model, T, B, 1, True)
    print(f"  K3 pre-roll bound {w3p['bound_ms']:.4f} ms ({w3p['bound_by']})")
    rec["k3_pendcart"].update(
        max_abs_err=max(rec["k3_pendcart"]["max_abs_err"], e_k3),
        ms_unclamped_rollout=ms3, plain_ms_unclamped_rollout=plain_ms3,
        bound_ms_unclamped_rollout=w3p["bound_ms"])
    del prev, etas, gains, k, p, k3, p3

    ph.start("kl-path", f"ilqgkl_batch_lanes, pendcart B={B} T={T}, "
             f"kl_step={KL_STEP}, max_iter={KL_ITERS}, scalar η, no limits")
    cfg = ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS)
    # the zero policy with k = u0 (bench.py:126-129)
    policy0 = GaussianPolicy(
        K=torch.zeros((B, T, 1, 4), device=dev), k=u_pre.contiguous(),
        sigma=torch.ones((B, T, 1, 1), device=dev),
        sigma_inv=torch.ones((B, T, 1, 1), device=dev))
    x_pre = x_pre.contiguous()
    fx = fx.contiguous()

    def kl_solve(sl=slice(None), to=dev):
        pol = GaussianPolicy(*(a[sl].to(to) for a in policy0))
        return ilqgkl_batch_lanes(model, tiles, x_pre[sl].to(to), pol,
                                  fx[sl].to(to), cost0[sl].to(to), cfg=cfg)

    kl_solve()                                   # warm-up
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0 = time.perf_counter()

    def timed():
        s.record()
        out = kl_solve()
        e.record()
        return out

    r, launches = counted(counters, timed)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kl_ms = s.elapsed_time(e)
    iters = int(r.n_iters.max())
    eta_maxed = r.bracket[:, 1] > 0.999 * r.bracket[:, 2]
    ok = ~r.pd_failed
    print(f"  launches: {launches}")
    print(f"  solve: {kl_ms:.3f} ms (CUDA events), {wall_ms:.3f} ms host "
          f"clock; max n_iters {iters}, {kl_ms / max(iters, 1):.4f} ms/iter")
    print(f"  cost_total median {r.cost_total.median().item():.6g} against "
          f"cost0 median {cost0.median().item():.6g}")
    print(f"  shares: satisfied {r.satisfied.float().mean().item():.4f}, "
          f"η maxed {eta_maxed.float().mean().item():.4f}, pd_failed "
          f"{r.pd_failed.float().mean().item():.4f}, kl_violated "
          f"{r.kl_violated.float().mean().item():.4f}")
    print(f"  median η {r.eta.median().item():.6g}, median divergence "
          f"{r.divergence.median().item():.6g}, n_iters histogram "
          f"{dict(zip(*(v.tolist() for v in torch.unique(r.n_iters, return_counts=True))))}")
    check(all(launches[c.__name__] > 0 for c in
              (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes)),
          f"a kernel of the KL path never ran: {launches}")
    check(launches["covariance_lanes"] == 1,
          f"K4 ran {launches['covariance_lanes']} times in one KL solve, "
          "expected once")
    check(r.x.shape == (B, T, 4) and r.u.shape == (B, T, 1)
          and r.policy.K.shape == (B, T, 1, 4) and r.cost_total.shape == (B,),
          "KL result shapes")
    check(1 <= iters <= KL_ITERS, f"KL n_iters {iters}")
    fin = (torch.isfinite(r.cost_total) & torch.isfinite(r.eta)
           & torch.isfinite(r.divergence)
           & torch.isfinite(r.x).flatten(1).all(dim=1)
           & torch.isfinite(r.policy.K).flatten(1).all(dim=1)
           & torch.isfinite(r.policy.sigma).flatten(1).all(dim=1))
    check(bool(fin[ok].all()), f"non-finite KL results on "
          f"{int((~fin & ok).sum())} lanes without pd_failed")
    paths = {"kl": launches}
    del r

    ph.start("gps-rollout", f"gps_rollout_lanes, {GPS_OUTER} outer KL "
             f"solves, B={B} T={T}")
    fx_fn = lambda x, u: problem.derivs(x, u).fx       # noqa: E731

    def timed_gps():
        s.record()
        out = gps_rollout_lanes(model, tiles, x_pre, policy0, cost0, fx_fn,
                                GPS_OUTER, cfg=cfg)
        e.record()
        return out

    (xg, polg, per), launches = counted(counters, timed_gps)
    gps_ms = s.elapsed_time(e)
    print(f"  launches: {launches}")
    print(f"  rollout: {gps_ms:.3f} ms (CUDA events), "
          f"{gps_ms / GPS_OUTER:.3f} ms per outer iteration")
    costs, etas_o, divs, sat, viol = per
    for i in range(GPS_OUTER):
        print(f"  outer {i + 1}: median cost_total "
              f"{costs[i].median().item():.6g}, median η "
              f"{etas_o[i].median().item():.6g}, median divergence "
              f"{divs[i].median().item():.6g}, satisfied "
              f"{sat[i].float().mean().item():.4f}")
    check(costs.shape == (GPS_OUTER, B) and xg.shape == (B, T, 4),
          "GPS rollout shapes")
    check(all(launches[c.__name__] >= GPS_OUTER for c in
              (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes)),
          f"a kernel of the GPS rollout ran too rarely: {launches}")
    check(bool(torch.isfinite(costs[-1]).float().mean() >= AGREE_SHARE),
          "GPS rollout: non-finite final costs")
    paths["gps"] = launches
    del xg, polg, per

    ph.start("kl-gpu-vs-cpu", f"first {B_CPU} scenarios, T={T}, "
             f"max_iter={KL_ITERS}")
    early_gpu["kl"] = kl_solve(slice(0, B_CPU))
    print("  the card's solve; the CPU's, in the --early-cpu child, is "
          "compared in early-gpu-vs-cpu")
    return paths


def lti_phases(ph, dev, rec, counters, early_gpu: dict) -> dict:
    """Phases 14-16: the LTI ⟨10,2⟩ kernels against their plain versions,
    the LTI fleet solve, and the LTI solve of B_CPU lanes at LTI_T_CPU that
    early-gpu-vs-cpu compares with the CPU's (``early_gpu["lti"]``). Adds
    the LTI measurements to ``rec[name]["lti"]``; returns the LTI path's
    launches."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)

    n, m, Tp = LTI_N, LTI_M, LTI_T_PLAIN
    ph.start("lti-kernels", f"LTI n={n} m={m} B={B}: kernels against plain "
             f"versions at T={Tp}, kernels timed at T={LTI_T}")
    # the LTI fleet (tools/bench_fleet.py:57-74): random_lti's spec from a
    # seeded generator, x0 = 1·linspace(0.5, 2), u0 tiled over the fleet
    spec = random_lti(0, n=n, m=m, T=LTI_T, device=dev)
    model, tiles = lti_lanes(spec), lti_derivs_tiles(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=300)
    A = len(cfg.alphas)
    x0s = torch.ones((B, n), device=dev) * torch.linspace(
        0.5, 2.0, B, device=dev)[:, None]
    u0s = spec.u0.expand(B, LTI_T, m).contiguous()
    x0_l = x0s.T.contiguous()
    rng = np.random.default_rng(4)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=torch.float32,
                       device=dev)
    lam[::8] = 0.0
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    ladder = ladder.contiguous()
    al1 = torch.tensor(rng.uniform(0.0, 1.0, (1, B)), dtype=torch.float32,
                       device=dev)
    # the initial sweep's streams: u = α·u0 by k := u0, u_nom := 0
    streams = {t: (torch.zeros((t, n + m, B), device=dev), torch.cat(
        [to_streams(u0s[:, :t]), torch.zeros((t, m * n, B), device=dev)],
        dim=1)) for t in (Tp, LTI_T)}

    def fwd(t, al, emit, plain):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(*streams[t], x0_l, al, model=model, lims=LTI_LIMS,
                 emit_traj=emit)

    k, p = fwd(Tp, ladder, False, False), fwd(Tp, ladder, False, True)
    e3 = compare("LTI K3 sweep A=6", {"totals": (k.totals, p.totals)})
    k, p = fwd(Tp, al1, True, False), fwd(Tp, al1, True, True)
    e3 = max(e3, compare("LTI K3 rollout A=1", {
        "totals": (k.totals, p.totals), "traj": (k.traj, p.traj)}))
    print_k3_plans("LTI", n, m, LTI_T)
    print(f"  LTI K3: bit-identical to the plain version: "
          f"{torch.equal(k.traj, p.traj) and torch.equal(k.totals, p.totals)}")
    traj, tot = k.traj, k.totals[0]

    def bwd(emit, lims, plain, tl=tiles, tr=traj):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam, n=n, m=m, reg_type=2, lims=lims, derivs_tiles=tl,
                 emit=emit)

    errs = []
    for lims in (LTI_LIMS, None):
        for emit in ("gains", "full"):
            what = f"LTI K1 {emit} {'±0.6' if lims else 'unconstrained'}"
            k, p = bwd(emit, lims, False), bwd(emit, lims, True)
            lay = bk.OutLayout(n, m, emit)
            nq = lay.quui if emit == "full" else lay.S
            errs.append(compare(what, {"out": (k.out[:, :nq], p.out[:, :nq]),
                                       "dV": (k.stats[:2], p.stats[:2])}))
            if emit == "full":
                errs.append(compare(what, {"Quu_inv": (k.out[:, nq:],
                                                       p.out[:, nq:])},
                                    QUU_INV_TOL))
            check(torch.equal(k.stats[2:], p.stats[2:]),
                  f"{what}: diverged/diverge_idx differ")
            print(f"  {what}: bit-identical {torch.equal(k.out, p.out)}, "
                  f"{int((k.stats[2] > 0.5).sum())} latched lanes in both")
            if lims is not None and emit == "gains":
                gains, dV = k.out, k.stats[:2]
                # where the box QP put k on a limit: k = lim - u_t exactly
                kk, u = k.out[:-1, :m], traj[:-1, n:n + m]
                on = (kk == -0.6 - u) | (kk == 0.6 - u)
                shares = [on[:, i].float().mean().item() for i in range(m)]
                both = (on[:, 0] & on[:, 1]).float().mean().item()
                print(f"  LTI K1 limits bind on a share of the steps: "
                      f"control 0 {shares[0]:.4f}, control 1 "
                      f"{shares[1]:.4f}, both {both:.4f}")
                check(min(shares + [both]) > 0,
                      "LTI K1: the limits never bind on some control, so "
                      "the enumeration was not exercised")
    # R negative definite: Quu = R + Bᵀ·Vxx·B is not positive definite
    # where λ·BᵀB cannot lift it, so the λ vector decides which lanes latch
    latch = lti_derivs_tiles(spec._replace(R=-spec.R))
    for lims in (LTI_LIMS, None):
        what = f"LTI K1 latch {'±0.6' if lims else 'unconstrained'}"
        k, p = bwd("full", lims, False, latch), bwd("full", lims, True, latch)
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"{what}: diverged/diverge_idx differ")
        n_latch = int((k.stats[2] > 0.5).sum())
        print(f"  {what}: {n_latch} of {B} lanes latched, identical "
              f"diverged/diverge_idx")
        lay = bk.OutLayout(n, m, "full")
        compare(what, {"k, K, Vx, Vxx, Quu": (k.out[:, :lay.quui],
                                              p.out[:, :lay.quui])},
                LATCH_TOL)
        if lims is None:
            check(0 < n_latch < B, f"{what}: {n_latch} lanes latched")

    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([dV[0], dV[1], tot, allow])

    def ls(plain, s=sel, tr=traj, g=gains):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(tr, g, x0_l, s, model=model, alphas=cfg.alphas,
                 reduce_ratio_min=0.0, lims=LTI_LIMS)

    k, p = ls(False), ls(True)
    e2 = compare("LTI K2", {"traj": (k.traj, p.traj),
                            "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]), "LTI K2: al_sel/any_ok differ")
    print(f"  LTI K2: {int(((k.ls[1] > 0.5) & (allow > 0.5)).sum())} of {B} "
          f"lanes accept")
    out = ls(False, torch.stack([dV[0], dV[1], tot, torch.zeros_like(tot)]))
    check(torch.equal(out.traj, traj),
          "LTI K2 α=0 retrace of a K3 stream is not bit-exact")
    print("  LTI K2 α=0 retrace of the K3 stream: bit-exact")

    # times: the kernels at the fleet's T, the plain versions once at Tp
    ms3 = cuda_ms(lambda: fwd(LTI_T, ladder, False, False), 20)
    ms3r = cuda_ms(lambda: fwd(LTI_T, al1, True, False), 20)
    plain3 = once_ms(lambda: fwd(Tp, ladder, False, True))
    ro = fwd(LTI_T, al1, True, False)
    traj_T, tot_T = ro.traj, ro.totals[0]
    ms1 = cuda_ms(lambda: bwd("gains", LTI_LIMS, False, tr=traj_T), 20)
    ms1f = cuda_ms(lambda: bwd("full", LTI_LIMS, False, tr=traj_T), 20)
    plain1 = once_ms(lambda: bwd("gains", LTI_LIMS, True))
    bo = bwd("gains", LTI_LIMS, False, tr=traj_T)
    sel_T = torch.stack([bo.stats[0], bo.stats[1], tot_T, allow])
    ms2 = cuda_ms(lambda: ls(False, sel_T, traj_T, bo.out), 20)
    plain2 = once_ms(lambda: ls(True))
    w3 = k3_work(model, LTI_T, B, A, False)
    w1 = k1_work(model, LTI_T, B, "gains", 2, LTI_LIMS)
    w1f = k1_work(model, LTI_T, B, "full", 2, LTI_LIMS)
    w2 = k2_work(model, LTI_T, B, A)
    for what, ms, w in (("K3 sweep A=6", ms3, w3), ("K1 gains", ms1, w1),
                        ("K1 full", ms1f, w1f), ("K2 A=6", ms2, w2)):
        print(f"  LTI {what} at T={LTI_T}: kernel {ms:.3f} ms, bound "
              f"{w['bound_ms']:.3f} ms ({w['bound_by']}: "
              f"{w['bound_bytes'] / 1e6:.1f} MB, "
              f"{w['bound_flops'] / 1e9:.2f} GFLOP)")
    print(f"  LTI K3 rollout A=1 at T={LTI_T}: kernel {ms3r:.3f} ms; plain "
          f"versions once at T={Tp}: K3 sweep {plain3:.1f} ms, K1 gains "
          f"{plain1:.1f} ms, K2 {plain2:.1f} ms")
    w3r = k3_work(model, LTI_T, B, 1, True)
    print(f"  LTI K3 rollout bound {w3r['bound_ms']:.4f} ms "
          f"({w3r['bound_by']})")
    rec["k3_lti"] = dict(ms=ms3, ms_rollout=ms3r, plain_ms=plain3,
                         plain_T=Tp, max_abs_err=e3, library_ms=None,
                         bound_ms_rollout=w3r["bound_ms"], **w3)
    rec["k1_lti"] = dict(ms=ms1, ms_full=ms1f, bound_ms_full=w1f["bound_ms"],
                         plain_ms=plain1, plain_T=Tp, max_abs_err=max(errs),
                         library_ms=None, **w1)
    rec["k2_lti"] = dict(ms=ms2, plain_ms=plain2, plain_T=Tp, max_abs_err=e2,
                         library_ms=None, **w2)
    del streams, traj, traj_T, ro, bo, gains, k, p, out

    ph.start("lti-path", f"ilqg_batch_lanes, LTI n={n} m={m} B={B} "
             f"T={LTI_T}, {A}-α ladder, reg_type 2, ±0.6, max_iter="
             f"{cfg.max_iter}, to convergence")

    def solve(x0, u0, trace=False):
        return ilqg_batch_lanes(model, None, x0, u0, lims=LTI_LIMS, cfg=cfg,
                                derivs_tiles=tiles, record_trace=trace)

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)

    def timed_solve():
        s.record()
        out = solve(x0s, u0s, trace=True)
        e.record()
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r, launches = counted(counters, timed_solve)
    wall_ms = (time.perf_counter() - t0) * 1e3
    solve_ms = s.elapsed_time(e)
    peak = torch.cuda.max_memory_allocated()
    iters = int(r.n_iters.max())
    ct, c0 = r.cost_total, r.trace.cost[:, 0]

    def hist(v):
        return {int(a): int(b) for a, b in zip(*torch.unique(
            v, return_counts=True))}

    print(f"  launches: {launches}")
    print(f"  n_iters histogram {hist(r.n_iters)}; reasons {hist(r.reason)}; "
          f"accepted mean {r.n_accepted.float().mean().item():.3f}")
    print(f"  cost_total min/median/max: {ct.min().item():.6g} / "
          f"{ct.median().item():.6g} / {ct.max().item():.6g} (initial "
          f"rollout median {c0.median().item():.6g})")
    print(f"  solve: {solve_ms:.3f} ms (CUDA events), {wall_ms:.3f} ms host "
          f"clock; {solve_ms / max(iters, 1):.4f} ms/iter over {iters} "
          f"iterations; peak memory {peak / 2**30:.3f} GiB")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the LTI path never ran: {launches}")
    check(1 <= iters <= cfg.cap(), f"LTI n_iters {iters}")
    check(bool(torch.isfinite(ct).all()), "LTI: non-finite cost")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.u).all()),
          "LTI: non-finite trajectory")
    check(r.x.shape == (B, LTI_T, n) and r.u.shape == (B, LTI_T, m)
          and r.policy.K.shape == (B, LTI_T, m, n)
          and r.policy.sigma.shape == (B, LTI_T, m, m), "LTI result shapes")
    check(bool((r.u.abs() <= 0.6).all()), "LTI: a control outside ±0.6")
    check(ct.median() < c0.median(), "LTI: median cost did not improve")
    st = torch.cat([to_streams(r.x), to_streams(r.u),
                    to_streams(r.cost[..., None])], dim=1)
    bo = bk.backward_lanes(st, r.lam, n=n, m=m, reg_type=2, lims=LTI_LIMS,
                           derivs_tiles=tiles, emit="gains")
    sel = torch.stack([bo.stats[0], bo.stats[1], ct, allow])
    out = fk.linesearch_lanes(st, bo.out, x0_l, sel, model=model,
                              alphas=cfg.alphas, lims=LTI_LIMS)
    rej = (out.ls[1] < 0.5) | (allow < 0.5)
    check(torch.equal(out.traj[..., rej], st[..., rej]),
          "LTI: rejected lanes of the solution do not retrace bit for bit")
    print(f"  retrace: {int(rej.sum())} rejected lanes reproduce the "
          f"solution stream bit for bit")
    rec["k1_lti"]["path"] = dict(
        solve_ms=solve_ms, iters=iters, ms_per_iter=solve_ms / max(iters, 1),
        peak_bytes=peak, reasons=hist(r.reason))
    del r, st, bo, out

    ph.start("lti-gpu-vs-cpu", f"first {B_CPU} scenarios, T={LTI_T_CPU}, "
             f"max_iter={cfg.max_iter}")
    early_gpu["lti"] = solve(x0s[:B_CPU],
                             u0s[:B_CPU, :LTI_T_CPU].contiguous())
    print("  the card's solve; the CPU's, in the --early-cpu child, is "
          "compared in early-gpu-vs-cpu")
    return launches


def kl_lti_phases(ph, dev, rec, counters, early_gpu: dict) -> dict:
    """Phases 17-20: the KL/GPS path on the LTI fleet. K4 at n=10 and K1 in
    GPS mode with policy emission at ⟨10,2⟩ against their plain versions,
    the KL solve of the reference's demo_linear_kl at fleet scale, the
    5-outer GPS rollout, and the KL solve of B_CPU lanes at LTI_T_CPU that
    early-gpu-vs-cpu compares with the CPU's (``early_gpu["kl_lti"]``).
    Adds the measurements to ``rec``; returns the launches of the two
    paths."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        SimpleLTVModel, lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        gps_rollout_lanes, ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)

    n, m, Tl, Tp = LTI_N, LTI_M, LTI_T, LTI_T_PLAIN
    ph.start("kl-lti-kernels", f"K4 n={n}, K1 GPS policy ⟨{n},{m}⟩ against "
             f"plain versions (K1 at T={Tp}), timed at B={B}, T={Tl}")
    # the LTI fleet of the lti phases; pre-rolled by K3 at α=1 with k := u0
    # and no limits, as demo_linear_kl (JAX demos.py:50-55)
    spec = random_lti(0, n=n, m=m, T=Tl, device=dev)
    model, tiles = lti_lanes(spec), lti_derivs_tiles(spec)
    x0s = torch.ones((B, n), device=dev) * torch.linspace(
        0.5, 2.0, B, device=dev)[:, None]
    u0s = spec.u0.expand(B, Tl, m).contiguous()
    x0_l = x0s.T.contiguous()
    ones = torch.ones((1, B), device=dev)
    gains_u0 = torch.cat([to_streams(u0s),
                          torch.zeros((Tl, m * n, B), device=dev)], dim=1)
    zeros_traj = torch.zeros((Tl, n + m + 1, B), device=dev)

    def pre_roll(plain):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(zeros_traj, gains_u0, x0_l, ones, model=model, lims=None,
                 emit_traj=True)

    k, p = pre_roll(False), pre_roll(True)
    e3 = compare("LTI K3 pre-roll, no limits", {
        "totals": (k.totals, p.totals), "traj": (k.traj, p.traj)})
    print_k3_plans("KL on LTI", n, m, Tl)
    print(f"  LTI K3 pre-roll: bit-identical to the plain version: "
          f"{torch.equal(k.traj, p.traj) and torch.equal(k.totals, p.totals)}")
    traj_pre, cost0 = k.traj, k.totals[0]
    ms3 = cuda_ms(lambda: pre_roll(False), 20)
    del p, zeros_traj, gains_u0

    # K4 at n=10 on the model's linearisation, SimpleLTVModel.from_lti
    fx_lti = SimpleLTVModel.from_lti(spec.A, spec.B, Tl).fx    # (T, n, n)
    fx_s = to_streams(fx_lti.expand(B, Tl, n, n))
    k4_check(rec, "k4_10", fx_s, n)
    del fx_s

    # K1 in GPS mode, policy emission, on the pre-roll: a previous policy
    # with every KL term non-zero (Σ⁻¹ positive definite), η scalar (1,
    # where the solve starts) or per step, with ±0.6 and without limits
    rng = np.random.default_rng(7)
    a = rng.standard_normal((Tp, B, m, m))
    si = np.einsum("tbij,tbkj->tbik", a, a) + 0.5 * np.eye(m)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((Tp, m, B)),
        0.5 * rng.standard_normal((Tp, m * n, B)),
        np.moveaxis(si.reshape(Tp, B, m * m), 1, 2)], axis=1),
        dtype=torch.float32, device=dev)
    etas = {"scalar η=1": torch.ones((Tp, B), device=dev),
            "per-step η": torch.tensor(10.0 ** rng.uniform(-1, 1, (Tp, B)),
                                       dtype=torch.float32, device=dev)}
    lam0 = torch.zeros(B, device=dev)
    traj_p = traj_pre[:Tp].contiguous()
    lay = bk.OutLayout(n, m, "policy")

    def gps_bwd(tr, pv, eta, lims, plain):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam0, n=n, m=m, reg_type=1, lims=lims,
                 derivs_tiles=tiles, prev=pv, eta=eta, emit="policy")

    errs, plain1 = [], None
    for what, eta in etas.items():
        for lims in (LTI_LIMS, None):
            name = f"LTI K1 GPS policy {what} {'±0.6' if lims else 'no limits'}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = gps_bwd(traj_p, prev, eta, lims, True)
            torch.cuda.synchronize()
            plain1 = plain1 or (time.perf_counter() - t0) * 1e3
            k = gps_bwd(traj_p, prev, eta, lims, False)
            errs.append(compare_slots(f"{name}: k, K, Quu",
                                      k.out[:, :lay.quui],
                                      p.out[:, :lay.quui], GPS_SLOT_TOL))
            errs.append(compare(name, {"dV": (k.stats[:2], p.stats[:2])}))
            errs.append(compare(name, {
                "Quu_inv": (k.out[:, lay.quui:], p.out[:, lay.quui:])},
                QUU_INV_TOL))
            check(torch.equal(k.stats[2:], p.stats[2:]),
                  f"{name}: diverged/diverge_idx differ")
            print(f"  {name}: bit-identical "
                  f"{torch.equal(k.out, p.out) and torch.equal(k.stats, p.stats)}"
                  f", {int((k.stats[2] > 0.5).sum())} latched lanes in both")
    # timed at the path's shapes: the first iteration's inputs (zero gains,
    # unit Σ, η = 1), no limits
    prev_path = torch.cat([torch.zeros((Tl, m + m * n, B), device=dev),
                           to_streams(torch.eye(m, device=dev).expand(
                               B, Tl, m, m))], dim=1)
    eta1 = torch.ones((Tl, B), device=dev)
    ms1 = cuda_ms(lambda: gps_bwd(traj_pre, prev_path, eta1, None, False), 20)
    w1 = k1_work(model, Tl, B, "policy", 1, None, gps=True)
    print(f"  LTI K1 GPS policy at T={Tl}: kernel {ms1:.3f} ms, bound "
          f"{w1['bound_ms']:.3f} ms ({w1['bound_by']}: "
          f"{w1['bound_bytes'] / 1e6:.1f} MB, "
          f"{w1['bound_flops'] / 1e9:.2f} GFLOP); plain once at T={Tp}: "
          f"{plain1:.1f} ms; K3 pre-roll (A=1, no limits) {ms3:.3f} ms")
    rec["k1_lti_gps"] = dict(max_abs_err=max(errs), ms=ms1, plain_ms=plain1,
                             plain_T=Tp, library_ms=None, **w1)
    rec["k3_lti"].update(max_abs_err=max(rec["k3_lti"]["max_abs_err"], e3),
                         ms_unclamped_rollout=ms3,
                         bound_ms_unclamped_rollout=k3_work(
                             model, Tl, B, 1, True)["bound_ms"])
    del prev, etas, prev_path, eta1, traj_p, k, p

    cfg = ILQGKLConfig(kl_step=KL_LTI_STEP)
    ph.start("kl-lti-solve", f"ilqgkl_batch_lanes, LTI n={n} m={m} B={B} "
             f"T={Tl}, kl_step={KL_LTI_STEP}, max_iter={cfg.max_iter}, "
             f"scalar η, no limits")
    # the zero previous policy with k = u0 and unit Σ (JAX demos.py:55), and
    # fx_model = SimpleLTVModel.from_lti(A, B, T).fx for every scenario
    x_pre = from_streams(traj_pre[:, :n], (n,)).contiguous()
    u_pre = from_streams(traj_pre[:, n:n + m], (m,)).contiguous()
    eye = torch.eye(m, device=dev).expand(B, Tl, m, m)
    policy0 = GaussianPolicy(K=torch.zeros((B, Tl, m, n), device=dev),
                             k=u_pre, sigma=eye, sigma_inv=eye)
    fx_model = fx_lti.expand(B, Tl, n, n)

    def kl_solve(sl=slice(None), to=dev, Tc=Tl):
        pol = GaussianPolicy(*(a[sl, :Tc].to(to) for a in policy0))
        c0 = traj_pre[:Tc, n + m, sl].sum(dim=0) if Tc < Tl else cost0[sl]
        return ilqgkl_batch_lanes(model, tiles, x_pre[sl, :Tc].to(to), pol,
                                  fx_model[sl, :Tc].to(to), c0.to(to),
                                  cfg=cfg)

    kl_solve()                                   # warm-up
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)

    def timed():
        s.record()
        out = kl_solve()
        e.record()
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r, launches = counted(counters, timed)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kl_ms = s.elapsed_time(e)
    peak = torch.cuda.max_memory_allocated()
    iters = int(r.n_iters.max())
    eta_maxed = r.bracket[:, 1] > 0.999 * r.bracket[:, 2]
    print(f"  launches: {launches}")
    print(f"  solve: {kl_ms:.3f} ms (CUDA events), {wall_ms:.3f} ms host "
          f"clock; max n_iters {iters}, {kl_ms / max(iters, 1):.4f} ms/iter; "
          f"peak memory {peak / 2**30:.3f} GiB")
    print(f"  cost_total median {r.cost_total.median().item():.6g} against "
          f"cost0 median {cost0.median().item():.6g}")
    print(f"  shares: satisfied {r.satisfied.float().mean().item():.4f}, "
          f"η maxed {eta_maxed.float().mean().item():.4f}, pd_failed "
          f"{r.pd_failed.float().mean().item():.4f}, kl_violated "
          f"{r.kl_violated.float().mean().item():.4f}")
    print(f"  median η {r.eta.median().item():.6g}, median divergence "
          f"{r.divergence.median().item():.6g}, n_iters histogram "
          f"{dict(zip(*(v.tolist() for v in torch.unique(r.n_iters, return_counts=True))))}")
    check(all(launches[c.__name__] > 0 for c in
              (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes)),
          f"a kernel of the KL-LTI path never ran: {launches}")
    check(launches["covariance_lanes"] == 1,
          f"K4 ran {launches['covariance_lanes']} times in one KL solve")
    check(r.x.shape == (B, Tl, n) and r.u.shape == (B, Tl, m)
          and r.policy.K.shape == (B, Tl, m, n)
          and r.policy.sigma.shape == (B, Tl, m, m)
          and r.cost_total.shape == (B,), "KL-LTI result shapes")
    check(1 <= iters <= cfg.max_iter, f"KL-LTI n_iters {iters}")
    ok = ~r.pd_failed
    fin = (torch.isfinite(r.cost_total) & torch.isfinite(r.eta)
           & torch.isfinite(r.divergence)
           & torch.isfinite(r.x).flatten(1).all(dim=1)
           & torch.isfinite(r.policy.K).flatten(1).all(dim=1)
           & torch.isfinite(r.policy.sigma).flatten(1).all(dim=1))
    check(bool(fin[ok].all()), f"non-finite KL-LTI results on "
          f"{int((~fin & ok).sum())} lanes without pd_failed")
    check(r.cost_total[ok].median() < cost0[ok].median(),
          "KL-LTI: median cost did not improve")
    paths = {"kl_lti": launches}
    del r
    prof = profile_split(kl_solve)
    if prof is None:
        print("  profile: torch.profiler recorded no device events; split "
              "not measured")
    else:
        per = ", ".join(f"{k} {v[0]:.3f} ms ({v[1]})"
                        for k, v in prof["by_kernel"].items())
        print(f"  profile of one solve: wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['busy_ms']:.3f} ms (idle share "
              f"{prof['idle_share']:.4f}); kernels {prof['kernel_ms']:.3f} ms "
              f"[{per}]; glue {prof['glue_ms']:.3f} ms in "
              f"{prof['glue_launches']} launches; busy over the unprofiled "
              f"solve {prof['busy_ms'] / kl_ms:.4f}")
    rec["k1_lti_gps"]["kl_lti_path"] = dict(
        solve_ms=kl_ms, iters=iters, ms_per_iter=kl_ms / max(iters, 1),
        peak_bytes=peak, profile=prof)

    ph.start("gps-lti", f"gps_rollout_lanes, {GPS_OUTER} outer KL solves, "
             f"LTI B={B} T={Tl}")

    def fx_fn(x, u):
        return fx_lti.expand(x.shape[0], Tl, n, n)

    def timed_gps():
        s.record()
        out = gps_rollout_lanes(model, tiles, x_pre, policy0, cost0, fx_fn,
                                GPS_OUTER, cfg=cfg)
        e.record()
        return out

    (xg, polg, per), launches = counted(counters, timed_gps)
    gps_ms = s.elapsed_time(e)
    print(f"  launches: {launches}")
    print(f"  rollout: {gps_ms:.3f} ms (CUDA events), "
          f"{gps_ms / GPS_OUTER:.3f} ms per outer iteration")
    costs, etas_o, divs, sat, viol = per
    for i in range(GPS_OUTER):
        print(f"  outer {i + 1}: median cost_total "
              f"{costs[i].median().item():.6g}, median η "
              f"{etas_o[i].median().item():.6g}, median divergence "
              f"{divs[i].median().item():.6g}, satisfied "
              f"{sat[i].float().mean().item():.4f}")
    check(costs.shape == (GPS_OUTER, B) and xg.shape == (B, Tl, n)
          and polg.K.shape == (B, Tl, m, n), "GPS-LTI shapes")
    check(all(launches[c.__name__] >= GPS_OUTER for c in
              (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes)),
          f"a kernel of the GPS-LTI rollout ran too rarely: {launches}")
    check(bool(torch.isfinite(costs[-1]).float().mean() >= AGREE_SHARE),
          "GPS-LTI rollout: non-finite final costs")
    paths["gps_lti"] = launches
    rec["k1_lti_gps"]["gps_lti_path"] = dict(rollout_ms=gps_ms,
                                             ms_per_outer=gps_ms / GPS_OUTER)
    del xg, polg, per

    ph.start("kl-lti-cpu", f"first {B_CPU} scenarios, T={LTI_T_CPU}, "
             f"max_iter={cfg.max_iter}")
    early_gpu["kl_lti"] = kl_solve(slice(0, B_CPU), dev, LTI_T_CPU)
    print("  the card's solve; the CPU's, in the --early-cpu child, is "
          "compared in early-gpu-vs-cpu")
    return paths


def quad_x0(rng=None) -> np.ndarray:
    """The quadrotor fleet's x0 (B, 6) in f64 as the JAX tier draws it
    (bench.py:230-232): default_x0 + 0.3·N(0,1)·[1,0,1,0,0.5,0], from a
    numpy seed (other bits than PRNGKey(1)): the first draw of ``rng``, by
    default of numpy seed 11 (tools_torch/make_quad_outcomes.py draws the
    same lanes)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        default_x0)
    rng = np.random.default_rng(11) if rng is None else rng
    return default_x0(torch.float64, device="cpu").numpy()[None, :] + (
        0.3 * rng.standard_normal((B, 6)) * np.array([1, 0, 1, 0, 0.5, 0]))


def quad_kernel_inputs(dev, alphas):
    """The quadrotor kernels' inputs at B lanes and QUAD_T steps, drawn in
    this order from numpy seed 11: x0 (quad_x0); K3's gains stream of a
    rollout whose rotors meet both limits, u = u_hover + 1.5·N(0,1); a
    per-lane α in [0, 1); λ = 10^U(-6, 2), every eighth 0. Returns a
    namespace of them with the zero stream K3 starts from and the α ladder
    of ``alphas``, and the generator for the caller's further draws."""
    from types import SimpleNamespace

    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    rng = np.random.default_rng(11)
    x0s = torch.tensor(quad_x0(rng), dtype=torch.float32, device=dev)
    u_rand = torch.tensor(QuadrotorSpec().u_hover + 1.5 * rng.standard_normal(
        (B, QUAD_T, 2)), dtype=torch.float32, device=dev)
    al1 = torch.tensor(rng.uniform(0.0, 1.0, (1, B)), dtype=torch.float32,
                       device=dev)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=torch.float32,
                       device=dev)
    lam[::8] = 0.0
    ladder = torch.tensor(alphas, device=dev)[:, None].expand(len(alphas), B)
    return SimpleNamespace(
        x0s=x0s, x0_l=x0s.T.contiguous(),
        gains0=torch.cat([to_streams(u_rand),
                          torch.zeros((QUAD_T, 12, B), device=dev)], dim=1),
        traj0=torch.zeros((QUAD_T, 8, B), device=dev),
        ladder=ladder.contiguous(), al1=al1, lam=lam), rng


def quad_phases(ph, dev, rec, counters, ilqg, early_gpu: dict) -> dict:
    """Phases 6-9: the quadrotor ⟨6,2⟩ kernels (K3, K1 Autodiff<Quadrotor>,
    K2) against their plain versions and K1 Autodiff<PendCart> against the
    analytic pendcart K1; the pendcart iLQG solve with autodiff tiles
    against the analytic solve ``ilqg`` (x0s, cfg and outcome of phase 4);
    the quadrotor fleet solve of JAX bench.py:215-254; and that solve on 64
    scenarios against the CPU. Adds the measurements to ``rec``; returns the
    launches of the paths ``ilqg_ad`` and ``quad``."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)

    Tq, Tp = QUAD_T, QUAD_T_PLAIN
    spec = QuadrotorSpec()
    model = quadrotor_lanes(spec)
    tiles = autodiff_derivs_tiles(model)
    lims = spec.lims
    cfg = ilqg["cfg"]
    A = len(cfg.alphas)
    ph.start("quad-kernels", f"quadrotor n=6 m=2 B={B}: K3, K1 "
             f"Autodiff<Quadrotor> (plain at T={Tp}), K2 against plain "
             f"versions, timed at T={Tq}; K1 Autodiff<PendCart> against the "
             f"analytic K1 at T={T}")
    q, rng = quad_kernel_inputs(dev, cfg.alphas)
    x0s, x0_l, traj0, gains0 = q.x0s, q.x0_l, q.traj0, q.gains0
    ladder, al1, lam = q.ladder, q.al1, q.lam

    def fwd(al, emit, plain):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(traj0, gains0, x0_l, al, model=model, lims=lims,
                 emit_traj=emit)

    k, p = fwd(ladder, False, False), fwd(ladder, False, True)
    e3 = compare("quad K3 sweep A=6", {"totals": (k.totals, p.totals),
                                       "terminal": (k.terminal, p.terminal)})
    k, p = fwd(al1, True, False), fwd(al1, True, True)
    e3 = max(e3, compare("quad K3 rollout A=1", {
        "totals": (k.totals, p.totals), "traj": (k.traj, p.traj)}))
    print_k3_plans("quad", 6, 2, Tq)
    print(f"  quad K3 rollout: bit-identical to the plain version: "
          f"{torch.equal(k.traj, p.traj) and torch.equal(k.totals, p.totals)}")
    traj, tot = k.traj, k.totals[0]
    ms3 = cuda_ms(lambda: fwd(ladder, False, False), 20)
    plain3 = cuda_ms(lambda: fwd(ladder, False, True), 3)
    ms3r = cuda_ms(lambda: fwd(al1, True, False), 20)
    plain3r = cuda_ms(lambda: fwd(al1, True, True), 3)
    traj_p = traj[:Tp].contiguous()

    def bwd(emit, plain, tr=traj):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam, n=6, m=2, reg_type=2, lims=lims, derivs_tiles=tiles,
                 emit=emit)

    errs, plain1 = [], None
    for emit in ("gains", "full"):
        what = f"quad K1 Autodiff<Quadrotor> {emit} at T={Tp}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = bwd(emit, True, traj_p)
        torch.cuda.synchronize()
        plain1 = plain1 or (time.perf_counter() - t0) * 1e3
        k = bwd(emit, False, traj_p)
        lay = bk.OutLayout(6, 2, emit)
        nq = lay.quui if emit == "full" else lay.S
        errs.append(compare_slots_ties(what, k.out[:, :nq], p.out[:, :nq],
                                       AD_SLOT_TOL))
        errs.append(compare(what, {"dV": (k.stats[:2], p.stats[:2])}))
        if emit == "full":
            errs.append(compare_slots_ties(f"{what} Quu_inv", k.out[:, nq:],
                                           p.out[:, nq:], QUU_INV_TOL))
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"{what}: diverged/diverge_idx differ")
        if emit == "gains":
            kk, u = k.out[:-1, :2], traj_p[:-1, 6:8]
            on = (kk == 0.0 - u) | (kk == spec.u_max - u)
            shares = [on[:, i].float().mean().item() for i in range(2)]
            print(f"  quad K1: the thrust box binds on a share of the steps: "
                  f"rotor 0 {shares[0]:.4f}, rotor 1 {shares[1]:.4f}")
            check(min(shares) > 0, "quad K1: a rotor's limits never bind, so "
                  "the enumeration was not exercised")
    ms1 = cuda_ms(lambda: bwd("gains", False), 20)
    ms1f = cuda_ms(lambda: bwd("full", False), 20)
    bo = bwd("gains", False)
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([bo.stats[0], bo.stats[1], tot, allow])

    def ls(plain, s=sel):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(traj, bo.out, x0_l, s, model=model, alphas=cfg.alphas,
                 reduce_ratio_min=0.0, lims=lims)

    k, p = ls(False), ls(True)
    e2 = compare("quad K2", {"traj": (k.traj, p.traj),
                             "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]), "quad K2: al_sel/any_ok differ")
    print(f"  quad K2: {int(((k.ls[1] > 0.5) & (allow > 0.5)).sum())} of {B} "
          f"lanes accept")
    out = ls(False, torch.stack([bo.stats[0], bo.stats[1], tot,
                                 torch.zeros_like(tot)]))
    check(torch.equal(out.traj, traj),
          "quad K2 α=0 retrace of a K3 stream is not bit-exact")
    print("  quad K2 α=0 retrace of the K3 stream: bit-exact")
    ms2 = cuda_ms(lambda: ls(False), 20)
    plain2 = once_ms(lambda: ls(True))
    w3, w3r = k3_work(model, Tq, B, A, False), k3_work(model, Tq, B, 1, True)
    w1 = k1_work(model, Tq, B, "gains", 2, lims)
    w1f = k1_work(model, Tq, B, "full", 2, lims)
    w2 = k2_work(model, Tq, B, A)
    for what, ms, w in (("K3 sweep A=6", ms3, w3), ("K3 rollout A=1", ms3r,
                                                     w3r),
                        ("K1 gains", ms1, w1), ("K1 full", ms1f, w1f),
                        ("K2 A=6", ms2, w2)):
        print(f"  quad {what} at T={Tq}: kernel {ms:.3f} ms, bound "
              f"{w['bound_ms']:.4f} ms ({w['bound_by']}: "
              f"{w['bound_bytes'] / 1e6:.1f} MB, "
              f"{w['bound_flops'] / 1e9:.3f} GFLOP)")
    print(f"  quad plain versions: K3 sweep {plain3:.1f} ms, rollout "
          f"{plain3r:.1f} ms, K2 {plain2:.1f} ms at T={Tq}; K1 gains "
          f"{plain1:.1f} ms once at T={Tp}")
    rec["k3_quad"] = dict(max_abs_err=e3, ms=ms3, plain_ms=plain3,
                          ms_rollout=ms3r, plain_ms_rollout=plain3r,
                          bound_ms_rollout=w3r["bound_ms"], library_ms=None,
                          **w3)
    rec["k1_quad"] = dict(max_abs_err=max(errs), ms=ms1, ms_full=ms1f,
                          bound_ms_full=w1f["bound_ms"], plain_ms=plain1,
                          plain_T=Tp, library_ms=None, **w1)
    rec["k2_quad"] = dict(max_abs_err=e2, ms=ms2, plain_ms=plain2,
                          library_ms=None, **w2)
    del q, traj0, gains0, traj_p, bo, k, p, out

    # K1 Autodiff<PendCart> against the analytic pendcart K1 at the iLQG
    # headline's shapes, and against its own plain version at T=Tp
    pspec = PendCartSpec()
    pmodel = pendcart_lanes(pspec)
    p_an, p_ad = pendcart_derivs_tiles(pspec), autodiff_derivs_tiles(pmodel)
    px0 = ilqg["x0s"].T.contiguous()
    pgains = torch.cat([torch.tensor(2.0 * rng.standard_normal((T, 1, B)),
                                     dtype=torch.float32, device=dev),
                        torch.zeros((T, 4, B), device=dev)], dim=1)
    ptraj = fk.forward_lanes(torch.zeros((T, 5, B), device=dev), pgains, px0,
                             al1, model=pmodel, lims=LIMS,
                             emit_traj=True).traj

    def pbwd(tl, emit, plain=False, tr=ptraj):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam, n=4, m=1, reg_type=2, lims=LIMS, derivs_tiles=tl,
                 emit=emit)

    errs, plain_ad = [], None
    for emit in ("gains", "full"):
        lay = bk.OutLayout(4, 1, emit)
        nq = lay.quui if emit == "full" else lay.S
        ka, kn = pbwd(p_ad, emit), pbwd(p_an, emit)
        what = f"K1 Autodiff<PendCart> {emit}"
        errs.append(compare_slots(f"{what} vs analytic K1, T={T}",
                                  ka.out[:, :nq], kn.out[:, :nq],
                                  AD_ANALYTIC_TOL))
        errs.append(compare(f"{what} vs analytic", {
            "dV": (ka.stats[:2], kn.stats[:2])}))
        if emit == "full":
            errs.append(compare(f"{what} vs analytic", {
                "Quu_inv": (ka.out[:, nq:], kn.out[:, nq:])}, QUU_INV_TOL))
        check(torch.equal(ka.stats[2:], kn.stats[2:]),
              f"{what}: diverged/diverge_idx differ from the analytic K1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp = pbwd(p_ad, emit, True, ptraj[:Tp].contiguous())
        torch.cuda.synchronize()
        plain_ad = plain_ad or (time.perf_counter() - t0) * 1e3
        kp = pbwd(p_ad, emit, False, ptraj[:Tp].contiguous())
        errs.append(compare_slots(f"{what} vs its plain version, T={Tp}",
                                  kp.out[:, :nq], pp.out[:, :nq],
                                  AD_SLOT_TOL))
    ms_ad = cuda_ms(lambda: pbwd(p_ad, "gains"), 20)
    ms_adf = cuda_ms(lambda: pbwd(p_ad, "full"), 20)
    ms_an = cuda_ms(lambda: pbwd(p_an, "gains"), 20)
    wp = k1_work(pmodel, T, B, "gains", 2, LIMS)
    print(f"  K1 Autodiff<PendCart> at T={T}: gains {ms_ad:.3f} ms, full "
          f"{ms_adf:.3f} ms; the analytic K1 gains in the same run "
          f"{ms_an:.3f} ms; bound {wp['bound_ms']:.4f} ms ({wp['bound_by']}); "
          f"plain once at T={Tp}: {plain_ad:.1f} ms")
    rec["k1_pendcart_ad"] = dict(max_abs_err=max(errs), ms=ms_ad,
                                 ms_full=ms_adf, ms_analytic=ms_an,
                                 plain_ms=plain_ad, plain_T=Tp,
                                 library_ms=None, **wp)
    del ptraj, pgains, ka, kn, kp, pp

    ph.start("ilqg-ad-path", f"ilqg_batch_lanes, pendcart B={B} T={T} with "
             f"autodiff_derivs_tiles, against the analytic solve of phase 4")
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    u0p = torch.zeros((B, T, 1), device=dev)

    def timed_ad():
        s.record()
        out = ilqg_batch_lanes(pmodel, None, ilqg["x0s"], u0p, lims=LIMS,
                               cfg=cfg, derivs_tiles=p_ad, max_steps=ITERS)
        e.record()
        return out

    r, launches_ad = counted(counters, timed_ad)
    ad_ms = s.elapsed_time(e)
    rel = (r.cost_total - ilqg["cost_total"]).abs() / ilqg["cost_total"].abs()
    close = (rel <= COST_RTOL).float().mean().item()
    same_reason = (r.reason == ilqg["reason"]).float().mean().item()
    same_acc = (r.n_accepted == ilqg["n_accepted"]).float().mean().item()
    print(f"  launches: {launches_ad}")
    print(f"  solve: {ad_ms:.3f} ms (CUDA events), max n_iters "
          f"{int(r.n_iters.max())}; against the analytic solve: cost rel "
          f"diff max {rel.max().item():.3e}, median {rel.median().item():.3e}"
          f"; share of lanes: cost within {COST_RTOL:.0e} {close:.3f}, same "
          f"reason {same_reason:.3f}, same accepted count {same_acc:.3f} "
          f"(need {AGREE_SHARE} each)")
    check(all(launches_ad[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the autodiff pendcart path never ran: {launches_ad}")
    check(min(close, same_reason, same_acc) >= AGREE_SHARE,
          "pendcart with autodiff tiles: outcomes differ from the analytic "
          "solve")
    rec["k1_pendcart_ad"]["path"] = dict(solve_ms=ad_ms,
                                         iters=int(r.n_iters.max()))
    del r

    ph.start("quad-path", f"ilqg_batch_lanes, quadrotor B={B} T={Tq}, "
             f"{A}-α ladder, reg_type 2, thrust box (0, {spec.u_max:g}), "
             f"autodiff tiles, max_steps={ITERS}")
    u0s = torch.full((B, Tq, 2), spec.u_hover, device=dev)

    def solve(x0, u0, trace=False):
        return ilqg_batch_lanes(model, None, x0, u0, lims=lims, cfg=cfg,
                                derivs_tiles=tiles, max_steps=ITERS,
                                record_trace=trace)

    warm = solve(x0s, u0s, trace=True)         # warm-up, initial costs
    cost_init = warm.trace.cost[:, 0]
    del warm

    def timed_solve():
        s.record()
        out = solve(x0s, u0s)
        e.record()
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r, launches = counted(counters, timed_solve)
    wall_ms = (time.perf_counter() - t0) * 1e3
    solve_ms = s.elapsed_time(e)
    peak = torch.cuda.max_memory_allocated()
    iters = int(r.n_iters.max())
    ct = r.cost_total

    def hist(v):
        return {int(a): int(b) for a, b in zip(*torch.unique(
            v, return_counts=True))}

    print(f"  launches: {launches}")
    print(f"  n_iters histogram {hist(r.n_iters)}; reasons {hist(r.reason)}; "
          f"accepted mean {r.n_accepted.float().mean().item():.3f}")
    print(f"  cost_total min/median/max: {ct.min().item():.6g} / "
          f"{ct.median().item():.6g} / {ct.max().item():.6g} (initial "
          f"rollout median {cost_init.median().item():.6g})")
    print(f"  solve: {solve_ms:.3f} ms (CUDA events), {wall_ms:.3f} ms host "
          f"clock; {solve_ms / max(iters, 1):.4f} ms/iter over {iters} "
          f"iterations; peak memory {peak / 2**30:.3f} GiB")
    on_lo = (r.u == 0.0).float().mean().item()
    on_hi = (r.u == spec.u_max).float().mean().item()
    print(f"  u within [{r.u.min().item():.6g}, {r.u.max().item():.6g}]; "
          f"share of controls at 0: {on_lo:.4f}, at {spec.u_max:g}: "
          f"{on_hi:.4f}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the quadrotor path never ran: {launches}")
    check(1 <= iters <= ITERS, f"quad n_iters {iters}")
    check(bool((r.reason != 5).all()), "quad: an initial rollout diverged")
    check(bool(torch.isfinite(ct).all()), "quad: non-finite cost")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.u).all()
               and torch.isfinite(r.policy.K).all()),
          "quad: non-finite trajectory or gains")
    check(r.x.shape == (B, Tq, 6) and r.u.shape == (B, Tq, 2)
          and r.policy.K.shape == (B, Tq, 2, 6), "quad result shapes")
    check(bool((r.u >= 0.0).all() and (r.u <= spec.u_max).all()),
          "quad: a thrust outside (0, u_max)")
    check(ct.median() < cost_init.median(), "quad: median cost did not "
          "improve")
    st = torch.cat([to_streams(r.x), to_streams(r.u),
                    to_streams(r.cost[..., None])], dim=1)
    bo = bk.backward_lanes(st, r.lam, n=6, m=2, reg_type=2, lims=lims,
                           derivs_tiles=tiles, emit="gains")
    sel = torch.stack([bo.stats[0], bo.stats[1], ct, allow])
    out = fk.linesearch_lanes(st, bo.out, x0_l, sel, model=model,
                              alphas=cfg.alphas, lims=lims)
    rej = (out.ls[1] < 0.5) | (allow < 0.5)
    check(torch.equal(out.traj[..., rej], st[..., rej]),
          "quad: rejected lanes of the solution do not retrace bit for bit")
    print(f"  retrace: {int(rej.sum())} rejected lanes reproduce the "
          f"solution stream bit for bit")
    rec["k1_quad"]["path"] = dict(
        solve_ms=solve_ms, iters=iters, ms_per_iter=solve_ms / max(iters, 1),
        peak_bytes=peak, reasons=hist(r.reason), n_iters=hist(r.n_iters),
        cost_median=ct.median().item(), cost_init_median=cost_init.median(
        ).item())
    del r, st, bo, out

    ph.start("quad-gpu-vs-cpu", f"first {B_CPU} scenarios, T={QUAD_T_CPU}, "
             f"max_steps={ITERS}")
    x0c = x0s[:B_CPU]
    u0c = torch.full((B_CPU, QUAD_T_CPU, 2), spec.u_hover, device=dev)
    early_gpu["quad"] = solve(x0c, u0c)
    print("  the card's solve; the CPU's, in the --early-cpu child, is "
          "compared in early-gpu-vs-cpu")
    return {"ilqg_ad": launches_ad, "quad": launches}


def hetero_phases(ph, dev, rec, counters, ilqg, early_gpu: dict) -> dict:
    """Phases 21-22: the heterogeneous fleets' kernels (PendCartParam K3, K1
    and K2; per-scenario limits on the pendcart and LTI ⟨10,2⟩ instances; K2
    in place) against their plain versions, timed with their bounds; then
    the parametrised pendcart fleet with per-scenario limits at the headline
    settings (x0s and cfg of phase 4), against the CPU on 64 lanes, and an
    LTI solve with a per-scenario box. Adds the measurements to ``rec``;
    returns the launches of the paths ``hetero`` and ``hetero_lti``."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_derivs_tiles_param,
        pendcart_lanes, pendcart_lanes_param)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)

    f32 = torch.float32
    spec = PendCartSpec()
    fixed, ftiles = pendcart_lanes(spec), pendcart_derivs_tiles(spec)
    model, tiles = pendcart_lanes_param(spec), pendcart_derivs_tiles_param(
        spec)
    cfg = ilqg["cfg"]
    A = len(cfg.alphas)
    ph.start("hetero-kernels", f"PendCartParam and per-scenario limits, "
             f"B={B} T={T}; LTI <10,2> per-scenario boxes, plain at "
             f"T={LTI_T_PLAIN}, timed at T={LTI_T}")
    rng = np.random.default_rng(21)
    par = torch.tensor(np.stack([rng.uniform(*PARAM_L, B),
                                 rng.uniform(*PARAM_D, B)]), dtype=f32,
                       device=dev)                                 # (2, B)
    hi = torch.tensor(rng.uniform(*HETERO_HI, B), dtype=f32, device=dev)
    lanes = torch.stack([-hi, hi]).contiguous()                    # (2, B)
    x0_l = ilqg["x0s"].T.contiguous()
    gains0 = torch.cat([torch.tensor(2.0 * rng.standard_normal((T, 1, B)),
                                     dtype=f32, device=dev),
                        torch.zeros((T, 4, B), device=dev)], dim=1)
    traj0 = torch.zeros((T, 5, B), device=dev)
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    ladder = ladder.contiguous()
    al1 = torch.tensor(rng.uniform(0.0, 1.0, (1, B)), dtype=f32, device=dev)

    def fwd(al, emit, plain, m=model, args=(par, lanes), lims=None):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(traj0, gains0, x0_l, al, *args, model=m, lims=lims,
                 emit_traj=emit)

    k, p = fwd(ladder, False, False), fwd(ladder, False, True)
    e3 = compare("PendCartParam K3 sweep A=6", {
        "totals": (k.totals, p.totals), "terminal": (k.terminal, p.terminal)})
    check_bits("PendCartParam K3 sweep", (k.totals, p.totals),
               (k.terminal, p.terminal))
    k, p = fwd(al1, True, False), fwd(al1, True, True)
    e3 = max(e3, compare("PendCartParam K3 rollout A=1", {
        "totals": (k.totals, p.totals), "traj": (k.traj, p.traj)}))
    check_bits("PendCartParam K3 rollout", (k.totals, p.totals),
               (k.traj, p.traj))
    print_k3_plans("PendCartParam", 4, 1, T)
    traj, tot = k.traj, k.totals[0]
    u = traj[:, 4]
    check(bool((u.abs() <= hi).all()), "PendCartParam K3: a control outside "
          "its lane's box")
    print(f"  PendCartParam K3: {(u.abs() == hi).float().mean().item():.4f} "
          f"of the controls on their lane's limit")
    ms3 = cuda_ms(lambda: fwd(ladder, False, False), 20)
    plain3 = cuda_ms(lambda: fwd(ladder, False, True), 3)
    ms3r = cuda_ms(lambda: fwd(al1, True, False), 20)
    plain3r = cuda_ms(lambda: fwd(al1, True, True), 3)

    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=f32, device=dev)
    lam[::8] = 0.0

    def bwd(emit, plain, tl=tiles, per=None, lims=None, tr=traj):
        per = dict(params=par, lims_lanes=lanes) if per is None else per
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam, n=4, m=1, reg_type=2, lims=lims, derivs_tiles=tl,
                 emit=emit, **per)

    errs, plain1 = [], {}
    for emit in ("gains", "full"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = bwd(emit, True)
        torch.cuda.synchronize()
        plain1[emit] = (time.perf_counter() - t0) * 1e3
        errs.append(compare_k1(f"PendCartParam K1 {emit}", bwd(emit, False),
                             p))
    bo = bwd("gains", False)
    ms1 = cuda_ms(lambda: bwd("gains", False), 20)
    ms1f = cuda_ms(lambda: bwd("full", False), 20)
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([bo.stats[0], bo.stats[1], tot, allow])

    def ls(plain, s=sel, m=model, args=(par, lanes), lims=None, tr=traj,
           g=None, **kw):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(tr, bo.out if g is None else g, x0_l, s, *args, model=m,
                 alphas=cfg.alphas, reduce_ratio_min=0.0, lims=lims, **kw)

    k, p = ls(False), ls(True)
    e2 = compare("PendCartParam K2", {"traj": (k.traj, p.traj),
                                      "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]),
          "PendCartParam K2: al_sel/any_ok differ")
    check_bits("PendCartParam K2", (k.traj, p.traj), (k.ls, p.ls))
    out = ls(False, torch.stack([bo.stats[0], bo.stats[1], tot,
                                 torch.zeros_like(tot)]))
    check(torch.equal(out.traj, traj),
          "PendCartParam K2 α=0 retrace of a K3 stream is not bit-exact")
    ms2 = cuda_ms(lambda: ls(False), 20)
    plain2 = cuda_ms(lambda: ls(True), 3)
    w3, w3r = k3_work(model, T, B, A, False, True), k3_work(model, T, B, 1,
                                                           True, True)
    # the per-scenario clamp does a static clamp's operations
    w1 = k1_work(model, T, B, "gains", 2, LIMS, lanes=True)
    w1f = k1_work(model, T, B, "full", 2, LIMS, lanes=True)
    w2 = k2_work(model, T, B, A, True)
    for what, ms, w in (("K3 sweep A=6", ms3, w3), ("K3 rollout A=1", ms3r,
                                                     w3r),
                        ("K1 gains", ms1, w1), ("K1 full", ms1f, w1f),
                        ("K2 A=6", ms2, w2)):
        print(f"  PendCartParam {what}: kernel {ms:.3f} ms, bound "
              f"{w['bound_ms']:.4f} ms ({w['bound_by']}: "
              f"{w['bound_bytes'] / 1e6:.1f} MB)")
    print(f"  PendCartParam plain versions: K3 sweep {plain3:.1f}, rollout "
          f"{plain3r:.1f}, K1 gains {plain1['gains']:.1f} (once), full "
          f"{plain1['full']:.1f} (once), K2 {plain2:.1f} ms")
    rec["k3_pendcart_param"] = dict(
        max_abs_err=e3, ms=ms3, plain_ms=plain3, ms_rollout=ms3r,
        plain_ms_rollout=plain3r, bound_ms_rollout=w3r["bound_ms"],
        library_ms=None, **w3)
    rec["k1_pendcart_param"] = dict(
        max_abs_err=max(errs), ms=ms1, ms_full=ms1f,
        bound_ms_full=w1f["bound_ms"], plain_ms=plain1["gains"],
        plain_ms_full=plain1["full"], library_ms=None, **w1)
    rec["k2_pendcart_param"] = dict(max_abs_err=e2, ms=ms2, plain_ms=plain2,
                                    library_ms=None, **w2)

    # homogeneous rows: every params row the spec's (l, d), every limits row
    # ±5, give the static pendcart instances' bits
    same_par = torch.tensor([[spec.l], [spec.d]], device=dev).expand(
        2, B).contiguous()
    same_lanes = torch.tensor([[-5.0], [5.0]], device=dev).expand(
        2, B).contiguous()
    ref = fwd(al1, True, False, fixed, (), LIMS)
    bit = all(torch.equal(o.traj, ref.traj) and torch.equal(o.totals,
                                                            ref.totals)
              for o in (fwd(al1, True, False, model, (same_par, same_lanes)),
                        fwd(al1, True, False, fixed, (None, same_lanes))))
    for emit in ("gains", "full"):
        r = bwd(emit, False, ftiles, {}, LIMS, ref.traj)
        for o in (bwd(emit, False, tiles, dict(params=same_par,
                                               lims_lanes=same_lanes),
                      None, ref.traj),
                  bwd(emit, False, ftiles, dict(lims_lanes=same_lanes), None,
                      ref.traj)):
            bit = bit and torch.equal(o.out, r.out) and torch.equal(
                o.stats, r.stats)
    sel_h = torch.stack([r.stats[0], r.stats[1], ref.totals[0], allow])
    la = ls(False, sel_h, fixed, (), LIMS, ref.traj, r.out)
    for o in (ls(False, sel_h, model, (same_par, same_lanes), None, ref.traj,
                 r.out),
              ls(False, sel_h, fixed, (None, same_lanes), None, ref.traj,
                 r.out)):
        bit = bit and torch.equal(o.traj, la.traj) and torch.equal(o.ls,
                                                                   la.ls)
    check(bit, "homogeneous params/limits rows are not bit-identical to the "
          "static pendcart instances")
    print("  homogeneous rows (params = spec's (l, d), limits ±5): K3, K1 "
          "gains/full and K2 bit-identical to the static pendcart instances")

    # per-scenario limits on the fixed pendcart instance
    kf, pf = (fwd(al1, True, plain, fixed, (None, lanes)) for plain in
              (False, True))
    e_pc = compare("pendcart K3, per-scenario limits", {
        "totals": (kf.totals, pf.totals), "traj": (kf.traj, pf.traj)})
    check_bits("pendcart K3, per-scenario limits", (kf.totals, pf.totals),
               (kf.traj, pf.traj))
    e_pc1 = max(compare_k1(f"pendcart K1 {emit}, per-scenario limits",
                         bwd(emit, False, ftiles, dict(lims_lanes=lanes),
                             None, kf.traj),
                         bwd(emit, True, ftiles, dict(lims_lanes=lanes),
                             None, kf.traj))
                for emit in ("gains", "full"))
    bof = bwd("gains", False, ftiles, dict(lims_lanes=lanes), None, kf.traj)
    sel_f = torch.stack([bof.stats[0], bof.stats[1], kf.totals[0], allow])
    k, p = (ls(plain, sel_f, fixed, (None, lanes), None, kf.traj, bof.out)
            for plain in (False, True))
    e_pc2 = compare("pendcart K2, per-scenario limits", {
        "traj": (k.traj, p.traj), "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]),
          "pendcart K2 with per-scenario limits: al_sel/any_ok differ")
    check_bits("pendcart K2, per-scenario limits", (k.traj, p.traj),
               (k.ls, p.ls))
    ms1_pc = cuda_ms(lambda: bwd("gains", False, ftiles,
                                 dict(lims_lanes=lanes), None, kf.traj), 20)
    ms2_pc = cuda_ms(lambda: ls(False, sel_f, fixed, (None, lanes), None,
                                kf.traj, bof.out), 20)
    ms3_pc = cuda_ms(lambda: fwd(al1, True, False, fixed, (None, lanes)), 20)
    print(f"  pendcart with per-scenario limits: K1 gains {ms1_pc:.3f} ms, "
          f"K2 {ms2_pc:.3f} ms, K3 rollout {ms3_pc:.3f} ms")
    for key, ms, e, w in (
            ("k1_pendcart", ms1_pc, e_pc1,
             k1_work(fixed, T, B, "gains", 2, LIMS, lanes=True)),
            ("k2_pendcart", ms2_pc, e_pc2, k2_work(fixed, T, B, A, True)),
            ("k3_pendcart", ms3_pc, e_pc, k3_work(fixed, T, B, 1, True,
                                                  True))):
        rec[key].update(ms_lims_lanes=ms, bound_ms_lims_lanes=w["bound_ms"],
                        max_abs_err=max(rec[key]["max_abs_err"], e))

    # K2 in place against K2 with a fresh output, on the static-limits
    # stream (the MPC step's own shapes are checked in mpc-kernels)
    g_f = r.out[:, :5].contiguous()
    fresh = ls(False, sel_h, fixed, (), LIMS, ref.traj, g_f)
    plain_ip = ls(True, sel_h, fixed, (), LIMS, ref.traj, g_f)
    buf = ref.traj.clone()
    inp = ls(False, sel_h, fixed, (), LIMS, buf, g_f, in_place=True)
    check(inp.traj.data_ptr() == buf.data_ptr(),
          "K2 in place did not return its input stream")
    check(torch.equal(buf, fresh.traj) and torch.equal(inp.ls, fresh.ls),
          "K2 in place is not bit-identical to K2 with a fresh output")
    e_ip = compare("pendcart K2 in place", {
        "traj": (buf, plain_ip.traj), "totals": (inp.ls[4],
                                                 plain_ip.ls[4])})
    check_bits("pendcart K2 in place", (buf, plain_ip.traj),
               (inp.ls, plain_ip.ls))
    ms_ip = cuda_ms(lambda: ls(False, sel_h, fixed, (), LIMS, buf, g_f,
                               in_place=True), 20)
    ms_fr = cuda_ms(lambda: ls(False, sel_h, fixed, (), LIMS, ref.traj, g_f),
                    20)
    plain_ip_ms = cuda_ms(lambda: ls(True, sel_h, fixed, (), LIMS, ref.traj,
                                     g_f), 3)
    print(f"  K2 in place: bit-identical to the fresh launch; {ms_ip:.3f} ms "
          f"against {ms_fr:.3f} ms fresh in the same run")
    rec["k2_pendcart"].update(
        ms_in_place=ms_ip, ms_fresh_beside_in_place=ms_fr,
        plain_ms_in_place=plain_ip_ms,
        max_abs_err=max(rec["k2_pendcart"]["max_abs_err"], e_ip))
    del traj0, gains0, traj, bo, k, p, out, ref, r, buf, kf, pf, fresh

    # LTI ⟨10,2⟩ with a box per lane and control
    n, m, Tl, Tp = LTI_N, LTI_M, LTI_T, LTI_T_PLAIN
    lspec = random_lti(0, n=n, m=m, T=Tl, device=dev)
    lmodel, ltiles = lti_lanes(lspec), lti_derivs_tiles(lspec)
    lcfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                      lam_max=1e15, max_iter=300)
    box = np.stack([-rng.uniform(*LTI_BOX, B), rng.uniform(*LTI_BOX, B),
                    -rng.uniform(*LTI_BOX, B), rng.uniform(*LTI_BOX, B)])
    llanes = torch.tensor(box, dtype=f32, device=dev)          # (2m, B)
    lx0s = torch.ones((B, n), device=dev) * torch.linspace(
        0.5, 2.0, B, device=dev)[:, None]
    lx0_l = lx0s.T.contiguous()
    lu0s = lspec.u0.expand(B, Tl, m).contiguous()
    streams = {t: (torch.zeros((t, n + m, B), device=dev), torch.cat(
        [to_streams(lu0s[:, :t]), torch.zeros((t, m * n, B), device=dev)],
        dim=1)) for t in (Tp, Tl)}
    lad = torch.tensor(lcfg.alphas, device=dev)[:, None].expand(
        len(lcfg.alphas), B).contiguous()

    def lfwd(t, al, emit, plain, ln=llanes, lims=None):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(*streams[t], lx0_l, al, None, ln, model=lmodel, lims=lims,
                 emit_traj=emit)

    def lbwd(emit, plain, tr, ln=llanes, lims=None):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam, n=n, m=m, reg_type=2, lims=lims,
                 derivs_tiles=ltiles, lims_lanes=ln, emit=emit)

    def lls(plain, tr, g, s, ln=llanes, lims=None):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(tr, g, lx0_l, s, None, ln, model=lmodel,
                 alphas=lcfg.alphas, reduce_ratio_min=0.0, lims=lims)

    k, p = lfwd(Tp, lad, False, False), lfwd(Tp, lad, False, True)
    el3 = compare("LTI K3 sweep A=6, per-scenario boxes",
                  {"totals": (k.totals, p.totals)})
    k, p = lfwd(Tp, al1, True, False), lfwd(Tp, al1, True, True)
    el3 = max(el3, compare("LTI K3 rollout A=1, per-scenario boxes", {
        "totals": (k.totals, p.totals), "traj": (k.traj, p.traj)}))
    print_k3_plans("LTI boxes", n, m, Tl)
    ltr, ltot = k.traj, k.totals[0]
    errs, plain_l1 = [], None
    for emit in ("gains", "full"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = lbwd(emit, True, ltr)
        torch.cuda.synchronize()
        plain_l1 = plain_l1 or (time.perf_counter() - t0) * 1e3
        k = lbwd(emit, False, ltr)
        lay = bk.OutLayout(n, m, emit)
        nq = lay.quui if emit == "full" else lay.S
        what = f"LTI K1 {emit}, per-scenario boxes"
        errs.append(compare_slots_ties(what, k.out[:, :nq], p.out[:, :nq],
                                       AD_SLOT_TOL))
        errs.append(compare(what, {"dV": (k.stats[:2], p.stats[:2])}))
        if emit == "full":
            errs.append(compare_slots_ties(f"{what} Quu_inv", k.out[:, nq:],
                                           p.out[:, nq:], QUU_INV_TOL))
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"{what}: diverged/diverge_idx differ")
        if emit == "gains":
            lg = k
            kk, uu = k.out[:-1, :m], ltr[:-1, n:n + m]
            on = (kk == llanes[0::2] - uu) | (kk == llanes[1::2] - uu)
            shares = [on[:, i].float().mean().item() for i in range(m)]
            print(f"  LTI K1: each lane's box binds on a share of the steps: "
                  f"control 0 {shares[0]:.4f}, control 1 {shares[1]:.4f}")
            check(min(shares) > 0, "LTI K1: a per-scenario box never binds")
    lsel = torch.stack([lg.stats[0], lg.stats[1], ltot, allow])
    k, p = lls(False, ltr, lg.out, lsel), lls(True, ltr, lg.out, lsel)
    el2 = compare("LTI K2, per-scenario boxes", {
        "traj": (k.traj, p.traj), "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]),
          "LTI K2 with per-scenario boxes: al_sel/any_ok differ")
    plain_l2 = once_ms(lambda: lls(True, ltr, lg.out, lsel))
    plain_l3 = once_ms(lambda: lfwd(Tp, lad, False, True))
    # homogeneous rows ±0.6 against the static limits, bit for bit
    same = torch.tensor([[-0.6], [0.6], [-0.6], [0.6]], device=dev).expand(
        2 * m, B).contiguous()
    a, b = lfwd(Tp, al1, True, False, None, LTI_LIMS), lfwd(Tp, al1, True,
                                                          False, same)
    bit = torch.equal(a.traj, b.traj) and torch.equal(a.totals, b.totals)
    ka = lbwd("full", False, a.traj, None, LTI_LIMS)
    kb = lbwd("full", False, a.traj, same)
    bit = bit and torch.equal(ka.out, kb.out) and torch.equal(ka.stats,
                                                              kb.stats)
    hs = torch.stack([ka.stats[0], ka.stats[1], a.totals[0], allow])
    la, lb = (lls(False, a.traj, ka.out, hs, None, LTI_LIMS),
              lls(False, a.traj, ka.out, hs, same))
    bit = bit and torch.equal(la.traj, lb.traj) and torch.equal(la.ls, lb.ls)
    check(bit, "LTI: rows all ±0.6 are not bit-identical to the static ±0.6")
    print("  LTI: rows all ±0.6 give the static limits' K3, K1 full and K2 "
          "bit for bit")
    ms3l = cuda_ms(lambda: lfwd(Tl, lad, False, False), 20)
    ro = lfwd(Tl, al1, True, False)
    ms3lr = cuda_ms(lambda: lfwd(Tl, al1, True, False), 20)
    ms1l = cuda_ms(lambda: lbwd("gains", False, ro.traj), 20)
    ms1lf = cuda_ms(lambda: lbwd("full", False, ro.traj), 20)
    bo_t = lbwd("gains", False, ro.traj)
    sel_t = torch.stack([bo_t.stats[0], bo_t.stats[1], ro.totals[0], allow])
    ms2l = cuda_ms(lambda: lls(False, ro.traj, bo_t.out, sel_t), 20)
    A6 = len(lcfg.alphas)
    wl3, wl3r = k3_work(lmodel, Tl, B, A6, False, True), k3_work(
        lmodel, Tl, B, 1, True, True)
    wl1 = k1_work(lmodel, Tl, B, "gains", 2, LTI_LIMS, lanes=True)
    wl1f = k1_work(lmodel, Tl, B, "full", 2, LTI_LIMS, lanes=True)
    wl2 = k2_work(lmodel, Tl, B, A6, True)
    for what, ms, w in (("K3 sweep A=6", ms3l, wl3), ("K3 rollout A=1",
                                                       ms3lr, wl3r),
                        ("K1 gains", ms1l, wl1), ("K1 full", ms1lf, wl1f),
                        ("K2 A=6", ms2l, wl2)):
        print(f"  LTI per-scenario boxes {what} at T={Tl}: kernel {ms:.3f} "
              f"ms, bound {w['bound_ms']:.3f} ms ({w['bound_by']})")
    print(f"  LTI plain versions once at T={Tp}: K3 sweep {plain_l3:.1f}, "
          f"K1 gains {plain_l1:.1f}, K2 {plain_l2:.1f} ms")
    rec["k3_lti_lanes"] = dict(max_abs_err=el3, ms=ms3l, ms_rollout=ms3lr,
                               bound_ms_rollout=wl3r["bound_ms"],
                               plain_ms=plain_l3, plain_T=Tp,
                               library_ms=None, **wl3)
    rec["k1_lti_lanes"] = dict(max_abs_err=max(errs), ms=ms1l, ms_full=ms1lf,
                               bound_ms_full=wl1f["bound_ms"],
                               plain_ms=plain_l1, plain_T=Tp,
                               library_ms=None, **wl1)
    rec["k2_lti_lanes"] = dict(max_abs_err=el2, ms=ms2l, plain_ms=plain_l2,
                               plain_T=Tp, library_ms=None, **wl2)
    del streams, ltr, k, p, a, b, ka, kb, la, lb, ro, bo_t, lg

    ph.start("hetero-path", f"ilqg_batch_lanes, parametrised pendcart "
             f"B={B} T={T}, l~U{PARAM_L}, d~U{PARAM_D}, limits "
             f"±U{HETERO_HI}, max_steps={ITERS}")
    params_b = par.T.contiguous()                           # (B, 2)
    lims_b = lanes.T.contiguous()[:, None, :]               # (B, 1, 2)
    u0s = torch.zeros((B, T, 1), device=dev)
    x0s = ilqg["x0s"]

    def solve(x0, u0, pb, lb, trace=False):
        return ilqg_batch_lanes(model, None, x0, u0, lims=lb, cfg=cfg,
                                derivs_tiles=tiles, params=pb,
                                max_steps=ITERS, record_trace=trace)

    warm = solve(x0s, u0s, params_b, lims_b, trace=True)
    cost_init = warm.trace.cost[:, 0]
    del warm
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)

    def timed():
        s.record()
        out = solve(x0s, u0s, params_b, lims_b)
        e.record()
        return out

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    r, launches = counted(counters, timed)
    solve_ms = s.elapsed_time(e)
    peak = torch.cuda.max_memory_allocated() - base
    iters = int(r.n_iters.max())
    ct = r.cost_total

    def hist(v):
        return {int(a): int(b) for a, b in zip(*torch.unique(
            v, return_counts=True))}

    ua = r.u[..., 0].abs()
    print(f"  launches: {launches}")
    print(f"  n_iters histogram {hist(r.n_iters)}; reasons {hist(r.reason)}; "
          f"accepted mean {r.n_accepted.float().mean().item():.3f}")
    print(f"  cost_total min/median/max: {ct.min().item():.6g} / "
          f"{ct.median().item():.6g} / {ct.max().item():.6g} (initial "
          f"rollout median {cost_init.median().item():.6g})")
    print(f"  solve: {solve_ms:.3f} ms (CUDA events); "
          f"{solve_ms / max(iters, 1):.4f} ms/iter over {iters} iterations; "
          f"peak memory above what the run started with "
          f"{peak / 2**30:.3f} GiB")
    print(f"  each lane's controls within its own box: share on the box "
          f"{(ua == hi[:, None]).float().mean().item():.4f}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the heterogeneous path never ran: {launches}")
    check(bool((ua <= hi[:, None]).all()),
          "hetero: a control outside its lane's box")
    check(bool(torch.isfinite(ct[r.reason != 5]).all()
               and torch.isfinite(r.x).all()), "hetero: non-finite results")
    check(ct.median() < cost_init.median(), "hetero: median cost did not "
          "improve")
    rec["k1_pendcart_param"]["path"] = dict(
        solve_ms=solve_ms, iters=iters, ms_per_iter=solve_ms / max(iters, 1),
        peak_bytes=peak, reasons=hist(r.reason))
    paths = {"hetero": launches}
    del r

    # the solve of B_CPU lanes that early-gpu-vs-cpu compares with the
    # --early-cpu child's
    sl = slice(0, B_CPU)
    early_gpu["hetero"] = solve(x0s[sl], u0s[sl], params_b[sl], lims_b[sl])

    # the LTI fleet with a per-scenario box on each control
    lb = llanes.T.reshape(B, m, 2)                    # [lo, hi] per control

    def timed_lti():
        s.record()
        out = ilqg_batch_lanes(lmodel, None, lx0s, lu0s, lims=lb, cfg=lcfg,
                               derivs_tiles=ltiles, max_steps=ITERS // 2,
                               record_trace=True)
        e.record()
        return out

    r, launches = counted(counters, timed_lti)
    lti_ms = s.elapsed_time(e)
    iters = int(r.n_iters.max())
    inside = ((r.u >= lb[:, None, :, 0]) & (r.u <= lb[:, None, :, 1])).all()
    print(f"  LTI n={n} m={m} T={Tl} with per-scenario boxes, max_steps="
          f"{ITERS // 2}: {lti_ms:.3f} ms, {iters} iterations, launches "
          f"{launches}; median cost {r.trace.cost[:, 0].median().item():.6g}"
          f" -> {r.cost_total.median().item():.6g}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the LTI per-scenario-box path never ran: {launches}")
    check(bool(inside), "LTI: a control outside its lane's box")
    check(bool(torch.isfinite(r.cost_total).all()), "LTI boxes: non-finite")
    check(r.cost_total.median() < r.trace.cost[:, 0].median(),
          "LTI boxes: median cost did not improve")
    rec["k1_lti_lanes"]["path"] = dict(solve_ms=lti_ms, iters=iters,
                                       ms_per_iter=lti_ms / max(iters, 1))
    paths["hetero_lti"] = launches
    return paths


def mpc_phases(ph, dev, rec, counters, early_gpu: dict) -> dict:
    """Phase 23: the MPC path's kernel instances (pendcart K3 at α=1, K1
    gains/full, K2 with the 4-α ladder fresh and in place; the same
    PendCartParam instances with per-scenario [l, d] and limits) against
    their plain versions at the path's shapes, timed with their bounds; the
    MPC serving loop at the JAX MPC tier's settings
    (``bench.py:149-212``), timed over windows of chunks with CUDA events,
    its launches and host syncs per step, a torch.profiler split of one
    chunk; a chunk with per-scenario parameters and limits; the MPC step
    ``ilqg_iteration_lanes`` with K2 in place; the loop on 64 lanes that
    early-gpu-vs-cpu compares with the CPU's (``early_gpu["mpc"]``). Adds
    the measurements to ``rec``; returns the launches of the paths
    ``mpc``, ``mpc_hetero`` and ``iteration``."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, default_x0, make_pendcart_problem,
        pendcart_derivs_tiles, pendcart_derivs_tiles_param, pendcart_lanes,
        pendcart_lanes_param)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_iteration_lanes, mpc_rollout_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)

    f32 = torch.float32
    Tm = MPC_T
    spec = PendCartSpec()
    model, tiles = pendcart_lanes(spec), pendcart_derivs_tiles(spec)
    mp, mt = pendcart_lanes_param(spec), pendcart_derivs_tiles_param(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                     lam_max=1e15, max_iter=5, iter_cap=9)
    A = len(cfg.alphas)
    # the tier's inputs (bench.py:169-196): x0 = default_x0 +
    # 0.2·N(0,1)·[1,1,0,0], a seed plan 0.1·N(0,1), from a numpy seed; and
    # the heterogeneous chunk's per-scenario [l, d] and limits
    rng = np.random.default_rng(31)
    x0 = torch.tensor(np.asarray(default_x0(device="cpu").numpy(),
                                 np.float64)[None, :]
                      + 0.2 * rng.standard_normal((B, 4))
                      * np.array([1.0, 1.0, 0, 0]), dtype=f32, device=dev)
    u_seed = torch.tensor(0.1 * rng.standard_normal((B, Tm, 1)), dtype=f32,
                          device=dev)
    params = torch.tensor(np.stack([rng.uniform(*PARAM_L, B),
                                    rng.uniform(*PARAM_D, B)], axis=1),
                          dtype=f32, device=dev)            # (B, 2)
    hi = torch.tensor(rng.uniform(*HETERO_HI, B), dtype=f32, device=dev)

    ph.start("mpc-kernels", f"the MPC path's instances at its shapes, B={B} "
             f"T={Tm}, {A}-α ladder: pendcart (±10) K3 rollout, K1 "
             f"gains/full, K2 fresh and in place; PendCartParam with "
             f"per-scenario [l, d] and limits K3, K1, K2")
    # each re-solve's first stream: the warm start's K3 roll of the seed
    # plan at α=1, and the solver's first λ
    gains0 = torch.cat([to_streams(u_seed), torch.zeros((Tm, 4, B),
                                                        device=dev)], dim=1)
    zeros, one = torch.zeros((Tm, 5, B), device=dev), torch.ones((1, B),
                                                                 device=dev)
    x0_l = x0.T.contiguous()
    lam = torch.full((B,), cfg.lam, device=dev)
    lanes = torch.stack([-hi, hi]).contiguous()             # (2, B)
    for what, mdl, tl, args, lims in (
            ("pendcart", model, tiles, (), MPC_LIMS),
            ("PendCartParam", mp, mt, (params.T.contiguous(), lanes), None)):
        key = "pendcart_param" if args else "pendcart"
        per = dict(params=args[0], lims_lanes=args[1]) if args else {}

        def fwd(plain):
            f = fk.forward_lanes_ref if plain else fk.forward_lanes
            return f(zeros, gains0, x0_l, one, *args, model=mdl, lims=lims,
                     emit_traj=True)

        k3, p3 = fwd(False), fwd(True)
        e3 = compare(f"{what} K3 rollout α=1", {
            "totals": (k3.totals, p3.totals), "traj": (k3.traj, p3.traj)})
        check_bits(f"{what} K3 rollout α=1", (k3.totals, p3.totals),
                   (k3.traj, p3.traj))
        print_k3_plans(what, 4, 1, Tm)
        traj = k3.traj

        def bwd(emit, plain):
            f = bk.backward_lanes_ref if plain else bk.backward_lanes
            return f(traj, lam, n=4, m=1, reg_type=cfg.reg_type, lims=lims,
                     derivs_tiles=tl, emit=emit, **per)

        e1, plain1 = [], {}
        for emit in ("gains", "full"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = bwd(emit, True)
            torch.cuda.synchronize()
            plain1[emit] = (time.perf_counter() - t0) * 1e3
            e1.append(compare_k1(f"{what} K1 {emit}", bwd(emit, False), p))
        bo = bwd("gains", False)
        sel = torch.stack([bo.stats[0], bo.stats[1], k3.totals[0],
                           (bo.stats[2] <= 0.5).float()])

        def ls(plain, src=traj, x0_=x0_l, **kw):
            f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
            return f(src, bo.out, x0_, sel, *args, model=mdl,
                     alphas=cfg.alphas, reduce_ratio_min=cfg.reduce_ratio_min,
                     lims=lims, **kw)

        k2, p2 = ls(False), ls(True)
        e2 = compare(f"{what} K2 A={A}", {"traj": (k2.traj, p2.traj),
                                         "totals": (k2.ls[4], p2.ls[4])})
        check(torch.equal(k2.ls[:2], p2.ls[:2]),
              f"{what} K2 A={A}: al_sel/any_ok differ")
        check_bits(f"{what} K2 A={A}", (k2.traj, p2.traj), (k2.ls, p2.ls))
        print(f"  {what} K2: {int((k2.ls[1] > 0.5).sum())} of {B} lanes "
              f"accept")
        ms3 = cuda_ms(lambda: fwd(False), 20)
        plain3 = cuda_ms(lambda: fwd(True), 3)
        ms1 = cuda_ms(lambda: bwd("gains", False), 20)
        ms1f = cuda_ms(lambda: bwd("full", False), 20)
        ms2 = cuda_ms(lambda: ls(False), 20)
        plain2 = cuda_ms(lambda: ls(True), 3)
        w1 = k1_work(mdl, Tm, B, "gains", cfg.reg_type, MPC_LIMS,
                     lanes=bool(args))
        w1f = k1_work(mdl, Tm, B, "full", cfg.reg_type, MPC_LIMS,
                      lanes=bool(args))
        w2 = k2_work(mdl, Tm, B, A, bool(args))
        w3 = k3_work(mdl, Tm, B, 1, True, bool(args))
        rec[f"k3_{key}_mpc"] = dict(max_abs_err=e3, ms=ms3, plain_ms=plain3,
                                    library_ms=None, **w3)
        rec[f"k1_{key}_mpc"] = dict(
            max_abs_err=max(e1), ms=ms1, ms_full=ms1f,
            bound_ms_full=w1f["bound_ms"], plain_ms=plain1["gains"],
            plain_ms_full=plain1["full"], library_ms=None, **w1)
        rec[f"k2_{key}_mpc"] = dict(max_abs_err=e2, ms=ms2, plain_ms=plain2,
                                    library_ms=None, **w2)
        rows = [("K3 rollout A=1", ms3, w3), ("K1 gains", ms1, w1),
                ("K1 full", ms1f, w1f), (f"K2 A={A}", ms2, w2)]
        if not args:
            # the MPC step's K2: in place, x0 a view of the stream it
            # overwrites, bit for bit the fresh launch
            buf = traj.clone()
            ip = ls(False, buf, buf[0, :4], in_place=True)
            check(ip.traj.data_ptr() == buf.data_ptr(),
                  "K2 in place did not return its input stream")
            check(torch.equal(buf, k2.traj) and torch.equal(ip.ls, k2.ls),
                  f"K2 A={A} in place is not bit-identical to K2 fresh")
            e_ip = compare(f"pendcart K2 A={A} in place", {
                "traj": (buf, p2.traj), "totals": (ip.ls[4], p2.ls[4])})
            ms_ip = cuda_ms(lambda: ls(False, buf, buf[0, :4],
                                       in_place=True), 20)
            rec["k2_pendcart_inplace"] = dict(
                max_abs_err=e_ip, ms=ms_ip, ms_fresh=ms2, plain_ms=plain2,
                library_ms=None, **w2)
            rows.append((f"K2 A={A} in place", ms_ip, w2))
            print(f"  pendcart K2 A={A} in place (x0 a view of the stream): "
                  f"bit-identical to the fresh launch")
        for name, ms, w in rows:
            print(f"  {what} {name} at T={Tm}: kernel {ms:.3f} ms, bound "
                  f"{w['bound_ms']:.4f} ms ({w['bound_by']})")
        print(f"  {what} plain versions: K3 rollout {plain3:.1f}, K1 gains "
              f"{plain1['gains']:.1f} (once), full {plain1['full']:.1f} "
              f"(once), K2 {plain2:.1f} ms")
    del gains0, zeros, k3, p3, traj, bo, k2, p2, buf, ip

    ph.start("mpc-path", f"mpc_rollout_lanes, pendcart B={B} T={Tm}, ±10, "
             f"{A}-α ladder, max_iter={cfg.max_iter}, "
             f"iter_cap={cfg.iter_cap}, {MPC_STEPS} steps a chunk")
    prob = make_pendcart_problem(spec, "euler", device=dev)

    def plant(x, u):
        return prob.dynamics(x, u, 0)

    def chunk(x, u, n_steps=MPC_STEPS):
        return mpc_rollout_lanes(model, None, x, u, plant, n_steps,
                                 lims=MPC_LIMS, cfg=cfg, derivs_tiles=tiles)

    t0 = time.perf_counter()
    first, launches = counted(counters, lambda: chunk(x0, u_seed))
    first_s = time.perf_counter() - t0
    x, u, _, us1, costs1 = first
    # one burn-in chunk, with its host syncs counted
    (x, u, _, _, _), syncs = sync_count(lambda: chunk(x, u))
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step_ms = []
    for _ in range(MPC_WINDOWS):
        s.record()
        x, u, _, _, _ = chunk(x, u)
        x, u, xs, us, costs = chunk(x, u)
        e.record()
        torch.cuda.synchronize()
        step_ms.append(s.elapsed_time(e) / (2 * MPC_STEPS))
    peak = torch.cuda.max_memory_allocated() - base
    prof = profile_split(lambda: chunk(x, u))
    per_step = {k: v / MPC_STEPS for k, v in launches.items() if v}
    print(f"  card: {smi()}")
    print(f"  ms per MPC step over {MPC_WINDOWS} windows of {2 * MPC_STEPS} "
          f"steps (CUDA events): min {min(step_ms):.4f}, median "
          f"{statistics.median(step_ms):.4f}; windows "
          f"{[round(v, 4) for v in step_ms]}")
    print(f"  first chunk (seed plan) {first_s * 1e3:.1f} ms host clock; "
          f"launches per step {per_step}; host syncs per step "
          f"{syncs / MPC_STEPS:.2f} ({syncs} in a {MPC_STEPS}-step chunk); "
          f"peak memory above what the windows started with "
          f"{peak / 2**30:.3f} GiB")
    if prof is None:
        print("  profile: torch.profiler recorded no device events; split "
              "not measured")
    else:
        per = ", ".join(f"{k} {v[0]:.3f} ms ({v[1]})"
                        for k, v in prof["by_kernel"].items())
        print(f"  profile of one chunk: wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['busy_ms']:.3f} ms (idle share "
              f"{prof['idle_share']:.4f}); kernels {prof['kernel_ms']:.3f} ms "
              f"[{per}]; glue {prof['glue_ms']:.3f} ms in "
              f"{prof['glue_launches']} launches")
    c_seed, c_end = costs1[0].median().item(), costs[-1].median().item()
    n_steps = (2 + 2 * MPC_WINDOWS) * MPC_STEPS
    fell = (costs[-1] < 0.1 * costs1[0]).float().mean().item()
    print(f"  median re-solve cost: first step {c_seed:.6g}, after step "
          f"{MPC_STEPS} {costs1[-1].median().item():.6g}, after {n_steps} "
          f"steps {c_end:.6g}; share of lanes whose re-solve cost fell "
          f"below a tenth of its first {fell:.4f}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the MPC path never ran: {launches}")
    check(bool(torch.isfinite(xs).all() and torch.isfinite(us).all()
               and torch.isfinite(costs).all() and torch.isfinite(x).all()),
          "MPC: non-finite states, controls or costs")
    check(xs.shape == (MPC_STEPS, B, 4) and us.shape == (MPC_STEPS, B, 1)
          and costs.shape == (MPC_STEPS, B) and u.shape == (B, Tm, 1),
          "MPC result shapes")
    check(bool((us.abs() <= 10.0).all() and (us1.abs() <= 10.0).all()),
          "MPC: a control outside ±10")
    check(c_end < c_seed, "MPC: the median closed-loop cost did not fall")
    rec["mpc"] = dict(ms_per_step_min=min(step_ms),
                      ms_per_step_median=statistics.median(step_ms),
                      windows_ms_per_step=step_ms,
                      launches_per_step=per_step,
                      syncs_per_step=syncs / MPC_STEPS, peak_bytes=peak,
                      profile=prof, cost_first=c_seed, cost_end=c_end,
                      share_cost_below_tenth=fell)
    paths = {"mpc": launches}

    # a chunk on a heterogeneous fleet: per-scenario [l, d] and limits in
    # every re-solve, and a plant that steps each lane's own pendulum
    lims_b = torch.stack([-hi, hi], dim=-1)[:, None, :]     # (B, 1, 2)
    par = [params[:, 0].contiguous(), params[:, 1].contiguous()]

    def hplant(x_, u_):
        return torch.stack(mp.dynamics(list(x_.T), list(u_.T), 0, par),
                           dim=1)

    (xh, uh, xsh, ush, csh), launches_h = counted(
        counters, lambda: mpc_rollout_lanes(
            mp, None, x0, u_seed, hplant, MPC_STEPS, lims=lims_b, cfg=cfg,
            derivs_tiles=mt, params=params))
    print(f"  heterogeneous chunk ({MPC_STEPS} steps, per-scenario [l, d] "
          f"and limits ±U{HETERO_HI}): launches {launches_h}; median cost "
          f"{csh[0].median().item():.6g} -> {csh[-1].median().item():.6g}; "
          f"share of applied controls on their lane's limit "
          f"{(ush[..., 0].abs() == hi).float().mean().item():.4f}")
    check(all(launches_h[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the heterogeneous MPC chunk never ran: {launches_h}")
    check(bool(torch.isfinite(xsh).all() and torch.isfinite(csh).all()),
          "heterogeneous MPC: non-finite states or costs")
    check(bool((ush[..., 0].abs() <= hi).all()
               and (uh[..., 0].abs() <= hi[:, None]).all()),
          "heterogeneous MPC: a control outside its lane's box")
    paths["mpc_hetero"] = launches_h

    # the MPC step: K1 gains and K2 in place on the MPC state's stream
    step = ilqg_iteration_lanes(model, None, MPC_LIMS, cfg,
                                derivs_tiles=tiles)
    gains = torch.cat([to_streams(u), torch.zeros((Tm, 4, B), device=dev)],
                      dim=1)
    ro = fk.forward_lanes(torch.zeros((Tm, 5, B), device=dev), gains,
                          x.T.contiguous(), torch.ones((1, B), device=dev),
                          model=model, lims=MPC_LIMS, emit_traj=True)
    state = list(step(ro.traj, ro.totals[0],
                      torch.full((B,), cfg.lam, device=dev)))
    tots, ptrs = [state[1]], []

    def steps():
        s.record()
        for _ in range(ITER_STEPS):
            ptrs.append(state[0].data_ptr())
            state[:] = step(*state)
            ptrs.append(state[0].data_ptr())
            tots.append(state[1])
        e.record()

    _, launches_i = counted(counters, steps)
    it_ms = s.elapsed_time(e) / ITER_STEPS
    mono = all(bool((b <= a + 1e-4 * a.abs()).all())
               for a, b in zip(tots, tots[1:]))
    print(f"  ilqg_iteration_lanes: {it_ms:.4f} ms per step over "
          f"{ITER_STEPS} steps; launches {launches_i}; median cost "
          f"{tots[0].median().item():.6g} -> {tots[-1].median().item():.6g}")
    check(len(set(ptrs)) == 1, "MPC step: K2 did not update the stream in "
          "place")
    check(mono, "MPC step: a lane's cost rose")
    check(launches_i["linesearch_lanes"] == ITER_STEPS
          and launches_i["backward_lanes"] == ITER_STEPS,
          f"MPC step launches {launches_i}")
    rec["k2_pendcart_inplace"]["iteration_path"] = dict(ms_per_step=it_ms)
    paths["iteration"] = launches_i

    ph.start("mpc-gpu-vs-cpu", f"first {B_CPU} scenarios, T={Tm}, "
             f"{MPC_CPU_STEPS} MPC steps")
    early_gpu["mpc"] = chunk(x0[:B_CPU], u_seed[:B_CPU], MPC_CPU_STEPS)
    print("  the card's loop; the CPU's, in the --early-cpu child, is "
          "compared in early-gpu-vs-cpu")
    return paths


def mpc_cpu_loop() -> dict:
    """The MPC loop of mpc-gpu-vs-cpu on the host (part of the
    ``--early-cpu`` child): the tier's x0 and seed plan (numpy seed 31, the
    first two draws of mpc_phases) on B_CPU lanes, MPC_CPU_STEPS steps, the
    plain versions; each step's states and costs."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, default_x0, make_pendcart_problem,
        pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        mpc_rollout_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)
    spec = PendCartSpec()
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                     lam_max=1e15, max_iter=5, iter_cap=9)
    rng = np.random.default_rng(31)
    x0 = torch.tensor(np.asarray(default_x0(device="cpu").numpy(),
                                 np.float64)[None, :]
                      + 0.2 * rng.standard_normal((B, 4))
                      * np.array([1.0, 1.0, 0, 0]), dtype=torch.float32)
    u_seed = torch.tensor(0.1 * rng.standard_normal((B, MPC_T, 1)),
                          dtype=torch.float32)
    prob = make_pendcart_problem(spec, "euler", device="cpu")
    c = mpc_rollout_lanes(pendcart_lanes(spec), None, x0[:B_CPU],
                          u_seed[:B_CPU],
                          lambda x_, u_: prob.dynamics(x_, u_, 0),
                          MPC_CPU_STEPS, lims=MPC_LIMS, cfg=cfg,
                          derivs_tiles=pendcart_derivs_tiles(spec))
    return dict(states=c[2].tolist(), costs=c[4].tolist())


def mpc_agree(g, c: dict) -> None:
    """The card's MPC loop ``g`` against the host's: per lane, the worst
    step's cost within COST_RTOL and its states within 1e-3, each share at
    least AGREE_SHARE."""
    gc, cc = g[4].cpu(), torch.tensor(c["costs"])
    gx, cx = g[2].cpu(), torch.tensor(c["states"])
    rel = ((gc - cc).abs() / cc.abs()).amax(dim=0)
    dx = (gx - cx).abs().amax(dim=(0, 2))
    close = (rel <= COST_RTOL).float().mean().item()
    x_close = (dx <= 1e-3).float().mean().item()
    print(f"  mpc: per lane, worst step: cost rel diff max "
          f"{rel.max().item():.3e}, median {rel.median().item():.3e}; state "
          f"max abs diff max {dx.max().item():.3e}; share of lanes: costs "
          f"within {COST_RTOL:.0e} {close:.3f}, states within 1e-3 "
          f"{x_close:.3f} (need {AGREE_SHARE} each)")
    check(min(close, x_close) >= AGREE_SHARE,
          "MPC: GPU and CPU closed loops differ")


def probe_phase(ph, dev, rec, counters) -> dict:
    """Phase 21: the probe K5, each mode against its plain version (bit for
    bit: copies and sequential f32 adds), timed, with its achieved
    bandwidth. Returns the launches of each mode's run."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        probe_kernel as pk)
    ph.start("probe", f"K5 over a ({PROBE_T}, {pk.S_IN}, {B}) stream: copy, "
             f"light ({pk.MODES['light']} terms a step), full "
             f"({pk.MODES['full']})")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((PROBE_T, pk.S_IN, B), generator=gen, device=dev)
    paths = {}
    for mode in pk.MODES:
        k, paths[f"probe_{mode}"] = counted(
            counters, lambda: pk.probe_lanes(x, mode))
        p = pk.probe_lanes_ref(x, mode)
        mx, _ = err(k, p)
        check(torch.equal(k, p), f"K5 {mode}: differs from its plain version "
              f"(max abs {mx:.3e})")
        ms = cuda_ms(lambda: pk.probe_lanes(x, mode), 20)
        plain = once_ms(lambda: pk.probe_lanes_ref(x, mode))
        # the copy is one PyTorch call too: the slice, copied
        lib = (cuda_ms(lambda: x[:, :pk.S_OUT].clone(), 20)
               if mode == "copy" else None)
        w = k5_work(mode, PROBE_T, B)
        gbs = w["bound_bytes"] / ms / 1e6
        print(f"  K5 {mode}: bit-identical, kernel {ms:.4f} ms "
              f"({gbs:.1f} GB/s of {w['bound_bytes'] / 1e6:.1f} MB), bound "
              f"{w['bound_ms']:.4f} ms ({w['bound_by']}), plain {plain:.1f} ms"
              + (f", torch slice clone {lib:.4f} ms; kernel / clone "
                 f"{ms / lib:.3f}" if lib else ""))
        if mode == "full":
            print(f"  K5 full: chain bound {PROBE_T * pk.MODES['full']} "
                  f"dependent adds × 4 cycles at 1.755 GHz = "
                  f"{k5_chain_ms(PROBE_T):.4f} ms")
        rec[f"k5_{mode}"] = dict(max_abs_err=mx, ms=ms, plain_ms=plain,
                                 library_ms=lib, achieved_GBps=gbs, **w)
        if mode == "full":
            rec["k5_full"]["chain_bound_ms"] = k5_chain_ms(PROBE_T)
    return paths


def sync_count(fn):
    """Run ``fn`` with CUDA's sync debug mode set to warn; returns
    (result, host syncs in that run)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def timed_solve(fn, counters):
    """One run of a generic solve: device ms (CUDA events), host ms, host
    syncs, and the port's kernel launches (none on this tier)."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)

    def run():
        s.record()
        out = fn()
        e.record()
        return out

    t0 = time.perf_counter()
    (out, syncs), launches = counted(counters, lambda: sync_count(run))
    host_ms = (time.perf_counter() - t0) * 1e3
    return out, dict(ms=s.elapsed_time(e), host_ms=host_ms, syncs=syncs,
                     kernel_launches=sum(launches.values()))


def per_iter(name: str, r, iters: int, lpi=None) -> dict:
    """Print and return a solve's per-iteration numbers; ``lpi``: device
    launches per iteration (:func:`launches_per_iter`)."""
    iters = max(int(iters), 1)
    out = dict(iters=iters, ms=r["ms"], ms_per_iter=r["ms"] / iters,
               host_ms=r["host_ms"], syncs_per_iter=r["syncs"] / iters,
               launches_per_iter=lpi, kernel_launches=r["kernel_launches"])
    lpi_text = ("not measured" if lpi is None else
                f"{lpi:.1f} (torch.profiler, first {GEN_PROFILE_ITERS} "
                f"iterations)")
    print(f"  {name}: {iters} iterations, {r['ms']:.1f} ms on CUDA events "
          f"({r['host_ms']:.1f} ms host clock), {out['ms_per_iter']:.3f} ms "
          f"per iteration, {out['syncs_per_iter']:.2f} host syncs per "
          f"iteration, device launches per iteration {lpi_text}; port "
          f"kernels launched: {r['kernel_launches']}")
    check(r["kernel_launches"] == 0, f"{name}: a port kernel ran")
    return out


def launches_per_iter(fn) -> float:
    """Device operations (kernels, copies, fills) per iteration of a short
    run (``fn`` runs GEN_PROFILE_ITERS iterations), counted in
    torch.profiler's raw CUDA activity records: building its Python event
    list for ≈10⁵ records would take minutes. None when it recorded no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    n = sum(1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda)
    return n / GEN_PROFILE_ITERS if n else None


def noise_floor_lanes(res) -> torch.Tensor:
    """Lanes whose last step changed their cost by less than GEN_NOISE of it
    (see GEN_NOISE)."""
    it = res.n_iters.long().clamp(max=res.trace.improvement.shape[-1] - 1)
    last = res.trace.improvement.gather(-1, it[..., None])[..., 0]
    return last.abs() < GEN_NOISE * res.cost.sum(-1).abs()


def generic_phases(ph, dev, counters) -> dict:
    """Phases 25-29: the generic tier on the card in f64 (plain PyTorch, no
    kernel of the port), against golden.npz, JAX's outcomes in
    tools_torch/generic_inputs.npz and the same calls on CPU tensors.
    Returns the record of the group."""
    import dataclasses
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        linear as tl, pendcart as tpc)
    from differentialdynamicprogramming_jl_tpu_torch.ops.boxqp import (
        boxqp, demo_qp)
    from differentialdynamicprogramming_jl_tpu_torch.ops.forward import (
        forward_pass)
    from differentialdynamicprogramming_jl_tpu_torch.parallel.mesh import (
        ilqg_batched)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas, ilqg)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig, ilqg_kl)

    f64 = torch.float64
    gold = np.load("tests/golden.npz")
    inp = np.load("tools_torch/generic_inputs.npz")
    out = {"card": smi()}

    def t(a, to=dev):
        return torch.tensor(np.asarray(a), dtype=f64, device=to)

    # ---- 25: boxQP
    ph.start("generic-boxqp", "demo_qp(n=500) card vs CPU; golden QPs")
    g, syncs = sync_count(lambda: demo_qp(500, device=dev))
    c = demo_qp(500, device="cpu")
    rel = abs(g.value.item() - c.value.item()) / abs(c.value.item())
    print(f"  demo_qp n=500: result {int(g.result)} (CPU {int(c.result)}), "
          f"iterations {int(g.iters)}, value {g.value.item()!r} (CPU "
          f"{c.value.item()!r}, rel {rel:.3e}, tol {GEN_QP_RTOL:.0e}); "
          f"{syncs} host syncs")
    check(int(g.result) == int(c.result) and int(g.result) >= 1,
          "demo_qp: result codes differ or failed")
    check(rel <= GEN_QP_RTOL, f"demo_qp: value rel {rel:.3e}")
    qp_ms = cuda_ms(lambda: demo_qp(500, device=dev), 3)
    eye3, box = np.eye(3), (-np.ones(3), np.ones(3))
    cases = {
        "n50": (inp["qp_n50_H"], inp["qp_n50_g"], -np.ones(50), np.ones(50),
                np.zeros(50)),
        "all_clamped": (eye3, np.array([10., -10., 10.]), *box,
                        np.zeros(3)),
        "interior": (2.0 * eye3, np.array([0.5, -0.25, 0.1]), *box,
                     np.zeros(3)),
        "non_pd": (np.diag([1.0, -1.0, 1.0]), np.ones(3), *box, np.zeros(3)),
    }
    for case, args in cases.items():
        r = boxqp(*(t(a) for a in args))
        dv = abs(r.value.item() - float(gold[f"boxqp_{case}_value"]))
        dx = abs(r.x.sum().item() - float(gold[f"boxqp_{case}_x_sum"]))
        print(f"  golden {case}: result {int(r.result)}, |Δvalue| {dv:.3e} "
              f"(tol 1e-10), |Δx_sum| {dx:.3e} (tol 1e-8)")
        check(int(r.result) == int(gold[f"boxqp_{case}_result"])
              and dv <= 1e-10 and dx <= 1e-8, f"golden boxQP {case} differs")
    print(f"  demo_qp n=500 on the card: {qp_ms:.2f} ms (CUDA events)")
    out["boxqp"] = dict(demo_qp_ms=qp_ms, demo_qp_iters=int(g.iters),
                        demo_qp_syncs=syncs, demo_qp_result=int(g.result))

    # ---- 26: ilqg on the golden pendcart
    ph.start("generic-ilqg-pendcart", "golden: zoh, T=300, ±10, f64")
    prob = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs="zoh",
                                     dtype=f64, device=dev)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, tol_fun=1e-8, tol_grad=1e-8, max_iter=300)
    lims = t([[-10.0, 10.0]])
    x0 = tpc.default_x0(f64, device=dev)
    u0 = torch.zeros((300, 1), dtype=f64, device=dev)
    res, r = timed_solve(lambda: ilqg(prob, x0, u0, lims=lims, cfg=cfg),
                         counters)
    lpi = launches_per_iter(lambda: ilqg(
        prob, x0, u0, lims=lims,
        cfg=dataclasses.replace(cfg, iter_cap=GEN_PROFILE_ITERS + 1)))
    cost, ang = res.cost.sum().item(), res.x[-1, 0].item()
    uabs = res.u.abs().sum().item()
    print(f"  reason {int(res.reason)}; cost {cost!r} (golden "
          f"{float(gold['pendcart_cost'])!r}), final angle {ang!r} (golden "
          f"{float(gold['pendcart_angle'])!r}), Σ|u| {uabs!r} (golden "
          f"{float(gold['pendcart_u_abs'])!r})")
    out["ilqg_pendcart"] = dict(reason=int(res.reason), cost=cost,
                                **per_iter("ilqg pendcart", r, res.n_iters,
                                           lpi))
    np.testing.assert_allclose(cost, gold["pendcart_cost"], rtol=1e-6)
    np.testing.assert_allclose(ang, gold["pendcart_angle"], rtol=1e-4)
    np.testing.assert_allclose(uabs, gold["pendcart_u_abs"], rtol=1e-4)
    check(res.cost.shape == (301,), "traj_cost contract: cost not (T+1,)")

    # ---- 27: demo_linear at T=1000 against JAX's outcome
    ph.start("generic-ilqg-lti", "demo_linear n=10, m=2, T=1000, f64, "
             "scan and parallel backward")
    spec = tl.LTISpec(*(t(inp[f"lti_demo_{k}"]) for k in tl.LTISpec._fields))
    lprob = tl.make_lti_problem(spec, 1000)
    out["ilqg_lti"] = {}
    for backward, tag in (("scan", "demo_linear"),
                          ("parallel", "demo_linear_parallel")):
        lcfg = ILQGConfig(backward=backward)
        res, r = timed_solve(lambda: ilqg(lprob, spec.x0, spec.u0, cfg=lcfg),
                             counters)
        lpi = launches_per_iter(lambda: ilqg(
            lprob, spec.x0, spec.u0,
            cfg=dataclasses.replace(lcfg, iter_cap=GEN_PROFILE_ITERS + 1)))
        cost = res.cost.sum().item()
        want = float(inp[f"{tag}_cost"])
        rel = abs(cost - want) / abs(want)
        print(f"  {backward}: reason {int(res.reason)} (JAX "
              f"{int(inp[f'{tag}_reason'])}), n_iters {int(res.n_iters)} (JAX "
              f"{int(inp[f'{tag}_n_iters'])}), cost {cost!r} (JAX {want!r}, "
              f"rel {rel:.3e}, tol {GEN_LTI_RTOL:.0e})")
        out["ilqg_lti"][backward] = dict(
            reason=int(res.reason), cost=cost,
            **per_iter(f"ilqg LTI {backward}", r, res.n_iters, lpi))
        check(rel <= GEN_LTI_RTOL and int(res.reason) == int(
            inp[f"{tag}_reason"]) and int(res.n_iters) == int(
            inp[f"{tag}_n_iters"]), f"demo_linear {backward}: differs from "
            "JAX's outcome")

    # ---- 28: ilqg_batched, card against CPU
    ph.start("generic-batched", f"ilqg_batched B={GEN_B}, pendcart zoh, "
             f"T={GEN_T}, ±10, f64, max_iter {GEN_BATCH_ITERS}")
    rng = np.random.default_rng(28)
    x0s = np.tile(np.asarray(tpc.default_x0(f64, device="cpu")), (GEN_B, 1))
    x0s[:, 0] += 0.2 * rng.standard_normal(GEN_B)
    bcfg = dataclasses.replace(cfg, max_iter=GEN_BATCH_ITERS)
    probc = tpc.make_pendcart_problem(tpc.PendCartSpec(), derivs="zoh",
                                      dtype=f64, device="cpu")

    def batched(pr, to):
        return ilqg_batched(pr, t(x0s, to), torch.zeros(
            (GEN_B, GEN_T, 1), dtype=f64, device=to), lims=t(
            [[-10.0, 10.0]], to), cfg=bcfg)

    res, r = timed_solve(lambda: batched(prob, dev), counters)
    lpi = launches_per_iter(lambda: ilqg_batched(
        prob, t(x0s), torch.zeros((GEN_B, GEN_T, 1), dtype=f64, device=dev),
        lims=lims, cfg=dataclasses.replace(
            bcfg, iter_cap=GEN_PROFILE_ITERS + 1)))
    t0 = time.perf_counter()
    cres = batched(probc, "cpu")
    cpu_s = time.perf_counter() - t0
    gc, cc = res.cost.sum(-1).cpu(), cres.cost.sum(-1)
    rel = ((gc - cc).abs() / cc.abs()).max().item()
    same = res.reason.cpu() == cres.reason
    floor = noise_floor_lanes(res).cpu() | noise_floor_lanes(cres)
    flips = ~same & floor & (res.reason.cpu() >= 2) & (cres.reason >= 2) & (
        res.reason.cpu() <= 3) & (cres.reason <= 3)
    print(f"  reasons card {res.reason.tolist()}, CPU {cres.reason.tolist()}"
          f"; max cost rel diff {rel:.3e} (tol {GEN_BATCH_RTOL:.0e}); lanes "
          f"at the noise floor {int(floor.sum())}, of which exits 2/3 "
          f"differ {int(flips.sum())}; CPU solve {cpu_s:.1f} s")
    out["ilqg_batched"] = dict(
        B=GEN_B, T=GEN_T, cpu_s=cpu_s, max_cost_rel=rel,
        reasons=res.reason.tolist(), exit_flips_at_noise_floor=int(
            flips.sum()),
        **per_iter(f"ilqg_batched B={GEN_B}", r, res.n_iters.max(), lpi))
    check(rel <= GEN_BATCH_RTOL, "ilqg_batched: card and CPU costs differ")
    check(bool((same | flips).all()), "ilqg_batched: card and CPU exits "
          "differ away from the noise floor")

    # ---- 29: ilqg_kl
    ph.start("generic-ilqg-kl", "golden scalar-η and per-step (T=60), "
             f"demo_linear_kl outer solve (T={GEN_KL_T}, kl_step 100)")
    out["ilqg_kl"] = {}

    def kl_setup(prefix, T, n):
        sp = tl.LTISpec(*(t(inp[f"{prefix}_{k}"]) for k in
                          tl.LTISpec._fields))
        sp = sp._replace(u0=sp.u0[:T])
        pr = tl.make_lti_problem(sp, T)
        ro = forward_pass(pr, sp.x0, sp.u0)
        traj = GaussianPolicy.zeros(T, n, 2, f64, device=dev)._replace(
            k=ro.u)
        return pr, tl.SimpleLTVModel.from_lti(sp.A, sp.B, T), ro, traj

    pr, model, ro, traj = kl_setup("lti_kl", 60, 4)
    for tag, kcfg in (
            ("scalar", ILQGKLConfig(kl_step=2.0, max_iter=30)),
            ("per_step", ILQGKLConfig(kl_step=1e-5, max_iter=15,
                                      constrain_per_step=True,
                                      gd_alpha=0.3))):
        res, r = timed_solve(lambda: ilqg_kl(pr, ro.x, traj, model, ro.cost,
                                             cfg=kcfg), counters)
        p = "ilqgkl" if tag == "scalar" else "ilqgkl_ps"
        cost, eta, div = (res.cost.sum().item(), res.eta.mean().item(),
                          res.divergence.mean().item())
        print(f"  golden {tag}: cost {cost!r} ({float(gold[p + '_cost'])!r})"
              f", η {eta!r}, KL {div!r}, n_iters {int(res.n_iters)} "
              f"({int(gold[p + '_iters'])}), satisfied "
              f"{bool(res.satisfied)}")
        np.testing.assert_allclose(cost, gold[p + "_cost"], rtol=1e-9)
        if tag == "scalar":
            np.testing.assert_allclose(eta, gold["ilqgkl_eta"], rtol=1e-9)
            np.testing.assert_allclose(div, gold["ilqgkl_divergence"],
                                       rtol=1e-8)
        else:
            np.testing.assert_allclose(eta, gold["ilqgkl_ps_eta_mean"],
                                       rtol=1e-8)
            np.testing.assert_allclose(div, gold["ilqgkl_ps_div_mean"],
                                       rtol=1e-7)
        check(int(res.n_iters) == int(gold[p + "_iters"])
              and bool(res.satisfied) == bool(gold[p + "_satisfied"]),
              f"ilqg_kl golden {tag}: iterations or satisfied differ")
        out["ilqg_kl"][tag] = dict(cost=cost, **per_iter(
            f"ilqg_kl {tag}", r, res.n_iters))
    pr, model, ro, traj = kl_setup("lti_demo", GEN_KL_T, 10)
    res, r = timed_solve(lambda: ilqg_kl(pr, ro.x, traj, model, ro.cost,
                                         cfg=ILQGKLConfig(kl_step=100.0)),
                         counters)
    print(f"  demo_linear_kl outer solve: cost {res.cost.sum().item()!r} "
          f"(pre-roll {ro.cost.sum().item()!r}), η {res.eta.item()!r}, KL "
          f"{res.divergence.item()!r}, satisfied {bool(res.satisfied)}")
    check(bool(torch.isfinite(res.cost).all()), "demo_linear_kl: non-finite")
    out["ilqg_kl"]["demo_linear_kl"] = dict(
        cost=res.cost.sum().item(), eta=res.eta.item(),
        satisfied=bool(res.satisfied),
        **per_iter("demo_linear_kl outer", r, res.n_iters))
    return out


def headline_x0() -> np.ndarray:
    """The headline fleet's x0 (B, 4) in f64: default_x0 + 0.2·N(0,1) on θ
    from seed 0, the first draw of the ilqg-kernels phase."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        default_x0)
    rng = np.random.default_rng(0)
    return np.asarray(default_x0(device="cpu").numpy(), np.float64)[
        None, :] + 0.2 * rng.standard_normal((B, 4)) * np.array(
            [1.0, 0, 0, 0])


def headline_cfg():
    """The headline's ILQGConfig (JAX bench.py:257-294)."""
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)
    return ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                      lam_max=1e15)


def packed_quad_x0() -> np.ndarray:
    """The packed group's quadrotor x0 (B, 6) in f64 (PACKED_QUAD_SEED)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        default_x0)
    rng = np.random.default_rng(PACKED_QUAD_SEED)
    return default_x0(torch.float64, device="cpu").numpy()[None, :] + (
        0.3 * rng.standard_normal((B, 6)) * np.array([1, 0, 1, 0, 0.5, 0]))


def lti_packed_fleet(device):
    """The packed group's LTI fleet, as the LTI path's
    (tools/bench_fleet.py:57-74): random_lti's spec from seed 0, x0 =
    1·linspace(0.5, 2) over the B scenarios (made on the host, so that the
    child process of the CPU solves draws the same lanes), and the LTI
    path's ILQGConfig (6-α ladder, reg_type 2, max_iter 300)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)
    spec = random_lti(0, n=LTI_N, m=LTI_M, T=LTI_T, device=device)
    x0s = torch.ones((B, LTI_N)) * torch.linspace(0.5, 2.0, B)[:, None]
    return spec, x0s.to(device), ILQGConfig(
        alphas=default_alphas(0.2, -3.0, 6), reg_type=2, lam_max=1e15,
        max_iter=300)


def packed_cpu_solves() -> dict:
    """The packed / full DDP group's CPU plain solves on B_CPU lanes, for
    its GPU-against-CPU checks: the headline pendcart with
    ``pendcart_packed_derivs`` and with ``pendcart_derivs_tiles_so``
    (T=500, 20 iterations), the quadrotor with ``autodiff_packed_derivs``
    and with its autodiff second-order tiles (T=QUAD_T_CPU), the LTI fleet
    with ``lti_packed_derivs`` (T=LTI_T_CPU). They take a few minutes of
    host time (full DDP's λ-retries: ≈6.6 backward passes an iteration on
    the pendcart), so ``main`` runs this in
    a child process (``chip_smoke.py --packed-cpu``, CPU tensors only) from
    the build phase on, beside the card's phases. Returns, per solve, the
    cost totals, reasons and accepted counts, and its seconds; then the
    lowered group's (lowered_cpu_solves)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles_so, pendcart_lanes,
        pendcart_packed_derivs)
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_lanes, lti_packed_derivs)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles, autodiff_packed_derivs
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    cfg, pspec, qspec = headline_cfg(), PendCartSpec(), QuadrotorSpec()
    qmodel = quadrotor_lanes(qspec)
    lspec, lx0, lcfg = lti_packed_fleet("cpu")
    f32 = dict(dtype=torch.float32, device="cpu")
    x0p = torch.tensor(headline_x0()[:B_CPU], **f32)
    x0q = torch.tensor(packed_quad_x0()[:B_CPU], **f32)
    runs = {
        "pendcart packed": lambda: ilqg_batch_lanes(
            pendcart_lanes(pspec), pendcart_packed_derivs(pspec), x0p,
            torch.zeros((B_CPU, T, 1), **f32), lims=LIMS, cfg=cfg,
            max_steps=ITERS),
        "pendcart full DDP (PendCartSO)": lambda: ilqg_batch_lanes(
            pendcart_lanes(pspec), None, x0p,
            torch.zeros((B_CPU, T, 1), **f32), lims=LIMS, cfg=cfg,
            derivs_tiles=pendcart_derivs_tiles_so(pspec), max_steps=ITERS),
        "quadrotor packed (autodiff_packed_derivs)": lambda: ilqg_batch_lanes(
            qmodel, autodiff_packed_derivs(qmodel), x0q,
            torch.full((B_CPU, QUAD_T_CPU, 2), qspec.u_hover, **f32),
            lims=qspec.lims, cfg=cfg, max_steps=ITERS),
        "quadrotor full DDP (Autodiff<Quadrotor,SO>)": lambda: (
            ilqg_batch_lanes(
                qmodel, None, x0q,
                torch.full((B_CPU, QUAD_T_CPU, 2), qspec.u_hover, **f32),
                lims=qspec.lims, cfg=cfg, max_steps=ITERS,
                derivs_tiles=autodiff_derivs_tiles(qmodel,
                                                   second_order=True))),
        "LTI packed (lti_packed_derivs)": lambda: ilqg_batch_lanes(
            lti_lanes(lspec), lti_packed_derivs(lspec), lx0[:B_CPU],
            lspec.u0[:LTI_T_CPU].expand(B_CPU, LTI_T_CPU, LTI_M).contiguous(),
            lims=LTI_LIMS, cfg=lcfg)}
    out = {}
    for label, run in runs.items():
        t0 = time.perf_counter()
        r = run()
        out[label] = dict(cost_total=r.cost_total.tolist(),
                          reason=r.reason.tolist(),
                          n_accepted=r.n_accepted.tolist(),
                          seconds=time.perf_counter() - t0)
    out.update(lowered_cpu_solves())
    return out


def packed_phases(ph, dev, rec, counters, ilqg, cpu_proc) -> dict:
    """Phases 30-32, the "packed / full DDP" group: K1 on the
    packed-derivatives stream (Packed<4,1>, with GPS mode, Packed<6,2>,
    Packed<10,2>) and with second-order tiles (PendCartSO,
    Autodiff<PendCart, SO>, Autodiff<Quadrotor, SO>) against their plain
    versions; the generators' cost; the headline pendcart fleet solve with
    ``pendcart_packed_derivs`` and with ``pendcart_derivs_tiles_so``, the
    quadrotor with ``autodiff_packed_derivs`` beside its in-kernel AD solve,
    the full-DDP autodiff solves and the LTI fleet with
    ``lti_packed_derivs``, each against the CPU on B_CPU lanes (the
    pendcart's autodiff full DDP against the analytic one on the card);
    ``backward_pass_pallas`` in GPS mode. The CPU solves come from
    ``cpu_proc`` (:func:`start_cpu_child` of ``--packed-cpu``). Adds the
    measurements to ``rec``; returns the launches of its paths."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_lanes, lti_packed_derivs)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_derivs_tiles_so,
        pendcart_lanes, pendcart_packed_derivs)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles, autodiff_packed_derivs
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        DERIV_FIELDS, from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        Derivs, GaussianPolicy)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    import re

    t_group = time.perf_counter()
    cfg = ilqg["cfg"]

    def cpu_solves() -> dict:
        return child_solves(cpu_proc)
    ph.start("packed-kernels", f"B={B}: K1 on the packed stream "
             f"(Packed<4,1>, GPS, Packed<6,2>, Packed<10,2>) and with "
             f"second-order tiles (PendCartSO, Autodiff<PendCart,SO>, "
             f"Autodiff<Quadrotor,SO>) against their plain versions; the "
             f"generators' cost")
    rng = np.random.default_rng(21)
    f32 = dict(dtype=torch.float32, device=dev)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), **f32)
    lam[::8] = 0.0
    al1 = torch.tensor(rng.uniform(0.0, 1.0, (1, B)), **f32)

    def rollout(model, x0_l, u, lims):
        """A K3 rollout at α ~ U(0, 1) of controls u (T, m, B)."""
        Tn, mm = u.shape[0], u.shape[1]
        gains = torch.cat([u, torch.zeros((Tn, mm * model.n, B), **f32)], 1)
        return fk.forward_lanes(torch.zeros((Tn, model.n + mm, B), **f32),
                                gains, x0_l, al1, model=model, lims=lims,
                                emit_traj=True).traj

    pspec, qspec = PendCartSpec(), QuadrotorSpec()
    pmodel, qmodel = pendcart_lanes(pspec), quadrotor_lanes(qspec)
    ptraj = rollout(pmodel, ilqg["x0s"].T.contiguous(),
                    torch.tensor(2.0 * rng.standard_normal((T, 1, B)), **f32),
                    LIMS)
    qx0s = torch.tensor(packed_quad_x0(), **f32)
    qtraj = rollout(qmodel, qx0s.T.contiguous(), torch.tensor(
        qspec.u_hover + 1.5 * rng.standard_normal((QUAD_T, 2, B)), **f32),
        qspec.lims)
    lspec, lx0s, lcfg = lti_packed_fleet(dev)
    lmodel = lti_lanes(lspec)
    ltraj = rollout(lmodel, lx0s.T.contiguous(), to_streams(
        lspec.u0.expand(B, LTI_T, LTI_M)), LTI_LIMS)

    gens = {"pendcart": (pendcart_packed_derivs(pspec), ptraj, 4, 1),
            "quad": (autodiff_packed_derivs(qmodel), qtraj, 6, 2),
            "lti": (lti_packed_derivs(lspec), ltraj, LTI_N, LTI_M)}
    gen_stats = {}
    for name, (gen, tr, n, m) in gens.items():
        x_s, u_s = tr[:, :n].contiguous(), tr[:, n:n + m].contiguous()
        ms = cuda_ms(lambda: gen(x_s, u_s), 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gen(x_s, u_s)
        # what one call holds at its peak above what was allocated before
        peak = torch.cuda.max_memory_allocated() - base

        def device_ops(calls):
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    gen(x_s, u_s)
                torch.cuda.synchronize()
            return sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)

        # a call's device operations as the difference of two sessions:
        # once profilers have run in the process, a session may miss its
        # first events (34 against 1 counted for the pendcart generator)
        ops = device_ops(2) - device_ops(1)
        D = bk.InLayout(n, m).DU
        mb = 4 * tr.shape[0] * B * (n + m + D) / 1e6
        print(f"  generator {name} ⟨{n},{m}⟩ at T={tr.shape[0]}: "
              f"{ms:.3f} ms a call, {ops} device operations (torch.profiler"
              f"), {D} slots out, peak memory a call {peak / 2**30:.3f} "
              f"GiB; its bytes (x, u in, the stream out) at "
              f"3.35 TB/s {mb * 1e6 / HBM_PER_MS:.4f} ms ({mb:.1f} MB)")
        gen_stats[name] = dict(ms=ms, device_ops=ops, mbytes=mb,
                               peak_bytes=peak)
    dp = {name: gen(tr[:, :n], tr[:, n:n + m])
          for name, (gen, tr, n, m) in gens.items()}

    def k1_check(key, what, n, m, lims, inputs, Tk, Tplain, model, tol,
                 emits=("gains", "full"), ties=False, packed=False,
                 so=False, reg_type=2, **kw):
        """K1 at Tplain against its plain version (each emission), timed at
        Tk; ``inputs(Tc)`` → (stream, derivs_tiles) cut to Tc steps."""
        def run(emit, plain, Tc):
            tr, tl = inputs(Tc)
            f = bk.backward_lanes_ref if plain else bk.backward_lanes
            extra = {k: v[:Tc].contiguous() for k, v in kw.items()}
            return f(tr, lam, n=n, m=m, reg_type=reg_type, lims=lims,
                     derivs_tiles=tl, emit=emit, **extra)

        errs, plain_ms, outs = [], None, {}
        cmp = compare_slots_ties if ties else compare_slots
        for emit in emits:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = run(emit, True, Tplain)
            torch.cuda.synchronize()
            plain_ms = plain_ms or (time.perf_counter() - t0) * 1e3
            k = run(emit, False, Tplain)
            lay = bk.OutLayout(n, m, emit)
            nq = lay.quui if lay.quui is not None else lay.S
            label = f"K1 {what} {emit} at T={Tplain}"
            errs.append(cmp(label, k.out[:, :nq], p.out[:, :nq], tol))
            errs.append(compare(label, {"dV": (k.stats[:2], p.stats[:2])}))
            if lay.quui is not None:
                errs.append(compare(label, {"Quu_inv": (
                    k.out[:, nq:], p.out[:, nq:])}, QUU_INV_TOL))
            check(torch.equal(k.stats[2:], p.stats[2:]),
                  f"{label}: diverged/diverge_idx differ")
            outs[emit] = k
        ms = {e: cuda_ms(lambda e=e: run(e, False, Tk), 20) for e in emits}
        w = k1_work(model, Tk, B, emits[0], reg_type, lims,
                    gps="prev" in kw, packed=packed, so=so)
        print(f"  K1 {what} at T={Tk}: " + ", ".join(
            f"{e} {v:.4f} ms" for e, v in ms.items())
            + f"; bound {w['bound_ms']:.4f} ms ({w['bound_by']}: "
            f"{w['bound_bytes'] / 1e6:.1f} MB, "
            f"{w['bound_flops'] / 1e9:.3f} GFLOP); plain once at "
            f"T={Tplain}: {plain_ms:.1f} ms")
        rec[key] = dict(max_abs_err=max(errs), ms=ms[emits[0]],
                        plain_ms=plain_ms, plain_T=Tplain, library_ms=None,
                        **w)
        if len(emits) > 1:
            rec[key]["ms_full"] = ms["full"]
        return outs

    ptiles, pso = pendcart_derivs_tiles(pspec), pendcart_derivs_tiles_so(pspec)
    outs = k1_check("k1_packed_pendcart", "Packed<4,1>", 4, 1, LIMS,
                    lambda Tc: (dp["pendcart"][:Tc].contiguous(), None), T, T,
                    pmodel, KERNEL_TOL, packed=True)
    a = bk.backward_lanes(ptraj, lam, n=4, m=1, reg_type=2, lims=LIMS,
                          derivs_tiles=ptiles, emit="full")
    compare_slots("K1 Packed<4,1> full against K1 PendCart on the same "
                  "trajectory", outs["full"].out[:, :26], a.out[:, :26],
                  KERNEL_TOL)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((T, 1, B)), 0.5 * rng.standard_normal((T, 4, B)),
        rng.uniform(0.5, 2.0, (T, 1, B))], axis=1), **f32)
    eta = torch.tensor(10.0 ** rng.uniform(-0.3, 1, (T, B)), **f32)
    k1_check("k1_packed_pendcart_gps", "Packed<4,1> GPS", 4, 1, None,
             lambda Tc: (dp["pendcart"][:Tc].contiguous(), None), T, T,
             pmodel, GPS_SLOT_TOL, emits=("full",), packed=True, reg_type=1,
             prev=prev, eta=eta)
    k1_check("k1_packed_quad", "Packed<6,2>", 6, 2, qspec.lims,
             lambda Tc: (dp["quad"][:Tc].contiguous(), None), QUAD_T,
             QUAD_T_PLAIN, qmodel, AD_SLOT_TOL, ties=True, packed=True)
    k1_check("k1_packed_lti", "Packed<10,2>", LTI_N, LTI_M, LTI_LIMS,
             lambda Tc: (dp["lti"][:Tc].contiguous(), None), LTI_T,
             LTI_T_PLAIN, lmodel, KERNEL_TOL, ties=True, packed=True)
    outs = k1_check("k1_pendcart_so", "PendCartSO", 4, 1, LIMS,
                    lambda Tc: (ptraj[:Tc].contiguous(), pso), T, T, pmodel,
                    KERNEL_TOL, so=True)
    pad_so = autodiff_derivs_tiles(pmodel, second_order=True)
    k1_check("k1_pendcart_ad_so", "Autodiff<PendCart,SO>", 4, 1, LIMS,
             lambda Tc: (ptraj[:Tc].contiguous(), pad_so), T, QUAD_T_PLAIN,
             pmodel, AD_SLOT_TOL, so=True)
    a = bk.backward_lanes(ptraj, lam, n=4, m=1, reg_type=2, lims=LIMS,
                          derivs_tiles=pad_so, emit="full")
    compare_slots("K1 Autodiff<PendCart,SO> full against K1 PendCartSO",
                  a.out[:, :26], outs["full"].out[:, :26], AD_ANALYTIC_TOL)
    qad_so = autodiff_derivs_tiles(qmodel, second_order=True)
    k1_check("k1_quad_so", "Autodiff<Quadrotor,SO>", 6, 2, qspec.lims,
             lambda Tc: (qtraj[:Tc].contiguous(), qad_so), QUAD_T,
             QUAD_T_PLAIN, qmodel, AD_SLOT_TOL, ties=True, so=True)
    for line in rec["ptxas"]:
        if re.search(r"<(Packed|PendCartSO|Autodiff<\w+,SO>)", line):
            print("  " + line)
    del ltraj, outs, a, prev, eta
    dp.pop("lti")
    torch.cuda.empty_cache()

    paths = {}

    def fleet(label, key, solve, x0s, u0s, x0c=None, u0c=None, gen=None,
              gen_key=None, besides=None):
        """One fleet solve at full width: launches, ms/iter, K1 ms a
        launch, the generator's calls and cost, host syncs an iteration,
        peak memory, and agreement with the CPU plain solve on the lanes
        of ``x0c``, ``u0c`` (none where they are None)."""
        calls = [0]
        if gen is not None:
            def counted_gen(x, u):
                calls[0] += 1
                return gen(x, u)
        else:
            counted_gen = None
        warm = solve(x0s, u0s, counted_gen, True)
        cost_init = warm.trace.cost[:, 0]
        del warm
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

        def timed():
            s.record()
            out = solve(x0s, u0s, counted_gen, False)
            e.record()
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the group holds its checks' streams: count what the solve adds
        base = torch.cuda.memory_allocated()
        calls[0] = 0
        r, launches = counted(counters, timed)
        solve_ms = s.elapsed_time(e)
        peak = torch.cuda.max_memory_allocated() - base
        n_calls = calls[0]
        _, syncs = sync_count(lambda: solve(x0s, u0s, counted_gen, False))
        iters = max(int(r.n_iters.max()), 1)
        ct = r.cost_total
        k1_ms = rec[key]["ms"]
        gen_text = ""
        if gen is not None:
            g = gen_stats[gen_key]
            gen_text = (f"; generator {n_calls} calls, {g['ms']:.3f} ms and "
                        f"{g['device_ops']} device operations a call")
        print(f"  {label}: launches {launches}")
        print(f"  {label}: {solve_ms:.3f} ms (CUDA events), "
              f"{solve_ms / iters:.4f} ms/iter over {iters} iterations; K1 "
              f"{k1_ms:.4f} ms a gains launch{gen_text}; "
              f"{syncs / iters:.2f} host syncs an iteration; peak memory "
              f"{peak / 2**30:.3f} GiB above what was allocated before")
        print(f"  {label}: cost median {ct.median().item():.6g} (initial "
              f"{cost_init.median().item():.6g}), accepted mean "
              f"{r.n_accepted.float().mean().item():.3f}, reasons "
              f"{ {int(a): int(b) for a, b in zip(*torch.unique(r.reason, return_counts=True))} }")
        if besides is not None:
            bc, bms, bit = besides
            rel = (ct - bc).abs() / bc.abs()
            print(f"  {label}: against the in-kernel solve of the same "
                  f"fleet ({bms:.3f} ms, {bms / bit:.4f} ms/iter): cost rel "
                  f"diff median {rel.median().item():.3e}, share within "
                  f"{COST_RTOL:.0e} {(rel <= COST_RTOL).float().mean().item():.3f}")
        check(all(launches[c.__name__] > 0 for c in counters[:3]),
              f"{label}: a kernel of the path never ran: {launches}")
        check(gen is None or n_calls >= 2,
              f"{label}: the generator ran {n_calls} times")
        check(bool(torch.isfinite(ct).all()), f"{label}: non-finite cost")
        check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.u).all()
                   and torch.isfinite(r.policy.K).all()),
              f"{label}: non-finite trajectory or gains")
        check(ct.median() < cost_init.median(),
              f"{label}: median cost did not improve")
        rec[key]["path"] = dict(
            solve_ms=solve_ms, iters=iters, ms_per_iter=solve_ms / iters,
            syncs_per_iter=syncs / iters, peak_bytes=peak,
            generator_calls=n_calls if gen is not None else None,
            generator=gen_stats.get(gen_key),
            cost_median=ct.median().item())
        if x0c is None:
            return launches, r
        g = solve(x0c, u0c, counted_gen, False)
        c = cpu_solves()[label]
        gc, cc = g.cost_total.cpu(), torch.tensor(c["cost_total"])
        rel = (gc - cc).abs() / cc.abs()
        close = (rel <= COST_RTOL).float().mean().item()
        same_reason = (g.reason.cpu() == torch.tensor(c["reason"])).float(
            ).mean().item()
        same_acc = (g.n_accepted.cpu() == torch.tensor(c["n_accepted"])
                    ).float().mean().item()
        print(f"  {label} against the CPU plain solve on {B_CPU} lanes, "
              f"T={u0c.shape[1]} ({c['seconds']:.1f} s in the child "
              f"process): cost "
              f"rel diff max {rel.max().item():.3e}; share of lanes: cost "
              f"within {COST_RTOL:.0e} {close:.3f}, same reason "
              f"{same_reason:.3f}, same accepted count {same_acc:.3f} (need "
              f"{AGREE_SHARE} each)")
        check(min(close, same_reason, same_acc) >= AGREE_SHARE,
              f"{label}: GPU and CPU outcomes differ")
        return launches, r

    ph.start("packed-path", f"ilqg_batch_lanes, pendcart B={B} T={T}, "
             f"{len(cfg.alphas)}-α ladder, reg_type 2, ±5, max_steps={ITERS}"
             f": pendcart_packed_derivs, pendcart_derivs_tiles_so and "
             f"autodiff second-order tiles")
    pgen = pendcart_packed_derivs(pspec)
    u0p = torch.zeros((B, T, 1), **f32)
    x0c, u0c = ilqg["x0s"][:B_CPU], u0p[:B_CPU]

    def psolve(tiles):
        def solve(x0, u0, gen, trace):
            return ilqg_batch_lanes(pmodel, gen, x0, u0, lims=LIMS, cfg=cfg,
                                    derivs_tiles=tiles, max_steps=ITERS,
                                    record_trace=trace)
        return solve

    paths["packed"], _ = fleet("pendcart packed", "k1_packed_pendcart",
                               psolve(None), ilqg["x0s"], u0p, x0c, u0c,
                               gen=pgen, gen_key="pendcart")
    paths["full_ddp"], r = fleet("pendcart full DDP (PendCartSO)",
                                 "k1_pendcart_so", psolve(pso), ilqg["x0s"],
                                 u0p, x0c, u0c)
    rel = (r.cost_total - ilqg["cost_total"]).abs() / ilqg[
        "cost_total"].abs()
    print(f"  full DDP against the first-order headline solve: cost rel "
          f"diff median {rel.median().item():.3e}; accepted mean "
          f"{r.n_accepted.float().mean().item():.3f} against "
          f"{ilqg['n_accepted'].float().mean().item():.3f}")
    # its plain version takes ≈0.1 s a step on the host: held against the
    # analytic full-DDP solve on the card instead of a CPU solve
    paths["ilqg_ad_full_ddp"], ra = fleet(
        "pendcart full DDP (Autodiff<PendCart,SO>)", "k1_pendcart_ad_so",
        psolve(pad_so), ilqg["x0s"], u0p)
    rel = (ra.cost_total - r.cost_total).abs() / r.cost_total.abs()
    close = (rel <= COST_RTOL).float().mean().item()
    print(f"  Autodiff<PendCart,SO> solve against PendCartSO's: share of "
          f"lanes with cost within {COST_RTOL:.0e} {close:.3f}")
    check(close >= AGREE_SHARE, "full DDP: autodiff and analytic solves "
          "differ")
    del r, ra

    ph.start("packed-quad-path", f"ilqg_batch_lanes, quadrotor B={B} "
             f"T={QUAD_T}, max_steps={ITERS}: autodiff_packed_derivs beside "
             f"the in-kernel AD solve, and full DDP by autodiff")
    qgen = autodiff_packed_derivs(qmodel)
    qtiles = autodiff_derivs_tiles(qmodel)
    u0q = torch.full((B, QUAD_T, 2), qspec.u_hover, **f32)

    def qsolve(tiles):
        def solve(x0, u0, gen, trace):
            return ilqg_batch_lanes(qmodel, gen, x0, u0, lims=qspec.lims,
                                    cfg=cfg, derivs_tiles=tiles,
                                    max_steps=ITERS, record_trace=trace)
        return solve

    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    qsolve(qtiles)(qx0s, u0q, None, False)
    s.record()
    ad = qsolve(qtiles)(qx0s, u0q, None, False)
    e.record()
    torch.cuda.synchronize()
    ad_ms, ad_it = s.elapsed_time(e), max(int(ad.n_iters.max()), 1)
    qx0c, qu0c = qx0s[:B_CPU], u0q[:B_CPU, :QUAD_T_CPU].contiguous()
    paths["quad_packed"], _ = fleet(
        "quadrotor packed (autodiff_packed_derivs)", "k1_packed_quad",
        qsolve(None), qx0s, u0q, qx0c, qu0c, gen=qgen, gen_key="quad",
        besides=(ad.cost_total, ad_ms, ad_it))
    rec["k1_packed_quad"]["path"].update(ad_solve_ms=ad_ms, ad_iters=ad_it)
    paths["quad_full_ddp"], _ = fleet(
        "quadrotor full DDP (Autodiff<Quadrotor,SO>)", "k1_quad_so",
        qsolve(qad_so), qx0s, u0q, qx0c, qu0c,
        besides=(ad.cost_total, ad_ms, ad_it))
    del ad

    ph.start("packed-lti-path", f"ilqg_batch_lanes, LTI n={LTI_N} "
             f"m={LTI_M} B={B} T={LTI_T}, ±0.6, max_iter={lcfg.max_iter}, "
             f"to convergence: lti_packed_derivs")
    lgen = lti_packed_derivs(lspec)
    lu0 = lspec.u0.expand(B, LTI_T, LTI_M).contiguous()

    def lsolve(x0, u0, gen, trace):
        return ilqg_batch_lanes(lmodel, gen, x0, u0, lims=LTI_LIMS, cfg=lcfg,
                                record_trace=trace)

    paths["lti_packed"], _ = fleet(
        "LTI packed (lti_packed_derivs)", "k1_packed_lti", lsolve, lx0s, lu0,
        lx0s[:B_CPU], lu0[:B_CPU, :LTI_T_CPU].contiguous(), gen=lgen,
        gen_key="lti")
    del lu0

    ph.start("packed-gps", f"backward_pass_pallas in GPS mode, pendcart "
             f"B={B} T={T}: the batch-major wrapper on Packed<4,1> GPS")
    lay = bk.InLayout(4, 1)
    a = from_streams(dp["pendcart"], (lay.DU,))
    derivs = Derivs(**{f: a[..., lay.offset(f):lay.offset(f) + math.prod(
        lay.shape(f))].reshape((B, T) + lay.shape(f)) for f in DERIV_FIELDS})
    u = a[..., lay.u:]
    tp = GaussianPolicy(
        K=torch.tensor(0.3 * rng.standard_normal((B, T, 1, 4)), **f32),
        k=torch.tensor(0.2 * rng.standard_normal((B, T, 1)), **f32),
        sigma=torch.full((B, T, 1, 1), 0.5, **f32),
        sigma_inv=torch.full((B, T, 1, 1), 2.0, **f32))
    eta_bt = torch.tensor(0.5 + rng.uniform(0, 1, (B, T)), **f32)
    zl = torch.zeros(B, **f32)
    out, launches = counted(counters, lambda: bk.backward_pass_pallas(
        derivs, u, zl, reg_type=1, lims=LIMS, use_limits=True, eta=eta_bt,
        traj_prev=tp))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = bk.backward_pass_pallas(Derivs(**{
        k: v.cpu() for k, v in derivs._asdict().items() if v is not None}),
                                  u.cpu(), zl.cpu(), reg_type=1, lims=LIMS,
                                  use_limits=True, eta=eta_bt.cpu(),
                                  traj_prev=GaussianPolicy(*(v.cpu() for v
                                                             in tp)))
    print(f"  backward_pass_pallas GPS: launches {launches}; CPU plain "
          f"{time.perf_counter() - t0:.1f} s")
    for name in ("k", "K", "sigma_inv"):
        compare_slots(f"backward_pass_pallas GPS {name} against CPU",
                      getattr(out.policy, name).cpu().flatten(2)
                      .permute(1, 2, 0),
                      getattr(ref.policy, name).flatten(2).permute(1, 2, 0),
                      GPS_SLOT_TOL)
    check(torch.equal(out.diverged.cpu(), ref.diverged),
          "backward_pass_pallas GPS: diverged differs from the CPU")
    check(launches["backward_lanes"] == 1, "backward_pass_pallas GPS: "
          f"launches {launches}")
    paths["pallas_gps"] = launches
    del derivs, u, a, out, ref, dp
    print(f"  packed / full DDP group: {time.perf_counter() - t_group:.1f} s "
          f"wall")
    return paths


# the fleet group (phases 33-36): the fleet scheduler against lock-step on
# the repo's fleet configurations (JAX tools/bench_fleet.py) at B=4096, the
# pendcart fleet also at FLEET_B_BIG (16 × the repo's cells: the card holds
# about 132 SMs × 4 blocks × 32 scenarios ≈ 16k lanes at once), and
# lock-step ms per iteration over FLEET_SWEEP_B (FLEET_SWEEP_ITERS
# iterations a solve)
FLEET_B_BIG = 65536
FLEET_SWEEP_B = (4096, 16384, 65536)
FLEET_SWEEP_ITERS = 20
# the pendcart fleet (JAX tools/bench_fleet.py:76-90): x0 = default_x0 +
# 0.4·N(0,1) on angle and cart position, u0 = 0, ±5, max_iter 300
FLEET_PEND_SPREAD, FLEET_ITERS = 0.4, 300


def fleet_schedules(iters: torch.Tensor) -> tuple:
    """JAX's three schedules (tools/bench_fleet.py:126-129): (chunk_iters,
    chunk_growth) from the lock-step median of n_iters."""
    med = int(iters.float().median().item())
    return ((max(med, 1), 8.0), (max(4, med - 2), 4.0), (10, 10.0))


def fleet_run(fn, counters) -> tuple:
    """One warm-up run of ``fn`` with its host syncs, launches, peak memory
    (above what was allocated before it) and, for a fleet with
    ``verbose=True``, the lanes of each chunk; then one timed run (CUDA
    events). Returns (the timed run's result, its numbers)."""
    import contextlib
    import io
    import re
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (out, syncs), launches = counted(counters, lambda: sync_count(fn))
    peak = torch.cuda.max_memory_allocated() - base
    B = out.cost_total.shape[0]
    lanes = [B] + [int(n) for n in re.findall(r"chunk \d+: (\d+)/",
                                              buf.getvalue()) if int(n)]
    del out
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    with contextlib.redirect_stdout(io.StringIO()):
        s.record()
        out = fn()
        e.record()
    torch.cuda.synchronize()
    return out, dict(ms=s.elapsed_time(e), syncs=syncs, launches=launches,
                     peak_bytes=peak, chunks=len(lanes), lanes=lanes)


def once_run(fn, counters) -> tuple:
    """One run of ``fn``, its kernels already warm: (result, dict of its
    ms by CUDA events, host syncs, launches and peak memory above what was
    allocated before it)."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)

    def timed():
        s.record()
        out = fn()
        e.record()
        return out

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (out, syncs), launches = counted(counters, lambda: sync_count(timed))
    return out, dict(ms=s.elapsed_time(e), syncs=syncs, launches=launches,
                     peak_bytes=torch.cuda.max_memory_allocated() - base)


def hist(v: torch.Tensor) -> dict:
    return {int(a): int(b) for a, b in zip(*torch.unique(
        v, return_counts=True))}


def same_as_lockstep(what: str, fl, ref, fields) -> None:
    """The fleet's result against lock-step's, bit for bit in ``fields``
    (names of the result, ``policy.K`` of its policy)."""
    bad = [f for f in fields if not torch.equal(
        fl.policy.K if f == "policy.K" else getattr(fl, f),
        ref.policy.K if f == "policy.K" else getattr(ref, f))]
    print(f"  {what}: bit-equal to lock-step in {', '.join(fields)}: "
          f"{not bad}")
    check(not bad, f"{what}: differs from lock-step in {bad}")


ILQG_FIELDS = ("cost_total", "reason", "n_accepted", "u", "x", "policy.K")
KL_FIELDS = ("cost_total", "u", "x", "policy.K", "eta", "satisfied",
             "divergence", "n_iters")


def fleet_compare(what, fleet_fn, ref, ref_run, schedules, counters,
                  out) -> dict:
    """Each schedule's fleet solve against the lock-step result ``ref``:
    bit-equality, n_iters, chunks, lanes a chunk, ms, host syncs, peak
    memory and launches. Adds one entry a schedule to ``out``; returns the
    first schedule's launches."""
    first = None
    for ci, gr in schedules:
        fl, r = fleet_run(lambda: fleet_fn(ci, gr), counters)
        same_as_lockstep(f"{what} fleet ({ci}, {gr:g})", fl, ref,
                         ILQG_FIELDS)
        check(bool((fl.n_iters >= ref.n_iters).all()),
              f"{what}: a fleet lane ran fewer iterations than lock-step")
        print(f"  {what} fleet ({ci}, {gr:g}): {r['ms']:.3f} ms "
              f"({ref_run['ms'] / r['ms']:.3f}× lock-step's "
              f"{ref_run['ms']:.3f}), {r['chunks']} chunks of lanes "
              f"{r['lanes']}, n_iters equal to lock-step's: "
              f"{torch.equal(fl.n_iters, ref.n_iters)}, {r['syncs']} host "
              f"syncs (lock-step {ref_run['syncs']}), peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB (lock-step "
              f"{ref_run['peak_bytes'] / 2**30:.3f}), launches "
              f"{r['launches']}")
        out[f"fleet_{ci}_{gr:g}"] = {k: v for k, v in r.items()}
        first = first or r["launches"]
        del fl
    return first


def fleet_phases(ph, dev, counters) -> dict:
    """Phases 33-36, the "fleet" group: ``ilqg_fleet`` against lock-step
    ``ilqg_batch_lanes`` on the LTI fleet and on the pendcart fleet (at
    B=4096 and FLEET_B_BIG, JAX's three schedules each, bit for bit), the
    stitched trace, lock-step ms per iteration over FLEET_SWEEP_B;
    ``ilqgkl_fleet`` against ``ilqgkl_batch_lanes`` in both η modes; the
    sharded entries on a one-rank NCCL group against their unsharded calls.
    Returns (the paths' launches, the group's numbers)."""
    import tempfile
    from differentialdynamicprogramming_jl_tpu_torch.models import (
        pendcart as tpc)
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, mean_t, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.parallel import (
        distributed as D, mesh as M)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        BatchTrace, ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.fleet import (
        ilqg_fleet, ilqg_fleet_sharded, ilqgkl_fleet, ilqgkl_fleet_sharded)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)

    paths, out = {}, {}
    ph.start("fleet-lti", f"ilqg_fleet against ilqg_batch_lanes, LTI "
             f"n={LTI_N} m={LTI_M} B={B} T={LTI_T}, ±0.6, to convergence")
    # a reduction over T on the card picks its order from the shape: the
    # same lane's mean over a compacted batch against over the whole fleet
    x = torch.randn((T, B), device=dev)
    for k in (B - 1, 1000, 37):
        print(f"  mean over T={T} of {k} of {B} lanes: torch.mean equal to "
              f"the whole batch's: "
              f"{torch.equal(torch.mean(x[:, :k], 0), torch.mean(x, 0)[:k])}"
              f"; mean_t equal: {torch.equal(mean_t(x[:, :k]), mean_t(x)[:k])}")
        check(torch.equal(mean_t(x[:, :k]), mean_t(x)[:k]),
              "mean_t depends on the batch")
    del x
    spec = random_lti(0, n=LTI_N, m=LTI_M, T=LTI_T, device=dev)
    model, tiles = lti_lanes(spec), lti_derivs_tiles(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=FLEET_ITERS)
    x0s = torch.ones((B, LTI_N), device=dev) * torch.linspace(
        0.5, 2.0, B, device=dev)[:, None]
    u0s = spec.u0.expand(B, LTI_T, LTI_M).contiguous()
    kw = dict(lims=LTI_LIMS, cfg=cfg, derivs_tiles=tiles)
    ref, rr = fleet_run(lambda: ilqg_batch_lanes(model, None, x0s, u0s, **kw),
                        counters)
    print(f"  lock-step: {rr['ms']:.3f} ms, n_iters histogram "
          f"{hist(ref.n_iters)}, reasons {hist(ref.reason)}, {rr['syncs']} "
          f"host syncs, peak {rr['peak_bytes'] / 2**30:.3f} GiB, launches "
          f"{rr['launches']}")
    res = out["lti"] = dict(lockstep=rr, n_iters=hist(ref.n_iters))
    paths["fleet_lti"] = fleet_compare(
        "LTI", lambda ci, gr: ilqg_fleet(
            model, None, x0s, u0s, chunk_iters=ci, chunk_growth=gr,
            verbose=True, **kw),
        ref, rr, fleet_schedules(ref.n_iters), counters, res)
    del ref, spec, model, tiles, x0s, u0s

    ph.start("fleet-pendcart", f"ilqg_fleet against ilqg_batch_lanes, "
             f"pendcart B={B} and {FLEET_B_BIG}, T={T}, ±5, x0 spread "
             f"{FLEET_PEND_SPREAD} on angle and cart, max_iter {FLEET_ITERS}")
    spec = tpc.PendCartSpec()
    model, tiles = tpc.pendcart_lanes(spec), tpc.pendcart_derivs_tiles(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=FLEET_ITERS)
    rng = np.random.default_rng(33)
    x0_np = np.asarray(tpc.default_x0(device="cpu").numpy(), np.float64)[
        None, :] + FLEET_PEND_SPREAD * rng.standard_normal(
            (FLEET_B_BIG, 4)) * np.array([1.0, 1.0, 0, 0])
    x0_all = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    kw = dict(lims=LIMS, cfg=cfg, derivs_tiles=tiles)
    out["pendcart"] = {}
    sweep = {}
    for b in FLEET_SWEEP_B:
        u0 = torch.zeros((b, T, 1), device=dev)
        r, run = fleet_run(lambda: ilqg_batch_lanes(
            model, None, x0_all[:b], u0, max_steps=FLEET_SWEEP_ITERS, **kw),
            counters)
        it = int(r.n_iters.max())
        sweep[b] = dict(ms=run["ms"], iters=it, ms_per_iter=run["ms"] / it,
                        peak_bytes=run["peak_bytes"])
        print(f"  lock-step B={b}, {FLEET_SWEEP_ITERS} iterations: "
              f"{run['ms']:.3f} ms, {run['ms'] / it:.4f} ms/iter over {it}, "
              f"peak {run['peak_bytes'] / 2**30:.3f} GiB")
        del r, u0
    out["pendcart"]["sweep"] = sweep
    for b in (B, FLEET_B_BIG):
        x0s, u0s = x0_all[:b], torch.zeros((b, T, 1), device=dev)
        ref, rr = fleet_run(lambda: ilqg_batch_lanes(
            model, None, x0s, u0s, **kw), counters)
        print(f"  lock-step B={b}: {rr['ms']:.3f} ms, n_iters histogram "
              f"{hist(ref.n_iters)}, reasons {hist(ref.reason)}, "
              f"{rr['syncs']} host syncs, peak "
              f"{rr['peak_bytes'] / 2**30:.3f} GiB, launches "
              f"{rr['launches']}")
        check(bool(torch.isfinite(ref.cost_total).all()),
              f"pendcart fleet B={b}: non-finite lock-step cost")
        res = out["pendcart"][b] = dict(lockstep=rr, n_iters=hist(
            ref.n_iters))
        first = fleet_compare(
            f"pendcart B={b}", lambda ci, gr: ilqg_fleet(
                model, None, x0s, u0s, chunk_iters=ci, chunk_growth=gr,
                verbose=True, **kw),
            ref, rr, fleet_schedules(ref.n_iters), counters, res)
        if b == B:
            # what FLEET_B_BIG's streams should take, from this B's peak
            want = rr["peak_bytes"] * FLEET_B_BIG / B
            have = torch.cuda.get_device_properties(dev).total_memory
            print(f"  B={FLEET_B_BIG} should peak at ≈{want / 2**30:.2f} GiB "
                  f"({FLEET_B_BIG // B} × B={B}'s) of the card's "
                  f"{have / 2**30:.1f}")
            check(want < 0.8 * have, f"B={FLEET_B_BIG} would not fit")
            paths["fleet_pendcart"] = first
            sched = fleet_schedules(ref.n_iters)[0]
            pend_ref, pend_in = ref, (x0s, u0s, sched)
        else:
            paths["fleet_pendcart_big"] = first
            del ref
    # the stitched trace: rows 1..n_iters as lock-step's
    x0s, u0s, (ci, gr) = pend_in
    rt = ilqg_batch_lanes(model, None, x0s, u0s, record_trace=True, **kw)
    ft = ilqg_fleet(model, None, x0s, u0s, chunk_iters=ci, chunk_growth=gr,
                    record_trace=True, **kw)
    cols = torch.arange(cfg.cap(), device=dev)[None, :]
    upto = cols <= rt.n_iters[:, None].long()
    bad = [f for f in BatchTrace._fields if not torch.equal(
        torch.where(upto, getattr(ft.trace, f).nan_to_num(7.0), 0.0),
        torch.where(upto, getattr(rt.trace, f).nan_to_num(7.0), 0.0))]
    print(f"  record_trace ({ci}, {gr:g}): stitched rows 1..n_iters equal "
          f"to lock-step's trace: {not bad}")
    check(not bad, f"stitched trace differs in {bad}")
    del rt, ft, x0_all

    ph.start("fleet-kl", f"ilqgkl_fleet against ilqgkl_batch_lanes, pendcart "
             f"B={B} T={T}, kl_step={KL_STEP}, max_iter={KL_ITERS}, scalar "
             f"and per-step η")
    # the KL path's inputs (kl_phases): x0 = default_x0 + 0.2·N(0,1) on
    # angle and cart, u0 = 0.2·N(0,1) from seed 1, pre-rolled by K3
    rng = np.random.default_rng(1)
    x0_np = np.asarray(tpc.default_x0(device="cpu").numpy(),
                       np.float64)[None, :] + (
        0.2 * rng.standard_normal((B, 4)) * np.array([1.0, 1.0, 0, 0]))
    u0 = torch.tensor(0.2 * rng.standard_normal((B, T, 1)),
                      dtype=torch.float32, device=dev)
    pre = fk.forward_lanes(
        torch.zeros((T, 5, B), device=dev),
        torch.cat([to_streams(u0), torch.zeros((T, 4, B), device=dev)], 1),
        torch.tensor(x0_np.T.copy(), dtype=torch.float32, device=dev),
        torch.ones((1, B), device=dev), model=model, lims=None,
        emit_traj=True)
    x_pre = from_streams(pre.traj[:, :4], (4,)).contiguous()
    u_pre = from_streams(pre.traj[:, 4:5], (1,)).contiguous()
    cost0 = pre.totals[0]
    fx = tpc.make_pendcart_problem(spec, derivs="euler", device=dev).derivs(
        x_pre, u_pre).fx.contiguous()
    policy0 = GaussianPolicy(
        K=torch.zeros((B, T, 1, 4), device=dev), k=u_pre,
        sigma=torch.ones((B, T, 1, 1), device=dev),
        sigma_inv=torch.ones((B, T, 1, 1), device=dev))
    kl_args = (model, tiles, x_pre, policy0, fx, cost0)
    out["kl"] = {}
    for mode, per_step in (("scalar", False), ("per-step", True)):
        kcfg = ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS,
                            constrain_per_step=per_step)
        ref, rr = fleet_run(lambda: ilqgkl_batch_lanes(*kl_args, cfg=kcfg),
                            counters)
        fl, r = fleet_run(lambda: ilqgkl_fleet(*kl_args, cfg=kcfg,
                                               verbose=True), counters)
        same_as_lockstep(f"KL {mode} η fleet (4, 4)", fl, ref, KL_FIELDS)
        print(f"  KL {mode} η: lock-step {rr['ms']:.3f} ms (n_iters "
              f"{hist(ref.n_iters)}, satisfied "
              f"{ref.satisfied.float().mean().item():.4f}), fleet "
              f"{r['ms']:.3f} ms ({rr['ms'] / r['ms']:.3f}× lock-step's), "
              f"{r['chunks']} chunks of lanes {r['lanes']}, host syncs "
              f"{r['syncs']} against {rr['syncs']}, launches {r['launches']}")
        out["kl"][mode] = dict(lockstep=rr, fleet=r,
                               n_iters=hist(ref.n_iters))
        paths["fleet_kl" if not per_step else "fleet_kl_step"] = \
            r["launches"]
        if not per_step:
            kl_ref, kl_fl, kl_cfg = ref, fl, kcfg
        del ref, fl

    ph.start("sharded", "the sharded entries on a one-rank NCCL group "
             "against their unsharded calls")
    with tempfile.TemporaryDirectory() as tmp:
        D.init_distributed(f"file://{tmp}/store", num_processes=1,
                           process_id=0, local_device_ids=[dev.index or 0])
        try:
            mesh = D.global_mesh()
            print(f"  mesh: {mesh.devices}, rank {mesh.rank} of "
                  f"{mesh.world_size}, backend "
                  f"{torch.distributed.get_backend()}")
            x0s, u0s, (ci, gr) = pend_in

            def stats_equal(what, st, want):
                same = torch.equal(st.cpu(), torch.stack(want).cpu())
                print(f"  {what}: stats {st.tolist()} equal to the local "
                      f"sums: {same}")
                check(same, f"{what}: stats differ from the local sums")

            def solved(r):
                return ((r.reason == 1) | (r.reason == 2)).sum().float()

            (res, st), launches = counted(counters, lambda: (
                M.ilqg_batch_sharded(model, None, x0s, u0s, mesh=mesh,
                                     reduce_stats=True, **kw)))
            paths["sharded_pendcart"] = launches
            same_as_lockstep("ilqg_batch_sharded", res, pend_ref,
                             ILQG_FIELDS + ("n_iters",))
            stats_equal("ilqg_batch_sharded", st, [
                pend_ref.cost_total.sum(), pend_ref.n_iters.sum().float(),
                solved(pend_ref)])
            fl = ilqg_fleet(model, None, x0s, u0s, chunk_iters=ci,
                            chunk_growth=gr, **kw)
            res = ilqg_fleet_sharded(model, None, x0s, u0s, chunk_iters=ci,
                                     chunk_growth=gr, mesh=mesh, **kw)
            same_as_lockstep("ilqg_fleet_sharded (against ilqg_fleet)", res,
                             fl, ILQG_FIELDS + ("n_iters",))
            (res, st), launches = counted(counters, lambda: (
                M.ilqgkl_batch_sharded(*kl_args, cfg=kl_cfg, mesh=mesh,
                                       reduce_stats=True)))
            paths["sharded_kl"] = launches
            same_as_lockstep("ilqgkl_batch_sharded", res, kl_ref, KL_FIELDS)
            stats_equal("ilqgkl_batch_sharded", st, [
                kl_ref.cost_total.sum(), kl_ref.n_iters.sum().float(),
                kl_ref.satisfied.sum().float()])
            res = ilqgkl_fleet_sharded(*kl_args, cfg=kl_cfg, mesh=mesh)
            same_as_lockstep("ilqgkl_fleet_sharded (against ilqgkl_fleet)",
                             res, kl_fl, KL_FIELDS)
            # the generic tier: generic-batched's inputs, f64, 3 iterations
            f64 = torch.float64
            rng = np.random.default_rng(28)
            gx = np.tile(np.asarray(tpc.default_x0(f64, device="cpu")),
                         (GEN_B, 1))
            gx[:, 0] += 0.2 * rng.standard_normal(GEN_B)
            gx = torch.tensor(gx, dtype=f64, device=dev)
            gu = torch.zeros((GEN_B, GEN_T, 1), dtype=f64, device=dev)
            prob = tpc.make_pendcart_problem(spec, derivs="zoh", dtype=f64,
                                             device=dev)
            gcfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6),
                              reg_type=2, lam_max=1e15, tol_fun=1e-8,
                              tol_grad=1e-8, max_iter=3)
            glims = torch.tensor([[-10.0, 10.0]], dtype=f64, device=dev)
            gref = M.ilqg_batched(prob, gx, gu, lims=glims, cfg=gcfg)
            res, st = M.ilqg_sharded(prob, gx, gu, lims=glims, cfg=gcfg,
                                     mesh=mesh, reduce_stats=True)
            bad = [f for f in ("x", "u", "cost", "n_iters", "reason")
                   if not torch.equal(getattr(res, f), getattr(gref, f))]
            print(f"  ilqg_sharded: equal to ilqg_batched in x, u, cost, "
                  f"n_iters, reason: {not bad}")
            check(not bad, f"ilqg_sharded differs from ilqg_batched in {bad}")
            stats_equal("ilqg_sharded", st, [
                gref.cost.sum(-1).sum(), gref.n_iters.sum().to(f64),
                solved(gref).to(f64)])
        finally:
            torch.distributed.destroy_process_group()
    return paths, out


def m3_fleet(device):
    """The m3 group's LTI fleet: random_lti's spec at n=10, m=3 from seed
    0, x0 = 1·linspace(0.5, 2) over the B scenarios (made on the host, so
    that the CPU child draws the same lanes), and the LTI path's
    ILQGConfig (6-α ladder, reg_type 2, λ_max 1e15, max_iter 300)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)
    spec = random_lti(0, n=LTI_N, m=M3_M, T=LTI_T, device=device)
    x0s = torch.ones((B, LTI_N)) * torch.linspace(0.5, 2.0, B)[:, None]
    return spec, x0s.to(device), ILQGConfig(
        alphas=default_alphas(0.2, -3.0, 6), reg_type=2, lam_max=1e15,
        max_iter=300)


def m3_kl_inputs(spec, x0s, Tk: int):
    """The KL tier's inputs on the m=3 fleet at horizon Tk: the pre-roll
    by K3 at α=1 with k := u0 and no limits (JAX demos.py:50-55), the zero
    previous policy with k = its controls and unit Σ, fx_model =
    SimpleLTVModel.from_lti(A, B, Tk).fx for every scenario, and cost0.
    On CPU tensors K3 is its plain version."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        SimpleLTVModel, lti_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    n, m, Bk, dev = LTI_N, M3_M, x0s.shape[0], x0s.device
    u0s = spec.u0[:Tk].expand(Bk, Tk, m).contiguous()
    gains = torch.cat([to_streams(u0s),
                       torch.zeros((Tk, m * n, Bk), device=dev)], dim=1)
    ro = fk.forward_lanes(torch.zeros((Tk, n + m + 1, Bk), device=dev),
                          gains, x0s.T.contiguous(),
                          torch.ones((1, Bk), device=dev),
                          model=lti_lanes(spec), lims=None, emit_traj=True)
    eye = torch.eye(m, device=dev).expand(Bk, Tk, m, m)
    policy0 = GaussianPolicy(
        K=torch.zeros((Bk, Tk, m, n), device=dev),
        k=from_streams(ro.traj[:, n:n + m], (m,)).contiguous(), sigma=eye,
        sigma_inv=eye)
    fx = SimpleLTVModel.from_lti(spec.A, spec.B, Tk).fx.expand(Bk, Tk, n, n)
    return (from_streams(ro.traj[:, :n], (n,)).contiguous(), policy0, fx,
            ro.totals[0]), ro.traj


def m3_solves(device, Bk: int, Tk: int):
    """The m3 group's iLQG (±0.6) and KL (kl_step 100, scalar η, no
    limits) solves on the first Bk scenarios at horizon Tk, on ``device``;
    returns their outcomes as lists."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    spec, x0s, cfg = m3_fleet(device)
    model, tiles = lti_lanes(spec), lti_derivs_tiles(spec)
    x0s = x0s[:Bk]
    r = ilqg_batch_lanes(model, None, x0s,
                         spec.u0[:Tk].expand(Bk, Tk, M3_M).contiguous(),
                         lims=M3_LIMS, cfg=cfg, derivs_tiles=tiles)
    kl_in, _ = m3_kl_inputs(spec, x0s, Tk)
    k = ilqgkl_batch_lanes(model, tiles, *kl_in,
                           cfg=ILQGKLConfig(kl_step=KL_LTI_STEP))
    return dict(cost_total=r.cost_total.tolist(), reason=r.reason.tolist(),
                n_accepted=r.n_accepted.tolist(),
                kl_cost_total=k.cost_total.tolist(),
                satisfied=k.satisfied.tolist(), n_iters=k.n_iters.tolist(),
                eta=k.eta.tolist())


def m3_cpu_solves() -> dict:
    """:func:`m3_solves` with the plain versions on the host (B_CPU lanes,
    T=LTI_T_CPU): ``chip_smoke.py --m3-cpu``, run by ``main`` in a child
    process from the build on, on two of the host's threads."""
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    out = m3_solves("cpu", B_CPU, LTI_T_CPU)
    out["seconds"] = time.perf_counter() - t0
    return out


def start_cpu_child(flag: str) -> subprocess.Popen:
    """This script with ``flag`` in a child process that sees no card, at a
    lower priority than this process (``nice``), whose phases need the
    host as they go: the children have until their group's phases."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(["nice", "-n", str(BACKGROUND_NICE),
                             sys.executable, os.path.abspath(__file__),
                             flag], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


# the parsed output of each CPU child, by process id
_CHILD_OUT: dict = {}


def child_solves(proc: subprocess.Popen) -> dict:
    """A CPU child's solves (start_cpu_child), waited for once."""
    if proc.pid not in _CHILD_OUT:
        out, err_ = proc.communicate(timeout=900)
        check(proc.returncode == 0, "a CPU solves' child process failed "
              f"({proc.returncode}): {err_[-2000:]}")
        _CHILD_OUT[proc.pid] = json.loads(out)
    return _CHILD_OUT[proc.pid]


def k_vs_plain(what: str, pairs, tol=KERNEL_TOL) -> float:
    """A ⟨10,3⟩ kernel's outputs against its plain version's, ``pairs``
    {output: (kernel's, plain's)}: bit for bit where they are, else within
    ``tol`` of each output's scale, with the share of differing elements
    printed. Returns the max abs error."""
    worst = 0.0
    for name, (a, pb) in pairs.items():
        same = bool(torch.equal(a, pb))
        mx, rel = err(a, pb)
        share = (a != pb).float().mean().item()
        print(f"  {what} {name}: bit-identical {same}; max_abs_err "
              f"{mx:.3e}, rel {rel:.3e} (tol {tol:.0e}), differing share "
              f"{share:.3e}")
        check(same or rel <= tol, f"{what} {name}: rel error {rel:.3e}")
        worst = max(worst, mx)
    return worst


def k1_emitted(full: torch.Tensor, n: int, m: int,
               emit: str) -> torch.Tensor:
    """The slots of K1's emission ``emit`` taken from a "full" output
    (T, S, B): k and K, then Vx and Vxx, then Quu and Quu⁻¹, each block
    where ``emit`` has it."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
        import OutLayout
    f, e = OutLayout(n, m, "full"), OutLayout(n, m, emit)
    blocks = ((0, f.Vx, True), (f.Vx, f.quu, e.Vx is not None),
              (f.quu, f.S, e.quu is not None))
    return torch.cat([full[:, a:b] for a, b, keep in blocks if keep], dim=1)


def m3_phases(ph, dev, rec, counters, cpu_proc) -> dict:
    """Phases 37-41, the m3 group: the LTI fleet with a third control. K3,
    K1 ⟨10,3⟩ (the masked box QP and the 3×3 Cholesky) and K2 against
    their plain versions; the converged lock-step solve and ``ilqg_fleet``;
    K1 in GPS mode and the KL solve; the GPU against the CPU child's solves
    (``cpu_proc``). Adds the measurements to ``rec``; returns the launches
    of its paths."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.fleet import (
        ilqg_fleet)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)

    t_group = time.perf_counter()
    n, m, Tl, Tc = LTI_N, M3_M, LTI_T, M3_T_CHECK
    ph.start("m3-kernels", f"LTI n={n} m={m} B={B}, ±0.6: K3, K1 (masked "
             f"box QP, {M3_QP_ITERS} iterations; 3×3 Cholesky) and K2 "
             f"against their plain versions at T={Tc}, timed at T={Tl}")
    for line in rec["ptxas"]:
        if f"LTI<{n},{m}>" in line:
            print("  " + with_plan(line))
    spec, x0s, cfg = m3_fleet(dev)
    model, tiles = lti_lanes(spec), lti_derivs_tiles(spec)
    A = len(cfg.alphas)
    x0_l = x0s.T.contiguous()
    u0s = spec.u0.expand(B, Tl, m).contiguous()
    rng = np.random.default_rng(31)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=torch.float32,
                       device=dev)
    lam[::8] = 0.0
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    ladder = ladder.contiguous()
    al1 = torch.tensor(rng.uniform(0.0, 1.0, (1, B)), dtype=torch.float32,
                       device=dev)
    # random controls for the checks (the box binds), u0 for the timings
    u_rand = torch.tensor(2.0 * rng.standard_normal((B, Tc, m)),
                          dtype=torch.float32, device=dev)
    streams = {t: (torch.zeros((t, n + m, B), device=dev), torch.cat(
        [to_streams(u), torch.zeros((t, m * n, B), device=dev)], dim=1))
        for t, u in ((Tc, u_rand), (Tl, u0s))}

    def fwd(t, al, emit, plain, lims=M3_LIMS):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(*streams[t], x0_l, al, model=model, lims=lims,
                 emit_traj=emit)

    k, p = fwd(Tc, ladder, False, False), fwd(Tc, ladder, False, True)
    e3 = k_vs_plain("K3 sweep A=6", {"totals": (k.totals, p.totals)})
    k, p = fwd(Tc, al1, True, False), fwd(Tc, al1, True, True)
    e3 = max(e3, k_vs_plain("K3 rollout A=1", {
        "totals": (k.totals, p.totals), "traj": (k.traj, p.traj)}))
    print_k3_plans("LTI <10,3>", n, m, Tl)
    traj, tot = k.traj, k.totals[0]
    # u0's rollout cost, against which the solve must improve
    c0 = fwd(Tl, torch.ones((1, B), device=dev), False, False).totals[0]

    def bwd(emit, lims, plain, tr=traj, tl=tiles, lm=lam):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lm, n=n, m=m, reg_type=2, lims=lims, derivs_tiles=tl,
                 emit=emit, qp_iters=M3_QP_ITERS)

    errs = []
    for lims in (M3_LIMS, None):
        for emit in ("gains", "full"):
            what = f"K1 <10,3> {emit} {'±0.6' if lims else 'unconstrained'}"
            k, p = bwd(emit, lims, False), bwd(emit, lims, True)
            lay = bk.OutLayout(n, m, emit)
            q = lay.quui if emit == "full" else lay.S
            errs.append(k_vs_plain(what, {
                "out": (k.out[:, :q], p.out[:, :q]),
                "dV": (k.stats[:2], p.stats[:2])}))
            if emit == "full":
                errs.append(k_vs_plain(what, {
                    "Quu_inv": (k.out[:, q:], p.out[:, q:])}, QUU_INV_TOL))
            check(torch.equal(k.stats[2:], p.stats[2:]),
                  f"{what}: diverged/diverge_idx differ")
            print(f"  {what}: latch equal, {int((k.stats[2] > 0.5).sum())} "
                  f"latched lanes in both")
            if lims is not None and emit == "gains":
                gains, dV = k.out, k.stats[:2]
                kk, u = k.out[:-1, :m], traj[:-1, n:n + m]
                on = (kk == -0.6 - u) | (kk == 0.6 - u)
                shares = [on[:, i].float().mean().item() for i in range(m)]
                print(f"  K1 <10,3> limits bind on a share of the steps: "
                      f"{', '.join(f'{v:.4f}' for v in shares)}; all three "
                      f"{on.all(dim=1).float().mean().item():.4f}")
                check(min(shares) > 0, "K1 <10,3>: a control's limit never "
                      "binds, so the box QP was not exercised")
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([dV[0], dV[1], tot, allow])

    def ls(plain, tr=traj, g=gains, s_=sel, in_place=False):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        kw = dict(in_place=True) if in_place else {}
        return f(tr, g, x0_l, s_, model=model, alphas=cfg.alphas,
                 reduce_ratio_min=0.0, lims=M3_LIMS, **kw)

    k, p = ls(False), ls(True)
    e2 = k_vs_plain("K2 A=6", {"traj": (k.traj, p.traj),
                               "ls": (k.ls, p.ls)})
    check(torch.equal(k.ls[:2], p.ls[:2]), "K2 <10,3>: al_sel/any_ok differ")
    buf = traj.clone()
    inp = fk.linesearch_lanes(buf, gains, buf[0, :n], sel, model=model,
                              alphas=cfg.alphas, lims=M3_LIMS, in_place=True)
    check(inp.traj.data_ptr() == buf.data_ptr() and torch.equal(buf, k.traj)
          and torch.equal(inp.ls, k.ls), "K2 <10,3> in place differs from "
          "K2 fresh")
    print(f"  K2 <10,3> in place: bit-equal to fresh; "
          f"{int(((k.ls[1] > 0.5) & (allow > 0.5)).sum())} of {B} lanes "
          f"accept")

    # times at the fleet's T (the sweep's and rollout's streams of u0, K1
    # and K2 on its rollout), the plain versions once at Tc
    ms3 = cuda_ms(lambda: fwd(Tl, ladder, False, False), 10)
    ms3r = cuda_ms(lambda: fwd(Tl, al1, True, False), 10)
    plain3 = once_ms(lambda: fwd(Tc, ladder, False, True))
    ro = fwd(Tl, al1, True, False)
    traj_T = ro.traj
    ms1 = cuda_ms(lambda: bwd("gains", M3_LIMS, False, tr=traj_T), 5)
    ms1f = cuda_ms(lambda: bwd("full", M3_LIMS, False, tr=traj_T), 5)
    ms1u = cuda_ms(lambda: bwd("gains", None, False, tr=traj_T), 5)
    plain1 = once_ms(lambda: bwd("gains", M3_LIMS, True))
    bo = bwd("gains", M3_LIMS, False, tr=traj_T)
    sel_T = torch.stack([bo.stats[0], bo.stats[1], ro.totals[0], allow])
    ms2 = cuda_ms(lambda: ls(False, traj_T, bo.out, sel_T), 10)
    plain2 = once_ms(lambda: ls(True))
    w3 = k3_work(model, Tl, B, A, False)
    w3r = k3_work(model, Tl, B, 1, True)
    w1 = k1_work(model, Tl, B, "gains", 2, M3_LIMS)
    w1f = k1_work(model, Tl, B, "full", 2, M3_LIMS)
    w1u = k1_work(model, Tl, B, "gains", 2, None)
    w2 = k2_work(model, Tl, B, A)
    for what, ms, w in (("K3 sweep A=6", ms3, w3), ("K3 rollout A=1", ms3r,
                                                     w3r),
                        ("K1 gains ±0.6", ms1, w1), ("K1 full ±0.6", ms1f,
                                                     w1f),
                        ("K1 gains unconstrained", ms1u, w1u),
                        ("K2 A=6", ms2, w2)):
        print(f"  <10,3> {what} at T={Tl}: kernel {ms:.4f} ms, bound "
              f"{w['bound_ms']:.4f} ms ({w['bound_by']}: "
              f"{w['bound_bytes'] / 1e6:.1f} MB, "
              f"{w['bound_flops'] / 1e9:.3f} GFLOP)")
    print(f"  <10,3> plain versions once at T={Tc}: K3 sweep {plain3:.1f} ms, "
          f"K1 gains ±0.6 {plain1:.1f} ms, K2 {plain2:.1f} ms")
    rec["k3_lti3"] = dict(ms=ms3, ms_rollout=ms3r, plain_ms=plain3,
                          plain_T=Tc, max_abs_err=e3, library_ms=None,
                          bound_ms_rollout=w3r["bound_ms"], **w3)
    rec["k1_lti3"] = dict(ms=ms1, ms_full=ms1f, bound_ms_full=w1f["bound_ms"],
                          ms_unconstrained=ms1u,
                          bound_ms_unconstrained=w1u["bound_ms"],
                          plain_ms=plain1, plain_T=Tc, max_abs_err=max(errs),
                          library_ms=None, **w1)
    rec["k2_lti3"] = dict(ms=ms2, plain_ms=plain2, plain_T=Tc, max_abs_err=e2,
                          library_ms=None, **w2)
    del streams, traj, traj_T, ro, bo, gains, k, p, buf, inp

    ph.start("m3-path", f"ilqg_batch_lanes, LTI n={n} m={m} B={B} T={Tl}, "
             f"{A}-α ladder, reg_type 2, ±0.6, a budget of {M3_PATH_ITERS} "
             f"iterations (max_steps), once (its kernels warmed by "
             f"m3-kernels)")
    kw = dict(lims=M3_LIMS, cfg=cfg, derivs_tiles=tiles)
    ref, rr = once_run(lambda: ilqg_batch_lanes(
        model, None, x0s, u0s, max_steps=M3_PATH_ITERS, **kw), counters)
    launches = rr["launches"]
    iters = int(ref.n_iters.max())
    u = ref.u
    at = (u.abs() == 0.6)
    clamp = at.any(dim=2).float().mean().item()
    k1 = launches["backward_lanes"]
    print(f"  launches: {launches}")
    print(f"  solve: {rr['ms']:.3f} ms (CUDA events); n_iters min/median/max "
          f"{int(ref.n_iters.min())} / {int(ref.n_iters.float().median())} / "
          f"{iters}; reasons {hist(ref.reason)}; "
          f"{rr['ms'] / max(iters, 1):.4f} ms/iter; K1 {k1} launches, "
          f"{(k1 - 1) / max(iters, 1):.3f} an iteration ({k1 - 1 - iters} "
          f"λ-retries of the fleet); final λ "
          f"median {ref.lam.median().item():.3g}, max "
          f"{ref.lam.max().item():.3g}")
    bins = hist(torch.div(ref.n_iters, 20, rounding_mode="floor") * 20)
    print(f"  n_iters histogram (bins of 20): {bins}")
    per = at.float().mean(dim=(0, 1)).tolist()
    print(f"  share of steps with a clamp active: {clamp:.4f} (per control "
          f"{', '.join(f'{v:.4f}' for v in per)}); max |u| "
          f"{u.abs().max().item():.6g}; {rr['syncs']} host syncs, peak "
          f"{rr['peak_bytes'] / 2**30:.3f} GiB")
    ct = ref.cost_total
    print(f"  cost_total min/median/max {ct.min().item():.6g} / "
          f"{ct.median().item():.6g} / {ct.max().item():.6g} (u0's rollout "
          f"median {c0.median().item():.6g})")
    check(all(rr["launches"][c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the m=3 path never ran: {rr['launches']}")
    check(1 <= iters <= cfg.cap(), f"m=3 n_iters {iters}")
    check(bool(torch.isfinite(ct).all() and torch.isfinite(ref.x).all()
               and torch.isfinite(ref.u).all()), "m=3: non-finite results")
    check(ref.x.shape == (B, Tl, n) and u.shape == (B, Tl, m)
          and ref.policy.K.shape == (B, Tl, m, n), "m=3 result shapes")
    check(bool((u.abs() <= 0.6).all()), "m=3: a control outside ±0.6")
    check(clamp > 0, "m=3: no clamp active at the solution")
    check(ct.median() < c0.median(), "m=3: median cost did not improve")
    paths = {"m3_lti": rr["launches"]}
    m3 = dict(lockstep=rr, n_iters_bins_of_20=bins, clamp_share=clamp)

    del ref, u
    Tf = M3_T_FLEET
    ph.start("m3-fleet", f"ilqg_fleet against lock-step on the m=3 fleet "
             f"cut to T={Tf}, JAX's first schedule")
    u0f = u0s[:, :Tf].contiguous()
    ref, rf = once_run(lambda: ilqg_batch_lanes(model, None, x0s, u0f, **kw),
                       counters)
    ci, gr = fleet_schedules(ref.n_iters)[0]
    fl, ff = once_run(lambda: ilqg_fleet(model, None, x0s, u0f,
                                         chunk_iters=ci, chunk_growth=gr,
                                         **kw), counters)
    same_as_lockstep(f"m=3 LTI T={Tf} fleet ({ci}, {gr:g})", fl, ref,
                     ILQG_FIELDS)
    check(torch.equal(fl.n_iters, ref.n_iters),
          "m=3 fleet: n_iters differ from lock-step's")
    print(f"  T={Tf}: lock-step {rf['ms']:.3f} ms, the fleet ({ci}, {gr:g}) "
          f"{ff['ms']:.3f} ms ({rf['ms'] / ff['ms']:.3f}× lock-step); "
          f"n_iters min/median/max {int(ref.n_iters.min())} / "
          f"{int(ref.n_iters.float().median())} / {int(ref.n_iters.max())}, "
          f"reasons {hist(ref.reason)}; launches {rf['launches']} against "
          f"{ff['launches']}; host syncs {rf['syncs']} against {ff['syncs']}")
    m3["fleet"] = dict(T=Tf, lockstep=rf, fleet=ff, schedule=(ci, gr))
    paths["m3_fleet"] = ff["launches"]
    del ref, fl

    kcfg = ILQGKLConfig(kl_step=KL_LTI_STEP)
    ph.start("m3-kl", f"K1 GPS policy <10,3> against its plain version at "
             f"T={Tc}; ilqgkl_batch_lanes on the m=3 fleet, B={B} T={Tl}, "
             f"kl_step={KL_LTI_STEP}, scalar η, no limits")
    kl_in, traj_pre = m3_kl_inputs(spec, x0s, Tl)
    a = rng.standard_normal((Tc, B, m, m))
    si = np.einsum("tbij,tbkj->tbik", a, a) + 0.5 * np.eye(m)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((Tc, m, B)),
        0.5 * rng.standard_normal((Tc, m * n, B)),
        np.moveaxis(si.reshape(Tc, B, m * m), 1, 2)], axis=1),
        dtype=torch.float32, device=dev)
    eta = torch.tensor(10.0 ** rng.uniform(-1, 1, (Tc, B)),
                       dtype=torch.float32, device=dev)
    lam0 = torch.zeros(B, device=dev)
    lay = bk.OutLayout(n, m, "policy")

    def gps_bwd(tr, pv, et, plain):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam0, n=n, m=m, reg_type=1, lims=None,
                 derivs_tiles=tiles, prev=pv, eta=et, emit="policy")

    tr_c = traj_pre[:Tc].contiguous()
    k, p = gps_bwd(tr_c, prev, eta, False), gps_bwd(tr_c, prev, eta, True)
    eg = k_vs_plain("K1 <10,3> GPS policy", {
        "k, K, Quu": (k.out[:, :lay.quui], p.out[:, :lay.quui]),
        "dV": (k.stats[:2], p.stats[:2])})
    eg = max(eg, k_vs_plain("K1 <10,3> GPS policy", {
        "Quu_inv": (k.out[:, lay.quui:], p.out[:, lay.quui:])}, QUU_INV_TOL))
    check(torch.equal(k.stats[2:], p.stats[2:]),
          "K1 <10,3> GPS: diverged/diverge_idx differ")
    plain_g = once_ms(lambda: gps_bwd(tr_c, prev, eta, True))
    prev_path = torch.cat([torch.zeros((Tl, m + m * n, B), device=dev),
                           to_streams(torch.eye(m, device=dev).expand(
                               B, Tl, m, m))], dim=1)
    eta1 = torch.ones((Tl, B), device=dev)
    msg = cuda_ms(lambda: gps_bwd(traj_pre, prev_path, eta1, False), 5)
    wg = k1_work(model, Tl, B, "policy", 1, None, gps=True)
    print(f"  K1 <10,3> GPS policy at T={Tl}: kernel {msg:.4f} ms, bound "
          f"{wg['bound_ms']:.4f} ms ({wg['bound_by']}); plain once at "
          f"T={Tc}: {plain_g:.1f} ms")
    rec["k1_lti3_gps"] = dict(ms=msg, plain_ms=plain_g, plain_T=Tc,
                              max_abs_err=eg, library_ms=None, **wg)
    del prev, eta, prev_path, eta1, tr_c, k, p

    def kl_solve():
        return ilqgkl_batch_lanes(model, tiles, *kl_in, cfg=kcfg)

    kl_solve()                                   # warm-up
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)

    def timed():
        s.record()
        out = kl_solve()
        e.record()
        return out

    torch.cuda.reset_peak_memory_stats()
    r, launches = counted(counters, timed)
    kl_ms = s.elapsed_time(e)
    kiters = int(r.n_iters.max())
    cost0 = kl_in[3]
    print(f"  launches: {launches}")
    print(f"  KL solve: {kl_ms:.3f} ms (CUDA events), max n_iters {kiters}, "
          f"{kl_ms / max(kiters, 1):.4f} ms/iter; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  shares: satisfied {r.satisfied.float().mean().item():.4f}, "
          f"pd_failed {r.pd_failed.float().mean().item():.4f}; median η "
          f"{r.eta.median().item():.6g}, median divergence "
          f"{r.divergence.median().item():.6g}; cost_total median "
          f"{r.cost_total.median().item():.6g} against cost0 median "
          f"{cost0.median().item():.6g}")
    check(all(launches[c.__name__] > 0 for c in
              (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes)),
          f"a kernel of the m=3 KL path never ran: {launches}")
    ok = ~r.pd_failed
    check(bool(ok.any()), "m=3 KL: every lane pd_failed")
    check(bool(torch.isfinite(r.cost_total[ok]).all()
               and torch.isfinite(r.policy.K[ok]).all()),
          "m=3 KL: non-finite results")
    check(r.cost_total[ok].median() < cost0[ok].median(),
          "m=3 KL: median cost did not improve")
    paths["m3_kl"] = launches
    m3["kl"] = dict(ms=kl_ms, iters=kiters,
                    satisfied=r.satisfied.float().mean().item(),
                    pd_failed=r.pd_failed.float().mean().item(),
                    eta_median=r.eta.median().item())
    del r, kl_in, traj_pre

    ph.start("m3-gpu-vs-cpu", f"first {B_CPU} scenarios, T={LTI_T_CPU}: the "
             f"iLQG and KL solves on the card against the CPU child's")
    g = m3_solves(dev, B_CPU, LTI_T_CPU)
    out, err_ = cpu_proc.communicate(timeout=900)
    check(cpu_proc.returncode == 0, "the m=3 CPU child failed "
          f"({cpu_proc.returncode}): {err_[-2000:]}")
    c = json.loads(out)
    print(f"  CPU solves (plain versions, child process): "
          f"{c['seconds']:.1f} s")
    for what, cost, same in (("iLQG", "cost_total", ("reason", "n_accepted")),
                             ("KL", "kl_cost_total", ("satisfied",
                                                      "n_iters"))):
        gc, cc = torch.tensor(g[cost]), torch.tensor(c[cost])
        rel = (gc - cc).abs() / cc.abs()
        close = (rel <= COST_RTOL).float().mean().item()
        shares = [np.mean(np.asarray(g[f]) == np.asarray(c[f]))
                  for f in same]
        print(f"  {what}: cost rel diff max {rel.max().item():.3e}, median "
              f"{rel.median().item():.3e}; shares: cost within "
              f"{COST_RTOL:.0e} {close:.3f}, "
              + ", ".join(f"same {f} {v:.3f}" for f, v in zip(same, shares))
              + f" (need {AGREE_SHARE} each)")
        check(min([close] + shares) >= AGREE_SHARE,
              f"m=3 {what}: GPU and CPU outcomes differ")
    wall = time.perf_counter() - t_group
    print(f"  m3 group: {wall:.1f} s wall")
    m3["wall_s"] = wall
    rec["m3"] = m3
    return paths


# ---------------------------------------------------------------------------
# the lowered group (phases 42-47): models written only in Python, lowered
# into libraries of their own (ops/hopper/lower.py, csrc/lowered.cuh)
# ---------------------------------------------------------------------------

# each lowered model's instance groups (_build.LOWERED_GROUPS) the group
# launches: the quadrotor every K1 emission, GPS mode and second order,
# K2 and K3; PendCartParam K1 (autodiff, params), K2, K3; LTI <10,2> K1
# (Autodiff<Lowered>); the quadrotor with an angle-wrapping diff, K2 and
# K3 (its K1 is the quadrotor's: K1's struct has no diff)
LOWERED_GROUPS = {"quad": ("fwd", "k1", "k1_gps", "k1_so"),
                  "param": ("fwd", "k1"), "lti": ("k1",),
                  "quad_diff": ("fwd",)}
# the lanes the lowered LTI's K1 is held to its plain version on
LOWERED_LTI_LANES = 512
# the lowered group's CPU solves (child process): the heterogeneous
# headline at a short horizon, KL on the quadrotor at QUAD_T_CPU
LOWERED_T_CPU = 24
# the quadrotor KL path's control noise about hover (its pre-roll), a
# numpy seed of its own
QUAD_KL_SEED, QUAD_KL_NOISE = 31, 0.3
# the heterogeneous headline with autodiff tiles: its per-scenario [l, d]
HETERO_AD_SEED = 32
# the JAX package's quadrotor outcomes on 64 lanes (make_quad_outcomes.py)
# and the iterations whose costs quad-jax holds to JAX's: at T=400 the
# fleet's f32 rounding decides the later ones. By
# tools_torch/quad_jax_diagnose.py (the same 64 lanes, 20 iterations, on
# an H100), the port on the card parts from the port on the host as it
# parts from JAX: from iteration 3 on some lanes take another line-search
# step (1.6% against the host, 6.2% against JAX), and by iteration 20
# 39.1% of the lanes are still on the host's path and 26.6% on JAX's, their
# costs within COST_RTOL on as many. Through iteration 2 every lane is on
# JAX's path on both devices, and the costs agree within COST_RTOL on
# 96.9% of the lanes against JAX (two lanes 2.8e-3 apart from iteration 1
# on: the m=2 box QP's near-ties, k ~sqrt(ulp) apart, over 400 steps)
QUAD_OUTCOMES = "tools_torch/quad_outcomes.npz"
QUAD_JAX_ITERS = 2
# the end state of those 64 lanes, which rounding moves less than each
# lane's path: the quartiles and the mean of the final costs against JAX's.
# By the same tool, the card's and the host's port part by at most 0.115
# in a quartile (at iteration 15; 0.102 at 20) and 0.039 in the mean (at
# 20); each bound is about twice that. JAX's own mean falls 2.9% in its
# last iteration and 8.9% in its last three, its median 15.5% in its last
# five (the tool prints these too): a solve that stalls a few iterations
# early fails
QUAD_JAX_QUARTILE_RTOL, QUAD_JAX_MEAN_RTOL = 0.2, 0.08
# the m3 path's iteration budget: the converged solve took 150.6 s of the
# run's 1200 s on an H100, most of it λ-retries of the whole fleet
M3_PATH_ITERS = 30
# launches by the builds' thread, joined when the script ends
BUILD_THREADS: list = []


def wrap_attitude(x, x_old):
    """The quadrotor's state difference with the attitude θ (state 4)
    wrapped into [-π, π): Python's remainder, as PyTorch and jnp compute
    it (a LanesModel ``diff``)."""
    d = [x[i] - x_old[i] for i in range(len(x))]
    d[4] = torch.remainder(d[4] + math.pi, 2 * math.pi) - math.pi
    return d


def lowered_models() -> dict:
    """The group's models with their descriptors removed, so that the card
    runs them through their lowering: the quadrotor, PendCartParam, LTI
    <10,2> (random_lti from seed 0; its constants do not depend on the
    spec's device), and the quadrotor with ``wrap_attitude``."""
    import dataclasses
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_lanes_param)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)

    def bare(m, **kw):
        return dataclasses.replace(m, device=None, **kw)

    quad = quadrotor_lanes(QuadrotorSpec())
    return dict(quad=bare(quad),
                param=bare(pendcart_lanes_param(PendCartSpec())),
                lti=bare(lti_lanes(random_lti(0, n=LTI_N, m=LTI_M, T=LTI_T,
                                              device="cpu"))),
                quad_diff=bare(quad, diff=wrap_attitude))


def start_lowered_builds(models: dict):
    """Lower the group's models and start their libraries' builds in a
    thread (one nvcc a library, all together), so that they overlap the
    earlier phases. Returns (thread, labels, box): the box receives
    ``builds`` (one _build.Build a label) or ``error``."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import lower
    jobs, labels = [], []
    for key, groups in LOWERED_GROUPS.items():
        low = lower.lower(models[key])
        for g in groups:
            jobs.append((low.struct(g == "fwd"), g))
            labels.append(f"{key} {g}")
    return build_thread(jobs, labels)


def background():
    """Lower the calling thread's priority (``nice``), and with it that of
    the nvcc processes it starts: the builds have until their group's
    phases, the earlier phases need the host now."""
    import os
    import threading
    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(),
                   BACKGROUND_NICE)


def build_thread(jobs, labels):
    """Start the builds of ``jobs`` ((struct, group) pairs) in a thread;
    returns (thread, labels, box) as start_lowered_builds."""
    import threading
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build)
    box: dict = {}

    def run():
        background()
        try:
            box["builds"] = _build.build_lowered(jobs)
        except Exception as e:   # noqa: BLE001 - reported by the phase
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    BUILD_THREADS.append(th)
    return th, labels, box


def quad_kl_inputs(model, x0s: torch.Tensor, Tk: int):
    """The KL tier's inputs on the quadrotor at horizon Tk for the lanes
    x0s (Bk, 6) on their device: the pre-roll by K3 at α=1 with k := u0 =
    hover + QUAD_KL_NOISE·N(0,1) (numpy seed QUAD_KL_SEED, drawn for B
    lanes and QUAD_T steps, cut to the lanes' count and Tk) and no limits,
    the zero previous policy with k = its controls and unit Σ, fx along it
    from the autodiff tiles (a few steps at a time: a call holds every
    direction's tangents), and cost0."""
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    Bk, dev = x0s.shape[0], x0s.device
    rng = np.random.default_rng(QUAD_KL_SEED)
    u0 = QuadrotorSpec().u_hover + QUAD_KL_NOISE * rng.standard_normal(
        (B, QUAD_T, 2))
    u0 = torch.tensor(u0[:Bk, :Tk], dtype=torch.float32, device=dev)
    gains = torch.cat([to_streams(u0), torch.zeros((Tk, 12, Bk),
                                                   device=dev)], dim=1)
    ro = fk.forward_lanes(torch.zeros((Tk, 8, Bk), device=dev), gains,
                          x0s.T.contiguous(), torch.ones((1, Bk), device=dev),
                          model=model, lims=None, emit_traj=True)
    tiles = autodiff_derivs_tiles(model)
    fx = []
    for t0 in range(0, Tk, 25):
        tr = ro.traj[t0:t0 + 25]
        d = tiles([tr[:, i] for i in range(6)], [tr[:, 6], tr[:, 7]], 0)
        fx.append(torch.stack([torch.stack([v.expand(tr.shape[0], Bk)
                                            for v in row], -1)
                               for row in d["fx"]], -2))
    fx = torch.cat(fx).permute(2, 0, 1, 3).contiguous()       # (Bk, Tk, 6, 6)
    eye = torch.eye(2, device=dev).expand(Bk, Tk, 2, 2)
    policy0 = GaussianPolicy(
        K=torch.zeros((Bk, Tk, 2, 6), device=dev),
        k=from_streams(ro.traj[:, 6:8], (2,)).contiguous(), sigma=eye,
        sigma_inv=eye)
    return (from_streams(ro.traj[:, :6], (6,)).contiguous(), policy0, fx,
            ro.totals[0]), ro.traj


def quad_kl_cfg():
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    return ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS)


def hetero_ad_inputs(device, Bk: int, Tk: int):
    """The heterogeneous headline with autodiff tiles: x0 of the headline
    (headline_x0), per-scenario [l, d] from PARAM_L, PARAM_D (numpy seed
    HETERO_AD_SEED, drawn for B lanes), u0 = 0, on the first Bk lanes at
    horizon Tk. Returns (x0s, u0s, params)."""
    rng = np.random.default_rng(HETERO_AD_SEED)
    par = np.stack([rng.uniform(*PARAM_L, B), rng.uniform(*PARAM_D, B)],
                   axis=1)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(headline_x0()[:Bk], **f32),
            torch.zeros((Bk, Tk, 1), **f32), torch.tensor(par[:Bk], **f32))


def lowered_cpu_solves() -> dict:
    """The lowered group's CPU plain solves on B_CPU lanes (part of the
    ``--packed-cpu`` child): the heterogeneous headline with autodiff tiles
    and params at LOWERED_T_CPU, and KL on the quadrotor at QUAD_T_CPU.
    On CPU tensors the descriptor-less models run the plain versions."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    models = lowered_models()
    out = {}
    t0 = time.perf_counter()
    pm = models["param"]
    x0s, u0s, par = hetero_ad_inputs("cpu", B_CPU, LOWERED_T_CPU)
    r = ilqg_batch_lanes(pm, None, x0s, u0s, lims=LIMS, cfg=headline_cfg(),
                         derivs_tiles=autodiff_derivs_tiles(pm), params=par,
                         max_steps=ITERS)
    out["lowered hetero (autodiff tiles, params)"] = dict(
        cost_total=r.cost_total.tolist(), reason=r.reason.tolist(),
        n_accepted=r.n_accepted.tolist(), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    qm = models["quad"]
    x0q = torch.tensor(quad_x0()[:B_CPU], dtype=torch.float32)
    kl_in, _ = quad_kl_inputs(qm, x0q, QUAD_T_CPU)
    k = ilqgkl_batch_lanes(qm, autodiff_derivs_tiles(qm), *kl_in,
                           cfg=quad_kl_cfg())
    out["quad KL"] = dict(
        cost_total=k.cost_total.tolist(), satisfied=k.satisfied.tolist(),
        n_iters=k.n_iters.tolist(), seconds=time.perf_counter() - t0)
    return out


def shares(g: dict, c: dict, cost: str, same) -> list:
    """The share of lanes whose ``cost`` agrees to COST_RTOL, then the share
    with equal values of each field of ``same``, between two solves'
    outcomes."""
    gc, cc = torch.tensor(g[cost]), torch.tensor(c[cost])
    close = (((gc - cc).abs() / cc.abs()) <= COST_RTOL).float().mean().item()
    return [close] + [float(np.mean(np.asarray(g[f]) == np.asarray(c[f])))
                      for f in same]


def agree(what: str, g: dict, c: dict, cost: str, same,
          need=None) -> None:
    """A card solve's outcomes ``g`` against a host's ``c`` on the same
    lanes: the share of lanes with costs within COST_RTOL and with equal
    ``same`` fields must each reach AGREE_SHARE (section 5's rule), or the
    shares ``need`` (cost first, then ``same``'s) where given."""
    gc, cc = torch.tensor(g[cost]), torch.tensor(c[cost])
    rel = (gc - cc).abs() / cc.abs()
    got = shares(g, c, cost, same)
    need = need or [AGREE_SHARE] * len(got)
    print(f"  {what}: cost rel diff max {rel.max().item():.3e}, median "
          f"{rel.median().item():.3e}; shares: cost within {COST_RTOL:.0e} "
          f"{got[0]:.3f}, " + ", ".join(f"same {f} {v:.3f}" for f, v in
                                        zip(same, got[1:]))
          + f" (need {', '.join(f'{v:.3f}' for v in need)})")
    check(all(v >= n for v, n in zip(got, need)),
          f"{what}: GPU and CPU outcomes differ")


def lowered_phases(ph, dev, rec, counters, builds, cpu_proc) -> dict:
    """Phases 42-47, the lowered group: models written only in Python
    (``lowered_models``) run through their lowering. lowered-build waits
    for the libraries' builds (``builds`` from start_lowered_builds) and
    prints their seconds and each instance's registers; lowered-kernels
    holds the lowered quadrotor's K1 (every emission, GPS mode, second
    order), K2 and K3 bit for bit to the hand-written instances and to
    their plain versions, and the lowered LTI's and PendCartParam's to
    their plain versions; lowered-path solves the quadrotor fleet with
    the lowered model (bit-equal to the hand-written solve) and the
    heterogeneous headline with autodiff tiles and params; quad-kl runs
    KL on the quadrotor (K4 n=6 and K1 GPS policy); diff runs K2 and K3
    with an angle-wrapping diff and one fleet solve; quad-jax holds the
    card's quadrotor solve of 64 lanes to the JAX package's outcomes
    (tools_torch/quad_outcomes.npz). The CPU child ``cpu_proc`` gives the
    host's solves. Adds the measurements to ``rec``; returns the launches
    of its paths."""
    import os
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_lanes_param)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig)

    t_group = time.perf_counter()
    models, (th, labels, box) = builds
    ph.start("lowered-build", "the lowered models' libraries, one nvcc each, "
             "started after the main build")
    th.join()
    if "error" in box:
        raise box["error"]
    lb = {}
    for label, b in zip(labels, box["builds"]):
        lines = ptxas_summary(b.log)
        print(f"  {label}: {b.seconds:.1f} s -> {b.path.name}")
        for line in lines:
            print(f"    {line}")
        lb[label] = dict(seconds=b.seconds, ptxas=lines)
    rec["lowered_builds"] = lb

    Tq, Tp = QUAD_T, QUAD_T_PLAIN
    spec = QuadrotorSpec()
    hand, low = quadrotor_lanes(spec), models["quad"]
    lims = spec.lims
    cfg = headline_cfg()
    A = len(cfg.alphas)
    ph.start("lowered-kernels", f"B={B}: the lowered quadrotor's K3, K1 "
             f"(gains, full, GPS policy and full, second order) and K2 bit "
             f"for bit to the hand-written instances at T={Tq} and to their "
             f"plain versions (K1 at T={Tp}); the lowered LTI <10,2> K1 at "
             f"T={LTI_T} (plain at T={LTI_T_PLAIN}); the lowered "
             f"PendCartParam's K3, K1, K2 with params at T={T}")
    q, rng = quad_kernel_inputs(dev, cfg.alphas)
    x0s, x0_l, traj0, gains0 = q.x0s, q.x0_l, q.traj0, q.gains0
    ladder, al1, lam = q.ladder, q.al1, q.lam

    def fwd(m, al, emit, plain=False):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(traj0, gains0, x0_l, al, model=m, lims=lims, emit_traj=emit)

    phase = {}

    def phase_count(key, fn):
        """fn's K1 launches, counted for the instance ``key``, which no
        path runs."""
        out, n = counted(counters, fn)
        phase[key] = phase.get(key, 0) + n["backward_lanes"]
        return out

    errs3 = []
    for al, emit, what in ((ladder, False, "sweep A=6"),
                           (al1, True, "rollout A=1")):
        k, h = fwd(low, al, emit), fwd(hand, al, emit)
        pairs = [(k.totals, h.totals), (k.terminal, h.terminal)]
        if emit:
            pairs.append((k.traj, h.traj))
        check_bits(f"lowered quad K3 {what}", *pairs, to="Quadrotor's")
        p = fwd(low, al, emit, True)
        errs3.append(compare(f"lowered quad K3 {what} against plain", {
            "totals": (k.totals, p.totals)} | (
            {"traj": (k.traj, p.traj)} if emit else {})))
    traj, tot = k.traj, k.totals[0]
    ms3 = cuda_ms(lambda: fwd(low, ladder, False), 20)
    ms3r = cuda_ms(lambda: fwd(low, al1, True), 20)
    plain3 = once_ms(lambda: fwd(low, ladder, False, True))
    tiles_h = {so: autodiff_derivs_tiles(hand, second_order=so)
               for so in (False, True)}
    tiles_l = {so: autodiff_derivs_tiles(low, second_order=so)
               for so in (False, True)}
    # a previous policy with every KL term non-zero (Σ⁻¹ positive
    # definite) and a per-step η in [1, 10], zeros counting as 1
    a = rng.standard_normal((Tq, B, 2, 2))
    si = np.einsum("tbij,tbkj->tbik", a, a) + 0.5 * np.eye(2)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((Tq, 2, B)),
        0.3 * rng.standard_normal((Tq, 12, B)),
        np.moveaxis(si.reshape(Tq, B, 4), 1, 2)], axis=1),
        dtype=torch.float32, device=dev)
    eta = torch.tensor(10.0 ** rng.uniform(0, 1, (Tq, B)),
                       dtype=torch.float32, device=dev)
    eta[::7, ::5] = 0.0

    def bwd(tiles, emit, plain=False, tr=traj, gps=False, so=False):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        kw = (dict(prev=prev[:tr.shape[0]], eta=eta[:tr.shape[0]],
                   reg_type=1, lims=None) if gps
              else dict(reg_type=2, lims=lims))
        return f(tr, torch.zeros_like(lam) if gps else lam, n=6, m=2,
                 derivs_tiles=tiles[so], emit=emit, **kw)

    cases = (("gains", False, False), ("full", False, False),
             ("policy", True, False), ("full", True, False),
             ("gains", False, True), ("full", False, True))
    for emit, gps, so in cases:
        what = (f"lowered quad K1 {'second-order ' if so else ''}"
                f"{'GPS ' if gps else ''}{emit}")
        # the second-order instance is on no path: its launches are these
        k = (phase_count("k1_lowered_quad_so", lambda: bwd(
            tiles_l, emit, gps=gps, so=so)) if so
             else bwd(tiles_l, emit, gps=gps, so=so))
        h = bwd(tiles_h, emit, gps=gps, so=so)
        check_bits(f"{what} at T={Tq}", (k.out, h.out), (k.stats, h.stats),
                   to=f"Autodiff<Quadrotor{',SO' if so else ''}>'s")
    errs1 = {}
    traj_p = traj[:Tp].contiguous()
    plain1 = {}
    # one plain "full" run a family, every emission's slots taken from it;
    # GPS mode holds the hand-written Autodiff<Quadrotor> instances to it
    # too (the lowered ones are bit-equal to them above, at T=Tq)
    for gps, so, emits, inst in (
            (False, False, ("full", "gains"), ("lowered",)),
            (True, False, ("full", "policy"), ("lowered", "hand-written")),
            (False, True, ("full", "gains"), ("lowered",))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = bwd(tiles_l, "full", True, traj_p, gps, so)
        torch.cuda.synchronize()
        fam = "so" if so else ("gps" if gps else "first")
        plain1[fam] = (time.perf_counter() - t0) * 1e3
        for who, emit in ((w_, e_) for w_ in inst for e_ in emits):
            k = bwd(tiles_h if who == "hand-written" else tiles_l, emit,
                    False, traj_p, gps, so)
            pe = k1_emitted(p.out, 6, 2, emit)
            lay = bk.OutLayout(6, 2, emit)
            nq = lay.quui if lay.quui is not None else lay.S
            what = f"{who} quad K1 {fam} {emit} at T={Tp} against plain"
            e = [compare_slots_ties(what, k.out[:, :nq], pe[:, :nq],
                                    AD_SLOT_TOL),
                 compare(what, {"dV": (k.stats[:2], p.stats[:2])})]
            if lay.quui is not None:
                # full DDP's Quu may be indefinite: its inverse is then NaN
                # in both, in the same places (err counts those equal)
                e.append(compare(what, {"Quu_inv": (k.out[:, nq:],
                                                    pe[:, nq:])},
                                 QUU_INV_TOL))
            check(torch.equal(k.stats[2:], p.stats[2:]),
                  f"{what}: diverged/diverge_idx differ")
            errs1[fam, who] = max(errs1.get((fam, who), 0.0), *e)
    ms1 = cuda_ms(lambda: bwd(tiles_l, "gains"), 20)
    ms1f = cuda_ms(lambda: bwd(tiles_l, "full"), 20)
    ms1g = cuda_ms(lambda: bwd(tiles_l, "policy", gps=True), 20)
    ms1gh = cuda_ms(lambda: bwd(tiles_h, "policy", gps=True), 20)
    ms1gf = cuda_ms(lambda: bwd(tiles_l, "full", gps=True), 20)
    ms1ghf = cuda_ms(lambda: bwd(tiles_h, "full", gps=True), 20)
    ms1s = cuda_ms(lambda: bwd(tiles_l, "gains", so=True), 5)
    ms1sf = cuda_ms(lambda: bwd(tiles_l, "full", so=True), 5)
    bo = bwd(tiles_l, "gains")
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([bo.stats[0], bo.stats[1], tot, allow])

    def ls(m, plain=False):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(traj, bo.out, x0_l, sel, model=m, alphas=cfg.alphas,
                 reduce_ratio_min=0.0, lims=lims)

    k, h, p = ls(low), ls(hand), ls(low, True)
    check_bits("lowered quad K2", (k.traj, h.traj), (k.ls, h.ls),
               to="Quadrotor's")
    e2 = compare("lowered quad K2 against plain", {
        "traj": (k.traj, p.traj), "totals": (k.ls[4], p.ls[4])})
    ms2 = cuda_ms(lambda: ls(low), 20)
    plain2 = once_ms(lambda: ls(low, True))
    w = dict(k3=k3_work(hand, Tq, B, A, False), k3r=k3_work(hand, Tq, B, 1,
                                                            True),
             k1=k1_work(hand, Tq, B, "gains", 2, lims),
             k1f=k1_work(hand, Tq, B, "full", 2, lims),
             k1g=k1_work(hand, Tq, B, "policy", 1, None, gps=True),
             k1gf=k1_work(hand, Tq, B, "full", 1, None, gps=True),
             k1s=k1_work(hand, Tq, B, "gains", 2, lims, so=True),
             k1sf=k1_work(hand, Tq, B, "full", 2, lims, so=True),
             k2=k2_work(hand, Tq, B, A))
    for what, ms, key in (("K3 sweep A=6", ms3, "k3"),
                          ("K3 rollout A=1", ms3r, "k3r"),
                          ("K1 gains", ms1, "k1"), ("K1 full", ms1f, "k1f"),
                          ("K1 GPS policy", ms1g, "k1g"),
                          ("K1 GPS full", ms1gf, "k1gf"),
                          ("K1 GPS policy, hand-written Autodiff<Quadrotor>",
                           ms1gh, "k1g"),
                          ("K1 GPS full, hand-written Autodiff<Quadrotor>",
                           ms1ghf, "k1gf"),
                          ("K1 second-order gains", ms1s, "k1s"),
                          ("K1 second-order full", ms1sf, "k1sf"),
                          ("K2 A=6", ms2, "k2")):
        print(f"  lowered quad {what} at T={Tq}: kernel {ms:.4f} ms, bound "
              f"{w[key]['bound_ms']:.4f} ms ({w[key]['bound_by']})")
    print(f"  lowered quad plain versions: K3 sweep {plain3:.1f} ms, K2 "
          f"{plain2:.1f} ms at T={Tq}; K1 once at T={Tp}: first order "
          f"{plain1['first']:.1f} ms, GPS {plain1['gps']:.1f} ms, second "
          f"order {plain1['so']:.1f} ms")
    rec["k3_lowered_quad"] = dict(
        max_abs_err=max(errs3), ms=ms3, ms_rollout=ms3r, plain_ms=plain3,
        bound_ms_rollout=w["k3r"]["bound_ms"], library_ms=None, **w["k3"])
    rec["k1_lowered_quad"] = dict(
        max_abs_err=errs1["first", "lowered"], ms=ms1, ms_full=ms1f,
        bound_ms_full=w["k1f"]["bound_ms"], plain_ms=plain1["first"],
        plain_T=Tp, library_ms=None, **w["k1"])
    for key, who, ms, msf in (("k1_lowered_quad_gps", "lowered", ms1g, ms1gf),
                              ("k1_quad_gps", "hand-written", ms1gh, ms1ghf)):
        rec[key] = dict(max_abs_err=errs1["gps", who], ms=ms, ms_full=msf,
                        bound_ms_full=w["k1gf"]["bound_ms"],
                        plain_ms=plain1["gps"], plain_T=Tp, library_ms=None,
                        **w["k1g"])
    rec["k1_lowered_quad_so"] = dict(
        max_abs_err=errs1["so", "lowered"], ms=ms1s, ms_full=ms1sf,
        bound_ms_full=w["k1sf"]["bound_ms"], plain_ms=plain1["so"],
        plain_T=Tp, library_ms=None, **w["k1s"])
    rec["k2_lowered_quad"] = dict(max_abs_err=e2, ms=ms2, plain_ms=plain2,
                                  library_ms=None, **w["k2"])
    del q, traj0, gains0, traj_p, bo, k, h, p, prev, eta

    # the lowered LTI <10,2>: Autodiff<Lowered> K1 at T=LTI_T
    lspec = random_lti(0, n=LTI_N, m=LTI_M, T=LTI_T, device=dev)
    lhand, llow = lti_lanes(lspec), models["lti"]
    lx0 = (torch.ones((LTI_N, B), device=dev)
           * torch.linspace(0.5, 2.0, B, device=dev))
    lgains = torch.cat([to_streams(lspec.u0.expand(B, LTI_T, LTI_M)
                                   + 0.3 * torch.tensor(rng.standard_normal(
                                       (B, LTI_T, LTI_M)),
                                       dtype=torch.float32, device=dev)),
                        torch.zeros((LTI_T, LTI_M * LTI_N, B),
                                    device=dev)], dim=1)
    ltraj = fk.forward_lanes(torch.zeros((LTI_T, 12, B), device=dev),
                             lgains, lx0, al1, model=lhand, lims=LTI_LIMS,
                             emit_traj=True).traj
    ltiles = autodiff_derivs_tiles(llow)

    def lbwd(emit, plain=False, tr=ltraj):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam, n=LTI_N, m=LTI_M, reg_type=2, lims=LTI_LIMS,
                 derivs_tiles=ltiles, emit=emit)

    for emit in ("gains", "full"):
        # on no path: its launches are these
        out = phase_count("k1_lowered_lti", lambda: lbwd(emit))
        check(bool(torch.isfinite(out.out).all()),
              f"lowered LTI K1 {emit}: non-finite output")
    # the plain version on the first LOWERED_LTI_LANES lanes (each lane's
    # recursion is its own): its vmapped Jet passes at n=10 hold 78 pairs'
    # tangents a step
    lp_in = ltraj[:LTI_T_PLAIN].contiguous()
    nl = LOWERED_LTI_LANES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = bk.backward_lanes_ref(lp_in[..., :nl].contiguous(), lam[:nl],
                              n=LTI_N, m=LTI_M, reg_type=2, lims=LTI_LIMS,
                              derivs_tiles=ltiles, emit="full")
    torch.cuda.synchronize()
    plain_l = (time.perf_counter() - t0) * 1e3
    el = []
    for emit in ("full", "gains"):
        k = lbwd(emit, False, lp_in)
        k = k._replace(out=k.out[..., :nl], stats=k.stats[:, :nl])
        lay = bk.OutLayout(LTI_N, LTI_M, emit)
        nq = lay.quui if lay.quui is not None else lay.S
        what = f"lowered LTI K1 {emit} at T={LTI_T_PLAIN} against plain"
        el += [compare_slots_ties(what, k.out[:, :nq], p.out[:, :nq],
                                  KERNEL_TOL),
               compare(what, {"dV": (k.stats[:2], p.stats[:2])})]
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"{what}: diverged/diverge_idx differ")
    ms_l = cuda_ms(lambda: lbwd("gains"), 5)
    ms_lf = cuda_ms(lambda: lbwd("full"), 5)
    wl, wlf = (k1_work(lhand, LTI_T, B, e, 2, LTI_LIMS)
               for e in ("gains", "full"))
    print(f"  lowered LTI K1 at T={LTI_T}: gains {ms_l:.4f} ms, full "
          f"{ms_lf:.4f} ms; bound {wl['bound_ms']:.4f} ms "
          f"({wl['bound_by']}), full {wlf['bound_ms']:.4f}; plain full once "
          f"at T={LTI_T_PLAIN} on {nl} lanes: {plain_l:.1f} ms")
    rec["k1_lowered_lti"] = dict(
        max_abs_err=max(el), ms=ms_l, ms_full=ms_lf,
        bound_ms_full=wlf["bound_ms"], plain_ms=plain_l,
        plain_T=LTI_T_PLAIN, plain_lanes=nl, library_ms=None, **wl)
    del ltraj, lgains, lp_in, p, k, out

    # the lowered PendCartParam with per-scenario [l, d] (params)
    pspec = PendCartSpec()
    phand, plow = pendcart_lanes_param(pspec), models["param"]
    px0, _, ppar = hetero_ad_inputs(dev, B, T)
    px0_l, par = px0.T.contiguous(), ppar.T.contiguous()
    pgains = torch.cat([torch.tensor(2.0 * rng.standard_normal((T, 1, B)),
                                     dtype=torch.float32, device=dev),
                        torch.zeros((T, 4, B), device=dev)], dim=1)
    ptraj0 = torch.zeros((T, 5, B), device=dev)
    pladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    pladder = pladder.contiguous()

    def pfwd(al, emit, plain=False):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(ptraj0, pgains, px0_l, al, par, model=plow, lims=LIMS,
                 emit_traj=emit)

    ep3 = []
    for al, emit, what in ((pladder, False, "sweep A=6"),
                           (al1, True, "rollout A=1")):
        k, p = pfwd(al, emit), pfwd(al, emit, True)
        pairs = {"totals": (k.totals, p.totals)} | (
            {"traj": (k.traj, p.traj)} if emit else {})
        ep3.append(compare(f"lowered PendCartParam K3 {what}", pairs))
    ptraj = k.traj
    ms_p3 = cuda_ms(lambda: pfwd(pladder, False), 20)
    ms_p3r = cuda_ms(lambda: pfwd(al1, True), 20)
    plain_p3 = once_ms(lambda: pfwd(pladder, False, True))
    ptiles = autodiff_derivs_tiles(plow)

    def pbwd(emit, plain=False, tr=ptraj):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam, n=4, m=1, reg_type=2, lims=LIMS,
                 derivs_tiles=ptiles, params=par, emit=emit)

    pp_in = ptraj[:Tp].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = pbwd("full", True, pp_in)
    torch.cuda.synchronize()
    plain_p1 = (time.perf_counter() - t0) * 1e3
    ep1 = []
    for emit in ("full", "gains"):
        k = pbwd(emit, False, pp_in)
        S = bk.OutLayout(4, 1, emit).S
        what = f"lowered PendCartParam K1 {emit} at T={Tp} against plain"
        ep1 += [compare_slots(what, k.out[:, :min(S, 26)],
                              p.out[:, :min(S, 26)], AD_SLOT_TOL),
                compare(what, {"dV": (k.stats[:2], p.stats[:2])})]
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"{what}: diverged/diverge_idx differ")
    ms_p1 = cuda_ms(lambda: pbwd("gains"), 20)
    ms_p1f = cuda_ms(lambda: pbwd("full"), 20)
    pbo = pbwd("gains")
    psel = torch.stack([pbo.stats[0], pbo.stats[1],
                        pfwd(al1, False).totals[0], allow])

    def pls(plain=False):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(ptraj, pbo.out, px0_l, psel, par, model=plow,
                 alphas=cfg.alphas, reduce_ratio_min=0.0, lims=LIMS)

    k, p = pls(), pls(True)
    ep2 = compare("lowered PendCartParam K2", {
        "traj": (k.traj, p.traj), "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]),
          "lowered PendCartParam K2: al_sel/any_ok differ")
    ms_p2 = cuda_ms(lambda: pls(), 20)
    plain_p2 = once_ms(lambda: pls(True))
    wp3, wp1, wp1f, wp2 = (k3_work(phand, T, B, A, False),
                           k1_work(phand, T, B, "gains", 2, LIMS),
                           k1_work(phand, T, B, "full", 2, LIMS),
                           k2_work(phand, T, B, A))
    print(f"  lowered PendCartParam at T={T}: K3 sweep {ms_p3:.4f} ms "
          f"(bound {wp3['bound_ms']:.4f}), rollout {ms_p3r:.4f}; K1 gains "
          f"{ms_p1:.4f} ms (bound {wp1['bound_ms']:.4f}, "
          f"{wp1['bound_by']}), full {ms_p1f:.4f}; K2 {ms_p2:.4f} ms (bound "
          f"{wp2['bound_ms']:.4f}); plain: K3 {plain_p3:.1f}, K2 "
          f"{plain_p2:.1f} ms, K1 full once at T={Tp} {plain_p1:.1f} ms")
    rec["k3_lowered_param"] = dict(max_abs_err=max(ep3), ms=ms_p3,
                                   ms_rollout=ms_p3r, plain_ms=plain_p3,
                                   library_ms=None, **wp3)
    rec["k1_lowered_param"] = dict(max_abs_err=max(ep1), ms=ms_p1,
                                   ms_full=ms_p1f,
                                   bound_ms_full=wp1f["bound_ms"],
                                   plain_ms=plain_p1, plain_T=Tp,
                                   library_ms=None, **wp1)
    rec["k2_lowered_param"] = dict(max_abs_err=ep2, ms=ms_p2,
                                   plain_ms=plain_p2, library_ms=None, **wp2)
    del ptraj, ptraj0, pgains, pbo, pp_in, k, p

    ph.start("lowered-path", f"ilqg_batch_lanes, quadrotor B={B} T={Tq}, "
             f"max_steps={ITERS}: the lowered model against the "
             f"hand-written one, bit for bit; the heterogeneous headline "
             f"(PendCartParam, B={B} T={T}) with autodiff tiles and params")
    u0s = torch.full((B, Tq, 2), spec.u_hover, device=dev)

    def qsolve(m, tiles, x0=x0s, u0=u0s):
        return ilqg_batch_lanes(m, None, x0, u0, lims=lims, cfg=cfg,
                                derivs_tiles=tiles, max_steps=ITERS)

    qsolve(hand, tiles_h[False])                # warm-up of both paths
    qsolve(low, tiles_l[False])
    ref, rh = once_run(lambda: qsolve(hand, tiles_h[False]), counters)
    got, rl = once_run(lambda: qsolve(low, tiles_l[False]), counters)
    same_as_lockstep("lowered quadrotor fleet against the hand-written",
                     got, ref, ILQG_FIELDS)
    iters = int(got.n_iters.max())
    print(f"  launches: hand-written {rh['launches']}, lowered "
          f"{rl['launches']}")
    print(f"  ms/iter over {iters} iterations: hand-written "
          f"{rh['ms'] / max(iters, 1):.4f}, lowered "
          f"{rl['ms'] / max(iters, 1):.4f} (CUDA events); host syncs "
          f"{rh['syncs']} and {rl['syncs']}")
    check(all(rl["launches"][c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the lowered quadrotor path never ran: "
          f"{rl['launches']}")
    paths = {"lowered_quad": rl["launches"]}
    lowered = dict(quad=dict(hand=rh, lowered=rl, iters=iters))
    del ref, got

    hx0, hu0, hpar = hetero_ad_inputs(dev, B, T)

    def hsolve(x0, u0, p_):
        return ilqg_batch_lanes(plow, None, x0, u0, lims=LIMS, cfg=cfg,
                                derivs_tiles=ptiles, params=p_,
                                max_steps=ITERS)

    hsolve(hx0, hu0, hpar)
    r, rr = once_run(lambda: hsolve(hx0, hu0, hpar), counters)
    hit = int(r.n_iters.max())
    print(f"  heterogeneous headline with autodiff tiles: launches "
          f"{rr['launches']}; {rr['ms']:.3f} ms, "
          f"{rr['ms'] / max(hit, 1):.4f} ms/iter over {hit} iterations; "
          f"reasons {hist(r.reason)}; cost median "
          f"{r.cost_total.median().item():.6g}")
    check(all(rr["launches"][c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the lowered heterogeneous path never ran: "
          f"{rr['launches']}")
    check(bool(torch.isfinite(r.cost_total).all()
               and torch.isfinite(r.u).all()), "lowered hetero: non-finite")
    check(bool((r.u.abs() <= 5.0).all()), "lowered hetero: |u| above 5")
    paths["lowered_hetero"] = rr["launches"]
    lowered["hetero"] = dict(run=rr, iters=hit)
    g = hsolve(*hetero_ad_inputs(dev, B_CPU, LOWERED_T_CPU))
    c = child_solves(cpu_proc)["lowered hetero (autodiff tiles, params)"]
    print(f"  CPU child's solve ({B_CPU} lanes, T={LOWERED_T_CPU}): "
          f"{c['seconds']:.1f} s")
    agree(f"lowered hetero, {B_CPU} lanes at T={LOWERED_T_CPU}", dict(
        cost_total=g.cost_total.tolist(), reason=g.reason.tolist(),
        n_accepted=g.n_accepted.tolist()), c, "cost_total",
          ("reason", "n_accepted"))
    del r, g

    ph.start("quad-kl", f"ilqgkl_batch_lanes on the quadrotor, B={B} "
             f"T={Tq}, kl_step={KL_STEP}, max_iter={KL_ITERS}, scalar η, no "
             f"limits: hand-written and lowered, bit for bit; K4 n=6 and K1 "
             f"GPS policy on the path")
    # one set of inputs for both runs: the pre-roll by the hand-written K3
    # (the lowered K3 is bit-equal to it, lowered-kernels)
    kl_h, _ = quad_kl_inputs(hand, x0s, Tq)
    kcfg = quad_kl_cfg()

    def kl(m, tiles, inp=kl_h):
        return ilqgkl_batch_lanes(m, tiles, *inp, cfg=kcfg)

    kl(hand, tiles_h[False])
    kl(low, tiles_l[False])
    ref, kh = once_run(lambda: kl(hand, tiles_h[False]), counters)
    got, kr = once_run(lambda: kl(low, tiles_l[False]), counters)
    same_as_lockstep("lowered quadrotor KL against the hand-written", got,
                     ref, KL_FIELDS)
    kiters = int(got.n_iters.max())
    print(f"  launches: hand-written {kh['launches']}, lowered "
          f"{kr['launches']}")
    print(f"  KL solve: hand-written {kh['ms']:.3f} ms, lowered "
          f"{kr['ms']:.3f} ms (CUDA events), max n_iters {kiters}; K4 n=6 "
          f"{kr['launches']['covariance_lanes']} and K1 GPS policy "
          f"{kr['launches']['backward_lanes']} launches")
    print(f"  shares: satisfied {got.satisfied.float().mean().item():.4f}, "
          f"pd_failed {got.pd_failed.float().mean().item():.4f}; median η "
          f"{got.eta.median().item():.6g}, median divergence "
          f"{got.divergence.median().item():.6g}; cost_total median "
          f"{got.cost_total.median().item():.6g} against cost0 median "
          f"{kl_h[3].median().item():.6g}")
    check(all(kr["launches"][c_.__name__] > 0 for c_ in
              (bk.backward_lanes, fk.forward_lanes, ck.covariance_lanes)),
          f"a kernel of the quadrotor KL path never ran: {kr['launches']}")
    check(bool(torch.isfinite(got.cost_total).all()),
          "quad KL: non-finite cost")
    paths["quad_kl"], paths["quad_kl_lowered"] = kh["launches"], kr["launches"]
    lowered["kl"] = dict(hand=kh, lowered=kr, iters=kiters,
                         satisfied=got.satisfied.float().mean().item())
    del ref, got, kl_h
    x0c = x0s[:B_CPU]
    kc, _ = quad_kl_inputs(low, x0c, QUAD_T_CPU)
    g = kl(low, tiles_l[False], kc)
    c = child_solves(cpu_proc)["quad KL"]
    print(f"  CPU child's KL solve ({B_CPU} lanes, T={QUAD_T_CPU}): "
          f"{c['seconds']:.1f} s")
    agree(f"quad KL, {B_CPU} lanes at T={QUAD_T_CPU}", dict(
        cost_total=g.cost_total.tolist(), satisfied=g.satisfied.tolist(),
        n_iters=g.n_iters.tolist()), c, "cost_total",
          ("satisfied", "n_iters"))

    dm = models["quad_diff"]
    ph.start("diff", f"K3 and K2 with the angle-wrapping diff (lowered "
             f"quadrotor, B={B} T={Tq}, the stored attitude shifted by 2π on "
             f"half the lanes) against their plain versions; one "
             f"{ITERS}-iteration fleet solve")
    shifted = traj.clone()
    shifted[:, 4, ::2] += 2 * math.pi
    dgains = bwd(tiles_l, "gains").out
    ed = []
    for al, emit, what in ((ladder, False, "sweep A=6"),
                           (al1, True, "rollout A=1")):
        def dfwd(plain=False, al=al, emit=emit):
            f = fk.forward_lanes_ref if plain else fk.forward_lanes
            return f(shifted, dgains, x0_l, al, model=dm, lims=lims,
                     emit_traj=emit)
        k, p = dfwd(), dfwd(True)
        ed.append(compare(f"diff K3 {what}", {"totals": (k.totals, p.totals)}
                          | ({"traj": (k.traj, p.traj)} if emit else {})))
    ms_d3 = cuda_ms(lambda: fk.forward_lanes(shifted, dgains, x0_l, ladder,
                                             model=dm, lims=lims), 20)
    plain_d3 = once_ms(lambda: fk.forward_lanes_ref(
        shifted, dgains, x0_l, ladder, model=dm, lims=lims))
    dsel = torch.stack([torch.full_like(tot, -1.0),
                        torch.full_like(tot, 0.5), tot, allow])

    def dls(plain=False):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(shifted, dgains, x0_l, dsel, model=dm, alphas=cfg.alphas,
                 reduce_ratio_min=0.0, lims=lims)

    k, p = dls(), dls(True)
    ed2 = compare("diff K2", {"traj": (k.traj, p.traj),
                              "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]), "diff K2: al_sel/any_ok differ")
    ms_d2 = cuda_ms(lambda: dls(), 20)
    plain_d2 = once_ms(lambda: dls(True))
    wd3, wd2 = k3_work(hand, Tq, B, A, False), k2_work(hand, Tq, B, A)
    print(f"  diff K3 sweep A=6 {ms_d3:.4f} ms (bound {wd3['bound_ms']:.4f} "
          f"ms, {wd3['bound_by']}), K2 A=6 {ms_d2:.4f} ms (bound "
          f"{wd2['bound_ms']:.4f}); plain {plain_d3:.1f}, {plain_d2:.1f} ms")
    rec["k3_lowered_diff"] = dict(max_abs_err=max(ed), ms=ms_d3,
                                  plain_ms=plain_d3, library_ms=None, **wd3)
    rec["k2_lowered_diff"] = dict(max_abs_err=ed2, ms=ms_d2,
                                  plain_ms=plain_d2, library_ms=None, **wd2)
    dtiles = autodiff_derivs_tiles(dm)
    r, rd = once_run(lambda: qsolve(dm, dtiles), counters)
    diters = int(r.n_iters.max())
    print(f"  fleet solve with the diff: launches {rd['launches']}; "
          f"{rd['ms']:.3f} ms, {rd['ms'] / max(diters, 1):.4f} ms/iter over "
          f"{diters} iterations; cost median "
          f"{r.cost_total.median().item():.6g}; reasons {hist(r.reason)}")
    check(all(rd["launches"][c_.__name__] > 0 for c_ in counters[:3]),
          f"a kernel of the diff path never ran: {rd['launches']}")
    check(bool(torch.isfinite(r.cost_total).all()), "diff: non-finite cost")
    check(bool((r.u >= 0.0).all() and (r.u <= spec.u_max).all()),
          "diff: a thrust outside (0, u_max)")
    paths["lowered_diff"] = rd["launches"]
    lowered["diff"] = dict(run=rd, iters=diters)
    del shifted, dgains, k, p, r

    ph.start("quad-jax", f"the card's quadrotor solve of the lanes of "
             f"{QUAD_OUTCOMES} against the JAX package's outcomes there")
    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               QUAD_OUTCOMES))
    print(f"  reference: {ref['solver']}, {ref['x0'].shape[0]} lanes, "
          f"T={int(ref['T'])}, max_iter={int(ref['max_iter'])}")
    Tj = int(ref["T"])
    jcfg = ILQGConfig(alphas=cfg.alphas, reg_type=2, lam_max=1e15,
                      max_iter=int(ref["max_iter"]))
    jx0 = torch.tensor(ref["x0"], device=dev)
    check(bool(torch.equal(jx0, x0s[:jx0.shape[0]])),
          "quad-jax: the reference's lanes are not the quadrotor fleet's")
    r = ilqg_batch_lanes(low, None, jx0, torch.full(
        (jx0.shape[0], Tj, 2), spec.u_hover, device=dev), lims=lims,
        cfg=jcfg, derivs_tiles=tiles_l[False], record_trace=True)
    reason, acc = r.reason.cpu().numpy(), r.n_accepted.cpu().numpy()
    same = (reason == ref["reason"]) & (acc == ref["n_accepted"])
    print(f"  lanes with the same reason and accepted count: "
          f"{int(same.sum())} of {same.size} (need {AGREE_SHARE:.0%}); "
          f"reasons card {hist(r.reason)}, JAX "
          f"{dict(zip(*np.unique(ref['reason'], return_counts=True)))}")
    check(same.mean() >= AGREE_SHARE, "quad-jax: reasons or accepted counts "
          "differ from JAX's on too many lanes")
    # their costs iteration by iteration (JAX's record_trace in the file):
    # the share within COST_RTOL, and the share still on JAX's path (the
    # same accepted α at every iteration so far)
    k = int(ref["max_iter"]) + 1
    cost = r.trace.cost.cpu().numpy()[same, :k]
    alpha = r.trace.alpha.cpu().numpy()[same, :k]
    jc, ja = ref["trace_cost"][same, :k], ref["trace_alpha"][same, :k]
    rel = np.abs(cost - jc) / np.abs(jc)
    path = np.cumprod(alpha[:, 1:] == ja[:, 1:], axis=1).astype(bool)
    within = (rel <= COST_RTOL).mean(axis=0)
    on_path = np.concatenate([[1.0], path.mean(axis=0)])
    print("  iteration: share of those lanes with cost within "
          f"{COST_RTOL:.0e} / on JAX's path: " + ", ".join(
              f"{i} {within[i]:.3f}/{on_path[i]:.3f}" for i in range(k)))
    print(f"  final cost rel diff on those lanes: max {rel[:, -1].max():.3e},"
          f" median {np.median(rel[:, -1]):.3e}")
    for i in range(1, QUAD_JAX_ITERS + 1):
        check(within[i] >= AGREE_SHARE, f"quad-jax: iteration {i}: "
              f"{within[i]:.3f} of the lanes' costs within {COST_RTOL:.0e} "
              f"of JAX's (need {AGREE_SHARE})")
    # the end state on every lane: final cost quartiles and mean
    fin, jfin = r.cost_total.cpu().numpy(), ref["cost_total"]
    qs = np.percentile(fin, (25, 50, 75))
    jqs = np.percentile(jfin, (25, 50, 75))
    q_rel = np.abs(qs - jqs) / jqs
    mean_rel = abs(fin.mean() / jfin.mean() - 1.0)
    print(f"  final cost quartiles card {qs.tolist()}, JAX {jqs.tolist()}: "
          f"rel diff {q_rel.tolist()} (bound {QUAD_JAX_QUARTILE_RTOL}); mean "
          f"card {fin.mean():.9g}, JAX {jfin.mean():.9g}: rel diff "
          f"{mean_rel:.6e} (bound {QUAD_JAX_MEAN_RTOL})")
    check(q_rel.max() <= QUAD_JAX_QUARTILE_RTOL and
          mean_rel <= QUAD_JAX_MEAN_RTOL, "quad-jax: the final costs' "
          "quartiles or mean part from JAX's")
    lowered["quad_jax"] = dict(
        same_share=float(same.mean()), within=within.tolist(),
        on_path=on_path.tolist(), rel_max=float(rel[:, -1].max()),
        rel_median=float(np.median(rel[:, -1])),
        final_quartiles_rel=q_rel.tolist(), final_mean_rel=float(mean_rel))
    for key, n in phase.items():
        rec[key]["phase_launches"] = n
    wall = time.perf_counter() - t_group
    print(f"  lowered group: {wall:.1f} s wall")
    lowered["wall_s"] = wall
    rec["lowered"] = lowered
    return paths


# ---------------------------------------------------------------------------
# the tiles group (phases 48-53): a user's own Python derivative tiles
# lowered into K1 (LoweredTiles, ops/hopper/lower.py lower_tiles) and
# models that read the step index t, on the card
# ---------------------------------------------------------------------------

# the T at which the group's LoweredTiles and time-varying instances are
# held to their plain versions, t from 0 to 32: LTI_T_PLAIN's
TILES_T_PLAIN = LTI_T_PLAIN
# random_lti's step h: the LTI reference r(t) = 0.5·sin(π·h·t)
TRACK_H = 0.01
# the tiles group's libraries: label -> (model key, lowering, group)
TILES_BUILDS = (("lti fwd", "lti", "model", "fwd"),
                ("lti t1", "lti_tiles", "tiles", "t1"),
                ("lti t1_gps", "lti_tiles", "tiles", "t1_gps"),
                ("track fwd", "track", "model", "fwd"),
                ("track t1", "track_tiles", "tiles", "t1"),
                ("quad_track fwd", "quad", "model", "fwd"),
                ("quad_track k1", "quad", "model", "k1"),
                ("so t1_so", "so_tiles", "tiles", "t1_so"))


def tiles_models() -> dict:
    """The tiles group's Python-only models and user tiles, none with a
    device descriptor: the LTI fleet (random_lti seed 0) and
    ``DerivsTiles(fn=lti_derivs_tiles(spec).fn)``; the LTI fleet tracking
    r(t) and its user tiles reading t, the quadrotor tracking px(t)
    (tools_torch/tracking.py); the pendcart's second-order tiles."""
    import dataclasses
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles_so)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
        import DerivsTiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
        import LanesModel
    from tools_torch import tracking

    spec = random_lti(0, n=LTI_N, m=LTI_M, T=LTI_T, device="cpu")
    track, track_fn = tracking.lti_track(torch, LanesModel, spec.A, spec.B,
                                         spec.Q, spec.R, TRACK_H)
    return dict(
        spec=spec, lti=dataclasses.replace(lti_lanes(spec), device=None),
        lti_tiles=DerivsTiles(fn=lti_derivs_tiles(spec).fn), track=track,
        track_tiles=DerivsTiles(fn=track_fn),
        quad=tracking.quad_track(torch, LanesModel, QuadrotorSpec()),
        so_tiles=DerivsTiles(fn=pendcart_derivs_tiles_so(PendCartSpec()).fn))


def start_tiles_builds(t: dict):
    """Lower the tiles group's models and tiles and start their libraries'
    builds in a thread, as start_lowered_builds."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import lower
    jobs = []
    for _, key, kind, group in TILES_BUILDS:
        if kind == "model":
            jobs.append((lower.lower(t[key]).struct(group == "fwd"), group))
        else:
            n, m = (4, 1) if key == "so_tiles" else (LTI_N, LTI_M)
            jobs.append((lower.lower_tiles(t[key], n, m).struct(), group))
    return build_thread(jobs, [label for label, *_ in TILES_BUILDS])


def tiles_cpu_solves() -> dict:
    """The tiles group's CPU plain solves on B_CPU lanes (the
    ``--tiles-cpu`` child): the tracking LTI at LTI_T_CPU with its user
    tiles, and the tracking quadrotor at QUAD_T_CPU with autodiff tiles."""
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    t = tiles_models()
    out = {}
    t0 = time.perf_counter()
    x0s, u0s = lti_fleet_inputs(t["spec"], "cpu", B_CPU, LTI_T_CPU)
    r = ilqg_batch_lanes(t["track"], None, x0s, u0s, lims=LTI_LIMS,
                         cfg=lti_cfg(), derivs_tiles=t["track_tiles"])
    out["lti-track"] = dict(
        cost_total=r.cost_total.tolist(), reason=r.reason.tolist(),
        n_accepted=r.n_accepted.tolist(), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    spec = QuadrotorSpec()
    x0q = torch.tensor(quad_x0()[:B_CPU], dtype=torch.float32)
    r = ilqg_batch_lanes(t["quad"], None, x0q,
                         torch.full((B_CPU, QUAD_T_CPU, 2), spec.u_hover),
                         lims=spec.lims, cfg=headline_cfg(),
                         derivs_tiles=autodiff_derivs_tiles(t["quad"]),
                         max_steps=ITERS)
    out["quad-track"] = dict(
        cost_total=r.cost_total.tolist(), reason=r.reason.tolist(),
        n_accepted=r.n_accepted.tolist(), seconds=time.perf_counter() - t0)
    return out


def lti_cfg():
    """The LTI fleet's ILQGConfig (tools/bench_fleet.py --lti): run to
    convergence."""
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)
    return ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                      lam_max=1e15, max_iter=300)


def lti_fleet_inputs(spec, device, Bk: int, Tk: int):
    """The LTI fleet's inputs at the spec's (n, m): x0 = 1·linspace(0.5, 2)
    over B lanes (made on the host) and u0 = the spec's, on the first Bk
    lanes at horizon Tk."""
    n, m = spec.B.shape
    x0s = torch.ones((B, n)) * torch.linspace(0.5, 2.0, B)[:, None]
    u0s = spec.u0.cpu()[:Tk].expand(Bk, Tk, m)
    return x0s[:Bk].to(device), u0s.contiguous().to(device)


def bits_or_parts(what: str, fields: dict) -> bool:
    """Print whether each (card, reference) pair is bit-equal, and where a
    pair is not, its largest difference; returns whether all are."""
    same = True
    for name, (a, b) in fields.items():
        # a NaN in the same place as the reference's counts as equal
        eq = bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        same &= eq
        if not eq:
            mx, rel = err(a, b)
            print(f"  {what} {name}: NOT bit-equal, max_abs_err={mx:.3e} "
                  f"rel={rel:.3e}")
    print(f"  {what}: bit-equal in {', '.join(fields)}: {same}")
    return same


def tiles_phases(ph, dev, rec, counters, builds, cpu_proc) -> dict:
    """Phases 48-53, the tiles group. tiles-build waits for the group's
    libraries; tiles-kernels holds each new instance (LoweredTiles LTI in
    gains, full, GPS policy and full; LoweredTiles LTI reading t; the
    second-order LoweredTiles pendcart; Autodiff<Lowered> reading t, and
    the lowered K3 and K2 of the LTI, the tracking LTI and the tracking
    quadrotor) to its plain version at TILES_T_PLAIN and times it at the
    path's T; tiles-lti solves the LTI fleet with a Python-only model and
    the user's tiles against the hand-written solve, then KL on it;
    lti-track, quad-track and tiles-so are the other paths. Returns the
    launches of the group's paths."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        SimpleLTVModel, lti_derivs_tiles, lti_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles_so, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)

    t_group = time.perf_counter()
    tm, (th, labels, box) = builds
    ph.start("tiles-build", "the tiles group's libraries, one nvcc each, "
             "started after the main build")
    th.join()
    if "error" in box:
        raise box["error"]
    lb = {}
    for label, b in zip(labels, box["builds"]):
        lines = ptxas_summary(b.log)
        print(f"  {label}: {b.seconds:.1f} s -> {b.path.name}")
        for line in lines:
            print(f"    {line}")
        lb[label] = dict(seconds=b.seconds, ptxas=lines)
    rec["tiles_builds"] = lb

    n, m, Tl, Tp = LTI_N, LTI_M, LTI_T, TILES_T_PLAIN
    cfg = lti_cfg()
    A = len(cfg.alphas)
    spec = tm["spec"]._replace(**{k: getattr(tm["spec"], k).to(dev) for k in
                                  ("A", "B", "Q", "R", "x0", "u0")})
    hand, htiles = lti_lanes(spec), lti_derivs_tiles(spec)
    ph.start("tiles-kernels", f"B={B}: the user's LTI tiles (LoweredTiles) "
             f"against the hand-written LTI K1 at T={Tl} and against their "
             f"plain version at T={Tp}; the time-varying instances (the "
             f"tracking LTI's K3, K1, K2; Autodiff<Lowered> quad_track) and "
             f"the second-order LoweredTiles pendcart against theirs")
    rng = np.random.default_rng(51)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=torch.float32,
                       device=dev)
    lam[::8] = 0.0
    al1 = torch.tensor(rng.uniform(0.0, 1.0, (1, B)), dtype=torch.float32,
                       device=dev)
    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    ladder = ladder.contiguous()
    x0s, u0s = lti_fleet_inputs(spec, dev, B, Tl)
    x0_l = x0s.T.contiguous()
    gains0 = torch.cat([to_streams(u0s + 0.3 * torch.tensor(
        rng.standard_normal((B, Tl, m)), dtype=torch.float32, device=dev)),
        torch.zeros((Tl, m * n, B), device=dev)], dim=1)
    traj0 = torch.zeros((Tl, n + m, B), device=dev)
    def fwd(model, al, emit, plain=False, Tk=Tl):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(traj0[:Tk], gains0[:Tk], x0_l, al, model=model,
                 lims=LTI_LIMS, emit_traj=emit)

    # K3 of the lowered LTI and of the tracking LTI: bits against the
    # hand-written LTI (the untracked one) and against the plain versions
    w3 = k3_work(hand, Tl, B, A, False)
    w3r = k3_work(hand, Tl, B, 1, True)
    k, h = fwd(tm["lti"], al1, True), fwd(hand, al1, True)
    bits_or_parts("lowered LTI K3 rollout against the hand-written LTI's",
                  {"traj": (k.traj, h.traj), "totals": (k.totals, h.totals)})
    traj, tot = h.traj, h.totals[0]
    for key, model in (("k3_lowered_lti", tm["lti"]),
                       ("k3_lowered_track", tm["track"])):
        e = []
        for al, emit, what in ((ladder, False, "sweep A=6"),
                               (al1, True, "rollout A=1")):
            k, p = fwd(model, al, emit, Tk=Tp), fwd(model, al, emit, True,
                                                    Tp)
            pairs = {"totals": (k.totals, p.totals)} | (
                {"traj": (k.traj, p.traj)} if emit else {})
            e.append(compare(f"{key} {what} at T={Tp}", pairs))
        ms3 = cuda_ms(lambda: fwd(model, ladder, False), 10)
        ms3r = cuda_ms(lambda: fwd(model, al1, True), 10)
        plain3 = once_ms(lambda: fwd(model, ladder, False, True, Tp))
        # the reference: a product, sin, a product and a subtraction a step
        extra = 4 * Tl * B if key == "k3_lowered_track" else 0
        rec[key] = dict(max_abs_err=max(e), ms=ms3, ms_rollout=ms3r,
                        plain_ms=plain3, plain_T=Tp,
                        bound_ms_rollout=bound(w3r["bound_bytes"],
                                               w3r["bound_flops"] + extra)[
                            "bound_ms"], library_ms=None,
                        **bound(w3["bound_bytes"],
                                w3["bound_flops"] + A * extra))
        print(f"  {key} at T={Tl}: sweep {ms3:.4f} ms, rollout {ms3r:.4f} ms "
              f"(bound {rec[key]['bound_ms']:.4f}); plain sweep at T={Tp} "
              f"{plain3:.1f} ms")

    # K1: the user's LTI tiles (LoweredTiles) against the hand-written LTI
    # at the fleet's T, then against their plain version
    def bwd(tiles, emit, tr=traj, plain=False, gps=None):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        kw = (dict(prev=gps[0][:tr.shape[0]], eta=gps[1][:tr.shape[0]],
                   reg_type=1, lims=None) if gps is not None
              else dict(reg_type=2, lims=LTI_LIMS))
        return f(tr, torch.zeros_like(lam) if gps is not None else lam, n=n,
                 m=m, derivs_tiles=tiles, emit=emit, **kw)

    for emit in ("gains", "full"):
        k, h = bwd(tm["lti_tiles"], emit), bwd(htiles, emit)
        bits_or_parts(f"K1 LoweredTiles LTI {emit} at T={Tl} against the "
                      f"hand-written LTI", {"out": (k.out, h.out),
                                            "stats": (k.stats, h.stats)})
    a_ = rng.standard_normal((Tl, B, m, m))
    si = np.einsum("tbij,tbkj->tbik", a_, a_) + 0.5 * np.eye(m)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((Tl, m, B)),
        0.5 * rng.standard_normal((Tl, m * n, B)),
        np.moveaxis(si.reshape(Tl, B, m * m), 1, 2)], axis=1),
        dtype=torch.float32, device=dev)
    eta = torch.tensor(10.0 ** rng.uniform(-1, 1, (Tl, B)),
                       dtype=torch.float32, device=dev)
    k, h = (bwd(tl_, "policy", gps=(prev, eta)) for tl_ in
            (tm["lti_tiles"], htiles))
    bits_or_parts(f"K1 LoweredTiles LTI GPS policy at T={Tl} against the "
                  f"hand-written LTI", {"out": (k.out, h.out),
                                        "stats": (k.stats, h.stats)})
    tr_p = traj[:Tp].contiguous()
    for key, tiles, gps, emits in (
            ("k1_tiles_lti", tm["lti_tiles"], None, ("full", "gains")),
            ("k1_tiles_lti_gps", tm["lti_tiles"], (prev, eta),
             ("full", "policy")),
            ("k1_tiles_track", tm["track_tiles"], None, ("full", "gains"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = bwd(tiles, "full", tr_p, True, gps)
        torch.cuda.synchronize()
        plain1 = (time.perf_counter() - t0) * 1e3
        e = []
        for emit in emits:
            k = bwd(tiles, emit, tr_p, gps=gps)
            pe = k1_emitted(p.out, n, m, emit)
            lay = bk.OutLayout(n, m, emit)
            nq = lay.quui if lay.quui is not None else lay.S
            what = f"{key} {emit} at T={Tp} against plain"
            e += [compare_slots_ties(what, k.out[:, :nq], pe[:, :nq],
                                     KERNEL_TOL),
                  compare(what, {"dV": (k.stats[:2], p.stats[:2])})]
            if lay.quui is not None:
                e.append(compare(what, {"Quu_inv": (k.out[:, nq:],
                                                    pe[:, nq:])},
                                 QUU_INV_TOL))
            check(torch.equal(k.stats[2:], p.stats[2:]),
                  f"{what}: diverged/diverge_idx differ")
        if gps is None:
            ms1 = cuda_ms(lambda: bwd(tiles, "gains"), 10)
            ms1f = cuda_ms(lambda: bwd(tiles, "full"), 10)
            w1 = k1_work(hand, Tl, B, "gains", 2, LTI_LIMS)
            w1f = k1_work(hand, Tl, B, "full", 2, LTI_LIMS)
        else:
            # at the KL path's first inputs: zero gains, unit Σ, η = 1
            prev1 = torch.cat([torch.zeros((Tl, m + m * n, B), device=dev),
                               to_streams(torch.eye(m, device=dev).expand(
                                   B, Tl, m, m))], dim=1)
            eta1 = torch.ones((Tl, B), device=dev)
            ms1 = cuda_ms(lambda: bwd(tiles, "policy", gps=(prev1, eta1)), 10)
            ms1f = cuda_ms(lambda: bwd(tiles, "full", gps=(prev1, eta1)), 10)
            w1 = k1_work(hand, Tl, B, "policy", 1, None, gps=True)
            w1f = k1_work(hand, Tl, B, "full", 1, None, gps=True)
            del prev1, eta1
        extra = 4 * Tl * B if key == "k1_tiles_track" else 0
        rec[key] = dict(max_abs_err=max(e), ms=ms1, ms_full=ms1f,
                        bound_ms_full=bound(w1f["bound_bytes"],
                                            w1f["bound_flops"] + extra)[
                            "bound_ms"], plain_ms=plain1, plain_T=Tp,
                        library_ms=None,
                        **bound(w1["bound_bytes"], w1["bound_flops"] + extra))
        print(f"  {key} at T={Tl}: {emits[1]} {ms1:.4f} ms, full {ms1f:.4f} "
              f"ms (bound {rec[key]['bound_ms']:.4f} ms, "
              f"{rec[key]['bound_by']}); plain full once at T={Tp} "
              f"{plain1:.1f} ms")
    h_ms = cuda_ms(lambda: bwd(htiles, "gains"), 10)
    print(f"  K1 LTI gains at T={Tl}: LoweredTiles "
          f"{rec['k1_tiles_lti']['ms']:.4f} ms, hand-written LTI {h_ms:.4f} "
          f"ms in this run")
    rec["k1_tiles_lti"]["hand_written_ms"] = h_ms
    del prev, eta, tr_p

    # K2 of the lowered LTI and of the tracking LTI against plain
    bo = bwd(htiles, "gains")
    sel = torch.stack([bo.stats[0], bo.stats[1], tot, allow])

    def ls(model, plain=False, Tk=Tl):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(traj[:Tk], bo.out[:Tk], x0_l, sel, model=model,
                 alphas=cfg.alphas, reduce_ratio_min=0.0, lims=LTI_LIMS)

    k, h = ls(tm["lti"]), ls(hand)
    bits_or_parts("lowered LTI K2 against the hand-written LTI's",
                  {"traj": (k.traj, h.traj), "ls": (k.ls, h.ls)})
    w2 = k2_work(hand, Tl, B, A)
    for key, model in (("k2_lowered_lti", tm["lti"]),
                       ("k2_lowered_track", tm["track"])):
        k, p = ls(model, Tk=Tp), ls(model, True, Tp)
        e2 = compare(f"{key} at T={Tp}", {"traj": (k.traj, p.traj),
                                           "totals": (k.ls[4], p.ls[4])})
        check(torch.equal(k.ls[:2], p.ls[:2]), f"{key}: al_sel differ")
        ms2 = cuda_ms(lambda: ls(model), 10)
        plain2 = once_ms(lambda: ls(model, True, Tp))
        extra = (A + 1) * 4 * Tl * B if key == "k2_lowered_track" else 0
        rec[key] = dict(max_abs_err=e2, ms=ms2, plain_ms=plain2, plain_T=Tp,
                        library_ms=None, **bound(w2["bound_bytes"],
                                                 w2["bound_flops"] + extra))
        print(f"  {key} at T={Tl}: {ms2:.4f} ms (bound "
              f"{rec[key]['bound_ms']:.4f}); plain at T={Tp} {plain2:.1f} ms")
    del traj, traj0, gains0, bo, k, h, p

    # the tracking quadrotor: Autodiff<Lowered> reading t, its K3 and K2
    qspec = QuadrotorSpec()
    qhand, qm = quadrotor_lanes(qspec), tm["quad"]
    q, _ = quad_kernel_inputs(dev, headline_cfg().alphas)
    Tq = QUAD_T

    def qfwd(al, emit, plain=False, Tk=Tq):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(q.traj0[:Tk], q.gains0[:Tk], q.x0_l, al, model=qm,
                 lims=qspec.lims, emit_traj=emit)

    e3 = []
    for al, emit, what in ((q.ladder, False, "sweep A=6"),
                           (q.al1, True, "rollout A=1")):
        k, p = qfwd(al, emit, Tk=Tp), qfwd(al, emit, True, Tp)
        e3.append(compare(f"quad_track K3 {what} at T={Tp}", {
            "totals": (k.totals, p.totals)} | (
            {"traj": (k.traj, p.traj)} if emit else {})))
    qtraj = qfwd(q.al1, True).traj
    qtot = qfwd(q.al1, True).totals[0]
    ms3 = cuda_ms(lambda: qfwd(q.ladder, False), 10)
    ms3r = cuda_ms(lambda: qfwd(q.al1, True), 10)
    plain3 = once_ms(lambda: qfwd(q.ladder, False, True, Tp))
    qtiles = autodiff_derivs_tiles(qm)

    def qbwd(emit, tr=qtraj, plain=False):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, q.lam, n=6, m=2, reg_type=2, lims=qspec.lims,
                 derivs_tiles=qtiles, emit=emit)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = qbwd("full", qtraj[:Tp].contiguous(), True)
    torch.cuda.synchronize()
    plain1 = (time.perf_counter() - t0) * 1e3
    e1 = []
    for emit in ("full", "gains"):
        k = qbwd(emit, qtraj[:Tp].contiguous())
        pe = k1_emitted(p.out, 6, 2, emit)
        lay = bk.OutLayout(6, 2, emit)
        nq = lay.quui if lay.quui is not None else lay.S
        what = f"quad_track K1 Autodiff<Lowered> {emit} at T={Tp}"
        e1 += [compare_slots_ties(what, k.out[:, :nq], pe[:, :nq],
                                  AD_SLOT_TOL),
               compare(what, {"dV": (k.stats[:2], p.stats[:2])})]
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"{what}: diverged/diverge_idx differ")
    ms1 = cuda_ms(lambda: qbwd("gains"), 10)
    ms1f = cuda_ms(lambda: qbwd("full"), 10)
    qbo = qbwd("gains")
    qsel = torch.stack([qbo.stats[0], qbo.stats[1], qtot, allow])

    def qls(plain=False, Tk=Tq):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(qtraj[:Tk], qbo.out[:Tk], q.x0_l, qsel, model=qm,
                 alphas=headline_cfg().alphas, reduce_ratio_min=0.0,
                 lims=qspec.lims)

    k, p = qls(Tk=Tp), qls(True, Tp)
    e2 = compare(f"quad_track K2 at T={Tp}", {"traj": (k.traj, p.traj),
                                               "totals": (k.ls[4], p.ls[4])})
    ms2 = cuda_ms(lambda: qls(), 10)
    plain2 = once_ms(lambda: qls(True, Tp))
    # the reference: a product, sin and a product a step, in the cost
    xq = 3 * Tq * B
    w = dict(k3=k3_work(qhand, Tq, B, A, False),
             k3r=k3_work(qhand, Tq, B, 1, True),
             k1=k1_work(qhand, Tq, B, "gains", 2, qspec.lims),
             k1f=k1_work(qhand, Tq, B, "full", 2, qspec.lims),
             k2=k2_work(qhand, Tq, B, A))
    rec["k3_lowered_quad_track"] = dict(
        max_abs_err=max(e3), ms=ms3, ms_rollout=ms3r, plain_ms=plain3,
        plain_T=Tp, library_ms=None,
        bound_ms_rollout=bound(w["k3r"]["bound_bytes"],
                               w["k3r"]["bound_flops"] + xq)["bound_ms"],
        **bound(w["k3"]["bound_bytes"], w["k3"]["bound_flops"] + A * xq))
    rec["k1_lowered_quad_track"] = dict(
        max_abs_err=max(e1), ms=ms1, ms_full=ms1f, plain_ms=plain1,
        plain_T=Tp, library_ms=None,
        bound_ms_full=bound(w["k1f"]["bound_bytes"],
                            w["k1f"]["bound_flops"] + xq)["bound_ms"],
        **bound(w["k1"]["bound_bytes"], w["k1"]["bound_flops"] + xq))
    rec["k2_lowered_quad_track"] = dict(
        max_abs_err=e2, ms=ms2, plain_ms=plain2, plain_T=Tp, library_ms=None,
        **bound(w["k2"]["bound_bytes"], w["k2"]["bound_flops"]
                + (A + 1) * xq))
    print(f"  quad_track at T={Tq}: K3 sweep {ms3:.4f} ms, rollout "
          f"{ms3r:.4f}; K1 Autodiff<Lowered> gains {ms1:.4f} ms, full "
          f"{ms1f:.4f}; K2 {ms2:.4f} ms; plain at T={Tp}: K3 {plain3:.1f}, "
          f"K1 full {plain1:.1f}, K2 {plain2:.1f} ms")
    del q, qtraj, qbo, k, p

    # the pendcart's second-order tiles as a user's: LoweredTiles SO
    # against PendCartSO at the headline's T, and against plain
    pspec = PendCartSpec()
    pso = pendcart_derivs_tiles_so(pspec)
    px0 = torch.tensor(headline_x0(), dtype=torch.float32, device=dev)
    pu = torch.tensor(2.0 * rng.standard_normal((B, T, 1)),
                      dtype=torch.float32, device=dev)
    ptraj = fk.forward_lanes(
        torch.zeros((T, 5, B), device=dev),
        torch.cat([to_streams(pu), torch.zeros((T, 4, B), device=dev)], 1),
        px0.T.contiguous(), al1, model=pendcart_lanes(pspec), lims=LIMS,
        emit_traj=True).traj

    def pbwd(tiles, emit, tr=ptraj, plain=False):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(tr, lam, n=4, m=1, reg_type=2, lims=LIMS,
                 derivs_tiles=tiles, emit=emit)

    for emit in ("gains", "full"):
        k, h = pbwd(tm["so_tiles"], emit), pbwd(pso, emit)
        bits_or_parts(f"K1 LoweredTiles SO {emit} at T={T} against "
                      f"PendCartSO", {"out": (k.out, h.out),
                                      "stats": (k.stats, h.stats)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = pbwd(tm["so_tiles"], "full", ptraj[:Tp].contiguous(), True)
    torch.cuda.synchronize()
    plain1 = (time.perf_counter() - t0) * 1e3
    es = []
    for emit in ("full", "gains"):
        k = pbwd(tm["so_tiles"], emit, ptraj[:Tp].contiguous())
        pe = k1_emitted(p.out, 4, 1, emit)
        what = f"K1 LoweredTiles SO {emit} at T={Tp} against plain"
        es += [compare_slots(what, k.out[:, :min(pe.shape[1], 26)],
                             pe[:, :min(pe.shape[1], 26)], AD_SLOT_TOL),
               compare(what, {"dV": (k.stats[:2], p.stats[:2])})]
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"{what}: diverged/diverge_idx differ")
    ms1 = cuda_ms(lambda: pbwd(tm["so_tiles"], "gains"), 20)
    ms1f = cuda_ms(lambda: pbwd(tm["so_tiles"], "full"), 20)
    pm = pendcart_lanes(pspec)
    ws = k1_work(pm, T, B, "gains", 2, LIMS, so=True)
    wsf = k1_work(pm, T, B, "full", 2, LIMS, so=True)
    rec["k1_tiles_so"] = dict(max_abs_err=max(es), ms=ms1, ms_full=ms1f,
                              bound_ms_full=wsf["bound_ms"], plain_ms=plain1,
                              plain_T=Tp, library_ms=None, **ws)
    print(f"  K1 LoweredTiles SO at T={T}: gains {ms1:.4f} ms, full "
          f"{ms1f:.4f} ms (bound {ws['bound_ms']:.4f}, {ws['bound_by']}); "
          f"plain full once at T={Tp} {plain1:.1f} ms")
    del ptraj, p, k, h

    paths = {}

    def timed(fn):
        """fn's result, launches and device ms (CUDA events), warmed."""
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

        def run():
            s.record()
            out = fn()
            e.record()
            return out

        out, launches = counted(counters, run)
        return out, launches, s.elapsed_time(e)

    fields = ("cost_total", "reason", "n_accepted", "u")

    def hold(what, r, ref):
        return bits_or_parts(what, {f: (getattr(r, f), getattr(ref, f))
                                    for f in fields}
                             | {"policy.K": (r.policy.K, ref.policy.K)})

    ph.start("tiles-lti", f"ilqg_batch_lanes, the LTI fleet (B={B}, T={Tl}, "
             f"±0.6, to convergence) with a Python-only model and the "
             f"user's tiles, against the hand-written solve; then KL on it "
             f"(kl_step {KL_LTI_STEP}, scalar η, no limits)")

    def lsolve(model, tiles, x0=x0s, u0=u0s):
        return ilqg_batch_lanes(model, None, x0, u0, lims=LTI_LIMS, cfg=cfg,
                                derivs_tiles=tiles)

    lsolve(tm["lti"], tm["lti_tiles"])              # warm-up
    r, launches, ms_u = timed(lambda: lsolve(tm["lti"], tm["lti_tiles"]))
    ref, _, ms_h = timed(lambda: lsolve(hand, htiles))
    iters = int(r.n_iters.max())
    print(f"  launches: {launches}; n_iters max {iters}")
    print(f"  solve: user's tiles {ms_u:.3f} ms, hand-written {ms_h:.3f} ms "
          f"(CUDA events)")
    same = hold("tiles-lti solve against the hand-written", r, ref)
    if not same:
        agree("tiles-lti solve against the hand-written", {
            f: getattr(r, f).tolist() for f in ("cost_total", "reason",
                                                 "n_accepted")},
              {f: getattr(ref, f).tolist() for f in (
                  "cost_total", "reason", "n_accepted")}, "cost_total",
              ("reason", "n_accepted"))
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the tiles-lti path never ran: {launches}")
    check(bool(torch.isfinite(r.cost_total).all()), "tiles-lti: non-finite")
    paths["tiles_lti"] = launches
    rec["k1_tiles_lti"]["path"] = dict(solve_ms=ms_u, hand_written_ms=ms_h,
                                       iters=iters, bit_equal=same)
    del r, ref

    # KL on it: the pre-roll by the lowered K3 at α=1 with k := u0 and no
    # limits, the zero previous policy with unit Σ, fx = A
    ones = torch.ones((1, B), device=dev)
    g0 = torch.cat([to_streams(u0s), torch.zeros((Tl, m * n, B),
                                                 device=dev)], dim=1)
    kcfg = ILQGKLConfig(kl_step=KL_LTI_STEP)
    fx_model = SimpleLTVModel.from_lti(spec.A, spec.B, Tl).fx.expand(
        B, Tl, n, n)

    def kl(model, tiles):
        ro = fk.forward_lanes(torch.zeros((Tl, n + m + 1, B), device=dev), g0,
                              x0_l, ones, model=model, lims=None,
                              emit_traj=True)
        x_pre = from_streams(ro.traj[:, :n], (n,)).contiguous()
        u_pre = from_streams(ro.traj[:, n:n + m], (m,)).contiguous()
        eye = torch.eye(m, device=dev).expand(B, Tl, m, m)
        pol = GaussianPolicy(K=torch.zeros((B, Tl, m, n), device=dev),
                             k=u_pre, sigma=eye, sigma_inv=eye)
        return ilqgkl_batch_lanes(model, tiles, x_pre, pol, fx_model,
                                  ro.totals[0], cfg=kcfg)

    kl(tm["lti"], tm["lti_tiles"])                   # warm-up
    r, launches, ms_u = timed(lambda: kl(tm["lti"], tm["lti_tiles"]))
    ref, _, ms_h = timed(lambda: kl(hand, htiles))
    print(f"  KL launches: {launches}; KL solve: user's tiles {ms_u:.3f} ms, "
          f"hand-written {ms_h:.3f} ms")
    same = bits_or_parts("tiles-lti KL against the hand-written", {
        f: (getattr(r, f), getattr(ref, f)) for f in (
            "cost_total", "u", "eta", "satisfied", "n_iters")}
        | {"policy.K": (r.policy.K, ref.policy.K)})
    if not same:
        close = ((r.cost_total - ref.cost_total).abs()
                 <= COST_RTOL * ref.cost_total.abs()).float().mean().item()
        sat = (r.satisfied == ref.satisfied).float().mean().item()
        print(f"  shares: cost within {COST_RTOL:.0e} {close:.3f}, same "
              f"satisfied {sat:.3f} (need {AGREE_SHARE} each)")
        check(min(close, sat) >= AGREE_SHARE, "tiles-lti KL differs")
    check(launches["covariance_lanes"] >= 1 and launches["backward_lanes"]
          >= 1, f"a kernel of the tiles-lti KL path never ran: {launches}")
    paths["tiles_lti_kl"] = launches
    rec["k1_tiles_lti_gps"]["path"] = dict(solve_ms=ms_u,
                                           hand_written_ms=ms_h,
                                           bit_equal=same)
    del r, ref, g0, fx_model

    ph.start("lti-track", f"ilqg_batch_lanes, the LTI fleet tracking "
             f"r(t) = 0.5·sin(π·{TRACK_H}·t) on state 0 (B={B}, T={Tl}, "
             f"±0.6, to convergence), the user's tiles reading t; against "
             f"the CPU child's solve of {B_CPU} lanes at T={LTI_T_CPU}")
    lsolve(tm["track"], tm["track_tiles"])           # warm-up
    r, launches, ms_t = timed(lambda: lsolve(tm["track"], tm["track_tiles"]))
    iters = int(r.n_iters.max())
    print(f"  launches: {launches}; solve {ms_t:.3f} ms, n_iters max "
          f"{iters}; cost median {r.cost_total.median().item():.6g}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the lti-track path never ran: {launches}")
    check(bool(torch.isfinite(r.cost_total).all()
               and (r.u.abs() <= 0.6).all()), "lti-track: bad result")
    paths["lti_track"] = launches
    rec["k1_tiles_track"]["path"] = dict(solve_ms=ms_t, iters=iters)
    xc, uc = lti_fleet_inputs(spec, dev, B_CPU, LTI_T_CPU)
    g = lsolve(tm["track"], tm["track_tiles"], xc, uc)
    c = child_solves(cpu_proc)["lti-track"]
    agree(f"lti-track {B_CPU} lanes at T={LTI_T_CPU} ({c['seconds']:.1f} s "
          f"in the child)", {f: getattr(g, f).tolist() for f in (
              "cost_total", "reason", "n_accepted")}, c, "cost_total",
          ("reason", "n_accepted"))
    del r, g

    ph.start("quad-track", f"ilqg_batch_lanes, the quadrotor fleet (B={B}, "
             f"T={Tq}, thrust box) tracking px = 0.5·sin(π/2·h·t), autodiff "
             f"tiles (Autodiff<Lowered> reading t), max_steps={ITERS}; "
             f"against the CPU child's solve of {B_CPU} lanes at "
             f"T={QUAD_T_CPU}")
    qx0 = torch.tensor(quad_x0(), dtype=torch.float32, device=dev)

    def qsolve(x0, Tk=Tq):
        return ilqg_batch_lanes(
            qm, None, x0, torch.full((x0.shape[0], Tk, 2), qspec.u_hover,
                                     device=dev),
            lims=qspec.lims, cfg=headline_cfg(), derivs_tiles=qtiles,
            max_steps=ITERS)

    qsolve(qx0)                                      # warm-up
    r, launches, ms_q = timed(lambda: qsolve(qx0))
    iters = int(r.n_iters.max())
    print(f"  launches: {launches}; solve {ms_q:.3f} ms, "
          f"{ms_q / max(iters, 1):.4f} ms/iter over {iters}; cost median "
          f"{r.cost_total.median().item():.6g}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the quad-track path never ran: {launches}")
    check(bool(torch.isfinite(r.cost_total).all() and (r.u >= 0).all()
               and (r.u <= qspec.u_max).all()), "quad-track: bad result")
    paths["quad_track"] = launches
    rec["k1_lowered_quad_track"]["path"] = dict(
        solve_ms=ms_q, iters=iters, ms_per_iter=ms_q / max(iters, 1))
    g = qsolve(qx0[:B_CPU], QUAD_T_CPU)
    c = child_solves(cpu_proc)["quad-track"]
    agree(f"quad-track {B_CPU} lanes at T={QUAD_T_CPU} ({c['seconds']:.1f} s "
          f"in the child)", {f: getattr(g, f).tolist() for f in (
              "cost_total", "reason", "n_accepted")}, c, "cost_total",
          ("reason", "n_accepted"))
    del r, g

    ph.start("tiles-so", f"ilqg_batch_lanes, full DDP on the headline "
             f"pendcart (B={B}, T={T}, ±5, max_steps={ITERS}) with the "
             f"user's second-order tiles, against PendCartSO's solve")
    u0p = torch.zeros((B, T, 1), device=dev)

    def ssolve(tiles):
        return ilqg_batch_lanes(pm, None, px0, u0p, lims=LIMS,
                                cfg=headline_cfg(), derivs_tiles=tiles,
                                max_steps=ITERS)

    ssolve(tm["so_tiles"])                           # warm-up
    r, launches, ms_s = timed(lambda: ssolve(tm["so_tiles"]))
    ref, _, ms_h = timed(lambda: ssolve(pso))
    print(f"  launches: {launches}; solve: user's tiles {ms_s:.3f} ms, "
          f"PendCartSO {ms_h:.3f} ms")
    same = hold("tiles-so solve against PendCartSO's", r, ref)
    check(same, "tiles-so: the solve is not PendCartSO's bit for bit")
    check(launches["backward_lanes"] > 0, f"tiles-so: K1 never ran "
          f"{launches}")
    paths["tiles_so"] = launches
    rec["k1_tiles_so"]["path"] = dict(solve_ms=ms_s, pendcart_so_ms=ms_h)
    del r, ref
    rec["tiles"] = dict(seconds=time.perf_counter() - t_group)
    print(f"  the tiles group: {time.perf_counter() - t_group:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# the ladder, demos and aot phases: any α ladder on the card, the
# demos' tour, solver export served from bytes
# ---------------------------------------------------------------------------

# K2 and K3 past a block's eight candidate warps, against their plain
# versions at LADDER_T steps (three chunks of the pendcart's ring, so it
# wraps). On every other lane k is negated, an ascent direction, so that
# the smaller α of later rounds roll lower totals, and K2's old total cost
# is the lowest of the first round's totals as K3 rolls them (dV = [-1, 0]:
# a candidate passes where its total is lower): those lanes accept only
# candidates of later rounds. K2's decisions are held bit for bit to the
# accept rule on K3's totals, its stream to its plain version's (or, where
# the kernel parts from it in the last bits, to the plain re-roll at the
# kernel's α)
LADDER_AS = (9, 11, 16, 40)
LADDER_T = LTI_T_PLAIN
# the demos run at their defaults except these, cut to keep the demos
# phase under a minute: the generic tier is host-bound f64 on the card
# (measured on an H100: demo_linear 14.3 s at T=1000, demo_linear_kl's 5
# outer solves 45.5 s at T=300, demo_pendcart 12.4 s at T=300 with 20
# iterations; its own budget is 1000 iterations at T=600)
DEMO_CUTS = {"linear": dict(T=150), "linear_kl": dict(T=50),
             "pendcart": dict(T=100, max_iter=20)}
# the aot phase's demo_linear solve, cut from T=1000 (10.7 s a solve on the
# card, five of them in the phase)
AOT_LINEAR_T = 100


def ladder_cfg():
    """The headline's config with ``ILQGConfig()``'s own 11-α ladder."""
    import dataclasses
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig)
    return dataclasses.replace(headline_cfg(), alphas=ILQGConfig().alphas)


def demos_cpu_solves() -> dict:
    """The ladder and demos phases' CPU plain solves on B_CPU lanes (the
    ``--demos-cpu`` child): the headline fleet with the 11-α ladder (T=500,
    20 iterations), ``demo_fleet``'s first B_CPU lanes at its settings
    (T=500, 20 iterations) and ``demo_quadrotor``'s at T=QUAD_T_CPU."""
    from differentialdynamicprogramming_jl_tpu_torch import demos
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    spec, qspec = PendCartSpec(), QuadrotorSpec()
    model, tiles = pendcart_lanes(spec), pendcart_derivs_tiles(spec)
    qmodel = quadrotor_lanes(qspec)
    f32 = torch.float32
    fx, fu = demos._fleet_inputs(B, T, f32, "cpu")
    qx, qu = demos._quad_inputs(B, QUAD_T_CPU, f32, "cpu")
    runs = {
        "ladder-fleet": lambda: ilqg_batch_lanes(
            model, None, torch.tensor(headline_x0()[:B_CPU], dtype=f32),
            torch.zeros((B_CPU, T, 1)), lims=LIMS, cfg=ladder_cfg(),
            derivs_tiles=tiles, max_steps=ITERS),
        "demo-fleet": lambda: ilqg_batch_lanes(
            model, None, fx[:B_CPU], fu[:B_CPU], lims=LIMS,
            cfg=demos._fleet_cfg(ITERS), derivs_tiles=tiles),
        "demo-quadrotor": lambda: ilqg_batch_lanes(
            qmodel, None, qx[:B_CPU], qu[:B_CPU], lims=qspec.lims,
            cfg=demos._quad_cfg(30), derivs_tiles=autodiff_derivs_tiles(
                qmodel))}
    out = {}
    for label, run in runs.items():
        t0 = time.perf_counter()
        r = run()
        out[label] = dict(cost_total=r.cost_total.tolist(),
                          reason=r.reason.tolist(),
                          n_accepted=r.n_accepted.tolist(),
                          seconds=time.perf_counter() - t0)
    return out


def agree_cpu(what: str, g, c: dict) -> None:
    """A card solve's first lanes against the CPU child's solve of the same
    lanes: the shares of lanes whose cost agrees to COST_RTOL and whose
    reason and accepted count agree, each at least AGREE_SHARE."""
    n = len(c["cost_total"])
    gc = g.cost_total[:n].cpu().double()
    cc = torch.tensor(c["cost_total"], dtype=torch.float64)
    rel = (gc - cc).abs() / cc.abs()
    close = (rel <= COST_RTOL).float().mean().item()
    same_r = (g.reason[:n].cpu() == torch.tensor(c["reason"])).float().mean()
    same_a = (g.n_accepted[:n].cpu()
              == torch.tensor(c["n_accepted"])).float()
    print(f"  {what} against the CPU solve of the same {len(cc)} lanes "
          f"({c['seconds']:.1f} s there): cost within {COST_RTOL:.0e} "
          f"{close:.3f}, same reason {same_r.item():.3f}, same accepted "
          f"{same_a.mean().item():.3f}, max rel {rel.max().item():.3e} "
          f"(need {AGREE_SHARE} each)")
    check(min(close, same_r.item(), same_a.mean().item()) >= AGREE_SHARE,
          f"{what}: card and CPU outcomes differ")


def ladder_inputs(model, tiles, lims, dev, Tk: int, seed: int):
    """x0 (n, B), a K3-rolled [x, u, c] stream of random controls and K1's
    gains on it, for the kernels' checks at B lanes and Tk steps."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    rng = np.random.default_rng(seed)
    n, m = model.n, model.m
    f32 = dict(dtype=torch.float32, device=dev)
    if n == 4:
        x0 = (np.array([np.pi - 0.6, 0, 0, 0])[:, None]
              + np.array([0.2, 0.2, 0, 0])[:, None]
              * rng.standard_normal((4, B)))
        u = 2.0 * rng.standard_normal((Tk, 1, B))
    elif n == 6:
        x0 = np.ascontiguousarray(quad_x0(rng).T)
        u = 2.4525 + 1.5 * rng.standard_normal((Tk, 2, B))
    else:
        x0 = (np.linspace(0.5, 2.0, B)[None, :]
              + 0.3 * rng.standard_normal((n, B)))
        u = 0.5 * rng.standard_normal((Tk, m, B))
    x0 = torch.tensor(x0, **f32)
    gains0 = torch.cat([torch.tensor(u, **f32),
                        torch.zeros((Tk, m * n, B), device=dev)], dim=1)
    traj = fk.forward_lanes(torch.zeros((Tk, n + m, B), device=dev), gains0,
                            x0, torch.ones((1, B), device=dev), model=model,
                            lims=lims, emit_traj=True).traj
    gains = bk.backward_lanes(traj, torch.ones(B, device=dev), n=n, m=m,
                              reg_type=2, lims=lims, derivs_tiles=tiles,
                              emit="gains").out
    return x0, traj, gains


def ladder_phases(ph, dev, rec, counters, ilqg, builds, cpu_proc) -> dict:
    """The ladder group: K3 and K2 at A ∈ LADDER_AS against their plain
    versions at LADDER_T steps on the pendcart (bit for bit), LTI <10,2>,
    the quadrotor and the lowered quadrotor (KERNEL_TOL); K2 and K3 at
    A=11 against A=6 at the headline's shape; the headline fleet with
    ``ILQGConfig()``'s 11-α ladder, its 64 lanes against the CPU."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        default_alphas)
    ph.start("ladder-kernels", f"K3, K2 at A={LADDER_AS} against their plain "
             f"versions, B={B}, T={LADDER_T}")
    spec, qspec = PendCartSpec(), QuadrotorSpec()
    pend, ptiles = pendcart_lanes(spec), pendcart_derivs_tiles(spec)
    quad = quadrotor_lanes(qspec)
    qtiles = autodiff_derivs_tiles(quad)
    lspec = random_lti(0, n=LTI_N, m=LTI_M, T=LADDER_T, device=dev)
    cases = (("pendcart", pend, ptiles, LIMS, True),
             ("LTI <10,2>", lti_lanes(lspec), lti_derivs_tiles(lspec),
              LTI_LIMS, False),
             ("quadrotor", quad, qtiles, qspec.lims, False),
             ("lowered quadrotor", builds[0]["quad"], qtiles, qspec.lims,
              False))
    late_total = 0
    worst = {}
    for i, (label, model, tiles, lims, bits) in enumerate(cases):
        x0, traj, gains = ladder_inputs(model, tiles, lims, dev, LADDER_T,
                                        40 + i)
        odd = torch.arange(B, device=dev) % 2 == 1
        gains[:, :model.m, odd] *= -1.0
        for A in LADDER_AS:
            al = torch.tensor(np.random.default_rng(A).uniform(
                0.0, 1.0, (A, B)), dtype=torch.float32, device=dev)
            n0 = fk.forward_lanes.launches
            k = fk.forward_lanes(traj, gains, x0, al, model=model, lims=lims,
                                 emit_traj=True)
            check(fk.forward_lanes.launches - n0 == -(-A // 8),
                  f"K3 A={A}: {fk.forward_lanes.launches - n0} launches")
            p = fk.forward_lanes_ref(traj, gains, x0, al, model=model,
                                     lims=lims, emit_traj=True)
            kw = dict(model=model, alphas=default_alphas(0.2, -3.0, A),
                      reduce_ratio_min=0.0, lims=lims, gk=0, gK=model.m)
            lad = torch.tensor(kw["alphas"], device=dev)[:, None].expand(
                A, B).contiguous()
            # the kernel's own candidate totals (K2's pass 1 rolls each
            # candidate with K3's operations, so the same bits)
            ktot = fk.forward_lanes(traj, gains, x0, lad, model=model,
                                    lims=lims).totals
            ctot = torch.where(odd, ktot[:8].amin(0), traj[:, -1].sum(0))
            sel = torch.stack([
                -torch.ones(B, device=dev), torch.zeros(B, device=dev), ctot,
                (torch.arange(B, device=dev) % 3 != 1).float()])
            k2 = fk.linesearch_lanes(traj, gains, x0, sel, **kw)
            # its decision: the accept rule on those totals, bit for bit
            al_sel, found, dc, rt, al_eff = fk._accept(
                ktot, sel, kw["alphas"], 0.0)
            check_bits(f"{label} K2 A={A} decision", (k2.ls[:4], torch.stack(
                [al_sel, found.float(), dc, rt])), to="the accept rule on "
                "K3's totals")
            taken = k2.ls[1] > 0.5
            late = int((taken & (k2.ls[0] < np.float32(kw["alphas"][7]))
                        ).sum())
            late_total += late
            check(bool((k2.ls[0][taken & odd] < np.float32(
                kw["alphas"][7])).all()), f"{label} K2 A={A}: a lane took a "
                  "first-round α over the first round's lowest total")
            if bits:
                p2 = fk.linesearch_lanes_ref(traj, gains, x0, sel, **kw)
                check_bits(f"{label} A={A}", (k.totals, p.totals),
                           (k.traj, p.traj), (k2.traj, p2.traj),
                           (k2.ls, p2.ls))
                e = 0.0
            else:
                # the plain re-roll at the kernel's α_eff: near ties of the
                # old total may decide apart between the two versions
                p2 = fk.forward_lanes_ref(traj, gains, x0, al_eff[None],
                                          model=model, lims=lims,
                                          emit_traj=True)
                e = k_vs_plain(f"{label} A={A}", {
                    "K3 totals": (k.totals, p.totals),
                    "K3 traj": (k.traj, p.traj),
                    "K2 traj": (k2.traj, p2.traj),
                    "K2 total": (k2.ls[4], p2.totals[0])})
            worst[label] = max(worst.get(label, 0.0), e)
            print(f"  {label} A={A}: K3 {-(-A // 8)} launches, K2 one; "
                  f"{late} lanes took an α past the first round")
    check(late_total > 0, "no lane took a candidate past the first round")
    with_65 = False
    try:
        fk.linesearch_lanes(traj, gains, x0, sel, model=model,
                            alphas=default_alphas(0.2, -3.0, 65),
                            lims=lims)
    except ValueError as ex:
        with_65 = "65 alphas" in str(ex)
    check(with_65, "K2 took a 65-α ladder")
    print("  K2 refuses a 65-α ladder (ValueError)")

    # times at the headline's shape: A=11 against A=6
    x0, traj, gains = ladder_inputs(pend, ptiles, LIMS, dev, T, 50)
    sel = torch.stack([-torch.ones(B, device=dev), torch.zeros(B, device=dev),
                       traj[:, -1].sum(0), torch.ones(B, device=dev)])
    t = {}
    for A in (6, 11):
        lad = torch.tensor(default_alphas(0.2, -3.0, A), device=dev)[
            :, None].expand(A, B).contiguous()

        def k3(f=fk.forward_lanes, lad=lad):
            return f(traj, gains, x0, lad, model=pend, lims=LIMS)

        def k2(f=fk.linesearch_lanes, A=A):
            return f(traj, gains, x0, sel, model=pend,
                     alphas=default_alphas(0.2, -3.0, A),
                     reduce_ratio_min=0.0, lims=LIMS)
        t[A] = dict(k3=cuda_ms(k3, 20), k2=cuda_ms(k2, 20))
        if A == 11:
            a3, b3 = k3(), k3(fk.forward_lanes_ref)
            a2, b2 = k2(), k2(fk.linesearch_lanes_ref)
            check_bits("pendcart A=11 at T=500", (a3.totals, b3.totals),
                       (a2.traj, b2.traj), (a2.ls, b2.ls))
            plain = dict(k3=once_ms(lambda: k3(fk.forward_lanes_ref)),
                         k2=once_ms(lambda: k2(fk.linesearch_lanes_ref)))
    print(f"  at B={B}, T={T}: K2 A=11 {t[11]['k2']:.4f} ms against A=6 "
          f"{t[6]['k2']:.4f} ms ({t[11]['k2'] / t[6]['k2']:.2f}×); K3 sweep "
          f"A=11 {t[11]['k3']:.4f} ms (two launches) against A=6 "
          f"{t[6]['k3']:.4f} ms ({t[11]['k3'] / t[6]['k3']:.2f}×); plain "
          f"K2 {plain['k2']:.1f} ms, K3 {plain['k3']:.1f} ms")
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    print(f"  plans: K2 A=11 {plan_text(plan.linesearch_plan(4, 1, 11, T, B))}"
          f"; K3 A=11 groups {plan.k3_groups(11)}")
    rec["k2_pendcart_a11"] = dict(
        max_abs_err=0.0, ms=t[11]["k2"], plain_ms=plain["k2"],
        ms_a6=t[6]["k2"], library_ms=None, **k2_work(pend, T, B, 11))
    rec["k3_pendcart_a11"] = dict(
        max_abs_err=0.0, ms=t[11]["k3"], plain_ms=plain["k3"],
        ms_a6=t[6]["k3"], library_ms=None, **k3_work(pend, T, B, 11, False))
    rec["ladder_worst"] = worst

    ph.start("ladder-fleet", f"ilqg_batch_lanes, pendcart B={B} T={T}, "
             f"ILQGConfig()'s 11-α ladder, max_steps={ITERS}")
    cfg = ladder_cfg()
    check(len(cfg.alphas) == 11, "the default ladder is not 11 α")
    x0s = ilqg["x0s"]
    u0s = torch.zeros((B, T, 1), device=dev)

    def solve(x, u):
        return ilqg_batch_lanes(pend, None, x, u, lims=LIMS, cfg=cfg,
                                derivs_tiles=ptiles, max_steps=ITERS)

    solve(x0s, u0s)                         # warm-up
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed():
        s.record()
        out = solve(x0s, u0s)
        e.record()
        return out

    r, launches = counted(counters, timed)
    iters = int(r.n_iters.max())
    ms = s.elapsed_time(e)
    print(f"  launches: {launches}")
    print(f"  solve {ms:.3f} ms, {ms / max(iters, 1):.4f} ms/iter over "
          f"{iters} iterations, against the 6-α headline's "
          f"{ilqg['ms_iter']:.4f} ms/iter")
    ct = r.cost_total
    check(bool(torch.isfinite(ct[r.reason != 5]).all()), "non-finite cost")
    check(ct.median() < ilqg["cost_total"].median() * 1.5,
          "the 11-α fleet's median cost is far above the 6-α fleet's")
    print(f"  cost_total median {ct.median().item():.6g} (6-α "
          f"{ilqg['cost_total'].median().item():.6g}); reasons "
          f"{ {int(v): int(c) for v, c in zip(*torch.unique(r.reason, return_counts=True))} }")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the 11-α path never ran: {launches}")
    g = solve(x0s[:B_CPU], u0s[:B_CPU])
    agree_cpu("ladder-fleet", g, child_solves(cpu_proc)["ladder-fleet"])
    rec["ladder_fleet"] = dict(ms=ms, iters=iters,
                               ms_iter=ms / max(iters, 1))
    return {"ladder": launches}


def demos_phases(ph, dev, counters, cpu_proc) -> dict:
    """The demos group: ``demos.main``'s registry, help and exit codes;
    ``main(["boxqp"])``, ``main(["fleet"])`` and ``main(["quadrotor"])`` on
    the card at their defaults (B=4096), each counted; the fleet's and the
    quadrotor's first B_CPU lanes against the CPU child's solves (the
    quadrotor at T=QUAD_T_CPU); demo_mpc (lanes tier) at its
    defaults; demo_linear, demo_linear_kl and demo_pendcart cut
    (DEMO_CUTS)."""
    from differentialdynamicprogramming_jl_tpu_torch import demos
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    ph.start("demos", "the demos' tour on the card")
    check(demos.main(["--help"]) == 0, "demos --help")
    check(demos.main(["no-such-demo"]) == 2, "demos: unknown name")
    paths, walls = {}, {}
    for name in ("boxqp", "fleet", "quadrotor"):
        t0 = time.perf_counter()
        rc, paths[f"demos_{name}"] = counted(
            counters, lambda: demos.main([name]))
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"demos {name}: exit {rc}")
    check(paths["demos_fleet"]["backward_lanes"] > 0
          and paths["demos_quadrotor"]["backward_lanes"] > 0,
          f"the demos launched no K1: {paths}")
    res = demos.demo_fleet()
    check(res.x.shape == (B, T, 4), "demo_fleet: B=4096, T=500")
    check(bool(torch.isfinite(res.cost_total).all()), "demo_fleet: cost")
    c = child_solves(cpu_proc)
    agree_cpu("demo_fleet", res, c["demo-fleet"])
    q = demos.demo_quadrotor()
    qspec = QuadrotorSpec()
    check(q.u.shape == (B, QUAD_T, 2), "demo_quadrotor: B=4096, T=400")
    check(float(q.u.min()) >= qspec.lims[0][0]
          and float(q.u.max()) <= qspec.lims[0][1], "thrust box broken")
    check(bool(torch.isfinite(q.cost_total).all()), "demo_quadrotor: cost")
    print(f"  demo_quadrotor's first {B_CPU} lanes cut to "
          f"T={QUAD_T_CPU} on the card and on the CPU (the plain AD "
          f"tiles cost ≈80 ms a step there)")
    qm = quadrotor_lanes(qspec)
    qx, qu = demos._quad_inputs(B, QUAD_T_CPU, torch.float32, dev)
    g = ilqg_batch_lanes(qm, None, qx[:B_CPU], qu[:B_CPU], lims=qspec.lims,
                         cfg=demos._quad_cfg(30),
                         derivs_tiles=autodiff_derivs_tiles(qm))
    agree_cpu("demo_quadrotor", g, c["demo-quadrotor"])
    t0 = time.perf_counter()
    x, errs = demos.demo_mpc(device=dev)
    walls["mpc"] = time.perf_counter() - t0
    check(bool(torch.isfinite(x).all()) and len(errs) == 40, "demo_mpc")
    for name, fn in (("linear", demos.demo_linear),
                     ("linear_kl", demos.demo_linear_kl),
                     ("pendcart", demos.demo_pendcart)):
        cut = DEMO_CUTS[name]
        print(f"  {name}: cut to {cut}")
        t0 = time.perf_counter()
        r = fn(**cut)
        walls[name] = time.perf_counter() - t0
        check(bool(torch.isfinite(r.cost).all()), f"demo {name}: cost")
    print(f"  demo walls (s): "
          f"{ {k: round(v, 3) for k, v in walls.items()} }")
    return paths


AOT_SERVE = """
import sys, time
import numpy as np
import torch
from differentialdynamicprogramming_jl_tpu_torch.utils.aot import load_solver
d, n = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)
args = [torch.from_numpy(np.load(f"{d}/arg{i}.npy")).to(dev)
        for i in range(n)]
t0 = time.perf_counter()
serve = load_solver(f"{d}/solver.bin")
res = serve(*args)
torch.cuda.synchronize()
first = time.perf_counter() - t0
t0 = time.perf_counter()
res = serve(*args)
torch.cuda.synchronize()
again = time.perf_counter() - t0
try:
    serve(*[a[:-1] for a in args])
    refused = False
except ValueError as ex:
    refused = "shape mismatch" in str(ex)
for k, v in res._asdict().items():
    if isinstance(v, torch.Tensor):
        np.save(f"{d}/out_{k}.npy", v.cpu().numpy())
print(type(res).__name__, first, again, refused)
"""


def aot_phase(ph, dev, counters) -> dict:
    """The aot group: the headline lane solve and demo_linear's generic
    solve exported on the card, each served from its bytes here and in a
    fresh process that never defined its closure: bit for bit the direct
    call, the served times against the direct one, a wrong B refused with
    ValueError."""
    import os
    import tempfile
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        make_lti_problem, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, ilqg)
    from differentialdynamicprogramming_jl_tpu_torch.utils.aot import (
        deserialize_solver, export_solver)
    ph.start("aot", "export the headline lane solve and demo_linear's, serve "
             "each in a fresh process")
    spec = PendCartSpec()
    model, tiles = pendcart_lanes(spec), pendcart_derivs_tiles(spec)
    cfg = headline_cfg()

    def lanes(x0s, u0s):
        return ilqg_batch_lanes(model, None, x0s, u0s, lims=LIMS, cfg=cfg,
                                derivs_tiles=tiles, max_steps=ITERS)

    print(f"  demo_linear's solve cut to T={AOT_LINEAR_T} (its default "
          f"{LTI_T})")
    lspec = random_lti(0, n=LTI_N, m=LTI_M, T=AOT_LINEAR_T,
                       dtype=torch.float64, device=dev)
    prob = make_lti_problem(lspec, AOT_LINEAR_T)

    def linear(x0, u0):
        return ilqg(prob, x0, u0, cfg=ILQGConfig())

    x0s = torch.tensor(headline_x0(), dtype=torch.float32, device=dev)
    jobs = {"lanes": (lanes, (x0s, torch.zeros((B, T, 1), device=dev))),
            "linear": (linear, (lspec.x0.clone(), lspec.u0.clone()))}
    root = tempfile.mkdtemp(prefix="ddp_aot_")
    out, paths = {}, {}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    for name, (fn, args) in jobs.items():
        if name == "lanes":
            fn(*args)                           # warm-up
        (res, paths[f"aot_{name}"]), direct_s = wall(
            lambda: counted(counters, lambda: fn(*args)))
        ex = export_solver(fn, *args)
        blob = ex.serialize()
        print(f"  {name}: entry {ex.recipe['entry']}, {len(blob)} bytes, "
              f"{len(ex.consts)} constants, kernels "
              f"{ex.recipe['kernels']['launches']}")
        # served here, beside the direct call: the recipe's own overhead
        serve = deserialize_solver(blob)
        here, here_s = wall(lambda: serve(*args))
        check(type(here) is type(res), f"aot {name}: served a "
              f"{type(here).__name__}")
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "solver.bin"), "wb") as f:
            f.write(blob)
        for i, a in enumerate(args):
            np.save(os.path.join(d, f"arg{i}.npy"), a.cpu().numpy())
        # and in a fresh process that never defined fn
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-c", AOT_SERVE, d, str(len(args))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        CHILDREN.append(p)
        so, se = p.communicate(timeout=600)
        check(p.returncode == 0, f"aot {name}: the serving process failed "
              f"({p.returncode}): {se[-2000:]}")
        kind, first, again, refused = so.split()[-4:]
        check(refused == "True", f"aot {name}: a wrong B was not refused")
        check(kind == type(res).__name__,
              f"aot {name}: served a {kind}, not a {type(res).__name__}")
        fields = {k: (torch.from_numpy(np.load(os.path.join(
            d, f"out_{k}.npy"))), v.cpu())
            for k, v in res._asdict().items() if isinstance(v, torch.Tensor)}
        check(bits_or_parts(f"aot {name} served in a fresh process", fields),
              f"aot {name}: the served result is not the direct one")
        check(bits_or_parts(f"aot {name} served here", {
            k: (getattr(here, k), v) for k, v in res._asdict().items()
            if isinstance(v, torch.Tensor)}),
            f"aot {name}: the result served here is not the direct one")
        out[name] = dict(direct_s=direct_s, served_here_s=here_s,
                         served_first_s=float(first), served_s=float(again),
                         process_s=time.perf_counter() - t0)
        fresh = float(again)
        print(f"  {name}: direct {direct_s * 1e3:.1f} ms; served here "
              f"{here_s * 1e3:.1f} ms ({here_s / direct_s:.3f}×); in a fresh "
              f"process {fresh * 1e3:.1f} ms ({fresh / direct_s:.3f}×), its "
              f"first call with the library's load {float(first):.2f} s, the "
              f"process {out[name]['process_s']:.1f} s; a wrong B refused")
    return paths, out


# ---------------------------------------------------------------------------
# the sizes group: the lowering's later ops on the headline fleet (rail),
# the LTI at n=8 through its normal entries (lti8), and every new instance
# against its plain version (ops)
# ---------------------------------------------------------------------------

# the headline fleet on a finite rail (tools_torch/rail.py): u0 = 2·N(0,1)
# from a numpy seed of its own, so that lanes pass the rail's end in the
# initial rollout (the headline's u0 = 0 leaves the cart at p = 0); its
# CPU solves (the --sizes-cpu child) at RAIL_T_CPU
RAIL_SEED, RAIL_U0, RAIL_T_CPU = 61, 2.0, 24
# the LTI at n=8 (random_lti seed 0, T=LTI_T, ±0.6) and its packed solve's
# iteration budget
LTI8_N, LTI8_M, LTI8_PACKED_ITERS = 8, 2, 20
# K4 at every n of the ops phase beside plan.COV_MAX_N, and the packed K1's
# sizes there (one with m = MAX_M)
COV_NS = (1, 2, 3, 5, 8, 12, 16, 21, 32)
PACKED_SIZES = ((8, 2), (5, 4))
SIZES_T_PLAIN = LTI_T_PLAIN
# pow: the exponents PyTorch's CUDA kernel special-cases, whose emitted
# forms must give its bits; at the others both take libdevice's powf, and a
# pow model's K3 rollout is held to POW_ULPS of the plain one after
# SIZES_T_PLAIN steps (each step's ulp carried on)
POW_SPECIAL = (2.0, 3.0, 0.5, -1.0, -2.0, -0.5)
POW_ULPS = 8


def cov_max_n() -> int:
    """The largest n K4 takes (plan.COV_MAX_N)."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import plan
    return plan.COV_MAX_N


def sizes_models() -> dict:
    """The sizes group's models, none with a descriptor: the rail model
    over the headline pendcart, the LTI at ⟨8,2⟩ (random_lti seed 0, its
    plain lti_lanes and lti_derivs_tiles), the op-set model and the pow
    model (tools_torch/opset.py)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
        import LanesModel
    from tools_torch import opset, rail
    spec = random_lti(0, n=LTI8_N, m=LTI8_M, T=LTI_T, device="cpu")
    return dict(
        rail=rail.rail_lanes(torch, LanesModel,
                             pendcart_lanes(PendCartSpec())),
        lti8_spec=spec, lti8=lti_lanes(spec), lti8_tiles=lti_derivs_tiles(spec),
        opset=opset.opset_lanes(LanesModel),
        pow=opset.pow_lanes(LanesModel))


def start_sizes_builds(m: dict):
    """Lower the group's models and start every library it launches in a
    thread, one nvcc each, all together: the lowered rail (fwd, k1,
    k1_gps), LTI ⟨8,2⟩ (fwd, and its tiles' t1, t1_gps), op-set (fwd, k1,
    k1_so) and pow (fwd) models, K4 at each n of COV_NS and at COV_MAX_N,
    and the packed K1 at PACKED_SIZES. Then K4's build time, on copies of
    its sources: the library of one n alone, the libraries of all those n
    (one an n) at once, and one library of all n. Returns (thread, labels,
    box) as build_thread; the box also receives ``probe`` (those three
    walls)."""
    import threading
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, lower, plan)
    jobs, labels = [], []
    for key, groups in (("rail", ("fwd", "k1", "k1_gps")), ("lti8", ("fwd",)),
                        ("opset", ("fwd", "k1", "k1_so")), ("pow", ("fwd",))):
        low = lower.lower(m[key])
        for g in groups:
            jobs.append((_build.lowered_source(low.struct(g == "fwd"), g),
                         _build.LOWERED_HEADERS, "lowered"))
            labels.append(f"{key} {g}")
    lt = lower.lower_tiles(m["lti8_tiles"], LTI8_N, LTI8_M)
    for g in ("t1", "t1_gps"):
        jobs.append((_build.lowered_source(lt.struct(), g),
                     _build.LOWERED_HEADERS, "lowered"))
        labels.append(f"lti8 tiles {g}")
    ns = COV_NS + (plan.COV_MAX_N,)
    for n in ns:
        jobs.append(_build.covariance_job((n,)))
        labels.append(f"K4 n={n}")
    for n, mm in PACKED_SIZES:
        jobs.append(_build.packed_job(n, mm))
        labels.append(f"packed <{n},{mm}>")
    box: dict = {}

    def probe(src):
        """A copy of K4's source that builds a library of its own (the
        build-time probes leave the port's libraries as they are)."""
        source, headers, _ = src
        return source + "\n// build-time probe\n", headers, "cov_probe"

    def wall(jobs_):
        t0 = time.perf_counter()
        _build.build_generated(jobs_, "K4's build-time probe")
        return time.perf_counter() - t0

    def run():
        background()
        try:
            t0 = time.perf_counter()
            box["builds"] = _build.build_generated(jobs, "the sizes group")
            box["wall"] = time.perf_counter() - t0
            # K4's build time, after the group's builds: one n alone, one
            # library an n with all of them at once, one library of all n
            box["probe"] = dict(
                one_n=wall([probe(_build.covariance_job((LTI8_N,)))]),
                per_n=wall([probe(_build.covariance_job((n,)))
                            for n in ns]),
                all_n=wall([probe(_build.covariance_job(ns))]))
        except Exception as e:   # noqa: BLE001 - reported by the phase
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    BUILD_THREADS.append(th)
    return th, labels, box


def rail_inputs(device, Bk: int, Tk: int):
    """The rail fleet's x0 (the headline's) and u0 = RAIL_U0·N(0,1) (numpy
    seed RAIL_SEED, drawn for B lanes and T steps), on the first Bk lanes
    at horizon Tk."""
    rng = np.random.default_rng(RAIL_SEED)
    u0 = RAIL_U0 * rng.standard_normal((B, T, 1))
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(headline_x0()[:Bk], **f32),
            torch.tensor(u0[:Bk, :Tk], **f32))


def kl_tier_inputs(model, device, Bk: int, Tk: int):
    """The KL tier's inputs (kl_phases: x0 = default_x0 + 0.2·N(0,1) on θ
    and θ̇, u0 = 0.2·N(0,1), numpy seed 1) for ``model`` on the first Bk
    lanes at horizon Tk: the pre-roll by K3 at α=1 with k := u0 and no
    limits, the zero previous policy with k = its controls and unit Σ, the
    pendcart's Euler fx along it, and cost0."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, default_x0, make_pendcart_problem)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    rng = np.random.default_rng(1)
    x0_np = np.asarray(default_x0(device="cpu").numpy(),
                       np.float64)[None, :] + (
        0.2 * rng.standard_normal((B, 4)) * np.array([1.0, 1.0, 0, 0]))
    u0_np = 0.2 * rng.standard_normal((B, T, 1))
    f32 = dict(dtype=torch.float32, device=device)
    u0 = torch.tensor(u0_np[:Bk, :Tk], **f32)
    ro = fk.forward_lanes(
        torch.zeros((Tk, 5, Bk), **f32),
        torch.cat([to_streams(u0), torch.zeros((Tk, 4, Bk), **f32)], dim=1),
        torch.tensor(x0_np[:Bk].T.copy(), **f32), torch.ones((1, Bk), **f32),
        model=model, lims=None, emit_traj=True)
    x_pre = from_streams(ro.traj[:, :4], (4,)).contiguous()
    u_pre = from_streams(ro.traj[:, 4:5], (1,)).contiguous()
    fx = make_pendcart_problem(PendCartSpec(), derivs="euler",
                               device=device).derivs(x_pre, u_pre).fx
    ones = torch.ones((Bk, Tk, 1, 1), **f32)
    pol = GaussianPolicy(K=torch.zeros((Bk, Tk, 1, 4), **f32), k=u_pre,
                         sigma=ones, sigma_inv=ones)
    return (x_pre, pol, fx.contiguous(), ro.totals[0]), ro


def lti_fleet_kl_inputs(model, spec, x0s, u0s):
    """KL on an LTI at any size (KL-LTI's tier): the pre-roll by K3 at α=1
    with k := u0 and no limits, the zero previous policy with unit Σ and
    k = its controls, fx = A along the horizon, cost0."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        SimpleLTVModel)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        from_streams, to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.policy import (
        GaussianPolicy)
    Bk, Tk, m = u0s.shape
    n, dev = x0s.shape[1], x0s.device
    ro = fk.forward_lanes(
        torch.zeros((Tk, n + m + 1, Bk), device=dev),
        torch.cat([to_streams(u0s), torch.zeros((Tk, m * n, Bk), device=dev)],
                  dim=1), x0s.T.contiguous(), torch.ones((1, Bk), device=dev),
        model=model, lims=None, emit_traj=True)
    eye = torch.eye(m, device=dev).expand(Bk, Tk, m, m)
    pol = GaussianPolicy(K=torch.zeros((Bk, Tk, m, n), device=dev),
                         k=from_streams(ro.traj[:, n:n + m], (m,)).contiguous(),
                         sigma=eye, sigma_inv=eye)
    fx = SimpleLTVModel.from_lti(spec.A.to(dev), spec.B.to(dev), Tk).fx.expand(
        Bk, Tk, n, n)
    return (from_streams(ro.traj[:, :n], (n,)).contiguous(), pol, fx,
            ro.totals[0])


def sizes_cpu_solves() -> dict:
    """The sizes group's CPU plain solves on B_CPU lanes (the
    ``--sizes-cpu`` child): the rail fleet at RAIL_T_CPU and KL on it, the
    LTI ⟨8,2⟩ fleet, KL on it and its packed solve at LTI_T_CPU. Two host
    threads: the card's phases need the host too, and the group's checks
    come last in the run."""
    torch.set_num_threads(2)
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_packed_derivs)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    m = sizes_models()
    rail, spec = m["rail"], m["lti8_spec"]
    rtiles = autodiff_derivs_tiles(rail)
    x0r, u0r = rail_inputs("cpu", B_CPU, RAIL_T_CPU)
    x8, u8 = lti_fleet_inputs(spec, "cpu", B_CPU, LTI_T_CPU)
    runs = {
        "rail": lambda: ilqg_batch_lanes(
            rail, None, x0r, u0r, lims=LIMS, cfg=headline_cfg(),
            derivs_tiles=rtiles, max_steps=ITERS),
        "rail KL": lambda: ilqgkl_batch_lanes(
            rail, rtiles, *kl_tier_inputs(rail, "cpu", B_CPU, RAIL_T_CPU)[0],
            cfg=ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS)),
        "rail KL nudged": lambda: ilqgkl_batch_lanes(
            rail, rtiles, *nudged(kl_tier_inputs(rail, "cpu", B_CPU,
                                                 RAIL_T_CPU)[0]),
            cfg=ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS)),
        "lti8": lambda: ilqg_batch_lanes(
            m["lti8"], None, x8, u8, lims=LTI_LIMS, cfg=lti_cfg(),
            derivs_tiles=m["lti8_tiles"]),
        "lti8 KL": lambda: ilqgkl_batch_lanes(
            m["lti8"], m["lti8_tiles"],
            *lti_fleet_kl_inputs(m["lti8"], spec, x8, u8),
            cfg=ILQGKLConfig(kl_step=KL_LTI_STEP)),
        "lti8 packed": lambda: ilqg_batch_lanes(
            m["lti8"], lti_packed_derivs(spec), x8, u8, lims=LTI_LIMS,
            cfg=lti_cfg(), max_steps=LTI8_PACKED_ITERS)}
    out = {}
    for label, run in runs.items():
        t0 = time.perf_counter()
        r = run()
        out[label] = {f: getattr(r, f).tolist() for f in (
            ("cost_total", "satisfied", "n_iters") if "KL" in label
            else ("cost_total", "reason", "n_accepted"))}
        out[label]["seconds"] = time.perf_counter() - t0
    return out


def nudged(kl_inputs):
    """KL inputs with the pre-rolled states moved by one ulp (toward +∞):
    how far a solve's outcomes move under rounding alone."""
    x, pol, fx, cost0 = kl_inputs
    return (torch.nextafter(x, torch.full_like(x, math.inf)), pol, fx,
            cost0)


def graph_ops(model) -> dict:
    """model_ops of a model without a descriptor: the operations of its
    lowered graph (factories and copies not counted), a step's dynamics and
    cost; the expansion K1 forms counted as one evaluation of the cost's
    (its gradient costs at least that), no second-order term."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import lower
    low = lower.lower(model)
    skip = set(lower.FACTORIES) | set(lower.COPIES)

    def count(name):
        return sum(op.target not in skip for op in low.fns[name].ops)

    cost = count("cost")
    return dict(step=count("dynamics") + cost, derivs=cost, so=0)


def timed_path(counters, fn):
    """fn's result, launches and device ms (CUDA events), after a warm-up
    run."""
    fn()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))

    def run():
        s.record()
        out = fn()
        e.record()
        return out

    out, launches = counted(counters, run)
    return out, launches, s.elapsed_time(e)


def plain_once_ms(fn) -> float:
    """Host wall of one synchronised run of a plain version (ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# each kernel-against-plain comparison of the sizes group: bit-identical?
BITS: dict = {}


def lane_kernels(rec, tag: str, model, tiles, lims, x0_l, traj0, gains0,
                 A_ladder, lam, Tp: int, gps=None) -> torch.Tensor:
    """K3 (sweep of the ladder, rollout at α=1), K1 (gains, full; with
    ``gps`` = (prev, eta) also GPS policy) and K2 of ``model`` with
    ``tiles`` against their plain versions at the first Tp steps (K1's run
    once, in full emission, the other emission's slots selected from it):
    each
    output's bit-equality recorded in BITS, and where it is not bit-equal
    held to KERNEL_TOL (K1 to AD_SLOT_TOL on at most TIE_SHARE of the
    elements, Quu⁻¹ to QUU_INV_TOL), each timed at the streams' T; records k3_/k1_/k1_<tag>_gps/k2_<tag>. Returns the rollout
    stream."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    Tl, _, Bl = traj0.shape
    n, m = model.n, model.m
    A = A_ladder.shape[0]
    al1 = torch.ones((1, Bl), device=traj0.device)

    def fwd(al, emit, plain=False, Tk=Tl):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(traj0[:Tk], gains0[:Tk], x0_l, al, model=model, lims=lims,
                 emit_traj=emit)

    def held(what, pairs):
        """Bit for bit, or (printed) within KERNEL_TOL of each output."""
        same = all(torch.equal(a, b) for a, b in pairs.values())
        BITS[what] = same
        return (max(err(a, b)[0] for a, b in pairs.values()) if same
                else k_vs_plain(what, pairs))

    e3 = [held(f"K3 {tag} sweep A={A} at T={Tp}",
               {"totals": (fwd(A_ladder, False, False, Tp).totals,
                           fwd(A_ladder, False, True, Tp).totals)})]
    k, p = fwd(al1, True, False, Tp), fwd(al1, True, True, Tp)
    e3.append(held(f"K3 {tag} rollout at T={Tp}",
                   {"traj": (k.traj, p.traj), "totals": (k.totals, p.totals)}))
    ro = fwd(al1, True)
    traj, tot = ro.traj, ro.totals[0]
    ms3 = cuda_ms(lambda: fwd(A_ladder, False), 10)
    ms3r = cuda_ms(lambda: fwd(al1, True), 10)
    plain3 = plain_once_ms(lambda: fwd(A_ladder, False, True, Tp))
    w3, w3r = k3_work(model, Tl, Bl, A, False), k3_work(model, Tl, Bl, 1, True)
    rec[f"k3_{tag}"] = dict(max_abs_err=max(e3), ms=ms3, ms_rollout=ms3r,
                            plain_ms=plain3, plain_T=Tp, library_ms=None,
                            bound_ms_rollout=w3r["bound_ms"], **w3)
    print(f"  K3 {tag} at T={Tl}: sweep {ms3:.4f} ms, rollout {ms3r:.4f} ms "
          f"(bound {w3['bound_ms']:.4f}, {w3['bound_by']}); plain sweep at "
          f"T={Tp} {plain3:.1f} ms")

    def bwd(emit, tr=traj, plain=False, g=None):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        kw = (dict(prev=g[0][:tr.shape[0]], eta=g[1][:tr.shape[0]],
                   reg_type=1, lims=None) if g is not None
              else dict(reg_type=2, lims=lims))
        return f(tr, torch.zeros_like(lam) if g is not None else lam, n=n,
                 m=m, derivs_tiles=tiles, emit=emit, **kw)

    trp = traj[:Tp].contiguous()
    for key, g, emits in ((f"k1_{tag}", None, ("gains", "full")),
                          (f"k1_{tag}_gps", gps, ("policy", "full"))):
        if key.endswith("_gps") and gps is None:
            continue
        e1, runs = [], []
        # the plain version once, in "full" emission (timed): the other
        # emission's slots are a selection of its slots (k1_emitted)
        plain1 = plain_once_ms(lambda: runs.append(bwd("full", trp, True, g)))
        (p,) = runs
        for emit in emits:
            a, b = bwd(emit, trp, g=g), p._replace(out=k1_emitted(
                p.out, n, m, emit))
            what = f"K1 {tag} {emit}{' GPS' if g is not None else ''} at T={Tp}"
            same = torch.equal(a.out, b.out) and torch.equal(a.stats,
                                                             b.stats)
            BITS[what] = same
            print(f"  {what}: bit-identical to the plain version: {same}")
            if not same:
                lay = bk.OutLayout(n, m, emit)
                nq = lay.quui if lay.quui is not None else lay.S
                compare_slots_ties(what, a.out[:, :nq], b.out[:, :nq],
                                   AD_SLOT_TOL)
                if lay.quui is not None:
                    compare(what, {"Quu_inv": (a.out[:, nq:], b.out[:, nq:])},
                            QUU_INV_TOL)
            check(torch.equal(a.stats[2:], b.stats[2:]),
                  f"{what}: diverged/diverge_idx differ")
            e1.append(err(a.out, b.out)[0])
        ms1 = cuda_ms(lambda: bwd(emits[0], g=g), 10)
        ms1f = cuda_ms(lambda: bwd("full", g=g), 10)
        w1 = k1_work(model, Tl, Bl, emits[0], 1 if g is not None else 2,
                     None if g is not None else lims, gps=g is not None)
        w1f = k1_work(model, Tl, Bl, "full", 1 if g is not None else 2,
                      None if g is not None else lims, gps=g is not None)
        rec[key] = dict(max_abs_err=max(e1), ms=ms1, ms_full=ms1f,
                        bound_ms_full=w1f["bound_ms"], plain_ms=plain1,
                        plain_T=Tp, library_ms=None, **w1)
        print(f"  K1 {key} at T={Tl}: {emits[0]} {ms1:.4f} ms, full "
              f"{ms1f:.4f} ms (bound {w1['bound_ms']:.4f}, {w1['bound_by']});"
              f" plain full once at T={Tp} {plain1:.1f} ms")

    bo = bwd("gains")
    sel = torch.stack([bo.stats[0], bo.stats[1], tot,
                       (torch.arange(Bl, device=traj.device) % 2 == 0).float()])
    alphas = A_ladder[:, 0].tolist()

    def ls(plain=False, Tk=Tl):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(traj[:Tk], bo.out[:Tk], x0_l, sel, model=model,
                 alphas=alphas, reduce_ratio_min=0.0, lims=lims)

    a, b = ls(Tk=Tp), ls(True, Tp)
    e2 = held(f"K2 {tag} at T={Tp}", {"traj": (a.traj, b.traj),
                                       "ls": (a.ls, b.ls)})
    ms2 = cuda_ms(lambda: ls(), 10)
    plain2 = plain_once_ms(lambda: ls(True, Tp))
    w2 = k2_work(model, Tl, Bl, A)
    rec[f"k2_{tag}"] = dict(max_abs_err=e2, ms=ms2, plain_ms=plain2,
                            plain_T=Tp, library_ms=None, **w2)
    print(f"  K2 {tag} at T={Tl}: {ms2:.4f} ms (bound {w2['bound_ms']:.4f});"
          f" plain at T={Tp} {plain2:.1f} ms")
    return traj


def gps_inputs(rng, Tl: int, Bl: int, n: int, m: int, dev):
    """A previous-policy stream with every KL term non-zero (k, K, an SPD
    Σ⁻¹) and a per-step η in [0.1, 10], from ``rng``."""
    a_ = rng.standard_normal((Tl, Bl, m, m))
    si = np.einsum("tbij,tbkj->tbik", a_, a_) + 0.5 * np.eye(m)
    prev = torch.tensor(np.concatenate([
        rng.standard_normal((Tl, m, Bl)),
        0.5 * rng.standard_normal((Tl, m * n, Bl)),
        np.moveaxis(si.reshape(Tl, Bl, m * m), 1, 2)], axis=1),
        dtype=torch.float32, device=dev)
    eta = torch.tensor(10.0 ** rng.uniform(-1, 1, (Tl, Bl)),
                       dtype=torch.float32, device=dev)
    return prev, eta


def sizes_phases(ph, dev, rec, counters, builds, cpu_proc) -> dict:
    """Phases 58-61, the sizes group: sizes-build, rail, lti8 and ops.
    Returns the launches of the group's paths; adds ``sizes`` (the group's
    seconds, builds and outcomes) to ``rec``."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        device_model, lti_packed_derivs)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk,
        plan)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    from tools_torch import opset, rail as rail_mod

    t_group = time.perf_counter()
    sm, (th, labels, box) = builds
    out = dict(walls={})
    ph.start("sizes-build", "the sizes group's libraries, one nvcc each, "
             "started after the main build")
    th.join()
    if "error" in box:
        raise box["error"]
    lb = {}
    for label, b in zip(labels, box["builds"]):
        lines = ptxas_summary(b.log)
        print(f"  {label}: {b.seconds:.1f} s -> {b.path.name}")
        for line in lines:
            print(f"    {line}")
        lb[label] = dict(seconds=b.seconds, ptxas=lines)
    pr = box["probe"]
    k = len(COV_NS) + 1
    print(f"  K4 build time after the group's builds (wall): the library of "
          f"one n (n={LTI8_N}) {pr['one_n']:.1f} s; {k} libraries, one an n, "
          f"{k} nvcc at once {pr['per_n']:.1f} s; one library of all {k} n "
          f"{pr['all_n']:.1f} s. A launch needs its own n only, so the port "
          f"builds one library an n, at that n's first launch")
    rec["ptxas"] += [line for v in lb.values() for line in v["ptxas"]]
    out["builds"] = dict(libraries=lb, wall=box["wall"], k4_probe=pr)
    paths = {}
    rng = np.random.default_rng(71)
    cfg = headline_cfg()
    A = len(cfg.alphas)

    # ---- rail
    ph.start("rail", f"the headline fleet (pendcart, B={B}, T={T}, ±5, "
             f"reg_type 2, {A}-α ladder, {ITERS} iterations, u0 = "
             f"{RAIL_U0}·N(0,1)) on a finite rail: a Python-only model "
             f"(abs, clamp, pow, log, a comparison, where), its kernels "
             f"against their plain versions at T={SIZES_T_PLAIN}; then KL "
             f"on it at the KL tier's settings")
    t_ph = time.perf_counter()
    rm = sm["rail"]
    rtiles = autodiff_derivs_tiles(rm)
    x0s, u0s = rail_inputs(dev, B, T)
    x0_l = x0s.T.contiguous()
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=torch.float32,
                       device=dev)
    lam[::8] = 0.0
    gains0 = torch.cat([to_streams(u0s), torch.zeros((T, 4, B), device=dev)],
                       dim=1)
    gps = gps_inputs(rng, T, B, 4, 1, dev)
    traj = lane_kernels(rec, "rail", rm, rtiles, LIMS, x0_l,
                        torch.zeros((T, 5, B), device=dev), gains0,
                        ladder.contiguous(), lam, SIZES_T_PLAIN, gps=gps)
    x_init = traj[:, :4].permute(2, 0, 1)
    share0 = rail_mod.leaves_rail(x_init)
    band0 = (traj[:, 4].abs() > rail_mod.BAND).any(dim=0).float().mean().item()
    del gps

    def rsolve(x0=x0s, u0=u0s):
        return ilqg_batch_lanes(rm, None, x0, u0, lims=LIMS, cfg=cfg,
                                derivs_tiles=rtiles, max_steps=ITERS)

    r, launches, ms = timed_path(counters, rsolve)
    iters = int(r.n_iters.max())
    share1 = rail_mod.leaves_rail(r.x)
    reasons = {int(v): int(c) for v, c in zip(*torch.unique(
        r.reason, return_counts=True))}
    print(f"  launches: {launches}; solve {ms:.3f} ms, {ms / max(iters, 1):.4f}"
          f" ms/iter over {iters}; reasons {reasons}; cost median "
          f"{r.cost_total.median().item():.6g}")
    print(f"  lanes past the rail's end (|p| > {rail_mod.RAIL}): initial "
          f"rollout {share0:.4f}, after the solve {share1:.4f}; controls in "
          f"the band (|u| > {rail_mod.BAND}) in the initial rollout: "
          f"{band0:.4f}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the rail path never ran: {launches}")
    check(share0 > 0, "rail: no lane leaves the rail in the initial rollout")
    check(bool(torch.isfinite(r.cost_total).all()
               and (r.u.abs() <= 5.0).all()), "rail: bad result")
    paths["rail"] = launches
    out["rail"] = dict(solve_ms=ms, iters=iters, reasons=reasons,
                       leave_initial=share0, leave_after=share1,
                       band_initial=band0)
    x0c, u0c = rail_inputs(dev, B_CPU, RAIL_T_CPU)
    g = rsolve(x0c, u0c)
    c = child_solves(cpu_proc)["rail"]
    agree(f"rail {B_CPU} lanes at T={RAIL_T_CPU} ({c['seconds']:.1f} s in "
          f"the child)", {f: getattr(g, f).tolist() for f in (
              "cost_total", "reason", "n_accepted")}, c, "cost_total",
          ("reason", "n_accepted"))
    del r, g, traj
    kcfg = ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS)
    kin, _ = kl_tier_inputs(rm, dev, B, T)
    r, launches, ms = timed_path(counters, lambda: ilqgkl_batch_lanes(
        rm, rtiles, *kin, cfg=kcfg))
    print(f"  KL launches: {launches}; KL solve {ms:.3f} ms, n_iters max "
          f"{int(r.n_iters.max())}; satisfied {r.satisfied.float().mean().item():.4f}"
          f"; cost median {r.cost_total.median().item():.6g} against cost0 "
          f"median {kin[3].median().item():.6g}")
    check(launches["covariance_lanes"] == 1 and launches["backward_lanes"] >= 1
          and launches["forward_lanes"] >= 1,
          f"a kernel of the rail KL path never ran: {launches}")
    check(bool(torch.isfinite(r.cost_total).all()), "rail KL: non-finite")
    paths["rail_kl"] = launches
    out["rail"]["kl_ms"] = ms
    kc, _ = kl_tier_inputs(rm, dev, B_CPU, RAIL_T_CPU)
    g = ilqgkl_batch_lanes(rm, rtiles, *kc, cfg=kcfg)
    c = child_solves(cpu_proc)["rail KL"]
    # this KL solve is chaotic at one ulp: the host's own solve from states
    # one ulp away agrees with it on these shares only, and the card is
    # held to the host at least as closely (or to AGREE_SHARE, where that
    # is lower)
    kl_fields = ("satisfied", "n_iters")
    self_shares = shares(child_solves(cpu_proc)["rail KL nudged"], c,
                         "cost_total", kl_fields)
    print(f"  rail KL on the host against itself from states one ulp away: "
          f"shares cost within {COST_RTOL:.0e} {self_shares[0]:.3f}, same "
          f"satisfied {self_shares[1]:.3f}, same n_iters "
          f"{self_shares[2]:.3f}")
    out["rail"]["kl_self_shares"] = self_shares
    agree(f"rail KL {B_CPU} lanes at T={RAIL_T_CPU} ({c['seconds']:.1f} s in "
          f"the child)", {f: getattr(g, f).tolist() for f in (
              "cost_total",) + kl_fields}, c, "cost_total", kl_fields,
          need=[min(AGREE_SHARE, v) for v in self_shares])
    del r, g, kin, kc
    out["walls"]["rail"] = time.perf_counter() - t_ph

    # ---- lti8
    spec = sm["lti8_spec"]
    spec = spec._replace(**{k: getattr(spec, k).to(dev) for k in spec._fields})
    n, m, Tl = LTI8_N, LTI8_M, LTI_T
    ph.start("lti8", f"random_lti(0, n={n}, m={m}, T={Tl}) through the plain "
             f"lti_lanes and lti_derivs_tiles (no descriptor at this size: "
             f"the lowering runs), B={B}, ±0.6, reg_type 2: its kernels "
             f"against their plain versions at T={SIZES_T_PLAIN}; the fleet "
             f"to convergence, KL on it (kl_step {KL_LTI_STEP}; K4 n={n}), "
             f"the packed solve (Packed<{n},{m}>, {LTI8_PACKED_ITERS} "
             f"iterations)")
    t_ph = time.perf_counter()
    lm, ltiles = sm["lti8"], sm["lti8_tiles"]
    check(lm.device is None and ltiles.device is None,
          "lti8: the LTI's lane objects carry a descriptor at n=8")
    lcfg = lti_cfg()
    A8 = len(lcfg.alphas)
    x8, u8 = lti_fleet_inputs(spec, dev, B, Tl)
    x8_l = x8.T.contiguous()
    gains8 = torch.cat([to_streams(u8 + 0.3 * torch.tensor(
        rng.standard_normal((B, Tl, m)), dtype=torch.float32, device=dev)),
        torch.zeros((Tl, m * n, B), device=dev)], dim=1)
    ladder8 = torch.tensor(lcfg.alphas, device=dev)[:, None].expand(A8, B)
    gps = gps_inputs(rng, Tl, B, n, m, dev)
    # the bound of an LTI <8,2> as the hand-written LTI forms it
    traj8 = lane_kernels(rec, "lti8", lm, ltiles, LTI_LIMS, x8_l,
                         torch.zeros((Tl, n + m, B), device=dev), gains8,
                         ladder8.contiguous(), lam, SIZES_T_PLAIN, gps=gps)
    del gps
    # K4 at n=8 on A along the horizon, and the packed K1 <8,2> on the
    # rollout's packed stream
    fx8 = to_streams(spec.A.expand(B, Tl, n, n).contiguous())
    k4_check(rec, "k4_8", fx8, n)
    dp = lti_packed_derivs(spec)(traj8[:, :n], traj8[:, n:n + m])
    packed_check(rec, "k1_packed_8_2", dp, lam, n, m, LTI_LIMS,
                 SIZES_T_PLAIN, device_model(spec))
    del dp, traj8, fx8

    def lsolve(tiles=ltiles, gen=None, x0=x8, u0=u8, steps=None):
        return ilqg_batch_lanes(lm, gen, x0, u0, lims=LTI_LIMS, cfg=lcfg,
                                derivs_tiles=tiles, max_steps=steps)

    cpu8 = child_solves(cpu_proc)
    xc, uc = lti_fleet_inputs(spec, dev, B_CPU, LTI_T_CPU)
    r, launches, ms = timed_path(counters, lsolve)
    iters = int(r.n_iters.max())
    print(f"  fleet: launches {launches}; solve {ms:.3f} ms, n_iters max "
          f"{iters}; reasons {dict(zip(*(v.tolist() for v in torch.unique(r.reason, return_counts=True))))}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the lti8 path never ran: {launches}")
    check(bool(torch.isfinite(r.cost_total).all()
               and (r.u.abs() <= 0.6).all()), "lti8: bad result")
    paths["lti8"] = launches
    out["lti8"] = dict(solve_ms=ms, iters=iters)
    g = lsolve(x0=xc, u0=uc)
    c = cpu8["lti8"]
    agree(f"lti8 {B_CPU} lanes at T={LTI_T_CPU} ({c['seconds']:.1f} s in the "
          f"child)", {f: getattr(g, f).tolist() for f in (
              "cost_total", "reason", "n_accepted")}, c, "cost_total",
          ("reason", "n_accepted"))
    del r, g
    kcfg8 = ILQGKLConfig(kl_step=KL_LTI_STEP)
    r, launches, ms = timed_path(counters, lambda: ilqgkl_batch_lanes(
        lm, ltiles, *lti_fleet_kl_inputs(lm, spec, x8, u8), cfg=kcfg8))
    print(f"  KL: launches {launches}; solve {ms:.3f} ms, n_iters max "
          f"{int(r.n_iters.max())}; satisfied "
          f"{r.satisfied.float().mean().item():.4f}")
    check(launches["covariance_lanes"] == 1 and launches["backward_lanes"]
          >= 1, f"a kernel of the lti8 KL path never ran: {launches}")
    check(bool(torch.isfinite(r.cost_total).all()), "lti8 KL: non-finite")
    paths["lti8_kl"] = launches
    out["lti8"]["kl_ms"] = ms
    g = ilqgkl_batch_lanes(lm, ltiles, *lti_fleet_kl_inputs(lm, spec, xc, uc),
                           cfg=kcfg8)
    c = cpu8["lti8 KL"]
    agree(f"lti8 KL {B_CPU} lanes at T={LTI_T_CPU}", {f: getattr(
        g, f).tolist() for f in ("cost_total", "satisfied", "n_iters")}, c,
          "cost_total", ("satisfied", "n_iters"))
    del r, g
    gen = lti_packed_derivs(spec)
    r, launches, ms = timed_path(counters, lambda: lsolve(
        None, gen, steps=LTI8_PACKED_ITERS))
    print(f"  packed: launches {launches}; solve {ms:.3f} ms over "
          f"{int(r.n_iters.max())} iterations; cost median "
          f"{r.cost_total.median().item():.6g}")
    check(launches["backward_lanes"] > 0, f"lti8 packed: K1 never ran "
          f"{launches}")
    check(bool(torch.isfinite(r.cost_total).all()), "lti8 packed: non-finite")
    paths["lti8_packed"] = launches
    out["lti8"]["packed_ms"] = ms
    g = lsolve(None, gen, xc, uc, LTI8_PACKED_ITERS)
    c = cpu8["lti8 packed"]
    agree(f"lti8 packed {B_CPU} lanes at T={LTI_T_CPU}", {f: getattr(
        g, f).tolist() for f in ("cost_total", "reason", "n_accepted")}, c,
          "cost_total", ("reason", "n_accepted"))
    del r, g
    out["walls"]["lti8"] = time.perf_counter() - t_ph

    # ---- ops
    Tp = SIZES_T_PLAIN
    ph.start("ops", f"kernel against plain at T={Tp}, B={B}: the op-set "
             f"model's K3, K1 (Dual and Jet) and K2; pow against torch.pow "
             f"at {opset.POW_EXPONENTS}; K4 at n in "
             f"{COV_NS + (plan.COV_MAX_N,)}; Packed at {PACKED_SIZES}")
    t_ph = time.perf_counter()
    om = sm["opset"]
    olims = ((-3.0, 3.0), (-3.0, 3.0))
    ox0 = torch.tensor(rng.standard_normal((3, B)), dtype=torch.float32,
                       device=dev)
    og = torch.cat([torch.tensor(1.5 * rng.standard_normal((Tp, 2, B)),
                                 dtype=torch.float32, device=dev),
                    torch.zeros((Tp, 6, B), device=dev)], dim=1)
    oladder = ladder.contiguous()
    for key, so in (("opset", False), ("opset_so", True)):
        _, launches = counted(counters, lambda: lane_kernels(
            rec, key, om, autodiff_derivs_tiles(om, second_order=so), olims,
            ox0, torch.zeros((Tp, 5, B), device=dev), og, oladder, lam, Tp))
        for k in (f"k3_{key}", f"k1_{key}", f"k2_{key}"):
            rec[k]["phase_launches"] = launches[
                {"3": "forward_lanes", "1": "backward_lanes",
                 "2": "linesearch_lanes"}[k[1]]]
    # the Jet instance's K3/K2 are the Dual one's (one fwd library)
    rec.pop("k3_opset_so")
    rec.pop("k2_opset_so")
    pm = sm["pow"]
    px0 = torch.tensor(rng.uniform(-1.0, 1.0, (pm.n, B)), dtype=torch.float32,
                       device=dev)

    def pfwd(plain=False):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(torch.zeros((Tp, pm.n + 2, B), device=dev),
                 torch.zeros((Tp, 1 + pm.n, B), device=dev), px0,
                 torch.ones((1, B), device=dev), model=pm, lims=None,
                 emit_traj=True)

    (k, p), launches = counted(counters, lambda: (pfwd(), pfwd(True)))
    check(bool(torch.isfinite(k.traj).all()), "pow: non-finite rollout")
    same = {e: bool(torch.equal(k.traj[:, i], p.traj[:, i]))
            for i, e in enumerate(opset.POW_EXPONENTS)}
    print(f"  pow: powc_ bit-equal to torch.pow on the card, by exponent: "
          f"{same}")
    for i, e in enumerate(opset.POW_EXPONENTS):
        if not same[e]:
            a, b = k.traj[:, i], p.traj[:, i]
            ulp = (a.view(torch.int32).long() - b.view(torch.int32).long()
                   ).abs().max().item()
            print(f"  pow e={e}: {ulp} ulp at most after {Tp} steps")
            check(e not in POW_SPECIAL and ulp <= POW_ULPS,
                  f"pow e={e}: {ulp} ulp from torch.pow")
    w3 = k3_work(pm, Tp, B, 1, True)
    rec["k3_pow"] = dict(max_abs_err=err(k.traj, p.traj)[0],
                         ms=cuda_ms(pfwd, 10), plain_ms=plain_once_ms(
                             lambda: pfwd(True)), library_ms=None,
                         phase_launches=launches["forward_lanes"], **w3)
    out["pow_bits"] = {str(e): v for e, v in same.items()}
    del k, p
    for n in COV_NS + (plan.COV_MAX_N,):
        if n == LTI8_N:
            continue
        gen = torch.Generator(device=dev).manual_seed(100 + n)
        fx = (0.6 * torch.eye(n, device=dev).reshape(1, n * n, 1)
              + (0.3 / math.sqrt(n)) * torch.randn(
                  (Tp, n * n, B), generator=gen, device=dev))
        _, launches = counted(counters, lambda: k4_check(
            rec, f"k4_{n}", fx, n))
        rec[f"k4_{n}"]["phase_launches"] = launches["covariance_lanes"]
        del fx
    for n, mm in PACKED_SIZES:
        if (n, mm) == (LTI8_N, LTI8_M):
            continue
        from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
            lti_lanes, random_lti)
        pspec = random_lti(2, n=n, m=mm, T=Tp, device=dev)
        plims = ((-0.6, 0.6),) * mm
        pg = torch.cat([torch.tensor(rng.standard_normal((Tp, mm, B)),
                                     dtype=torch.float32, device=dev),
                        torch.zeros((Tp, mm * n, B), device=dev)], dim=1)
        tr = fk.forward_lanes(
            torch.zeros((Tp, n + mm + 1, B), device=dev), pg,
            torch.ones((n, B), device=dev) * torch.linspace(
                0.5, 2.0, B, device=dev), torch.ones((1, B), device=dev),
            model=lti_lanes(pspec), lims=plims, emit_traj=True).traj
        dp = lti_packed_derivs(pspec)(tr[:, :n], tr[:, n:n + mm])
        _, launches = counted(counters, lambda: packed_check(
            rec, f"k1_packed_{n}_{mm}", dp, lam, n, mm, plims, Tp,
            device_model(pspec)))
        rec[f"k1_packed_{n}_{mm}"]["phase_launches"] = launches[
            "backward_lanes"]
        del dp, tr
    out["walls"]["ops"] = time.perf_counter() - t_ph
    out["seconds"] = time.perf_counter() - t_group
    print(f"  the sizes group: {out['seconds']:.1f} s (rail "
          f"{out['walls']['rail']:.1f}, lti8 {out['walls']['lti8']:.1f}, ops "
          f"{out['walls']['ops']:.1f}; the rest waited for the builds)")
    out["bits"] = dict(BITS)
    rec["sizes"] = out
    return paths


def packed_check(rec, key: str, dp, lam, n: int, m: int, lims, Tp: int,
                 dm) -> None:
    """K1 on the packed stream ``dp`` (T, D+m, B) at ⟨n,m⟩ (Packed<n,m>,
    a library built at its first launch) against its plain version at the
    first Tp steps, gains and full (the plain version run once, in full
    emission): bit for bit where they are, else within KERNEL_TOL of each
    slot's scale (QUU_INV_TOL for Quu⁻¹); timed at the stream's T. The
    bound is the LTI's with ``dm``'s descriptor."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    Tl, _, Bl = dp.shape

    def run(emit, d=dp, plain=False):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(d, lam, n=n, m=m, reg_type=2, lims=lims, derivs_tiles=None,
                 emit=emit)

    dpp = dp[:Tp].contiguous()
    e, runs = [], []
    # the plain version once, in "full" emission (timed): "gains" is a
    # selection of its slots (k1_emitted)
    plain = plain_once_ms(lambda: runs.append(run("full", dpp, True)))
    (p,) = runs
    for emit in ("gains", "full"):
        a, b = run(emit, dpp), p._replace(out=k1_emitted(p.out, n, m, emit))
        lay = bk.OutLayout(n, m, emit)
        nq = lay.quui if lay.quui is not None else lay.S
        what = f"K1 packed <{n},{m}> {emit} at T={Tp}"
        BITS[what] = bool(torch.equal(a.out, b.out)
                          and torch.equal(a.stats, b.stats))
        e.append(k_vs_plain(what, {"out": (a.out[:, :nq], b.out[:, :nq]),
                                   "dV": (a.stats[:2], b.stats[:2])}))
        if lay.quui is not None:
            e.append(k_vs_plain(what, {"Quu_inv": (a.out[:, nq:],
                                                   b.out[:, nq:])},
                                QUU_INV_TOL))
        check(torch.equal(a.stats[2:], b.stats[2:]),
              f"{what}: diverged/diverge_idx differ")
    ms = cuda_ms(lambda: run("gains"), 10)
    msf = cuda_ms(lambda: run("full"), 10)
    hand = fk.LanesModel(n=n, m=m, dynamics=None, cost=None, device=dm)
    w = k1_work(hand, Tl, Bl, "gains", 2, lims, packed=True)
    wf = k1_work(hand, Tl, Bl, "full", 2, lims, packed=True)
    rec[key] = dict(max_abs_err=max(e), ms=ms, ms_full=msf,
                    bound_ms_full=wf["bound_ms"], plain_ms=plain, plain_T=Tp,
                    library_ms=None, **w)
    print(f"  {key} at T={Tl}: gains {ms:.4f} ms, full {msf:.4f} ms (bound "
          f"{w['bound_ms']:.4f}, {w['bound_by']}); plain full once at T={Tp} "
          f"{plain:.1f} ms")


# ---------------------------------------------------------------------------
# the controls group: m above the kernel library's MAX_M = 4, each size
# from libraries generated for its own m (csrc/common.cuh DDP_MAX_M), up
# to m = 16 (the ceiling plan.MAX_CONTROLS is 32, checked in the humanoid
# group); and the tie model (JAX's derivative rules at ties)
# ---------------------------------------------------------------------------

# the checks with no path: K1, K2 and K3 of random_lti(1) at each
# tools_torch/controls.SIZES against their plain versions at CONTROLS_T
# steps, B scenarios, and at the larger sizes at fewer steps: the plain K1
# takes 5.6 s for 33 steps at <6,5>, 18.4 s for 33 at <10,8> and 41.1 s
# for 17 at <16,16> on the card, while the rings turn over several chunks
# (K1's tc 16 at <6,5>, 2 chunks; with four compute warps at most 2 at
# <10,8> and 1 at <16,16>; K2's and K3's at most 8)
CONTROLS_T = LTI_T_PLAIN
CONTROLS_T_BY_SIZE = {(6, 5): 17, (10, 8): 5, (16, 16): 3}
# arm7: random_lti(0, n=14, m=7) at ARM_T steps, B scenarios, ±0.6 on
# every control, the LTI fleet's ILQGConfig with a budget of ARM_ITERS
# iterations (max_steps); its CPU child solves B_CPU lanes at ARM_T_CPU
# on CPU tensors; cut from the LTI family's T=1000 to 100: K1 `gains` at
# <14,7> took 394 ms a launch at T=500 (unrolled, four compute warps), and
# the 20-iteration solve launched it 187 times (166 λ-retries of the
# fleet), 70.8 s of a 98.2 s phase; its budget cut from 20 iterations to
# 10 for the humanoid group (158 K1 launches of 230.55 ms at 20)
ARM_T, ARM_ITERS, ARM_T_CPU = 100, 10, 8
# the arm's kernels against their plain versions at ARM_T_PLAIN steps (its
# plain K1 takes 22.7 s for 33 steps on the card; K1's ring has tc 1)
ARM_T_PLAIN = 9
ARM_LIMS = ((-0.6, 0.6),) * 7
# the tie model's fleet: the headline's B, T, x0, ±5 and ILQGConfig from
# u0 = 0, ITERS iterations; its kernel checks put k = 0 (|u|'s tie) on
# TIE_ZERO_SHARE of the steps and k = TIE_K·N(0,1) elsewhere, which the
# ±5 clamp saturates on most; its CPU child solves B_CPU lanes at
# TIES_T_CPU
TIES_T_CPU, TIE_ZERO_SHARE, TIE_K = 8, 1 / 3, 8.0


def control_sizes():
    """The (n, m) of the checks with no path (tools_torch/controls.py)."""
    from tools_torch import controls
    return controls.SIZES


def controls_models() -> dict:
    """The group's models, none with a descriptor: at each controls.SIZES
    random_lti(1)'s lti_lanes, lti_derivs_tiles and their second-order
    tiles (controls.so_tiles); the arm (random_lti(0, n=14, m=7,
    T=ARM_T)); the tie model over the headline pendcart
    (tools_torch/ties.py)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
        import DerivsTiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
        import LanesModel
    from tools_torch import controls, ties
    out = {}
    for n, m in controls.SIZES:
        spec = random_lti(1, n=n, m=m, T=CONTROLS_T, device="cpu")
        tiles = lti_derivs_tiles(spec)
        out[(n, m)] = dict(spec=spec, model=lti_lanes(spec), tiles=tiles,
                           so=controls.so_tiles(DerivsTiles, tiles, n, m))
    n, m = controls.ARM
    spec = random_lti(0, n=n, m=m, T=ARM_T, device="cpu")
    out["arm"] = dict(spec=spec, model=lti_lanes(spec),
                      tiles=lti_derivs_tiles(spec))
    out["ties"] = ties.tie_lanes(torch, LanesModel,
                                 pendcart_lanes(PendCartSpec()))
    return out


def start_controls_builds(cm: dict):
    """Lower the group's models and tiles and start every library it
    launches in a thread, one nvcc each, all together: per size the
    lowered model (fwd) and the tiles' t1, t1_gps and second-order t1_so;
    the arm's fwd, t1 and t1_gps and K4 at n=14; the packed K1 at ⟨6,5⟩
    and ⟨10,8⟩; the tie model's fwd and k1. Returns (thread, labels, box)
    as start_sizes_builds."""
    import threading
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, lower)
    from tools_torch import controls
    structs, labels = [], []
    for n, m in controls.SIZES:
        c = cm[(n, m)]
        lt = lower.lower_tiles(c["tiles"], n, m).struct()
        structs += [(lower.lower(c["model"]).struct(True), "fwd"),
                    (lt, "t1"), (lt, "t1_gps"),
                    (lower.lower_tiles(c["so"], n, m).struct(), "t1_so")]
        labels += [f"<{n},{m}> {g}" for g in ("fwd", "t1", "t1_gps",
                                              "t1_so")]
    n, m = controls.ARM
    lt = lower.lower_tiles(cm["arm"]["tiles"], n, m).struct()
    structs += [(lower.lower(cm["arm"]["model"]).struct(True), "fwd"),
                (lt, "t1"), (lt, "t1_gps")]
    labels += [f"arm <{n},{m}> {g}" for g in ("fwd", "t1", "t1_gps")]
    low = lower.lower(cm["ties"])
    structs += [(low.struct(True), "fwd"), (low.struct(False), "k1")]
    labels += ["ties fwd", "ties k1"]
    jobs = [(_build.lowered_source(s, g), _build.LOWERED_HEADERS, "lowered")
            for s, g in structs]
    jobs.append(_build.covariance_job((n,)))
    labels.append(f"K4 n={n}")
    for pn, pm in ((6, 5), (10, 8)):
        jobs.append(_build.packed_job(pn, pm))
        labels.append(f"packed <{pn},{pm}>")
    box: dict = {}

    def run():
        background()
        try:
            t0 = time.perf_counter()
            box["builds"] = _build.build_generated(jobs, "the controls group")
            box["wall"] = time.perf_counter() - t0
        except Exception as e:   # noqa: BLE001 - reported by the phase
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    BUILD_THREADS.append(th)
    return th, labels, box


def controls_cpu_solves() -> dict:
    """The group's CPU plain solves on B_CPU lanes (the ``--controls-cpu``
    child): the arm fleet at ARM_T_CPU with ARM_ITERS iterations and KL on
    it, and the tie model's fleet at TIES_T_CPU with ITERS iterations. Two
    host threads."""
    torch.set_num_threads(2)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    from tools_torch import ties
    cm = controls_models()
    arm = cm["arm"]
    xa, ua = lti_fleet_inputs(arm["spec"], "cpu", B_CPU, ARM_T_CPU)
    tm = cm["ties"]
    xt = torch.tensor(headline_x0()[:B_CPU], dtype=torch.float32)
    runs = {
        "arm7": lambda: ilqg_batch_lanes(
            arm["model"], None, xa, ua, lims=ARM_LIMS, cfg=lti_cfg(),
            derivs_tiles=arm["tiles"], max_steps=ARM_ITERS),
        "arm7 KL": lambda: ilqgkl_batch_lanes(
            arm["model"], arm["tiles"],
            *lti_fleet_kl_inputs(arm["model"], arm["spec"], xa, ua),
            cfg=ILQGKLConfig(kl_step=KL_LTI_STEP)),
        "ties": lambda: ilqg_batch_lanes(
            tm, None, xt, torch.zeros((B_CPU, TIES_T_CPU, 1)),
            lims=ties.LIMS, cfg=headline_cfg(),
            derivs_tiles=autodiff_derivs_tiles(tm), max_steps=ITERS)}
    out = {}
    for label, run in runs.items():
        t0 = time.perf_counter()
        r = run()
        out[label] = {f: getattr(r, f).tolist() for f in (
            ("cost_total", "satisfied", "n_iters") if "KL" in label
            else ("cost_total", "reason", "n_accepted"))}
        out[label]["seconds"] = time.perf_counter() - t0
    return out


def bits_or_fail(what: str, pairs) -> float:
    """Each output of ``pairs`` {name: (kernel's, plain's)} bit-equal to
    its plain version (recorded in BITS), else the check fails; returns
    the max abs error (0)."""
    same = all(torch.equal(a, b) for a, b in pairs.values())
    BITS[what] = same
    if not same:
        k_vs_plain(what, pairs)
    check(same, f"{what}: not bit-equal to its plain version")
    return max(err(a, b)[0] for a, b in pairs.values())


def many_kernels(rec, tag: str, c: dict, n: int, m: int, Tc: int, lam,
                 rng, dev) -> dict:
    """The checks with no path at one size: K3 (the 6-α sweep, the
    rollout), K1 LoweredTiles (gains, full, policy with ±0.6; GPS full and
    policy, per-step η; second-order tiles, gains and full; each family's
    plain version run once, in full emission, the others' slots taken from
    it) and K2 (A = 6 and 11), at Tc steps and B scenarios, each bit for
    bit its plain version. Records k3_/k1_/k1_*_gps/k1_*_so/k2_/k2_*_a11
    with their launches in this phase; returns the phase's launches."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        default_alphas)
    from tools_torch import controls
    model, tiles, so = c["model"], c["tiles"], c["so"]
    lims = ((-controls.BOX, controls.BOX),) * m
    x0, gains0 = controls.lti_inputs(n, m, Tc, B, 10 * n + m, dev)
    cfg = lti_cfg()
    A = len(cfg.alphas)
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(
        A, B).contiguous()
    al1 = torch.ones((1, B), device=dev)
    traj0 = torch.zeros((Tc, n + m + 1, B), device=dev)
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes)
    own = {}

    def fwd(al, emit, plain=False):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(traj0, gains0, x0, al, model=model, lims=lims,
                 emit_traj=emit)

    (k, p), l3 = counted(counters, lambda: (fwd(ladder, False),
                                            fwd(ladder, False, True)))
    e3 = bits_or_fail(f"K3 {tag} sweep", {"totals": (k.totals, p.totals),
                                          "terminal": (k.terminal,
                                                       p.terminal)})
    (k, p), l3r = counted(counters, lambda: (fwd(al1, True),
                                             fwd(al1, True, True)))
    e3 = max(e3, bits_or_fail(f"K3 {tag} rollout", {
        "traj": (k.traj, p.traj), "totals": (k.totals, p.totals)}))
    traj, tot = k.traj, k.totals[0]
    w3, w3r = k3_work(model, Tc, B, A, False), k3_work(model, Tc, B, 1, True)
    rec[f"k3_{tag}"] = dict(
        max_abs_err=e3, ms=cuda_ms(lambda: fwd(ladder, False), 10),
        ms_rollout=cuda_ms(lambda: fwd(al1, True), 10),
        plain_ms=plain_once_ms(lambda: fwd(ladder, False, True)),
        plain_T=Tc, library_ms=None, bound_ms_rollout=w3r["bound_ms"],
        phase_launches=l3["forward_lanes"] + l3r["forward_lanes"], **w3)
    prev, eta = gps_inputs(rng, Tc, B, n, m, dev)
    lam0 = torch.zeros(B, device=dev)
    fams = (("", dict(derivs_tiles=tiles, reg_type=2, lims=lims, lm=lam),
             ("gains", "full", "policy")),
            ("_gps", dict(derivs_tiles=tiles, reg_type=1, lims=None,
                          prev=prev, eta=eta, lm=lam0), ("policy", "full")),
            ("_so", dict(derivs_tiles=so, reg_type=2, lims=lims, lm=lam),
             ("gains", "full")))
    gains = None
    for suffix, kw, emits in fams:
        kw = dict(kw)
        lm = kw.pop("lm")

        def bwd(emit, plain=False):
            f = bk.backward_lanes_ref if plain else bk.backward_lanes
            return f(traj, lm, n=n, m=m, emit=emit, **kw)

        runs = []
        plain = plain_once_ms(lambda: runs.append(bwd("full", True)))
        (pf,) = runs
        e1, launches = [], 0
        for emit in emits:
            a, l1 = counted(counters, lambda: bwd(emit))
            launches += l1["backward_lanes"]
            b = k1_emitted(pf.out, n, m, emit)
            e1.append(bits_or_fail(f"K1 {tag}{suffix} {emit}", {
                "out": (a.out, b), "stats": (a.stats, pf.stats)}))
            if suffix == "" and emit == "gains":
                gains = a
        gps, so_ = suffix == "_gps", suffix == "_so"
        w = k1_work(model, Tc, B, emits[0], kw["reg_type"], kw["lims"],
                    gps=gps, so=so_)
        wf = k1_work(model, Tc, B, "full", kw["reg_type"], kw["lims"],
                     gps=gps, so=so_)
        rec[f"k1_{tag}{suffix}"] = dict(
            max_abs_err=max(e1), ms=cuda_ms(lambda: bwd(emits[0]), 10),
            ms_full=cuda_ms(lambda: bwd("full"), 10),
            bound_ms_full=wf["bound_ms"], plain_ms=plain, plain_T=Tc,
            library_ms=None, phase_launches=launches, **w)
        own[f"k1{suffix}"] = launches
    sel = torch.stack([gains.stats[0], gains.stats[1], tot,
                       (torch.arange(B, device=dev) % 2 == 0).float()])
    for suffix, alphas in (("", cfg.alphas),
                           ("_a11", default_alphas(0.2, -3.0, 11))):
        def ls(plain=False):
            f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
            return f(traj, gains.out, x0, sel, model=model, alphas=alphas,
                     reduce_ratio_min=0.0, lims=lims)

        (a, b), l2 = counted(counters, lambda: (ls(), ls(True)))
        e2 = bits_or_fail(f"K2 {tag} A={len(alphas)}", {
            "traj": (a.traj, b.traj), "ls": (a.ls, b.ls)})
        rec[f"k2_{tag}{suffix}"] = dict(
            max_abs_err=e2, ms=cuda_ms(ls, 10), plain_ms=plain_once_ms(
                lambda: ls(True)), plain_T=Tc, library_ms=None,
            phase_launches=l2["linesearch_lanes"],
            **k2_work(model, Tc, B, len(alphas)))
    for key in (f"k3_{tag}", f"k1_{tag}", f"k1_{tag}_gps", f"k1_{tag}_so",
                f"k2_{tag}", f"k2_{tag}_a11"):
        r = rec[key]
        print(f"  {key} at T={Tc}: {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f}, {r['bound_by']}); plain once "
              f"{r['plain_ms']:.1f} ms")
    return traj


def controls_phases(ph, dev, rec, counters, builds, cpu_proc) -> dict:
    """The controls group: controls-build, controls-kernels, arm7 and
    ties. Returns the launches of its paths; adds ``controls`` (the
    group's seconds, builds and outcomes) to ``rec``."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        device_model, lti_packed_derivs)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    from tools_torch import controls, ties

    t_group = time.perf_counter()
    cm, (th, labels, box) = builds
    out = dict(walls={})
    ph.start("controls-build", "the controls group's libraries, one nvcc "
             "each, started after the quadrotor phases")
    th.join()
    if "error" in box:
        raise box["error"]
    lb = {}
    for label, b in zip(labels, box["builds"]):
        lines = ptxas_summary(b.log)
        print(f"  {label}: {b.seconds:.1f} s -> {b.path.name}")
        for line in lines:
            print(f"    {line}")
        lb[label] = dict(seconds=b.seconds, ptxas=lines)
    out["builds"] = dict(libraries=lb, wall=box["wall"])
    rng = np.random.default_rng(91)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=torch.float32,
                       device=dev)
    lam[::8] = 0.0
    paths = {}

    # ---- controls-kernels
    ph.start("controls-kernels", f"random_lti(1) at (n, m) in "
             f"{controls.SIZES} without a descriptor, B={B}, T by size "
             f"{CONTROLS_T_BY_SIZE}: K3, K1 LoweredTiles (gains, "
             f"full, policy; GPS full, policy; second order gains, full) and "
             f"K2 (A=6, 11) bit for bit against their plain versions; "
             f"Packed<6,5> and <10,8>; m=33 refused before any build")
    t_ph = time.perf_counter()
    for n, m in controls.SIZES:
        c = cm[(n, m)]
        c["spec"] = c["spec"]._replace(**{k: getattr(c["spec"], k).to(dev)
                                          for k in c["spec"]._fields})
        Tc = CONTROLS_T_BY_SIZE[(n, m)]
        t_s = time.perf_counter()
        traj = many_kernels(rec, f"c{n}_{m}", c, n, m, Tc, lam, rng, dev)
        if (n, m) in ((6, 5), (10, 8)):
            dp = lti_packed_derivs(c["spec"])(traj[:, :n], traj[:, n:n + m])
            lims = ((-controls.BOX, controls.BOX),) * m
            _, launches = counted(counters, lambda: packed_check(
                rec, f"k1_packed_{n}_{m}", dp, lam, n, m, lims, Tc,
                device_model(c["spec"])))
            rec[f"k1_packed_{n}_{m}"]["phase_launches"] = launches[
                "backward_lanes"]
            for emit in ("gains", "full"):
                what = f"K1 packed <{n},{m}> {emit} at T={Tc}"
                check(BITS[what], f"{what}: not bit-equal")
            del dp
        out["walls"][f"<{n},{m}>"] = time.perf_counter() - t_s
        del traj
    out["refusal"] = refused_before_build(dev, 4, 33, "MAX_CONTROLS = 32")
    print(f"  m=33: {out['refusal']}")
    out["walls"]["kernels"] = time.perf_counter() - t_ph

    # ---- arm7
    n, m = controls.ARM
    arm = cm["arm"]
    spec = arm["spec"]._replace(**{k: getattr(arm["spec"], k).to(dev)
                                   for k in arm["spec"]._fields})
    model, tiles = arm["model"], arm["tiles"]
    acfg = lti_cfg()
    A = len(acfg.alphas)
    ph.start("arm7", f"random_lti(0, n={n}, m={m}, T={ARM_T}) (a 7-joint "
             f"arm's shape) through lti_lanes and lti_derivs_tiles (no "
             f"descriptor: LoweredTiles K1, lowered K2/K3), B={B}, ±0.6, "
             f"reg_type 2: its kernels against their plain versions at "
             f"T={ARM_T_PLAIN}; the fleet with a budget of {ARM_ITERS} "
             f"iterations; KL on it (kl_step {KL_LTI_STEP}, scalar η, no "
             f"limits; K4 n={n}, K1 GPS policy at m={m})")
    t_ph = time.perf_counter()
    check(model.device is None and tiles.device is None,
          "arm7: the LTI's lane objects carry a descriptor")
    x0s, u0s = lti_fleet_inputs(spec, dev, B, ARM_T)
    x0_l = x0s.T.contiguous()
    gains0 = torch.cat([to_streams(u0s + 0.3 * torch.tensor(
        rng.standard_normal((B, ARM_T, m)), dtype=torch.float32,
        device=dev)), torch.zeros((ARM_T, m * n, B), device=dev)], dim=1)
    ladder = torch.tensor(acfg.alphas, device=dev)[:, None].expand(A, B)
    gps = gps_inputs(rng, ARM_T, B, n, m, dev)
    traj = lane_kernels(rec, "arm7", model, tiles, ARM_LIMS, x0_l,
                        torch.zeros((ARM_T, n + m, B), device=dev), gains0,
                        ladder.contiguous(), lam, ARM_T_PLAIN, gps=gps)
    del gps, traj
    for what, same in BITS.items():
        if " arm7 " in what:
            check(same, f"{what}: not bit-equal to its plain version")
    fx = to_streams(spec.A.expand(B, ARM_T, n, n).contiguous())
    k4_check(rec, "k4_14", fx, n)
    del fx

    def asolve(x0=x0s, u0=u0s):
        return ilqg_batch_lanes(model, None, x0, u0, lims=ARM_LIMS,
                                cfg=acfg, derivs_tiles=tiles,
                                max_steps=ARM_ITERS)

    r, rr = once_run(asolve, counters)
    iters = int(r.n_iters.max())
    k1 = rr["launches"]["backward_lanes"]
    at = r.u.abs() == 0.6
    print(f"  fleet: launches {rr['launches']}; solve {rr['ms']:.3f} ms, "
          f"{rr['ms'] / max(iters, 1):.3f} ms/iteration over {iters}; K1 "
          f"{k1} launches ({k1 - 1 - iters} λ-retries of the fleet); "
          f"reasons {hist(r.reason)}; peak {rr['peak_bytes'] / 2**30:.3f} "
          f"GiB; {rr['syncs']} host syncs; share of steps with a clamp "
          f"active {at.any(dim=2).float().mean().item():.4f}; cost median "
          f"{r.cost_total.median().item():.6g}")
    for key in ("k1_arm7", "k2_arm7", "k3_arm7"):
        print(f"  {key} at T={ARM_T}: {rec[key]['ms']:.4f} ms against its "
              f"bound {rec[key]['bound_ms']:.4f} ms ({rec[key]['bound_by']})")
    check(all(rr["launches"][c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the arm7 path never ran: {rr['launches']}")
    check(bool(torch.isfinite(r.cost_total).all()
               and (r.u.abs() <= 0.6).all()), "arm7: bad result")
    paths["arm7"] = rr["launches"]
    out["arm7"] = dict(solve_ms=rr["ms"], iters=iters, k1_launches=k1,
                       lam_retries=k1 - 1 - iters,
                       peak_bytes=rr["peak_bytes"], syncs=rr["syncs"],
                       reasons=hist(r.reason))
    del r
    cpu = child_solves(cpu_proc)
    xc, uc = lti_fleet_inputs(spec, dev, B_CPU, ARM_T_CPU)
    g = asolve(xc, uc)
    c = cpu["arm7"]
    agree(f"arm7 {B_CPU} lanes at T={ARM_T_CPU} ({c['seconds']:.1f} s in "
          f"the child)", {f: getattr(g, f).tolist() for f in (
              "cost_total", "reason", "n_accepted")}, c, "cost_total",
          ("reason", "n_accepted"))
    kcfg = ILQGKLConfig(kl_step=KL_LTI_STEP)
    kin = lti_fleet_kl_inputs(model, spec, x0s, u0s)
    r, rk = once_run(lambda: ilqgkl_batch_lanes(model, tiles, *kin,
                                                cfg=kcfg), counters)
    print(f"  KL: launches {rk['launches']}; {rk['ms']:.3f} ms a KL solve, "
          f"n_iters max {int(r.n_iters.max())}; satisfied "
          f"{r.satisfied.float().mean().item():.4f}; peak "
          f"{rk['peak_bytes'] / 2**30:.3f} GiB")
    check(rk["launches"]["covariance_lanes"] == 1
          and rk["launches"]["backward_lanes"] >= 1,
          f"a kernel of the arm7 KL path never ran: {rk['launches']}")
    check(bool(torch.isfinite(r.cost_total).all()), "arm7 KL: non-finite")
    paths["arm7_kl"] = rk["launches"]
    out["arm7"].update(kl_ms=rk["ms"], kl_peak_bytes=rk["peak_bytes"],
                       kl_iters=int(r.n_iters.max()))
    del r, kin
    g = ilqgkl_batch_lanes(model, tiles, *lti_fleet_kl_inputs(model, spec, xc, uc),
                           cfg=kcfg)
    agree(f"arm7 KL {B_CPU} lanes at T={ARM_T_CPU}", {f: getattr(
        g, f).tolist() for f in ("cost_total", "satisfied", "n_iters")},
          cpu["arm7 KL"], "cost_total", ("satisfied", "n_iters"))
    out["walls"]["arm7"] = time.perf_counter() - t_ph

    # ---- ties
    tm = cm["ties"]
    cfg = headline_cfg()
    A = len(cfg.alphas)
    ph.start("ties", f"the tie model (tools_torch/ties.py: u clamped to "
             f"±{ties.LIM} in the dynamics, {ties.L1}·|u| in the cost), "
             f"Autodiff<Lowered>: K3, K1 (Dual and Jet passes) and K2 "
             f"against their plain versions at T={CONTROLS_T} with the "
             f"controls on their ties; the headline fleet from u0 = 0 "
             f"(B={B}, T={T}, ±5, {ITERS} iterations); the rail's K1 still "
             f"bit-equal")
    t_ph = time.perf_counter()
    ttiles = autodiff_derivs_tiles(tm)
    x0t = torch.tensor(headline_x0(), dtype=torch.float32, device=dev)
    k = TIE_K * rng.standard_normal((B, T, 1))
    k[rng.uniform(size=(B, T, 1)) < TIE_ZERO_SHARE] = 0.0
    gains0 = torch.cat([to_streams(torch.tensor(k, dtype=torch.float32,
                                                device=dev)),
                        torch.zeros((T, 4, B), device=dev)], dim=1)
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    traj = lane_kernels(rec, "ties", tm, ttiles, ties.LIMS, x0t.T.contiguous(),
                        torch.zeros((T, 5, B), device=dev), gains0,
                        ladder.contiguous(), lam, CONTROLS_T)
    count = ties.tie_count(traj[:CONTROLS_T])
    print(f"  steps at a tie in the K1 checks (T={CONTROLS_T}): u = 0 "
          f"{count['zero']}, |u| = {ties.LIM} {count['bound']}, of "
          f"{count['steps']}")
    check(count["zero"] > 0 and count["bound"] > 0, "ties: no step at a tie")
    for what, same in BITS.items():
        if " ties " in what or " rail " in what:
            check(same, f"{what}: not bit-equal to its plain version")
    out["ties"] = dict(tie_steps=count)
    del traj

    def tsolve(x0=x0t, Tk=T):
        return ilqg_batch_lanes(tm, None, x0, torch.zeros(
            (x0.shape[0], Tk, 1), device=dev), lims=ties.LIMS, cfg=cfg,
            derivs_tiles=ttiles, max_steps=ITERS)

    r, launches, ms = timed_path(counters, tsolve)
    iters = int(r.n_iters.max())
    print(f"  fleet: launches {launches}; solve {ms:.3f} ms, "
          f"{ms / max(iters, 1):.4f} ms/iter over {iters}; reasons "
          f"{hist(r.reason)}; cost median {r.cost_total.median().item():.6g};"
          f" share of steps with u = 0 {(r.u == 0).float().mean().item():.4f}"
          f", with |u| = {ties.LIM} "
          f"{(r.u.abs() == ties.LIM).float().mean().item():.4f}")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the ties path never ran: {launches}")
    check(bool(torch.isfinite(r.cost_total).all()
               and (r.u.abs() <= ties.LIM).all()), "ties: bad result")
    paths["ties"] = launches
    out["ties"].update(solve_ms=ms, iters=iters, reasons=hist(r.reason))
    del r
    g = tsolve(x0t[:B_CPU], TIES_T_CPU)
    c = cpu["ties"]
    agree(f"ties {B_CPU} lanes at T={TIES_T_CPU} ({c['seconds']:.1f} s in "
          f"the child)", {f: getattr(g, f).tolist() for f in (
              "cost_total", "reason", "n_accepted")}, c, "cost_total",
          ("reason", "n_accepted"))
    out["walls"]["ties"] = time.perf_counter() - t_ph
    out["seconds"] = time.perf_counter() - t_group
    print(f"  the controls group: {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in out["walls"].items()) + ")")
    rec["ptxas"] += [line for v in lb.values() for line in v["ptxas"]]
    for v in lb.values():
        v.pop("ptxas")
    rec["controls"] = out
    return paths


# ---- the humanoid group (tools_torch/wide.py): K1's wide design, K2 and
# K3 past their ring, and the humanoid's LTI through iLQG and KL
# the path: random_lti(0, n=54, m=21, T=HUMANOID_T), ±0.6 on every control,
# HUMANOID_B scenarios, the LTI fleet's ILQGConfig with a budget of
# HUMANOID_ITERS iterations; KL on it at KL-LTI's settings. Its CPU child
# solves HUMANOID_B_CPU lanes at HUMANOID_T_CPU with the plain versions
HUMANOID_B, HUMANOID_T, HUMANOID_ITERS = 512, 100, 10
HUMANOID_B_CPU, HUMANOID_T_CPU = 16, 4
HUMANOID_LIMS = ((-0.6, 0.6),) * 21
# the wide K1's checks against its plain version on the card (T, B), the
# ⟨54,21⟩ and ceiling checks' (T, B), K2's and K3's (T, B)
WIDE_T_PLAIN, WIDE_B = 3, 512
WIDE_CPU_T, WIDE_CPU_B = 2, 8
K23_T_PLAIN = 3


def humanoid_models() -> dict:
    """The group's models, none with a descriptor (lti_lanes,
    lti_derivs_tiles): the humanoid (random_lti(0) at wide.HUMANOID, T =
    HUMANOID_T), the ceiling's K2/K3 model (wide.sparse_lti at
    wide.CEILING) and the wide K1's checks (random_lti(1) at each of
    wide.CHECKS)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        LTISpec, lti_derivs_tiles, lti_lanes, random_lti)
    from tools_torch import wide
    out = {}
    for key, spec in (("humanoid", random_lti(0, n=wide.HUMANOID[0],
                                              m=wide.HUMANOID[1],
                                              T=HUMANOID_T, device="cpu")),
                      ("ceiling", wide.sparse_lti(LTISpec, *wide.CEILING, 2,
                                                  "cpu"))):
        out[key] = dict(spec=spec, model=lti_lanes(spec),
                        tiles=lti_derivs_tiles(spec))
    for n, m in wide.CHECKS:
        out[(n, m)] = lti_derivs_tiles(random_lti(1, n=n, m=m,
                                                  T=WIDE_T_PLAIN,
                                                  device="cpu"))
    return out


HUMANOID_LIBRARIES = ("wide K1", "humanoid <54,21> fwd",
                      "ceiling <64,32> fwd")


def humanoid_builds() -> dict:
    """The group's libraries (the ``--humanoid-build`` child): K1's wide
    library, and the lowered K2/K3 (fwd) of the humanoid and of the
    ceiling's model, one nvcc each, all together. The lowering runs here
    and not in a thread of the card's process: the humanoid's
    8050-operation dynamics take seconds to trace, and a thread holding the
    interpreter's lock slowed that process's host-bound phases (kl-kernels
    94.4 s against 28.0). Its libraries land where the card's process
    finds them; that process lowers the models again at their first
    launch."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, lower)
    hm = humanoid_models()
    t0 = time.perf_counter()
    jobs = [_build.wide_job()] + [
        (_build.lowered_source(lower.lower(hm[k]["model"]).struct(True),
                               "fwd"), _build.LOWERED_HEADERS, "lowered")
        for k in ("humanoid", "ceiling")]
    lowering = time.perf_counter() - t0
    builds = _build.build_generated(jobs, "the humanoid group")
    return dict(lowering=lowering, wall=time.perf_counter() - t0,
                builds=[dict(seconds=b.seconds, name=b.path.name,
                             log=b.log) for b in builds])


def wide_cpu_inputs(dev):
    """The ⟨54,21⟩ and ceiling checks' K1 inputs (tools_torch/wide.py),
    the same in this process and in the CPU child, by (n, m): (the
    modes checked, the trajectory, λ, prev, η, random_lti(0)'s tiles).
    ⟨54,21⟩ "gains" with ±0.6 and GPS "policy" (the humanoid's two paths),
    the ceiling "gains" with ±0.6."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, random_lti)
    from tools_torch import wide
    out = {}
    for nm, modes in ((wide.HUMANOID, ("gains", "gps policy")),
                      (wide.CEILING, ("gains",))):
        spec = random_lti(0, n=nm[0], m=nm[1], T=WIDE_CPU_T, device=dev)
        out[nm] = (modes,) + wide.k1_inputs(*nm, WIDE_CPU_T, WIDE_CPU_B, 11,
                                            dev) + (lti_derivs_tiles(spec),)
    return out


def wide_cpu_kw(mode: str, m: int, prev, eta) -> dict:
    """backward_lanes' keywords of a check of wide_cpu_inputs."""
    if mode == "gains":
        return dict(reg_type=2, lims=((-0.6, 0.6),) * m, emit="gains")
    return dict(reg_type=1, lims=None, prev=prev, eta=eta, emit="policy")


def early_cpu_solves() -> dict:
    """The plain solves that the early phases' card solves are compared
    with at the end of the run (the ``--early-cpu`` child, started with the
    build), on CPU tensors from the inputs the card's solves take:
    ``"ilqg"``, the headline fleet on B_CPU lanes (T, ITERS iterations);
    ``"quad"``, the quadrotor fleet on B_CPU lanes at QUAD_T_CPU; ``"kl"``,
    the KL tier on B_CPU lanes (T, KL_ITERS iterations; its pre-roll
    by the plain K3 on the host); ``"lti"`` and ``"kl_lti"``, the LTI fleet
    and KL on it on B_CPU lanes at LTI_T_CPU."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_derivs_tiles_param,
        pendcart_lanes, pendcart_lanes_param)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    torch.set_num_threads(1)
    cfg = headline_cfg()
    spec = PendCartSpec()
    pmodel, ptiles = pendcart_lanes(spec), pendcart_derivs_tiles(spec)
    qspec = QuadrotorSpec()
    qmodel = quadrotor_lanes(qspec)
    x0q = torch.tensor(quad_x0(np.random.default_rng(11)),
                       dtype=torch.float32)[:B_CPU]
    lspec = random_lti(0, n=LTI_N, m=LTI_M, T=LTI_T, device="cpu")
    lmodel, ltiles = lti_lanes(lspec), lti_derivs_tiles(lspec)
    x0l, u0l = lti_fleet_inputs(lspec, "cpu", B_CPU, LTI_T_CPU)
    x0h, u0h, parh, limh = hetero_inputs("cpu", B_CPU, T)
    runs = {
        "ilqg": lambda: ilqg_batch_lanes(
            pmodel, None,
            torch.tensor(headline_x0()[:B_CPU], dtype=torch.float32),
            torch.zeros((B_CPU, T, 1)), lims=LIMS, cfg=cfg,
            derivs_tiles=ptiles, max_steps=ITERS),
        "quad": lambda: ilqg_batch_lanes(
            qmodel, None, x0q, torch.full((B_CPU, QUAD_T_CPU, 2),
                                          qspec.u_hover),
            lims=qspec.lims, cfg=cfg,
            derivs_tiles=autodiff_derivs_tiles(qmodel), max_steps=ITERS),
        "kl": lambda: ilqgkl_batch_lanes(
            pmodel, ptiles, *kl_tier_inputs(pmodel, "cpu", B_CPU, T)[0],
            cfg=ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS)),
        "lti": lambda: ilqg_batch_lanes(
            lmodel, None, x0l, u0l, lims=LTI_LIMS, cfg=lti_cfg(),
            derivs_tiles=ltiles),
        "kl_lti": lambda: ilqgkl_batch_lanes(
            lmodel, ltiles, *lti_fleet_kl_inputs(lmodel, lspec, x0l, u0l),
            cfg=ILQGKLConfig(kl_step=KL_LTI_STEP)),
        "hetero": lambda: ilqg_batch_lanes(
            pendcart_lanes_param(spec), None, x0h, u0h, lims=limh, cfg=cfg,
            derivs_tiles=pendcart_derivs_tiles_param(spec), params=parh,
            max_steps=ITERS)}
    out = {}
    for label, run in runs.items():
        t0 = time.perf_counter()
        out[label] = early_fields(label, run())
        out[label]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["mpc"] = mpc_cpu_loop()
    out["mpc"]["seconds"] = time.perf_counter() - t0
    return out


def early_fields(label: str, r) -> dict:
    """The outcomes early-gpu-vs-cpu compares: cost, reason and accepted
    count for iLQG; cost, satisfied and iterations for KL."""
    fields = (("cost_total", "satisfied", "n_iters") if "kl" in label
              else ("cost_total", "reason", "n_accepted"))
    return {f: getattr(r, f).tolist() for f in fields}


def early_gpu_vs_cpu(ph, cpu_proc, gpu: dict) -> None:
    """The early phases' comparisons, made at the end of the run: the
    card's solves ``gpu`` (label: result) against the ``--early-cpu``
    child's, which ran beside the phases at its low priority; the share of
    lanes with the cost within COST_RTOL and with the same reason and
    accepted count (KL: satisfied and iterations) must each reach
    AGREE_SHARE."""
    ph.start("early-gpu-vs-cpu", f"the first {B_CPU} scenarios of the iLQG "
             f"(T={T}), quadrotor (T={QUAD_T_CPU}), KL (T={T}), LTI and "
             f"KL-on-LTI (T={LTI_T_CPU}), heterogeneous (T={T}) paths and of "
             f"the MPC loop "
             f"({MPC_CPU_STEPS} steps): the card's solves of the early "
             "phases against the --early-cpu child's")
    cpu = child_solves(cpu_proc)
    for label, g in gpu.items():
        c = cpu[label]
        print(f"  {label}: CPU solve (plain versions) {c['seconds']:.1f} s "
              f"in the child")
        if label == "mpc":
            mpc_agree(g, c)
            continue
        agree(label, early_fields(label, g), c, "cost_total",
              ("satisfied", "n_iters") if "kl" in label
              else ("reason", "n_accepted"))


def humanoid_cpu_solves() -> dict:
    """The group's plain versions on the host (the ``--humanoid-cpu``
    child): K1 at ⟨54,21⟩ and at the ceiling on wide_cpu_inputs
    ("gains", ±0.6), and the humanoid fleet and KL on HUMANOID_B_CPU lanes
    at HUMANOID_T_CPU. Two host threads."""
    torch.set_num_threads(2)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    out = {}
    for (n, m), (modes, traj, lam, prev, eta, tiles) in wide_cpu_inputs(
            "cpu").items():
        for mode in modes:
            t0 = time.perf_counter()
            r = bk.backward_lanes_ref(traj, lam, n=n, m=m, derivs_tiles=tiles,
                                      **wide_cpu_kw(mode, m, prev, eta))
            out[f"k1 <{n},{m}> {mode}"] = dict(
                out=r.out.tolist(), stats=r.stats.tolist(),
                seconds=time.perf_counter() - t0)
    h = humanoid_models()["humanoid"]
    xc, uc = lti_fleet_inputs(h["spec"], "cpu", HUMANOID_B_CPU,
                              HUMANOID_T_CPU)
    runs = {
        "humanoid": lambda: ilqg_batch_lanes(
            h["model"], None, xc, uc, lims=HUMANOID_LIMS, cfg=lti_cfg(),
            derivs_tiles=h["tiles"], max_steps=HUMANOID_ITERS),
        "humanoid KL": lambda: ilqgkl_batch_lanes(
            h["model"], h["tiles"],
            *lti_fleet_kl_inputs(h["model"], h["spec"], xc, uc),
            cfg=ILQGKLConfig(kl_step=KL_LTI_STEP))}
    for label, run in runs.items():
        t0 = time.perf_counter()
        r = run()
        out[label] = {f: getattr(r, f).tolist() for f in (
            ("cost_total", "satisfied", "n_iters") if "KL" in label
            else ("cost_total", "reason", "n_accepted"))}
        out[label]["seconds"] = time.perf_counter() - t0
    return out


def refused_before_build(dev, n: int, m: int, what: str) -> str:
    """An (n, m) above a ceiling on CUDA tensors: K1's, K3's and K2's
    entries raise NotImplementedError naming it (``what``) before anything
    is lowered or built. Returns K3's message."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build, backward_kernel as bk, forward_kernel as fk, lower)
    spec = random_lti(1, n=n, m=m, T=4, device=dev)
    calls, msgs = [], []
    saved = (_build.build_generated, lower.lower, lower.lower_tiles)
    _build.build_generated = lambda *a, **k: calls.append("build")
    lower.lower = lambda *a, **k: calls.append("lower")
    lower.lower_tiles = lambda *a, **k: calls.append("lower")
    f32 = dict(dtype=torch.float32, device=dev)
    traj = torch.zeros((4, n + m + 1, 8), **f32)
    gains = torch.zeros((4, m + m * n, 8), **f32)
    x0 = torch.zeros((n, 8), **f32)
    entries = (
        lambda: fk.forward_lanes(traj, gains, x0, torch.ones((1, 8), **f32),
                                 model=lti_lanes(spec), lims=None),
        lambda: fk.linesearch_lanes(traj, gains, x0,
                                    torch.zeros((4, 8), **f32),
                                    model=lti_lanes(spec), alphas=(1.0,)),
        lambda: bk.backward_lanes(traj, torch.ones(8, **f32), n=n, m=m,
                                  derivs_tiles=lti_derivs_tiles(spec)))
    try:
        for entry in entries:
            try:
                entry()
                msgs.append("")
            except NotImplementedError as e:
                msgs.append(str(e))
    finally:
        _build.build_generated, lower.lower, lower.lower_tiles = saved
    check(all(what in msg for msg in msgs) and not calls,
          f"<{n},{m}> not refused before any build: {msgs}, {calls}")
    return msgs[0]


def humanoid_phases(ph, dev, rec, counters, builds, cpu_proc) -> dict:
    """The humanoid group: humanoid-build, wide-kernels (the wide K1 at
    the smallest sizes it takes and at the ceiling, K2/K3 past their ring,
    the refusals above the ceilings), humanoid (iLQG), humanoid-kl and
    humanoid-gpu-vs-cpu. Returns the launches of its paths; adds
    ``humanoid`` (the group's seconds, builds and outcomes) to ``rec``."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, forward_kernel as fk, plan)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes, kl_div_wiki_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        default_alphas)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    from tools_torch import wide

    t_group = time.perf_counter()
    hm, build_proc = builds
    out = dict(walls={})
    ph.start("humanoid-build", "the humanoid group's libraries (the wide "
             "K1, the lowered K2/K3 at <54,21> and <64,32>), one nvcc "
             "each, built by the --humanoid-build child started after the "
             "quadrotor phases")
    box = child_solves(build_proc)
    lb = {}
    for label, b in zip(HUMANOID_LIBRARIES, box["builds"]):
        lines = ptxas_summary(b["log"])
        print(f"  {label}: {b['seconds']:.1f} s -> {b['name']}")
        for line in lines:
            print(f"    {line}")
        lb[label] = dict(seconds=b["seconds"], ptxas=lines)
    out["builds"] = dict(libraries=lb, wall=box["wall"],
                         lowering=box["lowering"])
    print(f"  the lowering of both models in the child: "
          f"{box['lowering']:.1f} s")
    paths = {}
    k1c = (bk.backward_lanes,)

    # ---- wide-kernels
    ph.start("wide-kernels", f"K1's wide design against its plain version "
             f"on the card at {dict(wide.CHECKS)} (T={WIDE_T_PLAIN}, "
             f"B={WIDE_B}); K3 and K2 at <54,21> (one ring stage) and at "
             f"the ceiling {wide.CEILING} (K read from device memory), "
             f"T={K23_T_PLAIN}; the wide K1 at the ceiling; n=65 and m=33 "
             f"refused before any build")
    t_ph = time.perf_counter()
    for (n, m), modes in wide.CHECKS.items():
        tiles = hm[(n, m)]
        traj, lam, prev, eta = wide.k1_inputs(n, m, WIDE_T_PLAIN, WIDE_B, 7,
                                              dev)
        for gps in sorted({g for g, _ in modes}):
            emits = [e for g, e in modes if g == gps]
            kw = dict(n=n, m=m, derivs_tiles=tiles,
                      reg_type=1 if gps else 2,
                      lims=None if gps else ((-wide.BOX, wide.BOX),) * m)
            if gps:
                kw.update(prev=prev, eta=eta)
            e1, launches = [], 0
            for emit in emits:
                check(plan.backward_plan(n, m, gps, emit, WIDE_T_PLAIN,
                                         WIDE_B).tc == 0,
                      f"<{n},{m}> {emit}: not the wide design")
                a, l1 = counted(k1c, lambda: bk.backward_lanes(
                    traj, lam, emit=emit, **kw))
                launches += l1["backward_lanes"]
                b = bk.backward_lanes_ref(traj, lam, emit=emit, **kw)
                e1.append(bits_or_fail(
                    f"K1 wide <{n},{m}>{' GPS' if gps else ''} {emit}",
                    {"out": (a.out, b.out), "stats": (a.stats, b.stats)}))
            key = f"k1_wide_{n}_{m}{'_gps' if gps else ''}"
            # the kernel's time on the stream the tiles make, made once
            dp = bk._wide_stream(tiles, traj, n, m, None)
            kdp = dict(kw, derivs_tiles=None)
            rec[key] = dict(
                max_abs_err=max(e1),
                ms=cuda_ms(lambda: bk.backward_lanes(dp, lam, emit=emits[0],
                                                     **kdp), 10),
                plain_ms=plain_once_ms(lambda: bk.backward_lanes_ref(
                    traj, lam, emit=emits[0], **kw)),
                plain_T=WIDE_T_PLAIN, library_ms=None,
                phase_launches=launches,
                **k1_work(_sized(n, m), WIDE_T_PLAIN, WIDE_B, emits[0],
                          kw["reg_type"], kw["lims"], gps=gps, packed=True))
            print(f"  {key} at T={WIDE_T_PLAIN}, B={WIDE_B} "
                  f"({', '.join(emits)}): {rec[key]['ms']:.4f} ms (bound "
                  f"{rec[key]['bound_ms']:.4f}, {rec[key]['bound_by']}); "
                  f"plain once {rec[key]['plain_ms']:.1f} ms; "
                  f"{plan_text(plan.backward_plan(n, m, gps, emits[0], WIDE_T_PLAIN, WIDE_B))}")
            del dp
        del traj, prev, eta
    for key, (n, m) in (("humanoid", wide.HUMANOID),
                        ("ceiling", wide.CEILING)):
        h = hm[key]
        model = h["model"]
        traj, gains, x0, sel = wide.k23_inputs(n, m, K23_T_PLAIN, WIDE_B, 3,
                                               dev)
        lims = ((-wide.BOX, wide.BOX),) * m
        A6 = lti_cfg().alphas
        ladder = torch.tensor(A6, device=dev)[:, None].expand(
            len(A6), WIDE_B).contiguous()
        al1 = torch.ones((1, WIDE_B), device=dev)

        def fwd(al, emit, plain=False):
            f = fk.forward_lanes_ref if plain else fk.forward_lanes
            return f(traj, gains, x0, al, model=model, lims=lims,
                     emit_traj=emit)

        (k, p), l3 = counted(counters, lambda: (fwd(ladder, False),
                                                fwd(ladder, False, True)))
        e3 = bits_or_fail(f"K3 {key} <{n},{m}> sweep", {
            "totals": (k.totals, p.totals), "terminal": (k.terminal,
                                                         p.terminal)})
        (k, p), l3r = counted(counters, lambda: (fwd(al1, True),
                                                 fwd(al1, True, True)))
        e3 = max(e3, bits_or_fail(f"K3 {key} <{n},{m}> rollout", {
            "traj": (k.traj, p.traj), "totals": (k.totals, p.totals)}))
        e2, l2 = 0.0, 0
        for alphas in (A6, default_alphas(0.2, -3.0, 11)):
            def ls(plain=False):
                f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
                return f(traj, gains, x0, sel, model=model, alphas=alphas,
                         reduce_ratio_min=0.0, lims=lims)

            (a, b), l2a = counted(counters, lambda: (ls(), ls(True)))
            l2 += l2a["linesearch_lanes"]
            e2 = max(e2, bits_or_fail(f"K2 {key} <{n},{m}> A={len(alphas)}",
                                      {"traj": (a.traj, b.traj),
                                       "ls": (a.ls, b.ls)}))
        print(f"  K2/K3 {key} <{n},{m}>: plans "
              f"{plan_text(plan.linesearch_plan(n, m, 6, K23_T_PLAIN, WIDE_B))}"
              f" (K2 A=6); "
              f"{plan_text(plan.forward_plan(n, m, 1, K23_T_PLAIN, WIDE_B, True))}"
              f" (K3 rollout); direct K {plan.k23_direct(n, m)}")
        out[f"k23_{key}_checks"] = dict(k3_err=e3, k2_err=e2)
        rec[f"_k3_{key}_check"] = dict(
            max_abs_err=e3, phase_launches=l3["forward_lanes"]
            + l3r["forward_lanes"],
            plain_ms=plain_once_ms(lambda: fwd(ladder, False, True)),
            plain_T=K23_T_PLAIN)
        rec[f"_k2_{key}_check"] = dict(
            max_abs_err=e2, phase_launches=l2,
            plain_ms=plain_once_ms(lambda: ls(True)), plain_T=K23_T_PLAIN)
        if key == "ceiling":
            for kk, w, fn in (
                    ("k3_ceiling", k3_work(model, K23_T_PLAIN, WIDE_B, 6,
                                           False),
                     lambda: fwd(ladder, False)),
                    ("k2_ceiling", k2_work(model, K23_T_PLAIN, WIDE_B, 11),
                     ls)):
                src = rec.pop(f"_{kk}_check")
                rec[kk] = dict(src, ms=cuda_ms(fn, 10), library_ms=None,
                               **w)
        del traj, gains, x0, sel
    # the wide K1 at the humanoid's size and at the ceiling against the
    # plain version in the CPU child, on the same seeded inputs
    cpu = child_solves(cpu_proc)
    for (n, m), (modes, traj, lam, prev, eta, tiles) in wide_cpu_inputs(
            dev).items():
        for mode in modes:
            kw = dict(n=n, m=m, derivs_tiles=tiles,
                      **wide_cpu_kw(mode, m, prev, eta))
            a, l1 = counted(k1c, lambda: bk.backward_lanes(traj, lam, **kw))
            c = cpu[f"k1 <{n},{m}> {mode}"]
            co = torch.tensor(c["out"], dtype=torch.float32)
            cst = torch.tensor(c["stats"], dtype=torch.float32)
            d = max(err(a.out.cpu(), co)[0], err(a.stats.cpu(), cst)[0])
            same = (torch.equal(a.out.cpu(), co)
                    and torch.equal(a.stats.cpu(), cst))
            what = f"K1 wide <{n},{m}> {mode} against the CPU plain"
            BITS[what] = same
            print(f"  {what} (T={WIDE_CPU_T}, B={WIDE_CPU_B}; "
                  f"{c['seconds']:.1f} s there): bit-equal {same}, largest "
                  f"difference {d:.3g} (stated bound: 0, the LTI has no "
                  f"transcendental functions)")
            check(same, f"{what}: not bit-equal")
            out[f"k1 <{n},{m}> {mode} cpu"] = dict(err=d,
                                                   seconds=c["seconds"])
            if (n, m) == wide.CEILING:
                dp = bk._wide_stream(tiles, traj, n, m, None)
                kdp = dict(kw, derivs_tiles=None)
                rec["k1_wide_ceiling"] = dict(
                    max_abs_err=d, phase_launches=l1["backward_lanes"],
                    ms=cuda_ms(lambda: bk.backward_lanes(dp, lam, **kdp),
                               10),
                    plain_ms=c["seconds"] * 1e3, plain_T=WIDE_CPU_T,
                    plain_where="the CPU child", library_ms=None,
                    **k1_work(_sized(n, m), WIDE_CPU_T, WIDE_CPU_B, "gains",
                              2, kw["lims"], packed=True))
        del traj, lam, prev, eta
    out["refusal"] = refused_before_build(dev, 65, 2, "MAX_STATES = 64")
    print(f"  n=65: {out['refusal']}")
    out["walls"]["wide-kernels"] = time.perf_counter() - t_ph

    # ---- humanoid: iLQG
    n, m = wide.HUMANOID
    h = hm["humanoid"]
    spec = h["spec"]._replace(**{k: getattr(h["spec"], k).to(dev)
                                 for k in h["spec"]._fields})
    model, tiles = h["model"], h["tiles"]
    hcfg = lti_cfg()
    Bh, Th = HUMANOID_B, HUMANOID_T
    ph.start("humanoid", f"random_lti(0, n={n}, m={m}, T={Th}) (the DeepMind "
             f"Control Suite humanoid's linearisation) through lti_lanes and "
             f"lti_derivs_tiles (no descriptor: the wide K1 on the stream "
             f"the tiles make, lowered K2/K3 with one ring stage), B={Bh}, "
             f"±0.6 on every control, reg_type 2, the LTI fleet's "
             f"ILQGConfig with a budget of {HUMANOID_ITERS} iterations")
    t_ph = time.perf_counter()
    check(model.device is None and tiles.device is None,
          "humanoid: the LTI's lane objects carry a descriptor")
    x0s, u0s = lti_fleet_inputs(spec, dev, Bh, Th)

    def hsolve(x0=x0s, u0=u0s, trace=False):
        return ilqg_batch_lanes(model, None, x0, u0, lims=HUMANOID_LIMS,
                                cfg=hcfg, derivs_tiles=tiles,
                                max_steps=HUMANOID_ITERS, record_trace=trace)

    w0 = bk.backward_lanes.wide_launches
    r, rr = once_run(lambda: hsolve(trace=True), counters)
    wide_k1 = bk.backward_lanes.wide_launches - w0
    iters = int(r.n_iters.max())
    k1 = rr["launches"]["backward_lanes"]
    init = r.trace.cost[:, 0]
    stream_bytes = 4 * Th * Bh * (bk.InLayout(n, m).DU)
    print(f"  fleet: launches {rr['launches']} (the wide K1 {wide_k1}); "
          f"solve {rr['ms']:.3f} ms, {rr['ms'] / max(iters, 1):.3f} "
          f"ms/iteration over {iters}; K1 {k1} launches ({k1 - 1 - iters} "
          f"λ-retries of the fleet); reasons {hist(r.reason)}; peak "
          f"{rr['peak_bytes'] / 2**30:.3f} GiB; the derivative stream "
          f"{stream_bytes / 1e9:.3f} GB a K1 launch; {rr['syncs']} host "
          f"syncs; cost median {r.cost_total.median().item():.6g} against "
          f"the initial rollout's {init.median().item():.6g}; share of "
          f"controls at ±0.6 {(r.u.abs() == 0.6).float().mean().item():.4f}")
    check(all(rr["launches"][c.__name__] > 0 for c in counters[:3])
          and wide_k1 == k1, f"a kernel of the humanoid path never ran (or "
          f"K1 not wide): {rr['launches']}, wide {wide_k1}")
    check(bool(torch.isfinite(r.cost_total).all()
               and (r.u.abs() <= 0.6).all()), "humanoid: bad result")
    check(r.cost_total.median() < init.median(),
          "humanoid: the median cost did not fall below the initial "
          "rollout's")
    paths["humanoid"] = rr["launches"]
    out["humanoid"] = dict(solve_ms=rr["ms"], iters=iters, k1_launches=k1,
                           lam_retries=k1 - 1 - iters,
                           peak_bytes=rr["peak_bytes"], syncs=rr["syncs"],
                           stream_bytes=stream_bytes,
                           reasons=hist(r.reason),
                           cost_median=r.cost_total.median().item(),
                           initial_median=init.median().item())
    # the path's kernels at its shapes: K1 wide gains and full, K3, K2
    st = torch.cat([to_streams(r.x), to_streams(r.u),
                    to_streams(r.cost[..., None])], dim=1)
    lam = r.lam
    dp = bk._wide_stream(tiles, st, n, m, None)
    kw = dict(n=n, m=m, reg_type=2, lims=HUMANOID_LIMS, derivs_tiles=None)
    hc = out[f"k1 <{n},{m}> gains cpu"]
    rec["k1_humanoid"] = dict(
        max_abs_err=hc["err"],
        ms=cuda_ms(lambda: bk.backward_lanes(dp, lam, emit="gains", **kw), 5),
        ms_full=cuda_ms(lambda: bk.backward_lanes(dp, lam, emit="full", **kw),
                        5),
        bound_ms_full=k1_work(model, Th, Bh, "full", 2, HUMANOID_LIMS,
                              packed=True)["bound_ms"],
        stream_ms=cuda_ms(lambda: bk._wide_stream(tiles, st, n, m, None), 3),
        plain_ms=hc["seconds"] * 1e3, plain_T=WIDE_CPU_T,
        plain_where="the CPU child", library_ms=None,
        **k1_work(model, Th, Bh, "gains", 2, HUMANOID_LIMS, packed=True))
    del dp
    gains = bk.backward_lanes(st, lam, emit="gains", derivs_tiles=tiles,
                              **{k: v for k, v in kw.items()
                                 if k != "derivs_tiles"}).out
    x0_l = x0s.T.contiguous()
    ladder = torch.tensor(hcfg.alphas, device=dev)[:, None].expand(
        len(hcfg.alphas), Bh).contiguous()
    sel = torch.stack([torch.full((Bh,), -1.0, device=dev),
                       torch.ones(Bh, device=dev), r.cost_total,
                       torch.ones(Bh, device=dev)])
    for kk, w, fn in (
            ("k3_humanoid", k3_work(model, Th, Bh, len(hcfg.alphas), False),
             lambda: fk.forward_lanes(st, gains, x0_l, ladder, model=model,
                                      lims=HUMANOID_LIMS)),
            ("k2_humanoid", k2_work(model, Th, Bh, len(hcfg.alphas)),
             lambda: fk.linesearch_lanes(st, gains, x0_l, sel, model=model,
                                         alphas=hcfg.alphas,
                                         lims=HUMANOID_LIMS))):
        src = rec.pop(f"_{kk}_check")
        rec[kk] = dict(src, ms=cuda_ms(fn, 5), library_ms=None, **w)
        rec[kk].pop("phase_launches")
    del gains, st
    for key in ("k1_humanoid", "k2_humanoid", "k3_humanoid"):
        print(f"  {key} at B={Bh}, T={Th}: {rec[key]['ms']:.4f} ms against "
              f"its bound {rec[key]['bound_ms']:.4f} ms "
              f"({rec[key]['bound_by']})")
    print(f"  the stream from the tiles: {rec['k1_humanoid']['stream_ms']:.3f}"
          f" ms a K1 launch; K1 full {rec['k1_humanoid']['ms_full']:.4f} ms")
    g = hsolve(*lti_fleet_inputs(spec, dev, HUMANOID_B_CPU, HUMANOID_T_CPU))
    del r
    out["walls"]["humanoid"] = time.perf_counter() - t_ph

    # ---- humanoid-kl
    ph.start("humanoid-kl", f"KL on the humanoid at KL-LTI's settings "
             f"(kl_step {KL_LTI_STEP}, scalar η, no limits; pre-rolled by "
             f"K3), B={Bh}, T={Th}: the wide K1 in GPS policy, K3, K4 n={n}; "
             f"kl_div_wiki_lanes timed and profiled")
    t_ph = time.perf_counter()
    fx = to_streams(spec.A.expand(Bh, Th, n, n).contiguous())
    k4_check(rec, "k4_54", fx, n)
    del fx
    kcfg = ILQGKLConfig(kl_step=KL_LTI_STEP)
    kin = lti_fleet_kl_inputs(model, spec, x0s, u0s)
    w0 = bk.backward_lanes.wide_launches
    r, rk = once_run(lambda: ilqgkl_batch_lanes(model, tiles, *kin,
                                                cfg=kcfg), counters)
    wide_k1 = bk.backward_lanes.wide_launches - w0
    print(f"  KL: launches {rk['launches']} (the wide K1 {wide_k1}); "
          f"{rk['ms']:.3f} ms a KL solve, n_iters max "
          f"{int(r.n_iters.max())}; satisfied "
          f"{r.satisfied.float().mean().item():.4f}; peak "
          f"{rk['peak_bytes'] / 2**30:.3f} GiB")
    check(rk["launches"]["covariance_lanes"] == 1
          and rk["launches"]["forward_lanes"] >= 1
          and wide_k1 == rk["launches"]["backward_lanes"] >= 1,
          f"a kernel of the humanoid KL path never ran: {rk['launches']}")
    check(bool(torch.isfinite(r.cost_total).all()), "humanoid KL: non-finite")
    paths["humanoid_kl"] = rk["launches"]
    out["humanoid"].update(kl_ms=rk["ms"], kl_peak_bytes=rk["peak_bytes"],
                           kl_iters=int(r.n_iters.max()),
                           kl_satisfied=r.satisfied.float().mean().item())
    # K1 GPS policy at the path's shapes, on the KL path's pre-rolled
    # trajectory and previous policy, the stream made once
    x, pol = kin[0], kin[1]
    st = torch.cat([to_streams(x), to_streams(pol.k)], dim=1)
    prev = to_streams(torch.cat([pol.k, pol.K.reshape(Bh, Th, -1),
                                 pol.sigma_inv.reshape(Bh, Th, -1)], -1))
    eta = torch.ones((Th, Bh), device=dev)
    dp = bk._wide_stream(tiles, st, n, m, None)
    gkw = dict(n=n, m=m, reg_type=1, lims=None, derivs_tiles=None,
               prev=prev, eta=eta, emit="policy")
    hg = out[f"k1 <{n},{m}> gps policy cpu"]
    rec["k1_humanoid_gps"] = dict(
        max_abs_err=hg["err"],
        ms=cuda_ms(lambda: bk.backward_lanes(dp, torch.zeros(
            Bh, device=dev), **gkw), 5),
        plain_ms=hg["seconds"] * 1e3, plain_T=WIDE_CPU_T,
        plain_where="the CPU child", library_ms=None,
        **k1_work(model, Th, Bh, "policy", 1, None, gps=True, packed=True))
    del dp
    mu = torch.zeros((Th, n, Bh), device=dev)
    sxx = to_streams(torch.eye(n, device=dev).expand(Bh, Th, n, n))
    pk = to_streams(pol.k)
    pK = to_streams(pol.K.reshape(Bh, Th, -1))
    pS = to_streams(pol.sigma.reshape(Bh, Th, -1))
    pSi = to_streams(pol.sigma_inv.reshape(Bh, Th, -1))
    kl_args = (mu, sxx, pk, pK, pS, pk, pK, pSi, n, m)
    kl_ms = once_ms(lambda: kl_div_wiki_lanes(*kl_args))
    prof = profile_split(lambda: kl_div_wiki_lanes(*kl_args))
    out["humanoid"]["kl_div_ms"] = kl_ms
    out["humanoid"]["kl_div_profile"] = (None if prof is None else {
        k: prof[k] for k in ("wall_ms", "busy_ms", "glue_launches",
                             "idle_share")})
    print(f"  kl_div_wiki_lanes at n={n}, m={m}, B={Bh}, T={Th}: "
          f"{kl_ms:.1f} ms of device time an evaluation"
          + ("" if prof is None else
             f"; profiled: {prof['glue_launches']} device launches, wall "
             f"{prof['wall_ms']:.1f} ms, busy {prof['busy_ms']:.1f} ms, idle "
             f"share {prof['idle_share']:.3f}"))
    del r, kin, st, prev, mu, sxx
    out["walls"]["humanoid-kl"] = time.perf_counter() - t_ph

    # ---- humanoid-gpu-vs-cpu
    ph.start("humanoid-gpu-vs-cpu", f"{HUMANOID_B_CPU} lanes at "
             f"T={HUMANOID_T_CPU}: the card's fleet and KL against the plain "
             f"versions in the CPU child")
    t_ph = time.perf_counter()
    c = cpu["humanoid"]
    agree(f"humanoid {HUMANOID_B_CPU} lanes at T={HUMANOID_T_CPU} "
          f"({c['seconds']:.1f} s in the child)", {f: getattr(g, f).tolist()
                                                   for f in ("cost_total",
                                                             "reason",
                                                             "n_accepted")},
          c, "cost_total", ("reason", "n_accepted"))
    xc, uc = lti_fleet_inputs(spec, dev, HUMANOID_B_CPU, HUMANOID_T_CPU)
    g = ilqgkl_batch_lanes(model, tiles, *lti_fleet_kl_inputs(
        model, spec, xc, uc), cfg=kcfg)
    agree(f"humanoid KL {HUMANOID_B_CPU} lanes at T={HUMANOID_T_CPU}",
          {f: getattr(g, f).tolist() for f in ("cost_total", "satisfied",
                                                "n_iters")},
          cpu["humanoid KL"], "cost_total", ("satisfied", "n_iters"))
    out["walls"]["humanoid-gpu-vs-cpu"] = time.perf_counter() - t_ph
    out["seconds"] = time.perf_counter() - t_group
    print(f"  the humanoid group: {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in out["walls"].items()) + ")")
    rec["ptxas"] += [line for v in lb.values() for line in v["ptxas"]]
    for v in lb.values():
        v.pop("ptxas")
    rec["humanoid"] = out
    return paths


# ---------------------------------------------------------------------------
# the sources group: every public derivative source through the fleet iLQG
# and KL entries (K1's Autodiff<LTI>, Autodiff<PendCartParam>, and the GPS
# "policy" of the autodiff and full-DDP sources)
# ---------------------------------------------------------------------------

SOURCES_B = 512                  # the kernel checks' lanes
# the kernel checks' horizons (9-17 steps, as the controls group's): the
# plain autodiff tiles at n=10 take ≈0.1-0.4 s a step
SOURCES_T_PLAIN = {10: 9, 4: 17, 6: 9}
# the CPU child's subsets (--sources-cpu, ≈100 s of host time on two
# threads): the pendcart paths on B_CPU lanes at SOURCES_T_CPU (the plain
# autodiff tiles take ≈50 ms a step at 64 lanes on the host; at T=20 the
# KL tier's outcomes part at an ulp, at 60 and 120 autodiff and analytic
# tiles agree on every lane), the LTI paths on SOURCES_LTI_B_CPU lanes at
# SOURCES_LTI_T_CPU with SOURCES_LTI_ITERS iterations
SOURCES_T_CPU = 60
SOURCES_LTI_B_CPU, SOURCES_LTI_T_CPU, SOURCES_LTI_ITERS = 8, 12, 8
# full DDP against first-order KL (kl-ddp): the Vx·∂²f terms move each
# iterate, so costs agree to ≈1% (0.76% at most on 64 lanes of the KL tier
# on the host), satisfied flags alike; η and the measured KL are printed
KL_DDP_RTOL = 2e-2
# the source of each new K1 instance group, by record key: (kind, m,
# second order, the modes checked (emission, GPS mode), the path keys)
SOURCE_GROUPS = {
    "k1_lti_ad": ("lti", 2, False, (("gains", False), ("full", False)),
                  ("lti_ad",)),
    "k1_lti_ad_gps": ("lti", 2, False, (("policy", True),), ("kl_lti_ad",)),
    "k1_lti3_ad": ("lti", 3, False, (("gains", False), ("full", False),
                                     ("policy", True)), ()),
    "k1_lti_ad_so": ("lti", 2, True, (("gains", False), ("full", False),
                                      ("policy", True)), ()),
    "k1_lti3_ad_so": ("lti", 3, True, (("gains", False), ("full", False),
                                       ("policy", True)), ()),
    "k1_param_ad": ("param", 1, False, (("gains", False), ("full", False)),
                    ("hetero_ad",)),
    "k1_param_ad_so": ("param", 1, True, (("gains", False),
                                          ("full", False)), ()),
    "k1_pendcart_ad_gps": ("pendcart_ad", 1, False, (("policy", True),),
                           ("kl_ad",)),
    "k1_pendcart_ad_so_gps": ("pendcart_ad", 1, True, (("policy", True),),
                              ()),
    "k1_pendcart_so_gps": ("pendcart_so", 1, True, (("policy", True),),
                           ("kl_ddp",)),
    "k1_quad_so_gps": ("quad", 2, True, (("policy", True),), ()),
    "k1_lowered_so_gps": ("lowered", 1, True, (("full", True),
                                               ("policy", True)), ()),
    "k1_tiles_so_gps": ("tiles", 1, True, (("full", True),
                                           ("policy", True)), ()),
}


def start_source_library():
    """Build the sources library (``_build.sources_library``) in a thread at
    a low priority; returns (thread, box): the box receives ``build`` (a
    _build.Build) or ``error``."""
    import threading
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        _build)
    box: dict = {}

    def run():
        background()
        try:
            box["build"] = _build.build(_build.SOURCE_LIBRARY, "sources")
        except Exception as e:   # noqa: BLE001 - reported by the phase
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    BUILD_THREADS.append(th)
    return th, box


def sources_models() -> dict:
    """The group's models without a descriptor: the pendcart lowered
    (Autodiff<Lowered, true> in GPS mode) and the pendcart's full-DDP tiles
    as a user's function (LoweredTiles, second order, in GPS mode)."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles_so, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
        import DerivsTiles
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
        import LanesModel
    p = pendcart_lanes(PendCartSpec())
    return dict(lowered=LanesModel(n=4, m=1, dynamics=p.dynamics,
                                   cost=p.cost, terminal=p.terminal),
                tiles=DerivsTiles(
                    fn=pendcart_derivs_tiles_so(PendCartSpec()).fn))


def start_sources_builds(sm: dict):
    """Lower the group's models and tiles and start their libraries'
    builds in a thread, as start_lowered_builds."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import lower
    jobs = [(lower.lower(sm["lowered"]).struct(False), "k1_so_gps"),
            (lower.lower_tiles(sm["tiles"], 4, 1).struct(), "t1_so_gps")]
    return build_thread(jobs, ["lowered pendcart k1_so_gps",
                               "user's second-order tiles t1_so_gps"])


def source_tiles(kind: str, m: int, so: bool, dev, sm: dict):
    """(tiles, model, n, m, limits, per-scenario params or None) of one
    source kind on ``dev``."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles_so, pendcart_lanes,
        pendcart_lanes_param)
    from differentialdynamicprogramming_jl_tpu_torch.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    spec = PendCartSpec()
    if kind == "lti":
        model = lti_lanes(random_lti(0, n=LTI_N, m=m, T=LTI_T, device=dev))
        return (autodiff_derivs_tiles(model, second_order=so), model, LTI_N,
                m, ((-0.6, 0.6),) * m)
    if kind == "param":
        model = pendcart_lanes_param(spec)
        return (autodiff_derivs_tiles(model, second_order=so), model, 4, 1,
                LIMS)
    if kind == "quad":
        qspec = QuadrotorSpec()
        model = quadrotor_lanes(qspec)
        return (autodiff_derivs_tiles(model, second_order=so), model, 6, 2,
                qspec.lims)
    model = pendcart_lanes(spec)
    tiles = {"pendcart_ad": lambda: autodiff_derivs_tiles(model,
                                                          second_order=so),
             "pendcart_so": lambda: pendcart_derivs_tiles_so(spec),
             "lowered": lambda: autodiff_derivs_tiles(sm["lowered"],
                                                      second_order=True),
             "tiles": lambda: sm["tiles"]}[kind]()
    return tiles, model, 4, 1, LIMS


def source_inputs(n: int, m: int, Tk: int, dev, params: bool):
    """A check's K1 inputs at (n, m), numpy seed 13 (B = SOURCES_B lanes):
    a random trajectory around each model's operating point, λ over eight
    decades, a previous policy with every KL term non-zero and Σ⁻¹ = 2·I,
    η with zeros (which count as 1), and per-scenario [l, d]."""
    rng = np.random.default_rng(13)
    Bk = SOURCES_B
    x = rng.standard_normal((Tk, n, Bk))
    x[:, 0] += {4: math.pi - 0.6, 6: 1.0}.get(n, 0.0)
    u = 2.0 * rng.standard_normal((Tk, m, Bk)) + (2.4525 if n == 6 else 0.0)
    f32 = dict(dtype=torch.float32, device=dev)
    traj = torch.tensor(np.concatenate([x, u, np.zeros((Tk, 1, Bk))], 1),
                        **f32)
    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, Bk), **f32)
    prev = np.concatenate([rng.standard_normal((Tk, m, Bk)),
                           0.1 * rng.standard_normal((Tk, m * n, Bk)),
                           (2.0 * np.eye(m)).reshape(1, m * m, 1)
                           * np.ones((Tk, 1, Bk))], 1)
    eta = rng.uniform(0.5, 2.0, (Tk, Bk))
    eta[:, ::7] = 0.0
    par = (torch.tensor(np.stack([rng.uniform(*PARAM_L, Bk),
                                  rng.uniform(*PARAM_D, Bk)]), **f32)
           if params else None)
    return traj, lam, torch.tensor(prev, **f32), torch.tensor(eta, **f32), par


def hetero_inputs(device, Bk: int, Tk: int):
    """The heterogeneous headline (hetero-path's inputs: numpy seed 21's
    [l, d] and ±h limits, the headline's x0, u0 = 0) on the first Bk lanes
    at horizon Tk: (x0s, u0s, params (Bk, 2), limits (Bk, 1, 2))."""
    rng = np.random.default_rng(21)
    par = np.stack([rng.uniform(*PARAM_L, B), rng.uniform(*PARAM_D, B)],
                   axis=1)
    hi = rng.uniform(*HETERO_HI, B)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(headline_x0()[:Bk], **f32),
            torch.zeros((Bk, Tk, 1), **f32), torch.tensor(par[:Bk], **f32),
            torch.tensor(np.stack([-hi, hi], axis=1)[:Bk, None, :], **f32))


def source_solves(device, Bp: int, Tp: int, Bl: int, Tl: int,
                  lti_iters=None) -> dict:
    """The group's four paths as solve functions on ``device``: the
    pendcart ones on Bp lanes at Tp, the LTI ones on Bl lanes at Tl
    (``lti_iters`` caps the LTI fleet's iterations). Each entry: label ->
    (the new source's solve, the reference source's solve, the new
    source's K1 call at the path's shapes given a solution, or None); KL
    labels contain "KL"."""
    from differentialdynamicprogramming_jl_tpu_torch.models.linear import (
        lti_derivs_tiles, lti_lanes, random_lti)
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_derivs_tiles, pendcart_derivs_tiles_param,
        pendcart_derivs_tiles_so, pendcart_lanes, pendcart_lanes_param)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl import (
        ILQGKLConfig)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    spec = PendCartSpec()
    pm, qm = pendcart_lanes(spec), pendcart_lanes_param(spec)
    kl_in, _ = kl_tier_inputs(pm, device, Bp, Tp)
    kcfg = ILQGKLConfig(kl_step=KL_STEP, max_iter=KL_ITERS)
    x0h, u0h, parh, limh = hetero_inputs(device, Bp, Tp)
    lspec = random_lti(0, n=LTI_N, m=LTI_M, T=LTI_T, device=device)
    lm = lti_lanes(lspec)
    x0l, u0l = lti_fleet_inputs(lspec, device, Bl, Tl)
    lkl_in = lti_fleet_kl_inputs(lm, lspec, x0l, u0l)
    lcfg = lti_cfg()
    lkcfg = ILQGKLConfig(kl_step=KL_LTI_STEP)

    def kl(tiles):
        return lambda: ilqgkl_batch_lanes(pm, tiles, *kl_in, cfg=kcfg)

    def hetero(tiles):
        return lambda: ilqg_batch_lanes(qm, None, x0h, u0h, lims=limh,
                                        cfg=headline_cfg(),
                                        derivs_tiles=tiles, params=parh,
                                        max_steps=ITERS)

    def lti(tiles):
        return lambda: ilqg_batch_lanes(lm, None, x0l, u0l, lims=LTI_LIMS,
                                        cfg=lcfg, derivs_tiles=tiles,
                                        max_steps=lti_iters)

    def lti_kl(tiles):
        return lambda: ilqgkl_batch_lanes(lm, tiles, *lkl_in, cfg=lkcfg)

    def k1_kl(tiles, n):
        """K1 GPS "policy" on a KL solution's trajectory and policy, η = 1
        (the KL loop's launch)."""
        def call(r):
            st = torch.cat([to_streams(r.x), to_streams(r.u)], dim=1)
            prev = torch.cat([to_streams(r.policy.k), to_streams(
                r.policy.K.flatten(2)), to_streams(
                r.policy.sigma_inv.flatten(2))], dim=1).contiguous()
            one = torch.ones((st.shape[0], st.shape[2]), device=st.device)
            return lambda: bk.backward_lanes(
                st, torch.zeros_like(one[0]), n=n, m=r.u.shape[-1],
                reg_type=1, lims=None, derivs_tiles=tiles, prev=prev,
                eta=one, emit="policy")
        return call

    def k1_ilqg(tiles, n, lims, params=None, lanes=None):
        """K1 "gains" on an iLQG solution's trajectory at its λ."""
        def call(r):
            st = torch.cat([to_streams(r.x), to_streams(r.u)], dim=1)
            return lambda: bk.backward_lanes(
                st, r.lam, n=n, m=r.u.shape[-1], reg_type=2, lims=lims,
                derivs_tiles=tiles, params=params, lims_lanes=lanes,
                emit="gains")
        return call

    ana = pendcart_derivs_tiles(spec)
    pad, pso = autodiff_derivs_tiles(pm), pendcart_derivs_tiles_so(spec)
    had, lad = autodiff_derivs_tiles(qm), autodiff_derivs_tiles(lm)
    return {
        "kl_ad KL": (kl(pad), kl(ana), k1_kl(pad, 4)),
        "kl_ddp KL": (kl(pso), kl(ana), k1_kl(pso, 4)),
        "hetero_ad": (hetero(had), hetero(pendcart_derivs_tiles_param(spec)),
                      k1_ilqg(had, 4, None, parh.T.contiguous(),
                              limh[:, 0, :].T.contiguous())),
        "lti_ad": (lti(lad), lti(lti_derivs_tiles(lspec)),
                   k1_ilqg(lad, LTI_N, LTI_LIMS)),
        "kl_lti_ad KL": (lti_kl(lad), lti_kl(lti_derivs_tiles(lspec)),
                         k1_kl(lad, LTI_N)),
    }


def outcomes(label: str, r) -> dict:
    """The outcomes a path is held to: cost, reason and accepted count for
    iLQG; cost, satisfied, η, the measured KL and iterations for KL."""
    fields = (("cost_total", "satisfied", "eta", "divergence", "n_iters")
              if "KL" in label else ("cost_total", "reason", "n_accepted"))
    return {f: getattr(r, f).tolist() for f in fields}


def sources_cpu_solves() -> dict:
    """The group's paths with the new sources on the host (the
    ``--sources-cpu`` child): the pendcart paths on B_CPU lanes at
    SOURCES_T_CPU, the LTI ones on SOURCES_LTI_B_CPU lanes at
    SOURCES_LTI_T_CPU. Two host threads."""
    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, pendcart_lanes_param)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    torch.set_num_threads(2)
    out = {}
    for label, (run, _, _) in source_solves(
            "cpu", B_CPU, SOURCES_T_CPU, SOURCES_LTI_B_CPU,
            SOURCES_LTI_T_CPU, SOURCES_LTI_ITERS).items():
        t0 = time.perf_counter()
        out[label] = outcomes(label, run())
        out[label]["seconds"] = time.perf_counter() - t0
    # the heterogeneous fleet's own spread at this horizon: the same solve
    # from initial states one ulp away (toward +∞)
    qm = pendcart_lanes_param(PendCartSpec())
    x0h, u0h, parh, limh = hetero_inputs("cpu", B_CPU, SOURCES_T_CPU)
    out["hetero_ad nudged"] = outcomes("hetero_ad", ilqg_batch_lanes(
        qm, None, torch.nextafter(x0h, torch.full_like(x0h, math.inf)), u0h,
        lims=limh, cfg=headline_cfg(), derivs_tiles=autodiff_derivs_tiles(qm),
        params=parh, max_steps=ITERS))
    return out


def held_to(what: str, g, ref, rtol: float = COST_RTOL,
            fields=None) -> dict:
    """A path's solve ``g`` against the same solve with the reference
    source ``ref``: which outcomes are bit-equal, and the share of lanes
    whose cost (and, for KL, η and measured KL) agree to ``rtol`` and whose
    other outcomes are equal; each share must reach AGREE_SHARE (``fields``:
    the fields checked, all by default)."""
    kl = hasattr(g, "eta")
    close = ("cost_total", "eta", "divergence") if kl else ("cost_total",)
    equal = ("satisfied", "n_iters") if kl else ("reason", "n_accepted")
    bits = {f: bool(torch.equal(getattr(g, f), getattr(ref, f)))
            for f in close + equal}
    got = {}
    for f in close:
        a, b = getattr(g, f).double(), getattr(ref, f).double()
        got[f] = ((a - b).abs() <= rtol * b.abs()).float().mean().item()
    for f in equal:
        got[f] = (getattr(g, f) == getattr(ref, f)).float().mean().item()
    print(f"  {what}: bit-equal {[f for f, v in bits.items() if v]}; "
          f"shares: " + ", ".join(f"{f} {v:.3f}" for f, v in got.items())
          + f" (within {rtol:.0e} or equal; need {AGREE_SHARE})")
    for f in fields or got:
        check(got[f] >= AGREE_SHARE, f"{what}: {f} differs")
    return dict(bit_equal=bits, shares=got)


def sources_phases(ph, dev, rec, counters, builds, cpu_proc) -> dict:
    """The sources group. sources-kernels: each new K1 instance group
    against its plain version on the same CUDA tensors, bit for bit (out,
    stats), at B=512 and plain horizons of 9-17 steps (the lowered models'
    libraries built in a thread from the controls' start). kl-ad, lti-ad
    (the LTI fleet, then KL on it), hetero-ad, kl-ddp: the paths through
    the public entries with the new sources, each against the same solve
    with the reference source. sources-gpu-vs-cpu: each path on a lane
    subset against the ``--sources-cpu`` child. Returns the paths'
    launches; ``rec["sources"]`` gets the group's record."""
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk)
    sm, (th, labels, box), (sth, sbox) = builds
    ph.start("sources-kernels", f"every new K1 instance against its plain "
             f"version, B={SOURCES_B}, T={SOURCES_T_PLAIN} by n")
    th.join()
    sth.join()
    for b in (box, sbox):
        if "error" in b:
            raise b["error"]
    group = {"builds": {"sources library": sbox["build"].seconds}}
    print(f"  the sources library: {sbox['build'].seconds:.1f} s of nvcc "
          f"(in a thread from the main build on)")
    for line in ptxas_summary(sbox["build"].log):
        print(f"    {line}")
    for label, b in zip(labels, box["builds"]):
        print(f"  {label}: {b.seconds:.1f} s of nvcc")
        for line in ptxas_summary(b.log):
            print(f"    {line}")
        group["builds"][label] = b.seconds
    checks, plain = {}, {}
    for key, (kind, m, so, modes, on) in SOURCE_GROUPS.items():
        tiles, model, n, m, lims = source_tiles(kind, m, so, dev, sm)
        Tk = SOURCES_T_PLAIN[n]
        traj, lam, prev, eta, par = source_inputs(n, m, Tk, dev,
                                                  tiles.n_params > 0)
        errs, times, launched = [], {}, 0
        for emit, gps in modes:
            kw = dict(n=n, m=m, reg_type=1 if gps else 2,
                      lims=None if gps else lims, derivs_tiles=tiles,
                      params=par)
            if gps:
                kw.update(prev=prev, eta=eta)
            what = f"{key} {emit}{' GPS' if gps else ''}"
            k, n1 = counted(counters, lambda: bk.backward_lanes(
                traj, lam, emit=emit, **kw))
            launched += n1["backward_lanes"]
            # one plain run a source and GPS mode, in "full" emission:
            # each emission's slots are taken from it
            pkey = (kind, m, so, gps)
            if pkey not in plain:
                box = []
                ms_p = once_ms(lambda: box.append(bk.backward_lanes_ref(
                    traj, lam, emit="full", **kw)))
                plain[pkey] = (box[0], ms_p)
            p, ms_p = plain[pkey]
            pout = k1_emitted(p.out, n, m, emit)
            errs.append(bits_or_fail(what, {"out": (k.out, pout),
                                            "stats": (k.stats, p.stats)}))
            ms = cuda_ms(lambda: bk.backward_lanes(traj, lam, emit=emit,
                                                   **kw), 20)
            times[what] = (ms, ms_p)
            print(f"  {what}: bit-equal to plain; kernel {ms:.4f} ms, "
                  f"plain {ms_p:.1f} ms (T={Tk}, B={SOURCES_B})")
        emit, gps = modes[0]
        what = next(iter(times))
        rec[key] = dict(max_abs_err=max(errs), ms=times[what][0],
                        plain_ms=times[what][1], plain_T=Tk, T=Tk,
                        B=SOURCES_B, library_ms=None,
                        modes={w: dict(ms=t[0], plain_ms=t[1])
                               for w, t in times.items()},
                        **k1_work(model, Tk, SOURCES_B, emit,
                                  1 if gps else 2, None if gps else lims,
                                  gps=gps, so=so))
        if not on:
            rec[key]["phase_launches"] = launched
        checks[key] = len(modes)
    del plain
    group["checks"] = checks

    def path(key, label, run, ref, k1, rtol=COST_RTOL, fields=None,
             warm=True):
        """One path: the new source's solve counted and timed (after a
        warm-up where ``warm``), held to the reference source's; its K1
        instance timed on the solution at the path's shapes (record
        ``key``). Returns its launches."""
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)

        def timed():
            s.record()
            out = run()
            e.record()
            return out

        if warm:
            run()
        r, launches = counted(counters, timed)
        ms = s.elapsed_time(e)
        rr = ref()
        iters = int(r.n_iters.max())
        print(f"  {label}: launches {launches}; solve {ms:.3f} ms (CUDA "
              f"events), {ms / max(iters, 1):.4f} ms/iter over {iters} "
              f"iterations")
        check(launches["backward_lanes"] > 0, f"{label}: K1 never ran")
        check(bool(torch.isfinite(r.cost_total).all()),
              f"{label}: non-finite costs")
        group[key] = dict(solve_ms=ms, iters=iters, **held_to(
            f"{label} against the reference source", r, rr, rtol, fields))
        # the instance's time at the path's shapes, and its bound there
        inst = next(k for k, v in SOURCE_GROUPS.items() if key in v[4])
        kind, m, so, modes, _ = SOURCE_GROUPS[inst]
        _, model, n, _, lims = source_tiles(kind, m, so, dev, {})
        kms = cuda_ms(k1(r), 5)
        Tp, Bp = r.u.shape[1], r.u.shape[0]
        gps = "KL" in label
        work = k1_work(model, Tp, Bp, "policy" if gps else "gains",
                       1 if gps else 2, None if gps else lims, gps=gps,
                       lanes=kind == "param", so=so)
        print(f"  {inst} at T={Tp}, B={Bp}: {kms:.4f} ms (bound "
              f"{work['bound_ms']:.4f} ms, {work['bound_by']})")
        rec[inst].update(ms=kms, T=Tp, B=Bp, **work)
        return launches

    paths = {}
    solves = source_solves(dev, B, T, B, LTI_T)

    ph.start("kl-ad", f"ilqgkl_batch_lanes, pendcart B={B} T={T}, "
             f"kl_step={KL_STEP}, autodiff_derivs_tiles against the "
             "analytic tiles")
    paths["kl_ad"] = path("kl_ad", "KL with autodiff tiles",
                          *solves["kl_ad KL"])

    ph.start("lti-ad", f"ilqg_batch_lanes, LTI n={LTI_N} m={LTI_M} B={B} "
             f"T={LTI_T}, ±0.6, to convergence; then KL on it (kl_step "
             f"{KL_LTI_STEP}): autodiff_derivs_tiles against lti_derivs_tiles")
    paths["lti_ad"] = path("lti_ad", "LTI fleet with autodiff tiles",
                           *solves["lti_ad"], warm=False)
    paths["kl_lti_ad"] = path("kl_lti_ad", "KL on the LTI with autodiff "
                              "tiles", *solves["kl_lti_ad KL"], warm=False)

    ph.start("hetero-ad", f"ilqg_batch_lanes, parametrised pendcart B={B} "
             f"T={T}, l~U{PARAM_L}, d~U{PARAM_D}, limits ±U{HETERO_HI}: "
             "autodiff tiles against pendcart_derivs_tiles_param")
    paths["hetero_ad"] = path("hetero_ad", "hetero fleet with autodiff "
                              "tiles", *solves["hetero_ad"])

    ph.start("kl-ddp", f"ilqgkl_batch_lanes, pendcart B={B} T={T}, "
             "pendcart_derivs_tiles_so against the first-order tiles")
    paths["kl_ddp"] = path("kl_ddp", "KL with full-DDP tiles",
                           *solves["kl_ddp KL"], rtol=KL_DDP_RTOL,
                           fields=("cost_total", "satisfied"))
    del solves

    ph.start("sources-gpu-vs-cpu", f"the paths on {B_CPU} lanes at "
             f"T={SOURCES_T_CPU} (pendcart) and on {SOURCES_LTI_B_CPU} at "
             f"T={SOURCES_LTI_T_CPU} (LTI, {SOURCES_LTI_ITERS} iterations), "
             "against the --sources-cpu child's plain solves")
    cpu = child_solves(cpu_proc)
    for label, (run, _, _) in source_solves(
            dev, B_CPU, SOURCES_T_CPU, SOURCES_LTI_B_CPU, SOURCES_LTI_T_CPU,
            SOURCES_LTI_ITERS).items():
        g = outcomes(label, run())
        c = cpu[label]
        print(f"  {label}: CPU solve {c['seconds']:.1f} s in the child")
        same = (("satisfied", "n_iters") if "KL" in label
                else ("reason", "n_accepted"))
        need = None
        if label == "hetero_ad":
            # at T=60 its reasons and accepted counts move under rounding
            # alone (per-scenario boxes down to ±0.8): the host's own solve
            # from states one ulp away agrees with it on these shares only,
            # and the card is held to the host at least as closely (or to
            # AGREE_SHARE, where that is lower)
            own = shares(cpu["hetero_ad nudged"], c, "cost_total", same)
            print(f"  hetero_ad on the host against itself from states one "
                  f"ulp away: shares " + ", ".join(
                      f"{f} {v:.3f}" for f, v in zip(("cost",) + same, own)))
            group["hetero_ad_self_shares"] = own
            need = [min(AGREE_SHARE, v) for v in own]
        agree(label, g, c, "cost_total", same, need=need)
    rec["sources"] = group
    return paths


def _sized(n: int, m: int):
    """A stand-in with the (n, m) of a model, for k1_work on the packed
    stream (which reads no model)."""
    from types import SimpleNamespace
    return SimpleNamespace(n=n, m=m, n_params=0, device=None)



def main() -> int:
    ph = Phases()
    ph.start("device")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 1
    card = smi()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
        PendCartSpec, default_x0, pendcart_derivs_tiles, pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import _build
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import (
        backward_kernel as bk, covariance_kernel as ck, forward_kernel as fk,
        probe_kernel as pk)
    from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.pack import (
        to_streams)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
        ILQGConfig, default_alphas)

    ph.start("build")
    built = _build.build()
    print(f"  nvcc build: {built.seconds:.1f} s -> {built.path.name}")
    # the ptxas lines, also for the phases that print an instance's
    # registers beside its plan
    rec = {"ptxas": ptxas_summary(built.log)}
    for line in rec["ptxas"]:
        print("  " + with_plan(line))
    _build.library()
    # the sources library (K1's Autodiff<LTI> and GPS Autodiff<Quadrotor,
    # true>), the lowered and tiles groups' libraries build beside the
    # earlier phases
    source_lib = start_source_library()
    models = lowered_models()
    builds = (models, start_lowered_builds(models))
    tmodels = tiles_models()
    tbuilds = (tmodels, start_tiles_builds(tmodels))
    smodels = sizes_models()
    sbuilds = (smodels, start_sizes_builds(smodels))
    # the packed group's CPU solves run beside the card's phases
    cpu_proc = start_cpu_child("--packed-cpu")
    # the CPU solves the early phases are compared with at the end
    early_proc = start_cpu_child("--early-cpu")
    m3_proc = start_cpu_child("--m3-cpu")
    tiles_proc = start_cpu_child("--tiles-cpu")
    demos_proc = start_cpu_child("--demos-cpu")
    sizes_proc = start_cpu_child("--sizes-cpu")
    CHILDREN.extend([cpu_proc, early_proc, m3_proc, tiles_proc, demos_proc,
                     sizes_proc])

    ph.start("ilqg-kernels", f"vs plain versions, B={B}, T={T}")
    spec = PendCartSpec()
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    cfg = headline_cfg()
    A = len(cfg.alphas)
    rng = np.random.default_rng(0)
    x0_np = headline_x0()
    rng.standard_normal((B, 4))        # the draw headline_x0 made
    x0s = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    u_rand = torch.tensor(2.0 * rng.standard_normal((B, T, 1)),
                          dtype=torch.float32, device=dev)
    x0_l = x0s.T.contiguous()
    gains0 = torch.cat([to_streams(u_rand),
                        torch.zeros((T, 4, B), device=dev)], dim=1)
    traj0 = torch.zeros((T, 5, B), device=dev)
    ladder = torch.tensor(cfg.alphas, device=dev)[:, None].expand(A, B)
    ladder = ladder.contiguous()
    al1 = torch.tensor(rng.uniform(0.0, 1.0, (1, B)), dtype=torch.float32,
                       device=dev)

    def fwd(al, emit, plain):
        f = fk.forward_lanes_ref if plain else fk.forward_lanes
        return f(traj0, gains0, x0_l, al, model=model, lims=LIMS, gk=0,
                 gK=1, emit_traj=emit)

    k, p = fwd(ladder, False, False), fwd(ladder, False, True)
    e1 = compare("K3 sweep A=6", {"totals": (k.totals, p.totals),
                                  "terminal": (k.terminal, p.terminal)})
    check_bits("K3 sweep", (k.totals, p.totals), (k.terminal, p.terminal))
    k, p = fwd(al1, True, False), fwd(al1, True, True)
    e2 = compare("K3 rollout A=1", {"totals": (k.totals, p.totals),
                                    "traj": (k.traj, p.traj)})
    check_bits("K3 rollout", (k.totals, p.totals), (k.traj, p.traj))
    print_k3_plans("pendcart", 4, 1, T)
    traj = k.traj           # kernel-produced [x, u, c] stream, (T, 6, B)
    tot = k.totals[0]
    ms = cuda_ms(lambda: fwd(ladder, False, False), 20)
    plain_ms = cuda_ms(lambda: fwd(ladder, False, True), 3)
    ms1 = cuda_ms(lambda: fwd(al1, True, False), 20)
    plain_ms1 = cuda_ms(lambda: fwd(al1, True, True), 3)
    print(f"  K3 sweep A=6: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
          f"rollout A=1: kernel {ms1:.3f} ms, plain {plain_ms1:.1f} ms")
    w3r = k3_work(model, T, B, 1, True)
    print(f"  K3 bounds: sweep {k3_work(model, T, B, A, False)['bound_ms']:.4f}"
          f" ms, rollout {w3r['bound_ms']:.4f} ms ({w3r['bound_by']})")
    rec["k3_pendcart"] = dict(max_abs_err=max(e1, e2), ms=ms,
                              plain_ms=plain_ms, ms_rollout=ms1,
                              plain_ms_rollout=plain_ms1,
                              bound_ms_rollout=w3r["bound_ms"],
                              library_ms=None,
                              **k3_work(model, T, B, A, False))

    lam = torch.tensor(10.0 ** rng.uniform(-6, 2, B), dtype=torch.float32,
                       device=dev)
    lam[::8] = 0.0

    def bwd(emit, plain, tl=tiles, lm=lam):
        f = bk.backward_lanes_ref if plain else bk.backward_lanes
        return f(traj, lm, n=4, m=1, reg_type=2, lims=LIMS, derivs_tiles=tl,
                 emit=emit)

    errs = []
    for emit in ("gains", "full"):
        k, p = bwd(emit, False), bwd(emit, True)
        errs.append(compare(f"K1 {emit}", {
            "out": (k.out[:, :26], p.out[:, :26]),
            "dV": (k.stats[:2], p.stats[:2])}))
        if emit == "full":
            errs.append(compare("K1 full", {
                "Quu_inv": (k.out[:, 26], p.out[:, 26])}, QUU_INV_TOL))
        check(torch.equal(k.stats[2:], p.stats[2:]),
              f"K1 {emit}: diverged/diverge_idx differ")
        check_bits(f"K1 {emit}", (k.out, p.out), (k.stats, p.stats))
    gains = k.out[:, :5].contiguous()
    dV = k.stats[:2]
    # a concave control cost makes Quu ≤ 0 where λ·fuᵀfu cannot lift it:
    # the λ vector (zeros on every 8th lane) decides which lanes latch
    latch_tiles = pendcart_derivs_tiles(PendCartSpec(R=-1e-3))
    k, p = bwd("full", False, latch_tiles), bwd("full", True, latch_tiles)
    check(torch.equal(k.stats[2:], p.stats[2:]),
          "K1 latch: diverged/diverge_idx differ")
    n_latch = int((k.stats[2] > 0.5).sum())
    zk = (k.out[:, :5] == 0).all(dim=1)
    zp = (p.out[:, :5] == 0).all(dim=1)
    print(f"  K1 latch: {n_latch} of {B} lanes latched, identical "
          f"diverged/diverge_idx; {int((zk != zp).sum())} of {T * B} steps "
          f"where only one version zeroed the gains")
    # Quu⁻¹ is not compared here: on these lanes Vxx turns indefinite and
    # Quu = cuu + fuᵀVxx·fu cancels between large terms, so an ulp decides
    # its sign and with it whether the 1e-30 Cholesky guard returns 1e30.
    # The main spec's full emission above holds Quu⁻¹ to QUU_INV_TOL.
    compare("K1 latch", {"k, K, Vx, Vxx, Quu": (k.out[:, :26],
                                                p.out[:, :26])}, LATCH_TOL)
    check(0 < n_latch, "K1 latch: no lane latched")
    ms = cuda_ms(lambda: bwd("gains", False), 20)
    plain_ms = cuda_ms(lambda: bwd("gains", True), 3)
    msf = cuda_ms(lambda: bwd("full", False), 20)
    plain_msf = cuda_ms(lambda: bwd("full", True), 3)
    print(f"  K1 gains: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
          f"full: kernel {msf:.3f} ms, plain {plain_msf:.1f} ms")
    rec["k1_pendcart"] = dict(max_abs_err=max(errs), ms=ms,
                              plain_ms=plain_ms, ms_full=msf,
                              plain_ms_full=plain_msf, library_ms=None,
                              **k1_work(model, T, B, "gains", 2, LIMS))

    allow = (torch.arange(B, device=dev) % 2 == 0).float()
    sel = torch.stack([dV[0], dV[1], tot, allow])

    def ls(plain, s=sel):
        f = fk.linesearch_lanes_ref if plain else fk.linesearch_lanes
        return f(traj, gains, x0_l, s, model=model, alphas=cfg.alphas,
                 reduce_ratio_min=0.0, lims=LIMS, gk=0, gK=1)

    k, p = ls(False), ls(True)
    e = compare("K2 rr_min=0", {"traj": (k.traj, p.traj),
                                "totals": (k.ls[4], p.ls[4])})
    check(torch.equal(k.ls[:2], p.ls[:2]), "K2: al_sel/any_ok differ")
    check_bits("K2", (k.traj, p.traj), (k.ls, p.ls))
    n_acc = int(((k.ls[1] > 0.5) & (allow > 0.5)).sum())
    print(f"  K2: {n_acc} of {B} lanes accept")
    ms = cuda_ms(lambda: ls(False), 20)
    plain_ms = cuda_ms(lambda: ls(True), 3)
    print(f"  K2: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    rec["k2_pendcart"] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                              library_ms=None, **k2_work(model, T, B, A))
    # trap 6 across kernels: a K3 stream re-rolled by K2 with α=0 everywhere
    out = ls(False, torch.stack([dV[0], dV[1], tot, torch.zeros_like(tot)]))
    check(torch.equal(out.traj, traj),
          "K2 α=0 retrace of a K3 stream is not bit-exact")
    print("  K2 α=0 retrace of the K3 stream: bit-exact")
    torch.cuda.synchronize()

    ph.start("ilqg-path", f"ilqg_batch_lanes, pendcart B={B} T={T}, "
             f"{A}-α ladder, reg_type 2, ±5, max_steps={ITERS}")
    u0s = torch.zeros((B, T, 1), device=dev)

    def solve(x0, u0, trace=False):
        return ilqg_batch_lanes(model, None, x0, u0, lims=LIMS, cfg=cfg,
                                derivs_tiles=tiles, max_steps=ITERS,
                                record_trace=trace)

    warm = solve(x0s, u0s, trace=True)         # warm-up, initial costs
    cost_init = warm.trace.cost[:, 0]
    del warm
    counters = (bk.backward_lanes, fk.linesearch_lanes, fk.forward_lanes,
                ck.covariance_lanes, pk.probe_lanes)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0 = time.perf_counter()

    def timed_solve():
        s.record()
        out = solve(x0s, u0s)
        e.record()
        return out

    r, launches = counted(counters, timed_solve)
    wall_ms = (time.perf_counter() - t0) * 1e3
    solve_ms = s.elapsed_time(e)
    iters = int(r.n_iters.max())
    ct = r.cost_total
    reasons = {int(v): int(n) for v, n in zip(*torch.unique(
        r.reason, return_counts=True))}
    print(f"  launches: {launches}")
    print(f"  cost_total min/median/max: {ct.min().item():.6g} / "
          f"{ct.median().item():.6g} / {ct.max().item():.6g} "
          f"(initial rollout median {cost_init.median().item():.6g})")
    print(f"  reasons: {reasons}; max n_iters {iters}; "
          f"accepted mean {r.n_accepted.float().mean().item():.3f}")
    print(f"  solve: {solve_ms:.3f} ms (CUDA events), {wall_ms:.3f} ms host "
          f"clock; {solve_ms / max(iters, 1):.4f} ms/iter over {iters} "
          f"iterations")
    kern_ms = (launches["backward_lanes"] * rec["k1_pendcart"]["ms"]
               + launches["linesearch_lanes"] * rec["k2_pendcart"]["ms"])
    print(f"  kernel share estimate: {kern_ms:.3f} ms of {solve_ms:.3f} ms "
          f"in K1(gains)+K2 at their phase-3 times; the rest is K3, the "
          f"full replay, torch glue and host syncs")
    check(all(launches[c.__name__] > 0 for c in counters[:3]),
          f"a kernel of the main path never ran: {launches}")
    check(1 <= iters <= ITERS, f"n_iters {iters}")
    ok5 = r.reason != 5
    check(bool(torch.isfinite(ct[ok5]).all()), "non-finite cost")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.u).all()),
          "non-finite trajectory")
    check(r.x.shape == (B, T, 4) and r.policy.K.shape == (B, T, 1, 4),
          "result shapes")
    check(ct.median() < cost_init.median(), "median cost did not improve")
    # trap 6 on the solution: rejected lanes retrace bit for bit
    st = torch.cat([to_streams(r.x), to_streams(r.u),
                    to_streams(r.cost[..., None])], dim=1)
    bo = bk.backward_lanes(st, r.lam, n=4, m=1, reg_type=2, lims=LIMS,
                           derivs_tiles=tiles, emit="gains")
    sel = torch.stack([bo.stats[0], bo.stats[1], ct, allow])
    out = fk.linesearch_lanes(st, bo.out, x0_l, sel, model=model,
                              alphas=cfg.alphas, lims=LIMS, gk=0, gK=1)
    rej = (out.ls[1] < 0.5) | (allow < 0.5)
    check(torch.equal(out.traj[..., rej], st[..., rej]),
          "rejected lanes of the solution do not retrace bit for bit")
    print(f"  retrace: {int(rej.sum())} rejected lanes reproduce the "
          f"solution stream bit for bit")
    launches_ilqg = launches
    ilqg = dict(cfg=cfg, x0s=x0s, cost_total=ct, reason=r.reason,
                n_accepted=r.n_accepted, ms_iter=solve_ms / max(iters, 1))
    del r, bo, out, st

    ph.start("ilqg-gpu-vs-cpu", f"first {B_CPU} scenarios, T={T}, "
             f"max_steps={ITERS}")
    early_gpu = {"ilqg": solve(x0s[:B_CPU], u0s[:B_CPU])}
    print("  the card's solve; the CPU's, in the --early-cpu child, is "
          "compared in early-gpu-vs-cpu")

    paths = {"ilqg": launches_ilqg}
    paths.update(quad_phases(ph, dev, rec, counters, ilqg, early_gpu))
    # the controls group's libraries (≈1900 s of nvcc, the longest ≈400 s)
    # and its CPU child start here, not with the earlier groups': the
    # in-process CPU solves of the first phases lost half their speed to
    # them
    cmodels = controls_models()
    cbuilds = (cmodels, start_controls_builds(cmodels))
    controls_proc = start_cpu_child("--controls-cpu")
    CHILDREN.append(controls_proc)
    # the humanoid group's libraries (the lowered K2/K3 at <54,21> and
    # <64,32> take minutes of nvcc) and its CPU child, with the controls'
    hbuilds = (humanoid_models(), start_cpu_child("--humanoid-build"))
    CHILDREN.append(hbuilds[1])
    humanoid_proc = start_cpu_child("--humanoid-cpu")
    CHILDREN.append(humanoid_proc)
    # the sources group's lowered libraries and its CPU child, with theirs
    srcmodels = sources_models()
    srcbuilds = (srcmodels, start_sources_builds(srcmodels), source_lib)
    sources_proc = start_cpu_child("--sources-cpu")
    CHILDREN.append(sources_proc)
    paths.update(kl_phases(ph, dev, rec, counters, model, tiles, spec,
                           early_gpu))
    paths["lti"] = lti_phases(ph, dev, rec, counters, early_gpu)
    paths.update(kl_lti_phases(ph, dev, rec, counters, early_gpu))
    paths.update(hetero_phases(ph, dev, rec, counters, ilqg, early_gpu))
    paths.update(mpc_phases(ph, dev, rec, counters, early_gpu))
    paths.update(probe_phase(ph, dev, rec, counters))
    generic = generic_phases(ph, dev, counters)
    paths.update(packed_phases(ph, dev, rec, counters, ilqg, cpu_proc))
    fleet_paths, fleet = fleet_phases(ph, dev, counters)
    paths.update(fleet_paths)
    paths.update(m3_phases(ph, dev, rec, counters, m3_proc))
    m3 = rec.pop("m3")
    paths.update(lowered_phases(ph, dev, rec, counters, builds, cpu_proc))
    lowered = rec.pop("lowered")
    paths.update(tiles_phases(ph, dev, rec, counters, tbuilds, tiles_proc))
    tiles_group = dict(seconds=rec.pop("tiles")["seconds"],
                       builds=rec.pop("tiles_builds"))
    paths.update(ladder_phases(ph, dev, rec, counters, ilqg, builds,
                               demos_proc))
    ladder = dict(fleet=rec.pop("ladder_fleet"),
                  worst=rec.pop("ladder_worst"))
    paths.update(demos_phases(ph, dev, counters, demos_proc))
    aot_paths, aot = aot_phase(ph, dev, counters)
    paths.update(aot_paths)
    paths.update(sizes_phases(ph, dev, rec, counters, sbuilds, sizes_proc))
    sizes = rec.pop("sizes")
    for v in sizes["builds"]["libraries"].values():
        v.pop("ptxas")
    paths.update(controls_phases(ph, dev, rec, counters, cbuilds,
                                 controls_proc))
    controls_group = rec.pop("controls")
    paths.update(humanoid_phases(ph, dev, rec, counters, hbuilds,
                                 humanoid_proc))
    humanoid = rec.pop("humanoid")
    paths.update(sources_phases(ph, dev, rec, counters, srcbuilds,
                                sources_proc))
    sources = rec.pop("sources")
    early_gpu_vs_cpu(ph, early_proc, early_gpu)

    # ---- record and result: one entry per kernel instance, its launches
    #      summed over the paths that run it
    walls = ph.summary()
    print(f"  phase walls: {walls}")
    src = "differentialdynamicprogramming_jl_tpu_torch/ops/hopper/csrc/"
    tpu = "differentialdynamicprogramming_jl_tpu/ops/pallas/"
    k1, k2, k3, k4 = (tpu + "backward_kernel.py:729",
                      tpu + "forward_kernel.py:506",
                      tpu + "forward_kernel.py:198",
                      tpu + "covariance_kernel.py:28")
    k5 = "tools/probe_kernel_cost.py:38"
    # the fleet group's paths (fleet_phases)
    fleet_pend = ("fleet_pendcart", "fleet_pendcart_big", "sharded_pendcart")
    fleet_kl = ("fleet_kl", "fleet_kl_step", "sharded_kl")
    instances = (   # record key, wrapper, instance, source, TPU kernel, paths
        ("k1_pendcart", "backward_lanes", "pendcart <4,1> gains, full",
         "backward.cu", k1, ("ilqg", "ladder", "demos_fleet", "aot_lanes")
         + fleet_pend),
        ("k1_pendcart_mpc", "backward_lanes",
         "pendcart <4,1> gains, full, T=300", "backward.cu", k1,
         ("mpc", "iteration")),
        ("k1_pendcart_gps", "backward_lanes", "pendcart <4,1> GPS policy",
         "backward.cu", k1, ("kl", "gps") + fleet_kl),
        ("k1_lti", "backward_lanes", "LTI <10,2> gains, full",
         "backward_lti.cu", k1, ("lti", "fleet_lti")),
        ("k1_lti_gps", "backward_lanes", "LTI <10,2> GPS policy",
         "backward_lti_gps.cu", k1, ("kl_lti", "gps_lti")),
        ("k1_quad", "backward_lanes",
         "Autodiff<Quadrotor> <6,2> gains, full", "backward_quad.cu", k1,
         ("quad", "demos_quadrotor")),
        ("k1_pendcart_ad", "backward_lanes",
         "Autodiff<PendCart> <4,1> gains, full", "backward_pendcart_ad.cu",
         k1, ("ilqg_ad",)),
        ("k1_pendcart_param", "backward_lanes",
         "PendCartParam <4,1> gains, full, per-scenario limits",
         "backward_pendcart_param.cu", k1, ("hetero",)),
        ("k1_pendcart_param_mpc", "backward_lanes",
         "PendCartParam <4,1> gains, full, per-scenario limits, T=300",
         "backward_pendcart_param.cu", k1, ("mpc_hetero",)),
        ("k1_lti_lanes", "backward_lanes",
         "LTI <10,2> gains, full, per-scenario limits", "backward_lti.cu", k1,
         ("hetero_lti",)),
        ("k2_pendcart", "linesearch_lanes", "pendcart <4,1>", "forward.cu", k2,
         ("ilqg", "tiles_so", "demos_fleet", "aot_lanes") + fleet_pend),
        ("k2_pendcart_a11", "linesearch_lanes",
         "pendcart <4,1> A=11 (ILQGConfig()'s ladder, two rounds)",
         "forward.cu", k2, ("ladder",)),
        ("k2_pendcart_mpc", "linesearch_lanes", "pendcart <4,1> A=4, T=300",
         "forward.cu", k2, ("mpc",)),
        ("k2_pendcart_inplace", "linesearch_lanes",
         "pendcart <4,1> A=4, T=300, in place", "forward.cu", k2,
         ("iteration",)),
        ("k2_pendcart_param", "linesearch_lanes",
         "PendCartParam <4,1>, per-scenario limits",
         "forward_pendcart_param.cu", k2, ("hetero",)),
        ("k2_pendcart_param_mpc", "linesearch_lanes",
         "PendCartParam <4,1> A=4, T=300, per-scenario limits",
         "forward_pendcart_param.cu", k2, ("mpc_hetero",)),
        ("k2_lti_lanes", "linesearch_lanes", "LTI <10,2>, per-scenario limits",
         "forward_lti.cu", k2, ("hetero_lti",)),
        ("k2_lti", "linesearch_lanes", "LTI <10,2>", "forward_lti.cu", k2,
         ("lti", "fleet_lti")),
        ("k2_quad", "linesearch_lanes", "quadrotor <6,2>", "forward_quad.cu",
         k2, ("quad", "demos_quadrotor")),
        ("k3_pendcart", "forward_lanes", "pendcart <4,1>", "forward.cu", k3,
         ("ilqg", "kl", "gps", "tiles_so", "demos_fleet", "aot_lanes")
         + fleet_pend + fleet_kl),
        ("k3_pendcart_a11", "forward_lanes",
         "pendcart <4,1> A=11 sweep (launches of 8 and 3)", "forward.cu", k3,
         ("ladder",)),
        ("k3_pendcart_mpc", "forward_lanes", "pendcart <4,1> A=1, T=300",
         "forward.cu", k3, ("mpc",)),
        ("k3_pendcart_param", "forward_lanes",
         "PendCartParam <4,1>, per-scenario limits",
         "forward_pendcart_param.cu", k3, ("hetero",)),
        ("k3_pendcart_param_mpc", "forward_lanes",
         "PendCartParam <4,1> A=1, T=300, per-scenario limits",
         "forward_pendcart_param.cu", k3, ("mpc_hetero",)),
        ("k3_lti_lanes", "forward_lanes", "LTI <10,2>, per-scenario limits",
         "forward_lti.cu", k3, ("hetero_lti",)),
        ("k3_lti", "forward_lanes", "LTI <10,2>", "forward_lti.cu", k3,
         ("lti", "kl_lti", "gps_lti", "fleet_lti")),
        ("k3_quad", "forward_lanes", "quadrotor <6,2>", "forward_quad.cu", k3,
         ("quad", "demos_quadrotor")),
        ("k1_lti3", "backward_lanes",
         "LTI <10,3> gains, full (masked box QP; Cholesky unconstrained)",
         "backward_lti_10_3.cu", k1, ("m3_lti", "m3_fleet")),
        ("k1_lti3_gps", "backward_lanes", "LTI <10,3> GPS policy",
         "backward_lti_gps_10_3.cu", k1, ("m3_kl",)),
        ("k2_lti3", "linesearch_lanes", "LTI <10,3>", "forward_lti_10_3.cu",
         k2, ("m3_lti", "m3_fleet")),
        ("k3_lti3", "forward_lanes", "LTI <10,3>", "forward_lti_10_3.cu", k3,
         ("m3_lti", "m3_fleet", "m3_kl")),
        ("k4_4", "covariance_lanes", "n=4", "covariance.cu", k4,
         ("kl", "gps", "rail_kl") + fleet_kl),
        ("k4_10", "covariance_lanes", "n=10", "covariance.cu", k4,
         ("kl_lti", "gps_lti", "tiles_lti_kl")),
        # n=6: the quadrotor's state, KL on the quadrotor
        ("k4_6", "covariance_lanes", "n=6", "covariance.cu", k4,
         ("quad_kl", "quad_kl_lowered")),
        ("k1_quad_gps", "backward_lanes",
         "Autodiff<Quadrotor> <6,2> GPS policy", "backward_quad.cu", k1,
         ("quad_kl",)),
        # the lowered models' instances (the lowered group): their source
        # is lowered.cuh with a struct that ops/hopper/lower.py generates
        ("k1_lowered_quad", "backward_lanes",
         "Autodiff<Lowered> quadrotor <6,2> gains, full", "lowered.cuh", k1,
         ("lowered_quad", "lowered_diff")),
        ("k1_lowered_quad_gps", "backward_lanes",
         "Autodiff<Lowered> quadrotor <6,2> GPS policy", "lowered.cuh", k1,
         ("quad_kl_lowered",)),
        ("k1_lowered_quad_so", "backward_lanes",
         "Autodiff<Lowered,SO> quadrotor <6,2> gains, full (full DDP)",
         "lowered.cuh", k1, ()),
        ("k1_lowered_lti", "backward_lanes",
         "Autodiff<Lowered> LTI <10,2> gains, full", "lowered.cuh", k1, ()),
        ("k1_lowered_param", "backward_lanes",
         "Autodiff<Lowered> PendCartParam <4,1> gains, full, params",
         "lowered.cuh", k1, ("lowered_hetero",)),
        ("k2_lowered_quad", "linesearch_lanes", "Lowered quadrotor <6,2>",
         "lowered.cuh", k2, ("lowered_quad",)),
        ("k2_lowered_param", "linesearch_lanes",
         "Lowered PendCartParam <4,1>, params", "lowered.cuh", k2,
         ("lowered_hetero",)),
        ("k2_lowered_diff", "linesearch_lanes",
         "Lowered quadrotor <6,2> with diff", "lowered.cuh", k2,
         ("lowered_diff",)),
        ("k3_lowered_quad", "forward_lanes", "Lowered quadrotor <6,2>",
         "lowered.cuh", k3, ("lowered_quad", "quad_kl_lowered")),
        ("k3_lowered_param", "forward_lanes",
         "Lowered PendCartParam <4,1>, params", "lowered.cuh", k3,
         ("lowered_hetero",)),
        ("k3_lowered_diff", "forward_lanes",
         "Lowered quadrotor <6,2> with diff", "lowered.cuh", k3,
         ("lowered_diff",)),
        # the tiles group: a user's tiles lowered (LoweredTiles) and the
        # instances of models that read t
        ("k1_tiles_lti", "backward_lanes",
         "LoweredTiles LTI <10,2> gains, full (a user's tiles)",
         "lowered.cuh", k1, ("tiles_lti",)),
        ("k1_tiles_lti_gps", "backward_lanes",
         "LoweredTiles LTI <10,2> GPS policy (a user's tiles)",
         "lowered.cuh", k1, ("tiles_lti_kl",)),
        ("k1_tiles_track", "backward_lanes",
         "LoweredTiles LTI <10,2> gains, full, reading t", "lowered.cuh",
         k1, ("lti_track",)),
        ("k1_tiles_so", "backward_lanes",
         "LoweredTiles pendcart <4,1> second order gains, full",
         "lowered.cuh", k1, ("tiles_so",)),
        ("k1_lowered_quad_track", "backward_lanes",
         "Autodiff<Lowered> quadrotor <6,2> gains, full, reading t",
         "lowered.cuh", k1, ("quad_track",)),
        ("k2_lowered_lti", "linesearch_lanes", "Lowered LTI <10,2>",
         "lowered.cuh", k2, ("tiles_lti",)),
        ("k2_lowered_track", "linesearch_lanes",
         "Lowered LTI <10,2> reading t", "lowered.cuh", k2, ("lti_track",)),
        ("k2_lowered_quad_track", "linesearch_lanes",
         "Lowered quadrotor <6,2> reading t", "lowered.cuh", k2,
         ("quad_track",)),
        ("k3_lowered_lti", "forward_lanes", "Lowered LTI <10,2>",
         "lowered.cuh", k3, ("tiles_lti", "tiles_lti_kl")),
        ("k3_lowered_track", "forward_lanes", "Lowered LTI <10,2> reading t",
         "lowered.cuh", k3, ("lti_track",)),
        ("k3_lowered_quad_track", "forward_lanes",
         "Lowered quadrotor <6,2> reading t", "lowered.cuh", k3,
         ("quad_track",)),
        ("k1_packed_pendcart", "backward_lanes", "packed <4,1> gains, full",
         "backward_packed.cu", k1, ("packed",)),
        ("k1_packed_pendcart_gps", "backward_lanes", "packed <4,1> GPS full",
         "backward_packed.cu", k1, ("pallas_gps",)),
        ("k1_packed_quad", "backward_lanes", "packed <6,2> gains, full",
         "backward_packed.cu", k1, ("quad_packed",)),
        ("k1_packed_lti", "backward_lanes", "packed <10,2> gains, full",
         "backward_packed_lti.cu", k1, ("lti_packed",)),
        ("k1_pendcart_so", "backward_lanes",
         "PendCartSO <4,1> gains, full (full DDP)", "backward_so.cu", k1,
         ("full_ddp",)),
        ("k1_pendcart_ad_so", "backward_lanes",
         "Autodiff<PendCart,SO> <4,1> gains, full (full DDP)",
         "backward_so.cu", k1, ("ilqg_ad_full_ddp",)),
        ("k1_quad_so", "backward_lanes",
         "Autodiff<Quadrotor,SO> <6,2> gains, full (full DDP)",
         "backward_quad_so.cu", k1, ("quad_full_ddp",)),
        # the sizes group: the op set's later ops (the rail, the op-set and
        # pow models), the LTI at <8,2> without a descriptor, K4 at any n
        # and the packed K1 at any size, each a library generated at its
        # first launch (covariance.cuh, packed.cuh, lowered.cuh)
        ("k3_rail", "forward_lanes", "Lowered rail <4,1>", "lowered.cuh", k3,
         ("rail", "rail_kl")),
        ("k2_rail", "linesearch_lanes", "Lowered rail <4,1>", "lowered.cuh",
         k2, ("rail",)),
        ("k1_rail", "backward_lanes", "Autodiff<Lowered> rail <4,1> gains, "
         "full", "lowered.cuh", k1, ("rail",)),
        ("k1_rail_gps", "backward_lanes", "Autodiff<Lowered> rail <4,1> GPS "
         "policy", "lowered.cuh", k1, ("rail_kl",)),
        ("k3_lti8", "forward_lanes", "Lowered LTI <8,2>", "lowered.cuh", k3,
         ("lti8", "lti8_kl", "lti8_packed")),
        ("k2_lti8", "linesearch_lanes", "Lowered LTI <8,2>", "lowered.cuh",
         k2, ("lti8", "lti8_packed")),
        ("k1_lti8", "backward_lanes", "LoweredTiles LTI <8,2> gains, full",
         "lowered.cuh", k1, ("lti8",)),
        ("k1_lti8_gps", "backward_lanes", "LoweredTiles LTI <8,2> GPS "
         "policy", "lowered.cuh", k1, ("lti8_kl",)),
        ("k4_8", "covariance_lanes", "n=8", "covariance.cuh", k4,
         ("lti8_kl",)),
        ("k1_packed_8_2", "backward_lanes", "packed <8,2> gains, full",
         "packed.cuh", k1, ("lti8_packed",)),
        ("k1_packed_5_4", "backward_lanes", "packed <5,4> gains, full",
         "packed.cuh", k1, ()),
        ("k3_opset", "forward_lanes", "Lowered op-set <3,2>", "lowered.cuh",
         k3, ()),
        ("k2_opset", "linesearch_lanes", "Lowered op-set <3,2>",
         "lowered.cuh", k2, ()),
        ("k1_opset", "backward_lanes", "Autodiff<Lowered> op-set <3,2> "
         "gains, full", "lowered.cuh", k1, ()),
        ("k1_opset_so", "backward_lanes", "Autodiff<Lowered,SO> op-set <3,2> "
         "gains, full (Jet passes)", "lowered.cuh", k1, ()),
        ("k3_pow", "forward_lanes", "Lowered pow <8,1> (powc_ at 8 "
         "exponents)", "lowered.cuh", k3, ()),
        # the controls group: m above the kernel library's MAX_M = 4, from
        # libraries generated for their own m (lowered.cuh, packed.cuh,
        # covariance.cuh); the arm7 path and the tie model's
        ("k3_arm7", "forward_lanes", "Lowered LTI <14,7>", "lowered.cuh", k3,
         ("arm7", "arm7_kl")),
        ("k2_arm7", "linesearch_lanes", "Lowered LTI <14,7>", "lowered.cuh",
         k2, ("arm7",)),
        ("k1_arm7", "backward_lanes", "LoweredTiles LTI <14,7> gains, full",
         "lowered.cuh", k1, ("arm7",)),
        ("k1_arm7_gps", "backward_lanes", "LoweredTiles LTI <14,7> GPS "
         "policy", "lowered.cuh", k1, ("arm7_kl",)),
        ("k4_14", "covariance_lanes", "n=14", "covariance.cuh", k4,
         ("arm7_kl",)),
        ("k3_ties", "forward_lanes", "Lowered tie pendcart <4,1>",
         "lowered.cuh", k3, ("ties",)),
        ("k2_ties", "linesearch_lanes", "Lowered tie pendcart <4,1>",
         "lowered.cuh", k2, ("ties",)),
        ("k1_ties", "backward_lanes", "Autodiff<Lowered> tie pendcart <4,1> "
         "gains, full (JAX's rules at ties)", "lowered.cuh", k1, ("ties",)),
        ("k1_packed_6_5", "backward_lanes", "packed <6,5> gains, full",
         "packed.cuh", k1, ()),
        ("k1_packed_10_8", "backward_lanes", "packed <10,8> gains, full",
         "packed.cuh", k1, ()),
        # the humanoid group: K1's wide design (one library, any size,
        # backward_wide.cuh) and K2/K3 past their two-stage ring
        ("k1_humanoid", "backward_lanes", "wide LTI <54,21> gains, full "
         "(the packed stream the tiles make)", "backward_wide.cuh", k1,
         ("humanoid",)),
        ("k1_humanoid_gps", "backward_lanes", "wide LTI <54,21> GPS policy",
         "backward_wide.cuh", k1, ("humanoid_kl",)),
        ("k1_wide_30_2", "backward_lanes", "wide LTI <30,2> full",
         "backward_wide.cuh", k1, ()),
        ("k1_wide_28_8", "backward_lanes", "wide LTI <28,8> gains, full, "
         "policy", "backward_wide.cuh", k1, ()),
        ("k1_wide_28_8_gps", "backward_lanes", "wide LTI <28,8> GPS full, "
         "policy", "backward_wide.cuh", k1, ()),
        ("k1_wide_ceiling", "backward_lanes", "wide LTI <64,32> gains",
         "backward_wide.cuh", k1, ()),
        ("k3_humanoid", "forward_lanes", "Lowered LTI <54,21> (one ring "
         "stage)", "lowered.cuh", k3, ("humanoid", "humanoid_kl")),
        ("k2_humanoid", "linesearch_lanes", "Lowered LTI <54,21> (one ring "
         "stage)", "lowered.cuh", k2, ("humanoid",)),
        ("k3_ceiling", "forward_lanes", "Lowered LTI <64,32> (K read from "
         "device memory)", "lowered.cuh", k3, ()),
        ("k2_ceiling", "linesearch_lanes", "Lowered LTI <64,32> (K read "
         "from device memory)", "lowered.cuh", k2, ()),
        ("k4_54", "covariance_lanes", "n=54 (Σ in device memory)",
         "covariance.cuh", k4, ("humanoid_kl",)),
        # the sources group: every public derivative source in the modes
        # the fleet entries launch
        ("k1_lti_ad", "backward_lanes", "Autodiff<LTI<10,2>> gains, full",
         "backward_lti_ad.cu", k1, ("lti_ad",)),
        ("k1_lti_ad_gps", "backward_lanes", "Autodiff<LTI<10,2>> GPS policy",
         "backward_lti_ad.cu", k1, ("kl_lti_ad",)),
        ("k1_lti3_ad", "backward_lanes", "Autodiff<LTI<10,3>> gains, full, "
         "GPS policy", "backward_lti_ad_10_3.cu", k1, ()),
        ("k1_lti_ad_so", "backward_lanes", "Autodiff<LTI<10,2>,SO> gains, "
         "full, GPS policy (full DDP)", "backward_lti_ad_so.cu", k1, ()),
        ("k1_lti3_ad_so", "backward_lanes", "Autodiff<LTI<10,3>,SO> gains, "
         "full, GPS policy (full DDP)", "backward_lti_ad_so_10_3.cu", k1,
         ()),
        ("k1_param_ad", "backward_lanes", "Autodiff<PendCartParam> <4,1> "
         "gains, full, params", "backward_pendcart_param_ad.cu", k1,
         ("hetero_ad",)),
        ("k1_param_ad_so", "backward_lanes", "Autodiff<PendCartParam,SO> "
         "<4,1> gains, full, params (full DDP)",
         "backward_pendcart_param_ad.cu", k1, ()),
        ("k1_pendcart_ad_gps", "backward_lanes", "Autodiff<PendCart> <4,1> "
         "GPS policy", "backward_pendcart_gps.cu", k1, ("kl_ad",)),
        ("k1_pendcart_ad_so_gps", "backward_lanes", "Autodiff<PendCart,SO> "
         "<4,1> GPS policy (full DDP)", "backward_pendcart_gps.cu", k1, ()),
        ("k1_pendcart_so_gps", "backward_lanes", "PendCartSO <4,1> GPS "
         "policy (full DDP)", "backward_pendcart_gps.cu", k1, ("kl_ddp",)),
        ("k1_quad_so_gps", "backward_lanes", "Autodiff<Quadrotor,SO> <6,2> "
         "GPS policy (full DDP)", "backward_quad_so_gps.cu", k1, ()),
        ("k1_lowered_so_gps", "backward_lanes", "Autodiff<Lowered,SO> "
         "pendcart <4,1> GPS full, policy (full DDP)", "lowered.cuh", k1,
         ()),
        ("k1_tiles_so_gps", "backward_lanes", "LoweredTiles pendcart <4,1> "
         "second order GPS full, policy (a user's full-DDP tiles)",
         "lowered.cuh", k1, ()),
    ) + tuple(
        entry for n, m in control_sizes() for entry in (
            (f"k3_c{n}_{m}", "forward_lanes", f"Lowered LTI <{n},{m}>",
             "lowered.cuh", k3, ()),
            (f"k1_c{n}_{m}", "backward_lanes", f"LoweredTiles LTI <{n},{m}> "
             "gains, full, policy", "lowered.cuh", k1, ()),
            (f"k1_c{n}_{m}_gps", "backward_lanes", f"LoweredTiles LTI "
             f"<{n},{m}> GPS full, policy", "lowered.cuh", k1, ()),
            (f"k1_c{n}_{m}_so", "backward_lanes", f"LoweredTiles LTI "
             f"<{n},{m}> second order gains, full", "lowered.cuh", k1, ()),
            (f"k2_c{n}_{m}", "linesearch_lanes", f"Lowered LTI <{n},{m}> A=6",
             "lowered.cuh", k2, ()),
            (f"k2_c{n}_{m}_a11", "linesearch_lanes", f"Lowered LTI <{n},{m}> "
             "A=11", "lowered.cuh", k2, ()))
    ) + tuple(
        (f"k4_{n}", "covariance_lanes", f"n={n}", "covariance.cuh", k4, ())
        for n in COV_NS + (cov_max_n(),) if n != LTI8_N) + (
        ("k5_copy", "probe_lanes", "copy", "probe.cu", k5, ("probe_copy",)),
        ("k5_light", "probe_lanes", "light", "probe.cu", k5, ("probe_light",)),
        ("k5_full", "probe_lanes", "full", "probe.cu", k5, ("probe_full",)),
    )
    kernels = []
    for key, wrapper, inst, source, replaces, on in instances:
        by_path = {path: paths[path][wrapper] for path in on}
        # an instance on no path counts the launches of its own phase
        own = rec[key].pop("phase_launches", None)
        launches = sum(by_path.values()) if on else own
        check(launches > 0,
              f"{wrapper} [{inst}] was never launched on {on}: {by_path}")
        kernels.append(dict(
            name=f"{wrapper} [{inst}]", route="cuda", source=src + source,
            replaces=replaces, launches=launches,
            launches_by_path=by_path,
            library=("x[:, :27].clone()" if key == "k5_copy" else LIBRARY),
            **rec[key]))
    print(json.dumps({"generic": generic}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"m3": m3}))
    print(json.dumps({"lowered": lowered}))
    print(json.dumps({"tiles": tiles_group}))
    print(json.dumps({"ladder": ladder}))
    print(json.dumps({"aot": aot}))
    print(json.dumps({"sizes": sizes}))
    print(json.dumps({"controls": controls_group}))
    print(json.dumps({"humanoid": humanoid}))
    print(json.dumps({"sources": sources}))
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# child processes main starts, stopped when it ends however it ends
CHILDREN: list = []
# the nice value of the CPU children and of the build threads' nvcc (at
# 10 the first phases' in-process CPU solves still ran at half speed)
BACKGROUND_NICE = 19

if __name__ == "__main__":
    if sys.argv[1:] == ["--packed-cpu"]:
        print(json.dumps(packed_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--m3-cpu"]:
        print(json.dumps(m3_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--lowered-cpu"]:
        print(json.dumps(lowered_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--tiles-cpu"]:
        print(json.dumps(tiles_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--demos-cpu"]:
        print(json.dumps(demos_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--sizes-cpu"]:
        print(json.dumps(sizes_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--controls-cpu"]:
        print(json.dumps(controls_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--early-cpu"]:
        print(json.dumps(early_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--humanoid-build"]:
        print(json.dumps(humanoid_builds()))
        sys.exit(0)
    if sys.argv[1:] == ["--humanoid-cpu"]:
        print(json.dumps(humanoid_cpu_solves()))
        sys.exit(0)
    if sys.argv[1:] == ["--sources-cpu"]:
        print(json.dumps(sources_cpu_solves()))
        sys.exit(0)
    try:
        rc = main()
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
            child.wait()
        for th in BUILD_THREADS:      # their nvcc processes end with them
            th.join()
    sys.exit(rc)
