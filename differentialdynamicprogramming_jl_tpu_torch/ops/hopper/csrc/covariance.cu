// K4: forward state-covariance propagation (discrete Lyapunov iteration).
//
// Replaces the TPU kernel
//   differentialdynamicprogramming_jl_tpu/ops/pallas/covariance_kernel.py
//   ::covariance_lanes
// (reference forward_covariance, src/forward_pass.jl:37-56):
//   Σ[0] = R1;   Σ[t+1] = F[t]·Σ[t]·F[t]ᵀ + R1,
// emitting Σ[t] at slot t. Its xx block feeds the policy KL of the KL/GPS
// solve (src/klutils.jl:77).
//
// Layout: fx (T, n², B) and the output (T, n², B), f32, row-major n×n in
// the slot axis, scenario axis contiguous; R1 is a static n×n passed by
// value. The kernels are templates over n (covariance.cuh); n = 4
// (pendcart), 6 (quadrotor) and 10 (LTI) are instantiated here, each with
// its launch shape, and any other n from 1 to plan.COV_MAX_N is a library
// of its own, generated and built at its first launch with the plan that
// plan.py derives from n (_build.covariance_library). Up to
// plan.COV_RING_MAX_N that is this design; beyond, Σ and a ring of F no
// longer fit a block's shared memory, and covariance_global_kernel keeps Σ
// in device memory (covariance.cuh).
//
// Design. A block owns RING_W = 32 scenarios: 128 blocks at B=4096. Its
// first G warps compute; the plan's producer warps after them fill a
// cp.async ring (ring.cuh) with F's n² slots for chunks of tc steps,
// issuing chunk c+stages-1 after chunk c's barrier, as K3 does. Σ[t] stays
// in shared memory, double-buffered [2][n²][32], and is never read back
// from device memory. Warp g owns rows i ≡ g (mod G) of a step: it forms
// those rows of F·Σ in registers (sweeping Σ's rows once), then those rows
// of Σ[t+1] from them and F's columns, every chain of a loop side by side
// and every store after the last product, so that a step is one block of
// straight-line code; it writes them into the other Σ buffer and to
// out[t+1] (one 128-byte line a slot row). The G warps meet at a named
// barrier each step, so the producers are never held; every lane reads and
// writes only its own scenario's column. The last step's F is never read.
// With STAGE the compute warps do not store: Σ is kept for two chunks,
// [2·tc][n²][32], and the producers store chunk c's Σ after the barrier
// that ends it, 16 bytes a store where B % 4 == 0. The launch shapes come
// from ops/hopper/plan.py (COV_WARPS, COV_PRODUCERS, COV_STAGES,
// COV_STAGE_OUT, covariance_plan), measured on an H100 80GB HBM3 at 700 W:
// n=10 five compute warps and two producers (1.57 ms; 1, 2, 4 and 10
// compute warps took 6.6, 5.2, 1.86 and 1.66 ms, and the producers storing
// Σ 2.4), n=6 six and two (0.21 ms), n=4 one compute warp and four
// producers that store Σ (0.146 ms against 0.174 with the compute warp
// storing). A step costs its warps' 4n³ f32 instructions and their shared
// loads (2n² + n·rows a warp a step); at n=10 five warps on four
// schedulers issue about as long as the bytes take.
//
// The design it replaces gave one thread a scenario in blocks of 128: 32
// blocks on 32 of the 132 SMs at B=4096, one warp on each, reloading Σ[t]
// from device memory on every step's dependent chain: 8.25 ms at n=10,
// T=1000 and 0.687 ms at n=4, T=500 (12% of the bound).
//
// Sum order kept from the TPU kernel (covariance_kernel.py:59-73):
//   FS[i][c] = Σ_a F[i][a]·S[a][c], then S'[i][j] = Σ_c FS[i][c]·F[j][c]
//   + R1[i][j], each sum left to right, every element computed (Σ is not
//   assumed symmetric: its two triangles differ in the last bits); built
//   with --fmad=false like the other kernels, so the plain PyTorch version
//   gives the same bits.
//
// What bounds it: it reads fx and writes Σ, n²·4 bytes each a
// scenario-step, and does 4n³+n² f32 operations a scenario-step (each
// multiply and add its own instruction under --fmad=false). At B=4096:
// n=10, T=1000 moves 3.28 GB (0.978 ms at 3.35 TB/s) and does 16.8 G
// operations (≈0.56 ms at 132 SMs × 128 lanes × 1.755 GHz); n=4, T=500
// 262 MB (0.078 ms) and 0.56 G (≈0.02 ms); n=6, T=400 472 MB (0.141 ms).
// Bytes bind at each.
#include "covariance.cuh"

// warps: the compute warps G, stage: whether the producers store Σ, the
// plan: ops/hopper/plan.py (COV_WARPS, COV_STAGE_OUT, covariance_plan); one
// instance an n, and a (warps, stage) it was not built for is refused
extern "C" int ddp_covariance_lanes(const float* fx, float* out, int T,
                                    int B, int n, const float* r1, int warps,
                                    int stage, int blocks, int threads,
                                    int tc, int stages, int smem, int device,
                                    void* stream) {
  using namespace ddp;
  if (T < 1 || B < 1) return ERR_ARGS;
  cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RingPlan p{blocks, threads, tc, stages, smem};
  if (n == 4 && warps == 1 && stage)
    return launch_covariance<4, 1, true>(fx, out, T, B, r1, p, st);
  if (n == 6 && warps == 6 && !stage)
    return launch_covariance<6, 6, false>(fx, out, T, B, r1, p, st);
  if (n == 10 && warps == 5 && !stage)
    return launch_covariance<10, 5, false>(fx, out, T, B, r1, p, st);
  return ERR_ARGS;
}
