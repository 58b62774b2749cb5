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
// value. Templated on n; n = 4 (pendcart), 6 (quadrotor) and 10 (LTI) are
// instantiated, each with its launch shape, other n are refused with
// ERR_ARGS.
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
#include "ring.cuh"

namespace ddp {

namespace {

constexpr int COV_MAX_PRODUCERS = 4;

template <int NN>
struct R1 {
  float r[NN * NN];
};

// One step of warp g of G: rows g, g+G, ... of Σ[t+1] from F[t] (ring, at
// column lane) and Σ[t] (S), each written to Sn and, unless null, to o
// (out[t+1] at this lane's scenario; slot s at o[s·sB]); r1 holds the
// same rows of R1. A warp with fewer rows than R repeats its last row and
// stores it once. Every product and sum of the step is formed before the
// first store, each loop's chains side by side, so that the step is one
// block of straight-line code.
template <int NN, int G>
__device__ __forceinline__ void cov_step(const float* F, const float* S,
                                         float* Sn, float* o, size_t sB,
                                         const float (&r1)[(NN + G - 1) / G]
                                                           [NN],
                                         int g) {
  constexpr int R = (NN + G - 1) / G;
  float Fi[R][NN], FS[R][NN], acc[R][NN];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(g + r * G, NN - 1);
#pragma unroll
    for (int a = 0; a < NN; ++a) Fi[r][a] = F[(i * NN + a) * RING_W];
  }
  // FS[r][c] = Σ_a F[i][a]·S[a][c], a from left to right
#pragma unroll
  for (int a = 0; a < NN; ++a)
#pragma unroll
    for (int c = 0; c < NN; ++c) {
      const float s = S[(a * NN + c) * RING_W];
#pragma unroll
      for (int r = 0; r < R; ++r)
        FS[r][c] = a == 0 ? Fi[r][0] * s : FS[r][c] + Fi[r][a] * s;
    }
  // acc[r][j] = Σ_c FS[r][c]·F[j][c], c from left to right
#pragma unroll
  for (int c = 0; c < NN; ++c) {
    float Fc[NN];
#pragma unroll
    for (int j = 0; j < NN; ++j) Fc[j] = F[(j * NN + c) * RING_W];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NN; ++j)
        acc[r][j] = c == 0 ? FS[r][0] * Fc[j] : acc[r][j] + FS[r][c] * Fc[j];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = g + r * G;
    if (r < R - 1 || i < NN) {     // every row but the last exists
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const float v = acc[r][j] + r1[r][j];
        Sn[(i * NN + j) * RING_W] = v;
        if (o) o[(i * NN + j) * sB] = v;
      }
    }
  }
}

// Block: G compute warps, then the producer warps. Dynamic shared memory:
// the ring (stages × tc steps × n² slots × 32), then Σ (2 slots, or 2·tc
// with STAGE). One block barrier a chunk: at barrier c chunk c has landed
// and the compute warps are done with chunk c-1, whose stage the
// producers then refill while the compute warps take chunk c.
template <int NN, int G, bool STAGE>
__global__ void __launch_bounds__(RING_W * (G + COV_MAX_PRODUCERS))
covariance_kernel(const float* __restrict__ fx, float* __restrict__ out,
                  int T, int B, R1<NN> r1, int tc, int stages, bool vec,
                  bool ovec) {
  constexpr int NS = NN * NN;
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x & (RING_W - 1), w = threadIdx.x / RING_W;
  const int b0 = blockIdx.x * RING_W, b = b0 + lane;
  const int cols = min(RING_W, B - b0);
  const size_t sB = (size_t)B;
  const int steps_all = T - 1;                  // steps that read an F
  const int nc = (steps_all + tc - 1) / tc;     // chunks
  const int stage = tc * NS * RING_W;           // floats a stage
  const int nsig = STAGE ? 2 * tc : 2;          // Σ slots; Σ[t] in t % nsig
  float* const sig = ring + stages * stage;

  if (w >= G) {
    const int tid = threadIdx.x - RING_W * G;
    const int nthr = blockDim.x - RING_W * G;
    auto issue = [&](int c) {
      if (c < nc) {
        const int t0 = c * tc, steps = min(tc, steps_all - t0);
        stage_rows<NS>(ring + (c % stages) * stage, steps, cols, vec, tid,
                       nthr, [&](int tt, int s) {
                         return fx + ((size_t)(t0 + tt) * NS + s) * sB + b0;
                       });
      }
      cp_async_commit();
    };
    // STAGE: chunk c's Σ[t0+1 .. t0+steps] to device memory
    // (Σ[t0+1 ..] are slots (c % 2)·tc + 1 .. of the 2·tc, wrapping once)
    auto flush = [&](int c) {
      const int t0 = c * tc, steps = min(tc, steps_all - t0);
      const int k0 = (c & 1) * tc + 1;
      if (ovec) {
        for (int i = tid; i < steps * NS * (RING_W / 4); i += nthr) {
          const int row = i >> 3, p = 4 * (i & 7);
          const int tt = row / NS, s = row - tt * NS;
          const int k = k0 + tt < nsig ? k0 + tt : k0 + tt - nsig;
          if (p < cols)
            *reinterpret_cast<float4*>(
                out + ((size_t)(t0 + 1 + tt) * NS + s) * sB + b0 + p) =
                *reinterpret_cast<const float4*>(
                    sig + (k * NS + s) * RING_W + p);
        }
      } else {
        for (int i = tid; i < steps * NS * RING_W; i += nthr) {
          const int row = i >> 5, col = i & 31;
          const int tt = row / NS, s = row - tt * NS;
          const int k = k0 + tt < nsig ? k0 + tt : k0 + tt - nsig;
          if (col < cols)
            out[((size_t)(t0 + 1 + tt) * NS + s) * sB + b0 + col] =
                sig[(k * NS + s) * RING_W + col];
        }
      }
    };
    for (int c = 0; c < stages - 1; ++c) issue(c);
    for (int c = 0; c < nc + STAGE; ++c) {
      if (c < nc) cp_async_wait(stages - 2);   // chunk c landed
      __syncthreads();             // everyone's; chunk c-1 is consumed
      if (c < nc) issue(c + stages - 1);       // into chunk c-1's stage
      if (STAGE && c > 0) flush(c - 1);
    }
    return;
  }

  const bool live = b < B;
  // this warp's rows of R1; Σ[0] = R1
  constexpr int R = (NN + G - 1) / G;
  float r1w[R][NN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NN; ++j)
      r1w[r][j] = r1.r[min(w + r * G, NN - 1) * NN + j];
  for (int i = w; i < NN; i += G)
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const int s = i * NN + j;
      sig[s * RING_W + lane] = r1.r[s];
      if (live) out[s * sB + b] = r1.r[s];
    }
  for (int c = 0; c < nc; ++c) {
    __syncthreads();               // chunk c is ready, c-1 consumed
    const int t0 = c * tc, steps = min(tc, steps_all - t0);
    const float* st = ring + (c % stages) * stage + lane;
    for (int tt = 0; tt < steps; ++tt) {
      const int t = t0 + tt;
      float* o = !STAGE && live ? out + (size_t)(t + 1) * NS * sB + b
                                : nullptr;
      // Σ[t] in slot t % nsig: (c % 2)·tc + tt with STAGE, else t % 2
      const int k = STAGE ? (c & 1) * tc + tt : t & 1;
      const int kn = k + 1 == nsig ? 0 : k + 1;
      cov_step<NN, G>(st + tt * NS * RING_W, sig + k * NS * RING_W + lane,
                      sig + kn * NS * RING_W + lane, o, sB, r1w, w);
      // Σ[t+1] complete before any warp reads it; the chunk's last step
      // meets the next chunk's block barrier instead
      if (G > 1 && tt + 1 < steps) named_bar(1, RING_W * G);
    }
  }
  if (STAGE) __syncthreads();      // the last chunk's Σ is complete
}

template <int NN, int G, bool STAGE>
int launch_covariance(const float* fx, float* out, int T, int B,
                      const float* r1_host, const RingPlan& p,
                      cudaStream_t st) {
  constexpr int NS = NN * NN;
  const int producers = p.threads / RING_W - G;
  const int nsig = STAGE ? 2 * p.tc : 2;
  if (p.threads % RING_W != 0 || producers < 1 ||
      producers > COV_MAX_PRODUCERS ||
      !plan_ok(p, B, p.threads, NS, nsig * NS * RING_W))
    return ERR_ARGS;
  R1<NN> r1;
  for (int i = 0; i < NS; ++i) r1.r[i] = r1_host[i];
  const auto kernel = covariance_kernel<NN, G, STAGE>;
  const int rc = reserve_smem(kernel, p.smem);
  if (rc != 0) return rc;
  kernel<<<p.blocks, p.threads, p.smem, st>>>(
      fx, out, T, B, r1, p.tc, p.stages, rows_aligned(B, fx),
      rows_aligned(B, out));
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace ddp

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
