// K4's kernels, as templates over the state size: the ring-fed kernel
// (covariance_kernel, Σ in shared memory) and, for an n whose Σ and ring do
// not fit a block, covariance_global_kernel (Σ in device memory). The
// design, the sum order and what bounds them: covariance.cu. covariance.cu
// instantiates n = 4, 6 and 10 in the kernel library; any other n is a
// library of its own, generated at its first launch (ops/hopper/_build.py
// covariance_source) with the plan that ops/hopper/plan.py derives from n.
#pragma once

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


// Σ in device memory, for an n whose Σ and ring do not fit a block's shared
// memory (plan.py COV_RING_MAX_N): G warps, no producers and no ring. Σ[t]
// is out[t], written by the block's own warps one step before, read back
// after the block barrier that ends that step (device memory, L1 and L2;
// out carries no __restrict__, so the loads see those stores); R1 is
// out[0], which the wrapper fills before the launch, so no n×n parameter
// is passed (4 KB at n = 32). Warp g owns rows i ≡ g (mod G), one at a
// time: FS[i][·] in n registers from F's row i and Σ[t]'s rows, then each
// entry of the row of Σ[t+1] from FS and F's rows, loops over a and j not
// unrolled, so that registers and code grow with n and not n². Sum order
// and rounding are cov_step's.
template <int NN, int G>
__global__ void __launch_bounds__(RING_W * G)
covariance_global_kernel(const float* __restrict__ fx, float* out, int T,
                         int B) {
  constexpr int NS = NN * NN;
  const int lane = threadIdx.x & (RING_W - 1), w = threadIdx.x / RING_W;
  const int b = blockIdx.x * RING_W + lane;
  const bool live = b < B;
  const size_t sB = (size_t)B;
  const float* const R = out + b;                 // Σ[0] = R1
  for (int t = 0; t + 1 < T; ++t) {
    __syncthreads();               // Σ[t] complete
    if (!live) continue;
    const float* F = fx + (size_t)t * NS * sB + b;
    const float* S = out + (size_t)t * NS * sB + b;
    float* Sn = out + (size_t)(t + 1) * NS * sB + b;
    for (int i = w; i < NN; i += G) {
      float FS[NN];
      {
        const float f = F[(size_t)(i * NN) * sB];
#pragma unroll
        for (int c = 0; c < NN; ++c) FS[c] = f * S[(size_t)c * sB];
      }
#pragma unroll 1
      for (int a = 1; a < NN; ++a) {
        const float f = F[(size_t)(i * NN + a) * sB];
#pragma unroll
        for (int c = 0; c < NN; ++c)
          FS[c] = FS[c] + f * S[(size_t)(a * NN + c) * sB];
      }
#pragma unroll 1
      for (int j = 0; j < NN; ++j) {
        const float* Fj = F + (size_t)(j * NN) * sB;
        float acc = FS[0] * Fj[0];
#pragma unroll
        for (int c = 1; c < NN; ++c) acc = acc + FS[c] * Fj[(size_t)c * sB];
        Sn[(size_t)(i * NN + j) * sB] = acc + R[(size_t)(i * NN + j) * sB];
      }
    }
  }
}

template <int NN, int G>
int launch_covariance_global(const float* fx, float* out, int T, int B,
                             const RingPlan& p, cudaStream_t st) {
  if (p.threads != RING_W * G || p.blocks != (B + RING_W - 1) / RING_W ||
      p.smem != 0)
    return ERR_ARGS;
  covariance_global_kernel<NN, G><<<p.blocks, p.threads, 0, st>>>(fx, out,
                                                                 T, B);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace ddp
