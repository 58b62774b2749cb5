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
// value. One thread owns one scenario and walks t = 0 .. T-1, where the TPU
// kept Σ in VMEM scratch across grid steps. Templated on n; n = 4
// (pendcart) and n = 10 (LTI) are instantiated, other n are refused with
// ERR_ARGS until their model's slice adds them.
//
// Registers. Σ, F and F·Σ are 3n² floats, 300 at n = 10: more than the 255
// registers a thread can hold. So F·Σ is never held whole: each step loads
// Σ[t] back from out[t], which the step before wrote (an L2 hit) and F[t]
// from fx, then forms row i of F·Σ (n floats) and at once row i of Σ[t+1],
// which goes straight to out[t+1]. Live: Σ and F (2n², 200 at n = 10) and
// two rows. Σ[t] is reloaded at the top of the next step, across the loop's
// back edge, where the compiler does not forward the stores into registers.
//
// Sum order kept from the TPU kernel (covariance_kernel.py:59-73):
//   FS[i][c] = Σ_a F[i][a]·S[a][c], then S'[i][j] = Σ_c FS[i][c]·F[j][c]
//   + R1[i][j], each sum left to right; built with --fmad=false like the
//   other kernels, so the plain PyTorch version gives the same bits.
//
// What bounds it: it reads fx (the last step's F is not needed) and writes
// Σ, n²·4 bytes each per scenario-step, with 2n³ multiplies and as many
// adds: at n=4, B=4096, T=500 ≈131 MB each way and 128 operations a step;
// at n=10, B=4096, T=1000 ≈1.64 GB each way (bound ≈0.98 ms) against
// ≈16 GFLOP (≈0.24 ms), so bytes bound it. As in K1, B=4096 threads in
// blocks of 128 put one warp on each SM, so each step's loads and its
// dependent chain of products are exposed latency; a faster layout is
// later work.
#include "common.cuh"

namespace ddp {

namespace {

constexpr int COV_THREADS = 128;

template <int NN>
struct R1 {
  float r[NN * NN];
};

template <int NN>
__global__ void __launch_bounds__(COV_THREADS)
covariance_kernel(const float* __restrict__ fx, float* __restrict__ out,
                  int T, int B, R1<NN> r1) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  auto slot = [&](int t, int s) { return ((size_t)t * NN * NN + s) * sB + b; };
#pragma unroll
  for (int s = 0; s < NN * NN; ++s) out[slot(0, s)] = r1.r[s];

  for (int t = 0; t < T - 1; ++t) {
    float S[NN][NN], F[NN][NN];
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        S[i][j] = out[slot(t, i * NN + j)];
        F[i][j] = fx[slot(t, i * NN + j)];
      }
#pragma unroll
    for (int i = 0; i < NN; ++i) {
      float FS[NN];                           // row i of F·Σ
#pragma unroll
      for (int c = 0; c < NN; ++c) {
        float s = F[i][0] * S[0][c];
#pragma unroll
        for (int a = 1; a < NN; ++a) s = s + F[i][a] * S[a][c];
        FS[c] = s;
      }
#pragma unroll
      for (int j = 0; j < NN; ++j) {          // row i of Σ[t+1]
        float s = FS[0] * F[j][0];
#pragma unroll
        for (int c = 1; c < NN; ++c) s = s + FS[c] * F[j][c];
        out[slot(t + 1, i * NN + j)] = s + r1.r[i * NN + j];
      }
    }
  }
}

template <int NN>
int launch_covariance(const float* fx, float* out, int T, int B,
                      const float* r1_host, cudaStream_t st) {
  R1<NN> r1;
  for (int i = 0; i < NN * NN; ++i) r1.r[i] = r1_host[i];
  const dim3 grid((B + COV_THREADS - 1) / COV_THREADS);
  covariance_kernel<NN><<<grid, COV_THREADS, 0, st>>>(fx, out, T, B, r1);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace ddp

extern "C" int ddp_covariance_lanes(const float* fx, float* out, int T,
                                    int B, int n, const float* r1,
                                    int device, void* stream) {
  using namespace ddp;
  if (T < 1 || B < 1) return ERR_ARGS;
  cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return launch_covariance<4>(fx, out, T, B, r1, st);
    case 10:
      return launch_covariance<10>(fx, out, T, B, r1, st);
    default:
      return ERR_ARGS;
  }
}
