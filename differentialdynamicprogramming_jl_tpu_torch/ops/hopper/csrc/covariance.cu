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
// value. One thread owns one scenario and walks t = 0 .. T-1 with Σ and F in
// registers, where the TPU kept Σ in VMEM scratch across grid steps.
// Templated on n; n = 4 (pendcart) is instantiated, other n are refused
// with ERR_ARGS until their model's slice adds them.
//
// Sum order kept from the TPU kernel (covariance_kernel.py:59-73):
//   FS[i][c] = Σ_a F[i][a]·S[a][c], then S'[i][j] = Σ_c FS[i][c]·F[j][c]
//   + R1[i][j], each sum left to right; built with --fmad=false like the
//   other kernels, so the plain PyTorch version gives the same bits.
//
// What bounds it: at n=4, B=4096, T=500 it reads fx (≈131 MB; the last
// step's F is not needed) and writes Σ (≈131 MB), with 2n³ = 128 multiplies
// and adds per scenario-step. As in K1, B=4096 threads in blocks of 128 put
// one warp on each SM, so each step's 16 loads and its dependent chain of
// products are exposed latency; a faster layout is later work.
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
  float S[NN][NN];
#pragma unroll
  for (int i = 0; i < NN; ++i)
#pragma unroll
    for (int j = 0; j < NN; ++j) S[i][j] = r1.r[i * NN + j];

  for (int t = 0; t < T; ++t) {
    float* o = out + (size_t)t * NN * NN * sB + b;
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int j = 0; j < NN; ++j) o[(i * NN + j) * sB] = S[i][j];
    if (t == T - 1) break;   // Σ[T] is not emitted
    const float* f = fx + (size_t)t * NN * NN * sB + b;
    float F[NN][NN], FS[NN][NN];
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int j = 0; j < NN; ++j) F[i][j] = f[(i * NN + j) * sB];
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int c = 0; c < NN; ++c) {
        float s = F[i][0] * S[0][c];
#pragma unroll
        for (int a = 1; a < NN; ++a) s = s + F[i][a] * S[a][c];
        FS[i][c] = s;
      }
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        float s = FS[i][0] * F[j][0];
#pragma unroll
        for (int c = 1; c < NN; ++c) s = s + FS[i][c] * F[j][c];
        S[i][j] = s + r1.r[i * NN + j];
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
    default:
      return ERR_ARGS;
  }
}
