// K1: batched backward pass (Riccati recursion) with in-kernel derivatives.
//
// Replaces the TPU kernel
//   differentialdynamicprogramming_jl_tpu/ops/pallas/backward_kernel.py
//   ::backward_lanes (built by ::_make_kernel)
// for the subset on the fleet iLQG and KL/GPS paths: m = 1, pendcart
// derivatives computed in-register from the (x, u) slots of the trajectory
// stream, static control limits or none, reg_type 1 or 2, GPS mode, and
// "gains", "full" or "policy" emission.
//
// Layout: every stream is (T, S, B) f32 with the scenario axis contiguous.
// One thread owns one scenario and walks t = T-1 .. 0 inside the kernel,
// with Vx[4], Vxx[4][4], dV1, dV2 and the divergence latch in registers.
// This loop takes the place of the TPU's sequential grid axis and its VMEM
// scratch. Output slots follow OutLayout: k, K[4] ("gains", 5 slots), then
// Vx[4], Vxx[16] ("full" only), then Quu, Quu⁻¹ ("full": 27 slots,
// "policy": 7). Stats (4, B): dV1, dV2, diverged, diverge_idx. GPS mode
// also reads the previous-policy stream prev (T, 6, B) [k, K[4], Σ⁻¹] and
// the dual eta (T, B).
//
// What bounds it: at B=4096, T=500 one launch reads the x,u slots of the
// traj stream (5 of its 6 slots, ≈41 MB), in GPS mode also prev and eta
// (≈57 MB), and writes the gains stream (≈41 MB), the policy stream
// (≈57 MB) or the full stream (≈221 MB); the arithmetic is ≈0.5 kflop per
// scenario-step. So the kernel should be bandwidth-bound once occupancy
// allows it. It does not yet: B=4096 threads in blocks of 128 give 32
// blocks for 132 SMs, one warp per SM, so each step's loads and its
// dependent chain of arithmetic are exposed latency. Spreading a scenario
// over several threads, or prefetching step t-1 while step t computes, is
// work for later changes.
//
// Semantics kept from the TPU kernel (backward_kernel.py line numbers):
// - the t = T-1 boundary writes Vx = cx, Vxx = cxx, zero gains, and in
//   "full"/"policy" emission Quu = cuu with its inverse; in GPS mode V stays
//   unscaled there and only the emitted Quu is cuu/η + Σ⁻¹_prev (:401-439);
// - reg_type 2 regularises only the gain solve (λ·fuᵀfx, λ·fuᵀfu); the
//   value update uses the unregularised Quu and Qux and symmetrises Vxx
//   (:499-507, :574-600);
// - GPS mode scales Qx, Qu, Qxx, Qux, Quu by 1/η, adds the KL expansion
//   from prev (read_kl :370-392), symmetrises Quu and ignores λ; a zero η
//   counts as 1 (:483-497, :795-797);
// - with limits, the m=1 clamp takes lo/hi relative to u_t, the KKT free
//   mask decides when K is 0, and quu_s is guarded at 1e-30 (:173-181,
//   :523-531); without limits, the unrolled Cholesky solve gives
//   k = ((-Qu)/L)/L and K_j = ((-Qux_j)/L)/L, L = sqrt(max(Quu, 1e-30))
//   (:514-522, :122-158);
// - the inverse uses sqrt(max(d, 1e-30)) as _tiny_chol does (:134);
// - a non-PD lane gets k = K = 0 and V keeps updating: the latch records
//   t+1 of the first failing step in backward order and does not stop the
//   recursion (:570-572, :605-612).
#include "pendcart.cuh"

namespace ddp {

namespace {

constexpr int N = PendCart::N;
constexpr int THREADS = 128;
// emission modes (backward_kernel.py EMIT_CODE) and their slot counts
constexpr int EMIT_GAINS = 0, EMIT_FULL = 1, EMIT_POLICY = 2;
constexpr int S_GAINS = 1 + N, S_FULL = 1 + N + N + N * N + 2,
              S_POLICY = 1 + N + 2;
constexpr int S_PREV = 1 + N + 1;   // prev slots [k_prev, K_prev[N], Σ⁻¹]

// Quu⁻¹ for m = 1 by the TPU kernel's unrolled Cholesky solve against e0
__device__ __forceinline__ float inv1(float q) {
  const float L = sqrtf(maxp(q, 1e-30f));
  const float y = 1.0f / L;
  return y / L;
}

// GPS mode at one step: the dual and the pieces of the KL expansion
// cx_i = Kp_i·Sik, cu = -Sik, cxx_ij = Kp_i·SiK_j, cxu_j = -SiK_j, cuu = Si
struct KL {
  float eta, Kp[N], Si, Sik, SiK[N];
};

__device__ __forceinline__ void read_kl(const float* __restrict__ prev,
                                        const float* __restrict__ eta, int t,
                                        int b, size_t sB, KL& kl) {
  const float e = eta[(size_t)t * sB + b];
  kl.eta = e == 0.0f ? 1.0f : e;
  const float* pv = prev + (size_t)t * S_PREV * sB + b;
  kl.Si = pv[(1 + N) * sB];
  kl.Sik = kl.Si * pv[0];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    kl.Kp[j] = pv[(1 + j) * sB];
    kl.SiK[j] = kl.Si * kl.Kp[j];
  }
}

template <int EMIT, bool GPS>
__global__ void __launch_bounds__(THREADS)
backward_kernel(const float* __restrict__ traj, int s_in,
                const float* __restrict__ lam,
                const float* __restrict__ prev, const float* __restrict__ eta,
                float* __restrict__ out, int s_out,
                float* __restrict__ stats, int T, int B, int reg_type,
                bool use_limits, float lim_lo, float lim_hi, ModelConsts mc) {
  constexpr bool VALUE = EMIT == EMIT_FULL;     // Vx, Vxx slots
  constexpr bool QUU = EMIT != EMIT_GAINS;      // Quu, Quu⁻¹ slots
  constexpr int OQ = VALUE ? 1 + N + N + N * N : 1 + N;   // Quu's slot
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const PendCart P(mc);
  const float lm = lam[b];
  const size_t sB = (size_t)B;
  auto in = [&](int t, int s) { return traj[((size_t)t * s_in + s) * sB + b]; };
  auto put = [&](int t, int s, float v) {
    out[((size_t)t * s_out + s) * sB + b] = v;
  };

  float Vx[N], Vxx[N][N];
  float dv1 = 0.0f, dv2 = 0.0f, div = 0.0f, divt = 0.0f;
  PendCart::Derivs dv;

  {  // boundary t = T-1
    const int t = T - 1;
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = in(t, i);
    P.derivs(x, in(t, N), dv);
    put(t, 0, 0.0f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      put(t, 1 + i, 0.0f);
      Vx[i] = dv.cx[i];
#pragma unroll
      for (int j = 0; j < N; ++j) Vxx[i][j] = dv.cxx[i][j];
    }
    if (VALUE) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        put(t, 1 + N + i, Vx[i]);
#pragma unroll
        for (int j = 0; j < N; ++j) put(t, 1 + 2 * N + i * N + j, Vxx[i][j]);
      }
    }
    if (QUU) {
      float cuu = dv.cuu;
      if (GPS) {
        KL kl;
        read_kl(prev, eta, t, b, sB, kl);
        cuu = cuu / kl.eta + kl.Si;
      }
      put(t, OQ, cuu);
      put(t, OQ + 1, inv1(cuu));
    }
  }

  for (int t = T - 2; t >= 0; --t) {
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = in(t, i);
    const float u = in(t, N);
    P.derivs(x, u, dv);

    // Q expansions (src/backward_pass.jl:103-123); each sum runs a = 0..n-1
    float Qx[N], W[N][N], U[N], Qxx[N][N], Qux[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = dv.fx[0][i] * Vx[0];
#pragma unroll
      for (int a = 1; a < N; ++a) s = s + dv.fx[a][i] * Vx[a];
      Qx[i] = dv.cx[i] + s;
    }
    float Qu;
    {
      float s = dv.fu[0] * Vx[0];
#pragma unroll
      for (int a = 1; a < N; ++a) s = s + dv.fu[a] * Vx[a];
      Qu = dv.cu + s;
    }
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = Vxx[a][0] * dv.fx[0][j];
#pragma unroll
        for (int c = 1; c < N; ++c) s = s + Vxx[a][c] * dv.fx[c][j];
        W[a][j] = s;
      }
      float s = Vxx[a][0] * dv.fu[0];
#pragma unroll
      for (int c = 1; c < N; ++c) s = s + Vxx[a][c] * dv.fu[c];
      U[a] = s;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = dv.fx[0][i] * W[0][j];
#pragma unroll
        for (int a = 1; a < N; ++a) s = s + dv.fx[a][i] * W[a][j];
        Qxx[i][j] = dv.cxx[i][j] + s;
      }
    }
    float Quu;
    {
      float s = dv.fu[0] * U[0];
#pragma unroll
      for (int a = 1; a < N; ++a) s = s + dv.fu[a] * U[a];
      Quu = dv.cuu + s;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = dv.fu[0] * W[0][j];
#pragma unroll
      for (int a = 1; a < N; ++a) s = s + dv.fu[a] * W[a][j];
      Qux[j] = dv.cxu[j] + s;
    }

    float Qux_r[N], QuuF;
    if (GPS) {
      // GPS mode: Q terms scaled by 1/η plus the KL expansion, Quu
      // symmetrised, λ unused (src/backward_pass.jl:293-299)
      KL kl;
      read_kl(prev, eta, t, b, sB, kl);
      const float ie = 1.0f / kl.eta;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        Qx[i] = Qx[i] * ie + kl.Kp[i] * kl.Sik;
#pragma unroll
        for (int j = 0; j < N; ++j)
          Qxx[i][j] = Qxx[i][j] * ie + kl.Kp[i] * kl.SiK[j];
        Qux[i] = Qux[i] * ie + (-kl.SiK[i]);
        Qux_r[i] = Qux[i];
      }
      Qu = Qu * ie + (-kl.Sik);
      const float qg = Quu * ie + kl.Si;
      Quu = 0.5f * (qg + qg);
      QuuF = Quu;
    } else if (reg_type == 2) {
      // regularised gain matrices (src/backward_pass.jl:119-123)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = dv.fu[0] * dv.fx[0][j];
#pragma unroll
        for (int a = 1; a < N; ++a) s = s + dv.fu[a] * dv.fx[a][j];
        Qux_r[j] = Qux[j] + lm * s;
      }
      float s = dv.fu[0] * dv.fu[0];
#pragma unroll
      for (int a = 1; a < N; ++a) s = s + dv.fu[a] * dv.fu[a];
      QuuF = Quu + lm * s;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) Qux_r[j] = Qux[j];
      QuuF = Quu + lm;
    }

    const bool ok = QuuF > 0.0f;
    float k, K[N];
    if (!use_limits) {
      // unconstrained m = 1 solve by the unrolled Cholesky
      const float L = sqrtf(maxp(QuuF, 1e-30f));
      k = ok ? ((-Qu) / L) / L : 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) K[j] = ok ? ((-Qux_r[j]) / L) / L : 0.0f;
    } else {
      // m = 1 closed-form box QP with limits relative to u_t
      const float lo = lim_lo - u;
      const float hi = lim_hi - u;
      const float xq = clipp(-Qu / QuuF, lo, hi);
      const float grad = Qu + QuuF * xq;
      const bool clamped = ((xq <= lo) && (grad > 0.0f)) ||
                           ((xq >= hi) && (grad < 0.0f));
      const float quu_s = fabsf(QuuF) > 1e-30f ? QuuF : 1e-30f;
      k = ok ? xq : 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float kj = clamped ? 0.0f : -Qux_r[j] / quu_s;
        K[j] = ok ? kj : 0.0f;
      }
    }

    // value update with the unregularised terms (src/backward_pass.jl:63-72)
    const float Quu_k = Quu * k;
    dv1 = dv1 + k * Qu;
    dv2 = dv2 + 0.5f * (k * Quu_k);
    float QuuK[N], Vx_n[N], Vraw[N][N];
#pragma unroll
    for (int j = 0; j < N; ++j) QuuK[j] = Quu * K[j];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Vx_n[i] = Qx[i] + K[i] * (Quu_k + Qu) + Qux[i] * k;
#pragma unroll
      for (int j = 0; j < N; ++j)
        Vraw[i][j] = Qxx[i][j] + K[i] * QuuK[j] + K[i] * Qux[j] +
                     Qux[i] * K[j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Vx[i] = Vx_n[i];
#pragma unroll
      for (int j = 0; j < N; ++j) Vxx[i][j] = 0.5f * (Vraw[i][j] + Vraw[j][i]);
    }

    // divergence latch: t+1 of the first failing step (backward order)
    const float bad = ok ? 0.0f : 1.0f;
    const float newly = bad * (1.0f - div);
    divt = divt * (1.0f - newly) + newly * (float)(t + 1);
    div = maxp(div, bad);

    put(t, 0, k);
#pragma unroll
    for (int j = 0; j < N; ++j) put(t, 1 + j, K[j]);
    if (VALUE) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        put(t, 1 + N + i, Vx[i]);
#pragma unroll
        for (int j = 0; j < N; ++j) put(t, 1 + 2 * N + i * N + j, Vxx[i][j]);
      }
    }
    if (QUU) {
      put(t, OQ, Quu);
      put(t, OQ + 1, inv1(Quu));
    }
  }

  stats[b] = dv1;
  stats[sB + b] = dv2;
  stats[2 * sB + b] = div;
  stats[3 * sB + b] = divt;
}

}  // namespace

}  // namespace ddp

extern "C" int ddp_backward_lanes(const float* traj, int s_in,
                                  const float* lam, const float* prev,
                                  const float* eta, float* out, int s_out,
                                  float* stats, int T, int B, int emit,
                                  int reg_type, int use_limits, float lim_lo,
                                  float lim_hi, int model_id,
                                  const float* consts, int device,
                                  void* stream) {
  using namespace ddp;
  if (model_id != MODEL_PENDCART) return ERR_MODEL;
  const int s_emit = emit == EMIT_GAINS ? S_GAINS
                     : emit == EMIT_FULL ? S_FULL
                     : emit == EMIT_POLICY ? S_POLICY : -1;
  const bool gps = prev != nullptr;
  if (T < 2 || B < 1 || s_in < PendCart::N + PendCart::M ||
      s_out != s_emit || (reg_type != 1 && reg_type != 2) ||
      gps != (eta != nullptr))
    return ERR_ARGS;
  cudaSetDevice(device);
  ModelConsts mc;
  for (int i = 0; i < N_CONSTS; ++i) mc.c[i] = consts[i];
  const dim3 grid((B + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool lim = use_limits != 0;
#define DDP_BWD(E, G)                                                       \
  backward_kernel<E, G><<<grid, THREADS, 0, st>>>(                          \
      traj, s_in, lam, prev, eta, out, s_out, stats, T, B, reg_type, lim,   \
      lim_lo, lim_hi, mc)
  switch (emit * 2 + (gps ? 1 : 0)) {
    case 2 * EMIT_GAINS: DDP_BWD(EMIT_GAINS, false); break;
    case 2 * EMIT_GAINS + 1: DDP_BWD(EMIT_GAINS, true); break;
    case 2 * EMIT_FULL: DDP_BWD(EMIT_FULL, false); break;
    case 2 * EMIT_FULL + 1: DDP_BWD(EMIT_FULL, true); break;
    case 2 * EMIT_POLICY: DDP_BWD(EMIT_POLICY, false); break;
    case 2 * EMIT_POLICY + 1: DDP_BWD(EMIT_POLICY, true); break;
  }
#undef DDP_BWD
  return (int)cudaGetLastError();
}

extern "C" const char* ddp_error_string(int code) {
  if (code == ddp::ERR_MODEL) return "unknown device-model id";
  if (code == ddp::ERR_ARGS) return "arguments outside what the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
