// K1: batched backward pass (Riccati recursion) with in-kernel derivatives,
// templated on the model (common.cuh describes the interface).
//
// Replaces the TPU kernel
//   differentialdynamicprogramming_jl_tpu/ops/pallas/backward_kernel.py
//   ::backward_lanes (built by ::_make_kernel)
// for the subset on the fleet iLQG, KL/GPS and MPC paths: m ≤ 2,
// derivatives computed in-register from the (x, u) slots of the trajectory
// stream, control limits (the m=1 clamp or the m=2 9-set enumeration),
// static or per scenario (lims_lanes, (2m, B), read once per thread), or
// none (the unrolled Cholesky solve), per-scenario model parameters for a
// model that takes them (params, (P, B)), reg_type 1 or 2, GPS mode, and
// "gains", "full" or "policy" emission. Instances: every emission, with
// and without GPS mode, for pendcart ⟨4,1⟩ (backward.cu) and LTI ⟨10,2⟩
// (backward_lti.cu without GPS mode, backward_lti_gps.cu with it); "gains"
// and "full" without GPS mode for the parametrised pendcart PendCartParam
// ⟨4,1⟩ (backward_pendcart_param.cu); and the autodiff instances, whose
// derivatives are made in the kernel from the model's own functions
// (autodiff.cuh), "gains" and "full" without GPS mode: quadrotor ⟨6,2⟩
// (backward_quad.cu) and pendcart ⟨4,1⟩ (backward_pendcart_ad.cu).
//
// Layout: every stream is (T, S, B) f32 with the scenario axis contiguous.
// One thread owns one scenario and walks t = T-1 .. 0 inside the kernel,
// with Vx[N], Vxx[N][N], dV1, dV2 and the divergence latch in registers.
// This loop takes the place of the TPU's sequential grid axis and its VMEM
// scratch. Output slots follow OutLayout: k[M], K[M][N] ("gains"), then
// Vx[N], Vxx[N][N] ("full" only), then Quu[M][M], Quu⁻¹[M][M] ("full" and
// "policy"). Stats (4, B): dV1, dV2, diverged, diverge_idx. GPS mode also
// reads the previous-policy stream prev (T, M+M·N+M², B) [k[M], K[M][N],
// Σ⁻¹[M][M]] and the dual eta (T, B). Its K and Σ⁻¹ slots are read where
// the KL expansion consumes them, column by column of Σ⁻¹K, so that no
// M×N block of the expansion is held across the step.
//
// What bounds it. Pendcart ⟨4,1⟩ at B=4096, T=500: one launch reads the
// x,u slots (≈41 MB), in GPS mode also prev and eta (≈57 MB), and writes
// the gains (≈41 MB), policy (≈57 MB) or full stream (≈221 MB); ≈0.5 kflop
// per scenario-step, so it is bandwidth-bound once occupancy allows. LTI
// ⟨10,2⟩ at B=4096, T=1000: ≈7.5 kflop per scenario-step (W = Vxx·fx and
// Qxx = fxᵀ·W are n³ each), ≈31 GFLOP a launch against ≈557 MB moved
// ("gains"), so it is compute-bound; Vx, Vxx, W and Qxx do not fit in 255
// registers and spill. GPS mode at ⟨10,2⟩ adds ≈0.7 kflop a step and the
// 26-slot prev stream and η (≈1.1 GB a launch with "policy" emission), and
// stays compute-bound. Either way B=4096 threads in blocks of 128 give 32
// blocks for 132 SMs, one warp per SM, and each step's loads and its
// dependent chain of arithmetic are exposed latency. Spreading a scenario
// over several threads, or Vxx in shared memory, is work for later changes.
//
// Semantics kept from the TPU kernel (backward_kernel.py line numbers):
// - every sum over a (state) or mi (control) runs in the JAX order, from its
//   first term (:450-600);
// - the t = T-1 boundary writes Vx = cx, Vxx = cxx, zero gains, and in
//   "full"/"policy" emission Quu = cuu with its inverse; in GPS mode V stays
//   unscaled there and only the emitted Quu is cuu/η + Σ⁻¹_prev (:401-439);
// - reg_type 2 adds λ·fuᵀfx and λ·fuᵀfu (m×m) to the gain solve only,
//   reg_type 1 adds λ on Quu's diagonal; the value update uses the
//   unregularised Quu and Qux and symmetrises Vxx (:499-511, :574-600);
// - GPS mode scales Qx, Qu, Qxx, Qux, Quu by 1/η, adds the KL expansion
//   from prev (read_kl :370-392), symmetrises Quu and ignores λ; a zero η
//   counts as 1 (:483-497, :795-797);
// - without limits, the unrolled Cholesky solve (:514-522, :122-158), ok
//   when every leading minor is positive; with limits at m=1 the clamp
//   takes lo/hi relative to u_t, the KKT free mask decides when K is 0,
//   and quu_s is guarded at 1e-30 (:173-181, :523-531); at m=2 the exact
//   enumeration of the 9 active sets (:184-235) and the K rows with the
//   det_s/a_s/c_s guards (:532-551). A lane with both controls clamped is
//   OK even where QuuF is not positive definite (:231-234);
// - Quu⁻¹ by Cholesky solves against the unit vectors, pivot
//   sqrt(max(d, 1e-30)) (_tiny_inv :161-170);
// - a non-PD lane gets k = K = 0 and V keeps updating: the latch records
//   t+1 of the first failing step in backward order and does not stop the
//   recursion (:570-572, :605-612).
#pragma once

#include "common.cuh"

namespace ddp {

// emission modes (backward_kernel.py EMIT_CODE)
constexpr int EMIT_GAINS = 0, EMIT_FULL = 1, EMIT_POLICY = 2;

// output slots of an emission mode at (n, m), as OutLayout
inline int out_slots(int emit, int n, int m) {
  const int g = m + m * n;
  return emit == EMIT_GAINS ? g
         : emit == EMIT_FULL ? g + n + n * n + 2 * m * m
         : emit == EMIT_POLICY ? g + 2 * m * m : -1;
}

// the launcher's arguments, checked by ddp_backward_lanes
struct BwdArgs {
  const float* traj;
  int s_in;
  const float* lam;
  const float* prev;   // GPS mode, else null
  const float* eta;
  float* out;
  int s_out;
  float* stats;
  int T, B, emit, reg_type;
  bool use_limits;
  Lims lims;
  const float* lims_lanes;   // (2m, B) per-scenario limits, or null
  const float* params;       // (P, B) per-scenario parameters, or null
  const float* consts;   // host copy of the model descriptor
  cudaStream_t stream;
};

namespace {

constexpr int BWD_THREADS = 128;

// GPS mode at one step: the dual η (a zero counts as 1) and the previous
// policy's slots [k[M], K[M][N], Σ⁻¹[M][M]] of scenario b
template <int N, int M>
struct PrevStep {
  static constexpr int S = M + M * N + M * M;
  const float* p;
  size_t sB;
  __device__ __forceinline__ PrevStep(const float* prev, int t, int b,
                                      size_t sB_)
      : p(prev + (size_t)t * S * sB_ + b), sB(sB_) {}
  __device__ __forceinline__ float k(int mi) const { return p[mi * sB]; }
  __device__ __forceinline__ float K(int mi, int j) const {
    return p[(M + mi * N + j) * sB];
  }
  __device__ __forceinline__ float Si(int mi, int mj) const {
    return p[(M + M * N + mi * M + mj) * sB];
  }
};

__device__ __forceinline__ float read_eta(const float* __restrict__ eta,
                                          int t, int b, size_t sB) {
  const float e = eta[(size_t)t * sB + b];
  return e == 0.0f ? 1.0f : e;
}

__device__ __forceinline__ float guard(float v) {
  return fabsf(v) > 1e-30f ? v : 1e-30f;
}

// exact 2-D box QP min ½xᵀQx + gᵀx, lo ≤ x ≤ hi, by its 9 active sets
// (backward_kernel.py::_boxqp_m2); returns ok and writes x and the free set
__device__ __forceinline__ bool boxqp_m2(const float (&Q)[2][2],
                                         const float (&g)[2],
                                         const float (&lo)[2],
                                         const float (&hi)[2], float (&x)[2],
                                         bool (&fr)[2]) {
  const float a = Q[0][0], b = Q[0][1], c = Q[1][1];
  const float g0 = g[0], g1 = g[1];
  const float det = a * c - b * b;
  const float det_s = guard(det), a_s = guard(a), c_s = guard(c);
  // candidates: unconstrained, dim 0 at lo/hi, dim 1 at lo/hi, the corners
  const float c0[9] = {(-g0 * c + g1 * b) / det_s, lo[0], hi[0],
                       -(g0 + b * lo[1]) / a_s, -(g0 + b * hi[1]) / a_s,
                       lo[0], lo[0], hi[0], hi[0]};
  const float c1[9] = {(g0 * b - g1 * a) / det_s, -(g1 + b * lo[0]) / c_s,
                       -(g1 + b * hi[0]) / c_s, lo[1], hi[1],
                       lo[1], hi[1], lo[1], hi[1]};
  float bx0 = 0.0f, bx1 = 0.0f, bv = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float x0 = clipp(c0[i], lo[0], hi[0]);
    const float x1 = clipp(c1[i], lo[1], hi[1]);
    const float v = x0 * g0 + x1 * g1 +
                    0.5f * (a * x0 * x0 + 2.0f * b * x0 * x1 + c * x1 * x1);
    if (i == 0) {
      bx0 = x0;
      bx1 = x1;
      bv = v;
    } else {
      const bool take = v < bv;
      bx0 = take ? x0 : bx0;
      bx1 = take ? x1 : bx1;
      bv = minp(v, bv);     // NaN-keeping, as jnp.minimum
    }
  }
  // the free set from the KKT gradient at the minimiser (src/boxQP.jl:92-94)
  const float gr0 = g0 + a * bx0 + b * bx1;
  const float gr1 = g1 + b * bx0 + c * bx1;
  const bool f0 = !(((bx0 <= lo[0]) && (gr0 > 0.0f)) ||
                    ((bx0 >= hi[0]) && (gr0 < 0.0f)));
  const bool f1 = !(((bx1 <= lo[1]) && (gr1 > 0.0f)) ||
                    ((bx1 >= hi[1]) && (gr1 < 0.0f)));
  x[0] = bx0;
  x[1] = bx1;
  fr[0] = f0;
  fr[1] = f1;
  return (f0 && f1 && (a > 0.0f) && (det > 0.0f)) ||
         (f0 && !f1 && (a > 0.0f)) || (!f0 && f1 && (c > 0.0f)) ||
         (!f0 && !f1);
}

template <class Model, int EMIT, bool GPS>
__global__ void __launch_bounds__(BWD_THREADS)
backward_kernel(const float* __restrict__ traj, int s_in,
                const float* __restrict__ lam,
                const float* __restrict__ prev, const float* __restrict__ eta,
                float* __restrict__ out, int s_out,
                float* __restrict__ stats, int T, int B, int reg_type,
                bool use_limits, Lims lims,
                const float* __restrict__ lims_lanes,
                const float* __restrict__ params, typename Model::Consts mc) {
  constexpr int N = Model::N, M = Model::M;
  static_assert(M >= 1 && M <= MAX_M, "K1 is written for m = 1 or 2");
  constexpr bool VALUE = EMIT == EMIT_FULL;     // Vx, Vxx slots
  constexpr bool QUU = EMIT != EMIT_GAINS;      // Quu, Quu⁻¹ slots
  constexpr int OV = M + M * N;                 // Vx's slot
  constexpr int OQ = VALUE ? OV + N + N * N : OV;   // Quu's slot
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const Model P = make_model<Model>(mc, params, b, sB);
  const Lims lim = lane_lims<M>(lims, lims_lanes, b, sB);
  const float lm = lam[b];
  auto in = [&](int t, int s) { return traj[((size_t)t * s_in + s) * sB + b]; };
  auto put = [&](int t, int s, float v) {
    out[((size_t)t * s_out + s) * sB + b] = v;
  };

  float Vx[N], Vxx[N][N];
  float dv1 = 0.0f, dv2 = 0.0f, div = 0.0f, divt = 0.0f;
  typename Model::Derivs dv;

  {  // boundary t = T-1
    const int t = T - 1;
    float x[N], u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = in(t, i);
#pragma unroll
    for (int mi = 0; mi < M; ++mi) u[mi] = in(t, N + mi);
    P.derivs(x, u, dv);
#pragma unroll
    for (int s = 0; s < OV; ++s) put(t, s, 0.0f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Vx[i] = P.cx(dv, i);
#pragma unroll
      for (int j = 0; j < N; ++j) Vxx[i][j] = P.cxx(dv, i, j);
    }
    if (VALUE) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        put(t, OV + i, Vx[i]);
#pragma unroll
        for (int j = 0; j < N; ++j) put(t, OV + N + i * N + j, Vxx[i][j]);
      }
    }
    if (QUU) {
      float cuu[M][M], inv[M][M];
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int mj = 0; mj < M; ++mj) cuu[mi][mj] = P.cuu(dv, mi, mj);
      }
      if constexpr (GPS) {
        const PrevStep<N, M> pv(prev, t, b, sB);
        const float e = read_eta(eta, t, b, sB);
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
#pragma unroll
          for (int mj = 0; mj < M; ++mj)
            cuu[mi][mj] = cuu[mi][mj] / e + pv.Si(mi, mj);
        }
      }
      tiny_inv<M>(cuu, inv);
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int mj = 0; mj < M; ++mj) {
          put(t, OQ + mi * M + mj, cuu[mi][mj]);
          put(t, OQ + M * M + mi * M + mj, inv[mi][mj]);
        }
      }
    }
  }

  for (int t = T - 2; t >= 0; --t) {
    float x[N], u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = in(t, i);
#pragma unroll
    for (int mi = 0; mi < M; ++mi) u[mi] = in(t, N + mi);
    P.derivs(x, u, dv);

    // Q expansions (src/backward_pass.jl:103-123); each sum runs a = 0..n-1
    float Qx[N], Qu[M], W[N][N], U[N][M], Qxx[N][N], Quu[M][M], Qux[M][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = P.fx(dv, 0, i) * Vx[0];
#pragma unroll
      for (int a = 1; a < N; ++a) s = s + P.fx(dv, a, i) * Vx[a];
      Qx[i] = P.cx(dv, i) + s;
    }
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
      float s = P.fu(dv, 0, mi) * Vx[0];
#pragma unroll
      for (int a = 1; a < N; ++a) s = s + P.fu(dv, a, mi) * Vx[a];
      Qu[mi] = P.cu(dv, mi) + s;
    }
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = Vxx[a][0] * P.fx(dv, 0, j);
#pragma unroll
        for (int c = 1; c < N; ++c) s = s + Vxx[a][c] * P.fx(dv, c, j);
        W[a][j] = s;
      }
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
        float s = Vxx[a][0] * P.fu(dv, 0, mi);
#pragma unroll
        for (int c = 1; c < N; ++c) s = s + Vxx[a][c] * P.fu(dv, c, mi);
        U[a][mi] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = P.fx(dv, 0, i) * W[0][j];
#pragma unroll
        for (int a = 1; a < N; ++a) s = s + P.fx(dv, a, i) * W[a][j];
        Qxx[i][j] = P.cxx(dv, i, j) + s;
      }
    }
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
#pragma unroll
      for (int mj = 0; mj < M; ++mj) {
        float s = P.fu(dv, 0, mi) * U[0][mj];
#pragma unroll
        for (int a = 1; a < N; ++a) s = s + P.fu(dv, a, mi) * U[a][mj];
        Quu[mi][mj] = P.cuu(dv, mi, mj) + s;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = P.fu(dv, 0, mi) * W[0][j];
#pragma unroll
        for (int a = 1; a < N; ++a) s = s + P.fu(dv, a, mi) * W[a][j];
        Qux[mi][j] = P.cxu(dv, j, mi) + s;
      }
    }

    float Qux_r[M][N], QuuF[M][M];
    if constexpr (GPS) {
      // GPS mode: Q terms scaled by 1/η plus the KL expansion of the
      // previous policy (read_kl :370-392; each sum over a control in the
      // JAX order), Quu symmetrised, λ unused (src/backward_pass.jl:293-299)
      const PrevStep<N, M> pv(prev, t, b, sB);
      const float ie = 1.0f / read_eta(eta, t, b, sB);
      float Si[M][M], Sik[M];
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int mj = 0; mj < M; ++mj) Si[mi][mj] = pv.Si(mi, mj);
      }
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {        // Sik = Σ⁻¹·k
        float s = Si[mi][0] * pv.k(0);
#pragma unroll
        for (int mj = 1; mj < M; ++mj) s = s + Si[mi][mj] * pv.k(mj);
        Sik[mi] = s;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {           // cx_i = Σ_mi K[mi][i]·Sik[mi]
        float c = pv.K(0, i) * Sik[0];
#pragma unroll
        for (int mi = 1; mi < M; ++mi) c = c + pv.K(mi, i) * Sik[mi];
        Qx[i] = Qx[i] * ie + c;
      }
#pragma unroll
      for (int mi = 0; mi < M; ++mi) Qu[mi] = Qu[mi] * ie + (-Sik[mi]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float SiKj[M];                        // column j of Σ⁻¹·K
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
          float s = Si[mi][0] * pv.K(0, j);
#pragma unroll
          for (int mj = 1; mj < M; ++mj) s = s + Si[mi][mj] * pv.K(mj, j);
          SiKj[mi] = s;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {         // cxx_ij = Σ_mi K_mi,i·SiK_mi,j
          float c = pv.K(0, i) * SiKj[0];
#pragma unroll
          for (int mi = 1; mi < M; ++mi) c = c + pv.K(mi, i) * SiKj[mi];
          Qxx[i][j] = Qxx[i][j] * ie + c;
        }
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
          Qux[mi][j] = Qux[mi][j] * ie + (-SiKj[mi]);
          Qux_r[mi][j] = Qux[mi][j];
        }
      }
      float Qg[M][M];
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int mj = 0; mj < M; ++mj)
          Qg[mi][mj] = Quu[mi][mj] * ie + Si[mi][mj];
      }
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int mj = 0; mj < M; ++mj) {
          Quu[mi][mj] = 0.5f * (Qg[mi][mj] + Qg[mj][mi]);
          QuuF[mi][mj] = Quu[mi][mj];
        }
      }
    } else if (reg_type == 2) {
      // regularised gain matrices (src/backward_pass.jl:119-123)
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float s = P.fu(dv, 0, mi) * P.fx(dv, 0, j);
#pragma unroll
          for (int a = 1; a < N; ++a) s = s + P.fu(dv, a, mi) * P.fx(dv, a, j);
          Qux_r[mi][j] = Qux[mi][j] + lm * s;
        }
#pragma unroll
        for (int mj = 0; mj < M; ++mj) {
          float s = P.fu(dv, 0, mi) * P.fu(dv, 0, mj);
#pragma unroll
          for (int a = 1; a < N; ++a)
            s = s + P.fu(dv, a, mi) * P.fu(dv, a, mj);
          QuuF[mi][mj] = Quu[mi][mj] + lm * s;
        }
      }
    } else {
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int j = 0; j < N; ++j) Qux_r[mi][j] = Qux[mi][j];
#pragma unroll
        for (int mj = 0; mj < M; ++mj)
          QuuF[mi][mj] = Quu[mi][mj] + (mi == mj ? lm : 0.0f);
      }
    }

    // ---- gain solve
    bool ok;
    float k[M], K[M][N];
    if (!use_limits) {
      // unconstrained: the unrolled Cholesky solve
      float L[M][M], rhs[M], col[M];
      ok = tiny_chol<M>(QuuF, L);
#pragma unroll
      for (int mi = 0; mi < M; ++mi) rhs[mi] = -Qu[mi];
      tiny_chol_solve<M>(L, rhs, k);
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int mi = 0; mi < M; ++mi) rhs[mi] = -Qux_r[mi][j];
        tiny_chol_solve<M>(L, rhs, col);
#pragma unroll
        for (int mi = 0; mi < M; ++mi) K[mi][j] = col[mi];
      }
    } else if constexpr (M == 1) {
      // closed-form box QP with limits relative to u_t
      const float q = QuuF[0][0];
      const float lo = lim.lo[0] - u[0];
      const float hi = lim.hi[0] - u[0];
      const float xq = clipp(-Qu[0] / q, lo, hi);
      const float grad = Qu[0] + q * xq;
      const bool clamped = ((xq <= lo) && (grad > 0.0f)) ||
                           ((xq >= hi) && (grad < 0.0f));
      const float quu_s = guard(q);
      ok = q > 0.0f;
      k[0] = xq;
#pragma unroll
      for (int j = 0; j < N; ++j)
        K[0][j] = clamped ? 0.0f : -Qux_r[0][j] / quu_s;
    } else {
      // m = 2: the exact enumeration and its K rows
      const float lo[2] = {lim.lo[0] - u[0], lim.lo[1] - u[1]};
      const float hi[2] = {lim.hi[0] - u[0], lim.hi[1] - u[1]};
      bool fr[2];
      ok = boxqp_m2(QuuF, Qu, lo, hi, k, fr);
      const bool both = fr[0] && fr[1];
      const float a = QuuF[0][0], bb = QuuF[0][1], c = QuuF[1][1];
      const float det_s = guard(a * c - bb * bb);
      const float a_s = guard(a), c_s = guard(c);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float q0 = Qux_r[0][j], q1 = Qux_r[1][j];
        const float kb0 = (-q0 * c + q1 * bb) / det_s;
        const float kb1 = (q0 * bb - q1 * a) / det_s;
        K[0][j] = both ? kb0 : (fr[0] ? -q0 / a_s : 0.0f);
        K[1][j] = both ? kb1 : (fr[1] ? -q1 / c_s : 0.0f);
      }
    }
    // a non-PD lane gets zero gains; V keeps updating
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
      k[mi] = ok ? k[mi] : 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) K[mi][j] = ok ? K[mi][j] : 0.0f;
    }

    // value update with the unregularised terms (src/backward_pass.jl:63-72)
    float Quu_k[M], QuuK[M][N];
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
      float s = Quu[mi][0] * k[0];
#pragma unroll
      for (int mj = 1; mj < M; ++mj) s = s + Quu[mi][mj] * k[mj];
      Quu_k[mi] = s;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float r = Quu[mi][0] * K[0][j];
#pragma unroll
        for (int mj = 1; mj < M; ++mj) r = r + Quu[mi][mj] * K[mj][j];
        QuuK[mi][j] = r;
      }
    }
    {
      float s1 = k[0] * Qu[0], s2 = k[0] * Quu_k[0];
#pragma unroll
      for (int mi = 1; mi < M; ++mi) {
        s1 = s1 + k[mi] * Qu[mi];
        s2 = s2 + k[mi] * Quu_k[mi];
      }
      dv1 = dv1 + s1;
      dv2 = dv2 + 0.5f * s2;
    }
    float Vx_n[N], Vraw[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s1 = K[0][i] * (Quu_k[0] + Qu[0]), s2 = Qux[0][i] * k[0];
#pragma unroll
      for (int mi = 1; mi < M; ++mi) {
        s1 = s1 + K[mi][i] * (Quu_k[mi] + Qu[mi]);
        s2 = s2 + Qux[mi][i] * k[mi];
      }
      Vx_n[i] = Qx[i] + s1 + s2;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float r1 = K[0][i] * QuuK[0][j], r2 = K[0][i] * Qux[0][j],
              r3 = Qux[0][i] * K[0][j];
#pragma unroll
        for (int mi = 1; mi < M; ++mi) {
          r1 = r1 + K[mi][i] * QuuK[mi][j];
          r2 = r2 + K[mi][i] * Qux[mi][j];
          r3 = r3 + Qux[mi][i] * K[mi][j];
        }
        Vraw[i][j] = Qxx[i][j] + r1 + r2 + r3;
      }
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

#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
      put(t, mi, k[mi]);
#pragma unroll
      for (int j = 0; j < N; ++j) put(t, M + mi * N + j, K[mi][j]);
    }
    if (VALUE) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        put(t, OV + i, Vx[i]);
#pragma unroll
        for (int j = 0; j < N; ++j) put(t, OV + N + i * N + j, Vxx[i][j]);
      }
    }
    if (QUU) {
      float inv[M][M];
      tiny_inv<M>(Quu, inv);
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int mj = 0; mj < M; ++mj) {
          put(t, OQ + mi * M + mj, Quu[mi][mj]);
          put(t, OQ + M * M + mi * M + mj, inv[mi][mj]);
        }
      }
    }
  }

  stats[b] = dv1;
  stats[sB + b] = dv2;
  stats[2 * sB + b] = div;
  stats[3 * sB + b] = divt;
}

// one instance of K1 for one model, launched on the caller's stream
template <class Model, int EMIT, bool GPS>
int launch_one(const BwdArgs& a) {
  typename Model::Consts mc;
  for (int i = 0; i < Model::N_CONSTS; ++i) mc.c[i] = a.consts[i];
  const dim3 grid((a.B + BWD_THREADS - 1) / BWD_THREADS);
  backward_kernel<Model, EMIT, GPS><<<grid, BWD_THREADS, 0, a.stream>>>(
      a.traj, a.s_in, a.lam, a.prev, a.eta, a.out, a.s_out, a.stats, a.T,
      a.B, a.reg_type, a.use_limits, a.lims, a.lims_lanes, a.params, mc);
  return (int)cudaGetLastError();
}

// K1 for one model with or without GPS mode, in each emission
template <class Model, bool GPS>
int launch_backward(const BwdArgs& a) {
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, GPS>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, GPS>(a);
    case EMIT_POLICY: return launch_one<Model, EMIT_POLICY, GPS>(a);
    default: return ERR_ARGS;
  }
}

}  // namespace

// the LTI ⟨10,2⟩ instances: without GPS mode in backward_lti.cu, in GPS
// mode in backward_lti_gps.cu; PendCartParam ⟨4,1⟩, "gains" and "full"
// without GPS mode, in backward_pendcart_param.cu; the autodiff instances
// (autodiff.cuh), "gains" and "full" without GPS mode: quadrotor ⟨6,2⟩ in
// backward_quad.cu, pendcart ⟨4,1⟩ in backward_pendcart_ad.cu
int launch_backward_lti_10_2(const BwdArgs& a);
int launch_backward_lti_gps_10_2(const BwdArgs& a);
int launch_backward_pendcart_param(const BwdArgs& a);
int launch_backward_quad_6_2(const BwdArgs& a);
int launch_backward_pendcart_ad(const BwdArgs& a);

}  // namespace ddp
