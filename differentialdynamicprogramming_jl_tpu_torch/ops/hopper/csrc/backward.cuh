// K1: batched backward pass (Riccati recursion), templated on the model
// (common.cuh describes the interface): derivatives formed in the kernel
// from the trajectory's (x, u), first or second order, or read from a
// packed-derivatives stream (packed.cuh).
//
// Replaces the TPU kernel
//   differentialdynamicprogramming_jl_tpu/ops/pallas/backward_kernel.py
//   ::backward_lanes (built by ::_make_kernel)
// for the subset on the fleet iLQG, KL/GPS and MPC paths: m ≤ MAX_M,
// derivatives computed in-register from the (x, u) slots of the trajectory
// stream, control limits (the m=1 clamp, the m=2 9-set enumeration, or for
// m > 2 the masked projected-Newton box QP warm-started from the next
// step's k), static or per scenario (lims_lanes, (2m, B), read once per
// thread), or none (the unrolled Cholesky solve), per-scenario model
// parameters for a model that takes them (params, (P, B)), reg_type 1 or
// 2, GPS mode, and
// "gains", "full" or "policy" emission. Instances: every emission, with
// and without GPS mode, for pendcart ⟨4,1⟩ (backward.cu), LTI ⟨10,2⟩
// (backward_lti.cu without GPS mode, backward_lti_gps.cu with it) and LTI
// ⟨10,3⟩ (backward_lti_10_3.cu, backward_lti_gps_10_3.cu); "gains"
// and "full" without GPS mode for the parametrised pendcart PendCartParam
// ⟨4,1⟩ (backward_pendcart_param.cu); and the autodiff instances, whose
// derivatives are made in the kernel from the model's own functions
// (autodiff.cuh), "gains" and "full" without GPS mode: quadrotor ⟨6,2⟩
// (backward_quad.cu) and pendcart ⟨4,1⟩ (backward_pendcart_ad.cu). Full
// DDP, "gains" and "full" without GPS mode: the analytic PendCartSO and
// Autodiff<PendCart, true> ⟨4,1⟩ (backward_so.cu) and
// Autodiff<Quadrotor, true> ⟨6,2⟩ (backward_quad_so.cu). The
// packed-derivatives stream Packed<N, M> (packed.cuh): ⟨4,1⟩ in "gains",
// "full" and GPS "full", ⟨6,2⟩ in "gains" and "full" (backward_packed.cu),
// ⟨10,2⟩ in "gains" and "full" (backward_packed_lti.cu). Every other
// public derivative source in the modes the fleet entries launch, "gains"
// and "full" without GPS mode and GPS "policy": Autodiff<PendCartParam>
// and Autodiff<PendCartParam, true> without GPS mode
// (backward_pendcart_param_ad.cu); GPS "policy" of Autodiff<PendCart>,
// Autodiff<PendCart, true> and PendCartSO (backward_pendcart_gps.cu); and,
// in the sources library built at its first launch (backward_sources.cu),
// Autodiff<LTI> ⟨10,2⟩ and ⟨10,3⟩, first and second order
// (backward_lti_ad{,_10_3,_so,_so_10_3}.cu), and GPS "policy" of
// Autodiff<Quadrotor, true> (backward_quad_so_gps.cu).
//
// Layout: every stream is (T, S, B) f32 with the scenario axis contiguous.
// A block owns 32 scenarios: lane l of each warp works on scenario
// 32·blockIdx.x + l. Its compute warps walk t = T-1 .. 0 inside the
// kernel, with Vx[N], Vxx[N][N], dV1, dV2 and the divergence latch in
// registers; this loop takes the place of the TPU's sequential grid axis
// and its VMEM scratch. There are K1_WARPS of them: one, or four where n ≥
// 8 and "full" emission or GPS mode gives a step n×n work beyond the
// recursion's own, or m > 4. Four warps split W = Vxx·fx, U = Vxx·fu, Qxx and Vraw by
// rows, each element summed from a = 0 by the warp that owns its row, and
// exchange them through shared memory after the ring at two barriers a
// step; every warp forms the n- and m-sized terms itself. The step inputs
// (the x,u slots of the trajectory, or the D+M slots of the packed stream;
// in GPS mode also the previous policy's slots and η) are staged in descending chunks of tc steps in a
// shared-memory ring of `stages` stages (ring.cuh), which one more warp,
// the producer, fills with cp.async stages-1 chunks ahead; it meets the
// compute warps at two barriers a chunk, so the copies add no code and no
// live registers to the compute loop (with the copies in it, LTI's stack
// frame grew from ≈650 to ≈1000 bytes). The plan comes from
// ops/hopper/plan.py. Output slots follow OutLayout: k[M], K[M][N]
// ("gains"), then Vx[N], Vxx[N][N] ("full" only), then Quu[M][M],
// Quu⁻¹[M][M] ("full" and "policy"), each a coalesced 128-byte row of a
// warp's stores. Stats (4, B): dV1, dV2, diverged, diverge_idx. GPS mode
// also reads the previous-policy stream prev (T, M+M·N+M², B) [k[M],
// K[M][N], Σ⁻¹[M][M]] and the dual eta (T, B); its K and Σ⁻¹ slots are read
// from the ring where the KL expansion consumes them.
//
// What bounds it. Pendcart ⟨4,1⟩ at B=4096, T=500: one launch reads the
// x,u slots (≈41 MB), in GPS mode also prev and eta (≈57 MB), and writes
// the gains (≈41 MB), policy (≈57 MB) or full stream (≈221 MB): 0.025-0.08
// ms at 3.35 TB/s, against ≈0.5 kflop per scenario-step. LTI ⟨10,2⟩ at
// B=4096, T=1000: ≈7.5 kflop per scenario-step (W = Vxx·fx and Qxx =
// fxᵀ·W are n³ each), ≈31 GFLOP a launch against ≈557 MB moved ("gains"),
// so its bound is the operations; Vx, Vxx, W and Qxx do not fit in 255
// registers and spill. LTI ⟨10,3⟩ with limits adds the masked box QP,
// ≈2.5 kflop a scenario-step at 8 iterations (≈47 GFLOP a launch): a chain
// of dependent divisions and square roots run while the step's n×n terms
// are live, so the one-warp instance spills more (PERF.md §6). At B=4096
// the grid is 128 blocks on 128 SMs, and no step waits on device memory.
// What is left is each scenario's chain of dependent operations, T steps
// long: for the pendcart ≈750 instructions a step issued at ≈0.44 a cycle
// by its one warp, because each IEEE division (≈8 a step) and sinf/cosf
// carry a slow-path branch that cuts the step into blocks the compiler
// cannot interleave. Four warps repeat that chain in each of them, and
// measured slower there (PERF.md §6).
//
// Semantics kept from the TPU kernel (backward_kernel.py line numbers):
// - every sum over a (state) or mi (control) runs in the JAX order, from its
//   first term (:450-600);
// - full DDP adds Σ_a V′x[a]·∂²f_a to Qxx, Qux and Quu after the Q
//   expansions and before the GPS and regularisation branches, V′x the
//   value gradient of t+1 (:466-481); each compute warp adds the Qxx rows
//   it owns;
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
//   OK even where QuuF is not positive definite (:231-234); at m > 2 the
//   masked projected-Newton box QP (_boxqp_masked :238-320, boxqp_masked
//   below), started from the sanitised k of step t+1 (0 at t = T-2: the
//   kernel's warm-start scratch, :331-343, :434-438, :647-650, here a
//   register array of each compute warp, which all compute the same k),
//   and K solved on its final free subspace (:552-568);
// - Quu⁻¹ by Cholesky solves against the unit vectors, pivot
//   sqrt(max(d, 1e-30)) (_tiny_inv :161-170);
// - a non-PD lane gets k = K = 0 and V keeps updating: the latch records
//   t+1 of the first failing step in backward order and does not stop the
//   recursion (:570-572, :605-612).
#pragma once

#include "ring.cuh"

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
  int qp_iters;          // m > 2 with limits: the box QP's iterations
  Lims lims;
  const float* lims_lanes;   // (2m, B) per-scenario limits, or null
  const float* params;       // (P, B) per-scenario parameters, or null
  const float* consts;   // host copy of the model descriptor
  RingPlan plan;         // the launch plan (ops/hopper/plan.py)
  cudaStream_t stream;
};

// The argument checks of K1's C entry points (ddp_backward_lanes in
// backward.cu, and in a lowered model's library, lowered.cuh) and their
// BwdArgs; ERR_ARGS for arguments no instance takes. A trajectory holds at
// least n+m slots; the packed stream's exact D+m is checked by its
// instance (launch_one).
inline int bwd_args(const float* traj, int s_in, const float* lam,
                    const float* prev, const float* eta, float* out,
                    int s_out, float* stats, int T, int B, int emit,
                    int reg_type, int use_limits, const float* lims,
                    const float* lims_lanes, const float* params,
                    int n_params, int n, int m, const float* consts,
                    int qp_iters, int blocks, int threads, int tc,
                    int stages, int smem, void* stream, BwdArgs& a) {
  const bool gps = prev != nullptr;
  if (T < 2 || B < 1 || s_in < n + m ||
      s_out != out_slots(emit, n, m) ||
      (reg_type != 1 && reg_type != 2) || gps != (eta != nullptr) ||
      (params != nullptr) != (n_params > 0) || qp_iters < 0)
    return ERR_ARGS;
  Lims lim;
  if (!lims_from_host(lims, m, lim)) return ERR_ARGS;
  a = BwdArgs{traj,
              s_in,
              lam,
              prev,
              eta,
              out,
              s_out,
              stats,
              T,
              B,
              emit,
              reg_type,
              use_limits != 0 || lims_lanes != nullptr,
              qp_iters,
              lim,
              lims_lanes,
              params,
              consts,
              RingPlan{blocks, threads, tc, stages, smem},
              static_cast<cudaStream_t>(stream)};
  return 0;
}

namespace {

// GPS mode at one step: the previous policy's slots [k[M], K[M][N],
// Σ⁻¹[M][M]] of one scenario, read from its ring column (slot stride
// RING_W)
template <int N, int M>
struct PrevStep {
  static constexpr int S = M + M * N + M * M;
  const float* p;
  __device__ __forceinline__ explicit PrevStep(const float* p_) : p(p_) {}
  __device__ __forceinline__ float k(int mi) const {
    return p[mi * RING_W];
  }
  __device__ __forceinline__ float K(int mi, int j) const {
    return p[(M + mi * N + j) * RING_W];
  }
  __device__ __forceinline__ float Si(int mi, int mj) const {
    return p[(M + M * N + mi * M + mj) * RING_W];
  }
};

// the dual η of a step; a zero counts as 1
__device__ __forceinline__ float eta_or_one(float e) {
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
DDP_UNROLL
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

// ½xᵀHx + gᵀx in the JAX order (_boxqp_masked's val): Σ_i x_i·g_i from 0,
// then ½·x_i·H_ij·x_j added over i, j
template <int M>
__device__ __forceinline__ float qp_val(const float (&H)[M][M],
                                        const float (&g)[M],
                                        const float (&x)[M]) {
  float v = 0.0f;
DDP_UNROLL
  for (int i = 0; i < M; ++i) v = v + x[i] * g[i];
DDP_UNROLL
  for (int i = 0; i < M; ++i) {
DDP_UNROLL
    for (int j = 0; j < M; ++j) v = v + 0.5f * x[i] * H[i][j] * x[j];
  }
  return v;
}

// the gradient g + H·x (each row's sum from 0) and the KKT free set at x
// (src/boxQP.jl:92-94): a dimension is clamped at a bound its gradient
// pushes against
template <int M>
__device__ __forceinline__ void qp_kkt(const float (&H)[M][M],
                                       const float (&g)[M],
                                       const float (&lo)[M],
                                       const float (&hi)[M],
                                       const float (&x)[M], float (&gr)[M],
                                       bool (&fr)[M]) {
DDP_UNROLL
  for (int i = 0; i < M; ++i) {
    float s = 0.0f;
DDP_UNROLL
    for (int j = 0; j < M; ++j) s = s + H[i][j] * x[j];
    gr[i] = g[i] + s;
    fr[i] = !(((x[i] <= lo[i]) && (gr[i] > 0.0f)) ||
              ((x[i] >= hi[i]) && (gr[i] < 0.0f)));
  }
}

// Cholesky of H on the free set, the clamped rows and columns replaced by
// the identity's; whether it is positive definite
template <int M>
__device__ __forceinline__ bool masked_chol(const float (&H)[M][M],
                                            const bool (&fr)[M],
                                            float (&L)[M][M]) {
  float Hm[M][M];
DDP_UNROLL
  for (int i = 0; i < M; ++i) {
DDP_UNROLL
    for (int j = 0; j < M; ++j)
      Hm[i][j] = ((fr[i] && fr[j]) ? H[i][j] : 0.0f) +
                 (i == j ? (fr[i] ? 0.0f : 1.0f) : 0.0f);
  }
  return tiny_chol<M>(Hm, L);
}

// box QP min ½xᵀHx + gᵀx, lo ≤ x ≤ hi, for m > 2: a fixed number of
// masked projected-Newton iterations from x0 clipped to the box
// (backward_kernel.py::_boxqp_masked, the reference's src/boxQP.jl:71-165
// with the active set as flags): each finds the KKT free set, factors H on
// it, takes the Newton step on the free dimensions and keeps the best of
// α = 1, ½, ¼ clipped to the box by a strict <, the running minimum
// NaN-keeping. Writes x, the final free set and its factor L; returns ok:
// every factorisation positive definite, and with qp_iters > 0 the last
// iteration improved or the free gradient is at the KKT point (the
// reference's "no descent direction" failure, src/boxQP.jl:134)
template <int M>
__device__ __forceinline__ bool boxqp_masked(
    const float (&H)[M][M], const float (&g)[M], const float (&lo)[M],
    const float (&hi)[M], const float (&x0)[M], int qp_iters, float (&x)[M],
    bool (&fr)[M], float (&L)[M][M]) {
  float gr[M];
DDP_UNROLL
  for (int i = 0; i < M; ++i) x[i] = clipp(x0[i], lo[i], hi[i]);
  bool ok = true, improved = false;
#pragma unroll 1
  for (int it = 0; it < qp_iters; ++it) {
    qp_kkt<M>(H, g, lo, hi, x, gr, fr);
    ok = masked_chol<M>(H, fr, L) && ok;
    float rhs[M], dx[M], xb[M];
DDP_UNROLL
    for (int i = 0; i < M; ++i) rhs[i] = -(fr[i] ? gr[i] : 0.0f);
    tiny_chol_solve<M>(L, rhs, dx);
DDP_UNROLL
    for (int i = 0; i < M; ++i) {
      dx[i] = fr[i] ? dx[i] : 0.0f;
      xb[i] = x[i];
    }
    float vb = qp_val<M>(H, g, x);
    improved = false;
    const float steps[3] = {1.0f, 0.5f, 0.25f};
DDP_UNROLL
    for (int a = 0; a < 3; ++a) {
      float xc[M];
DDP_UNROLL
      for (int i = 0; i < M; ++i)
        xc[i] = clipp(x[i] + steps[a] * dx[i], lo[i], hi[i]);
      const float vc = qp_val<M>(H, g, xc);
      const bool take = vc < vb;
      improved = improved || take;
DDP_UNROLL
      for (int i = 0; i < M; ++i) xb[i] = take ? xc[i] : xb[i];
      vb = minp(vc, vb);
    }
DDP_UNROLL
    for (int i = 0; i < M; ++i) x[i] = xb[i];
  }
  // the free set and its factor at the solution
  qp_kkt<M>(H, g, lo, hi, x, gr, fr);
  ok = masked_chol<M>(H, fr, L) && ok;
  if (qp_iters > 0) {
    float gf2 = 0.0f, g2 = 0.0f;
DDP_UNROLL
    for (int i = 0; i < M; ++i) {
      const float v = fr[i] ? gr[i] : 0.0f;
      gf2 = gf2 + v * v;
    }
DDP_UNROLL
    for (int i = 0; i < M; ++i) g2 = g2 + g[i] * g[i];
    const bool stuck = (gf2 > 1e-6f * (g2 + 1e-30f)) && !improved;
    ok = ok && !stuck;
  }
  return ok;
}

// ring slots of a step's model input: x, u; for the packed stream its D+M
// slots
template <class Model>
__host__ __device__ constexpr int k1_in_slots() {
  if constexpr (Model::PACKED) return Model::D + Model::M;
  else return Model::N + Model::M;
}

// Compute warps of a K1 block, a trait of the instance
// (ops/hopper/plan.py::k1_warps); the producer warp is one more. Four where
// the state is large (n ≥ 8) and a step holds n×n work beyond the
// recursion's own: the Vxx stores of "full" emission, the KL terms of GPS
// mode; and at m > 4 in every emission, where one warp's m×n and m×m
// terms spill (⟨14,7⟩ `gains`: 1347 ms one warp, `full` 803 ms four, on an
// H100). Elsewhere one warp, whose step is a chain of dependent operations
// that more warps would only repeat (measured with tools_torch/kernel_ab.py,
// PERF.md §6). A variable template, not a constexpr function: device code
// may not call a host one.
template <int N, int M, int EMIT, bool GPS>
constexpr int K1_WARPS =
    N >= 8 && (GPS || EMIT == EMIT_FULL || M > 4) ? 4 : 1;

// compute warp Q's role, a compile-time constant: it owns rows Q, Q+G, ...
// of Vxx, Qxx and Vraw
template <int Q>
struct Role {
  static constexpr int q = Q;
};

// f(Role<q>{}) for the compute warp's index q < G (warp-uniform)
template <int G, class Fn>
__device__ __forceinline__ void by_role(int q, Fn&& f) {
  static_assert(G == 1 || G == 4, "one or four roles");
  if constexpr (G == 1) {
    f(Role<0>{});
  } else {
    switch (q) {
      case 0: f(Role<0>{}); break;
      case 1: f(Role<1>{}); break;
      case 2: f(Role<2>{}); break;
      default: f(Role<3>{}); break;
    }
  }
}

// the compute warps' barrier before they read each other's rows; one
// warp reads only what its own threads wrote
template <int G>
__device__ __forceinline__ void rows_bar() {
  if constexpr (G > 1) named_bar(1, RING_W * G);
}

template <class Model, int EMIT, bool GPS>
__global__ void __launch_bounds__(RING_W * (4 + 1))   // ≤ 4 compute warps
backward_kernel(const float* __restrict__ traj, int s_in,
                const float* __restrict__ lam,
                const float* __restrict__ prev, const float* __restrict__ eta,
                float* __restrict__ out, int s_out,
                float* __restrict__ stats, int T, int B, int reg_type,
                bool use_limits, Lims lims,
                const float* __restrict__ lims_lanes,
                const float* __restrict__ params, typename Model::Consts mc,
                int qp_iters, int tc, int stages, bool vec) {
  constexpr int N = Model::N, M = Model::M;
  static_assert(M >= 1 && M <= MAX_M, "K1 is written for 1 ≤ m ≤ MAX_M");
  constexpr bool VALUE = EMIT == EMIT_FULL;     // Vx, Vxx slots
  constexpr bool QUU = EMIT != EMIT_GAINS;      // Quu, Quu⁻¹ slots
  constexpr int OV = M + M * N;                 // Vx's slot
  constexpr int OQ = VALUE ? OV + N + N * N : OV;   // Quu's slot
  constexpr int PS = M + M * N + M * M;          // prev slots (GPS)
  constexpr int IN = k1_in_slots<Model>();       // x, u or the packed slots
  constexpr int F = IN + (GPS ? PS + 1 : 0);     // ring: [in, prev, η]
  constexpr int G = K1_WARPS<N, M, EMIT, GPS>;
  constexpr int ROWS = (N + G - 1) / G;          // rows a compute warp owns
  constexpr int SW = N + M;                      // exchange: W[a][·], U[a][·]
  extern __shared__ __align__(16) float ring[];
  const int warp = threadIdx.x / RING_W, lane = threadIdx.x & (RING_W - 1);
  const int b0 = blockIdx.x * RING_W, b = b0 + lane;
  const int cols = min(RING_W, B - b0);
  // chunk c of the ring: steps T-1-c·tc downwards, at most tc of them
  const int nc = (T + tc - 1) / tc, stage = tc * F * RING_W;
  // after the ring: W and U by rows, [a][SW][32], and Vraw, [i][N][32]
  float* const xw = ring + stages * stage;
  float* const xv = xw + N * SW * RING_W;

  if (warp == G) {
    // the producer warp: keeps stages-1 chunks in flight ahead of the
    // compute warps; two barriers a chunk, as theirs
    auto issue = [&](int c) {
      if (c < nc) {
        const int th = T - 1 - c * tc, steps = min(tc, th + 1);
        stage_rows<F>(ring + (c % stages) * stage, steps, cols, vec, lane,
                      RING_W, [&](int tt, int s) {
                        const size_t t = (size_t)(th - tt);
                        const float* row =
                            s < IN ? traj + (t * s_in + s) * B
                            : s < IN + PS ? prev + (t * PS + (s - IN)) * B
                                          : eta + t * B;
                        return row + b0;
                      });
      }
      cp_async_commit();
    };
    for (int c = 0; c < stages - 1; ++c) issue(c);
    for (int c = 0; c < nc; ++c) {
      issue(c + stages - 1);       // into the stage consumed at chunk c-1
      cp_async_wait(stages - 1);   // this lane's copies of chunk c landed
      __syncthreads();             // chunk c is ready
      __syncthreads();             // chunk c is consumed
    }
    return;
  }

  // compute warp `warp`: lane l works on scenario b0 + l. Every compute
  // warp forms the step's vectors and m-sized terms itself; the n×n terms
  // W, U, Qxx and Vraw are split by rows, each element summed from a = 0 by
  // the warp that owns its row, and shared through xw and xv
  const bool live = b < B;
  // a lane past B reads scenario B-1's inputs and drops its results
  const int bl = live ? b : B - 1;
  const size_t sB = (size_t)B;
  const Model P = make_model<Model>(mc, params, bl, sB);
  const Lims lim = lane_lims<M>(lims, lims_lanes, bl, sB);
  const float lm = lam[bl];
  auto put = [&](int t, int s, float v) {
    if (live) out[((size_t)t * s_out + s) * sB + b] = v;
  };
  // W and U by rows, and Vraw: in registers with one compute warp, else
  // through the exchange
  float Wl[G == 1 ? N : 1][SW], VrawR[ROWS][N];
  auto W = [&](int a, int j) {
    if constexpr (G == 1) return Wl[a][j];
    else return xw[(a * SW + j) * RING_W + lane];
  };
  auto put_W = [&](int a, int j, float v) {
    if constexpr (G == 1) Wl[a][j] = v;
    else xw[(a * SW + j) * RING_W + lane] = v;
  };
  int c = 0, pos = 0;              // the chunk, and the step within it
  int cur = lane;                  // the chunk's stage, this lane's column
  auto open_chunk = [&]() {
    if (c > 0) __syncthreads();    // chunk c-1 is consumed
    __syncthreads();               // chunk c is ready
    cur = (c % stages) * stage + lane;
  };
  int r = cur;                     // this step's ring row, this lane
  auto in = [&](int s) { return ring[r + s * RING_W]; };
  open_chunk();

  float Vx[N], VxxR[ROWS][N];      // VxxR[q]: row warp + q·G of Vxx
  float dv1 = 0.0f, dv2 = 0.0f, div = 0.0f, divt = 0.0f;
  // m > 2: the box QP's warm start, the sanitised k of step t+1 (0 before
  // the first step's solve)
  float kw[M];
DDP_UNROLL
  for (int mi = 0; mi < M; ++mi) kw[mi] = 0.0f;
  typename Model::Derivs dv;
  // the step's u and expansion at ring row r: read from the packed slots,
  // or formed from (x, u) at step t (the logical step 0…T-1, which the
  // model's derivatives may read), to second order away from the boundary
  auto expand = [&](float (&u)[M], int t, bool boundary) {
    if constexpr (Model::PACKED) {
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) u[mi] = in(Model::D + mi);
      dv.p = ring + r;
    } else {
      float x[N];
DDP_UNROLL
      for (int i = 0; i < N; ++i) x[i] = in(i);
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) u[mi] = in(N + mi);
      if constexpr (Model::SECOND_ORDER) {
        if (!boundary) {
          P.derivs_so(x, u, t, Vx, dv);
          return;
        }
      }
      P.derivs(x, u, t, dv);
    }
  };

  {  // boundary t = T-1
    const int t = T - 1;
    float u[M];
    expand(u, t, true);
DDP_UNROLL
    for (int i = 0; i < N; ++i) Vx[i] = P.cx(dv, i);
    float cuu[M][M], inv[M][M];
    if (QUU) {
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
        for (int mj = 0; mj < M; ++mj) cuu[mi][mj] = P.cuu(dv, mi, mj);
      }
      if constexpr (GPS) {
        const PrevStep<N, M> pv(ring + r + IN * RING_W);
        const float e = eta_or_one(in(IN + PS));
DDP_UNROLL
        for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
          for (int mj = 0; mj < M; ++mj)
            cuu[mi][mj] = cuu[mi][mj] / e + pv.Si(mi, mj);
        }
      }
      tiny_inv<M>(cuu, inv);
    }
    by_role<G>(warp, [&](auto role) {
      constexpr int Q = decltype(role)::q;
DDP_UNROLL
      for (int q = 0; q < ROWS; ++q) {
        const int i = Q + q * G;
        if (i < N) {
DDP_UNROLL
          for (int j = 0; j < N; ++j) {
            VxxR[q][j] = P.cxx(dv, i, j);
            if (VALUE) put(t, OV + N + i * N + j, VxxR[q][j]);
          }
        }
      }
      // the step's other slots, each written by one warp
DDP_UNROLL
      for (int s = Q; s < OV; s += G) put(t, s, 0.0f);
      if (VALUE) {
DDP_UNROLL
        for (int i = Q; i < N; i += G) put(t, OV + i, Vx[i]);
      }
      if (QUU) {
DDP_UNROLL
        for (int s = Q; s < 2 * M * M; s += G) {
          const int e = s % (M * M);
          put(t, OQ + s, s < M * M ? cuu[e / M][e % M] : inv[e / M][e % M]);
        }
      }
    });
  }

  for (int t = T - 2; t >= 0; --t) {
    if (++pos == tc) {
      pos = 0;
      ++c;
      open_chunk();
    }
    r = cur + pos * (F * RING_W);
    float u[M];
    expand(u, t, false);

    // Q expansions (src/backward_pass.jl:103-123); each sum runs a = 0..n-1
    // W = Vxx·fx and U = Vxx·fu, this warp's rows, to the exchange
    by_role<G>(warp, [&](auto role) {
      constexpr int Q = decltype(role)::q;
DDP_UNROLL
      for (int q = 0; q < ROWS; ++q) {
        const int a = Q + q * G;
        if (a < N) {
DDP_UNROLL
          for (int j = 0; j < N; ++j) {
            float s = VxxR[q][0] * P.fx(dv, 0, j);
DDP_UNROLL
            for (int cc = 1; cc < N; ++cc) s = s + VxxR[q][cc] * P.fx(dv, cc, j);
            put_W(a, j, s);
          }
DDP_UNROLL
          for (int mi = 0; mi < M; ++mi) {
            float s = VxxR[q][0] * P.fu(dv, 0, mi);
DDP_UNROLL
            for (int cc = 1; cc < N; ++cc)
              s = s + VxxR[q][cc] * P.fu(dv, cc, mi);
            put_W(a, N + mi, s);
          }
        }
      }
    });
    float Qx[N], Qu[M], Quu[M][M], Qux[M][N], QxxR[ROWS][N];
DDP_UNROLL
    for (int i = 0; i < N; ++i) {
      float s = P.fx(dv, 0, i) * Vx[0];
DDP_UNROLL
      for (int a = 1; a < N; ++a) s = s + P.fx(dv, a, i) * Vx[a];
      Qx[i] = P.cx(dv, i) + s;
    }
DDP_UNROLL
    for (int mi = 0; mi < M; ++mi) {
      float s = P.fu(dv, 0, mi) * Vx[0];
DDP_UNROLL
      for (int a = 1; a < N; ++a) s = s + P.fu(dv, a, mi) * Vx[a];
      Qu[mi] = P.cu(dv, mi) + s;
    }
    rows_bar<G>();                 // W and U are whole
    by_role<G>(warp, [&](auto role) {
      constexpr int Q = decltype(role)::q;
DDP_UNROLL
      for (int q = 0; q < ROWS; ++q) {
        const int i = Q + q * G;
        if (i < N) {
DDP_UNROLL
          for (int j = 0; j < N; ++j) {
            float s = P.fx(dv, 0, i) * W(0, j);
DDP_UNROLL
            for (int a = 1; a < N; ++a) s = s + P.fx(dv, a, i) * W(a, j);
            QxxR[q][j] = P.cxx(dv, i, j) + s;
          }
        }
      }
    });
DDP_UNROLL
    for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
      for (int mj = 0; mj < M; ++mj) {
        float s = P.fu(dv, 0, mi) * W(0, N + mj);
DDP_UNROLL
        for (int a = 1; a < N; ++a) s = s + P.fu(dv, a, mi) * W(a, N + mj);
        Quu[mi][mj] = P.cuu(dv, mi, mj) + s;
      }
DDP_UNROLL
      for (int j = 0; j < N; ++j) {
        float s = P.fu(dv, 0, mi) * W(0, j);
DDP_UNROLL
        for (int a = 1; a < N; ++a) s = s + P.fu(dv, a, mi) * W(a, j);
        Qux[mi][j] = P.cxu(dv, j, mi) + s;
      }
    }
    if constexpr (Model::SECOND_ORDER) {
      // full DDP: the dynamics Hessians contracted with V′x, formed by the
      // model (vh), before the GPS and regularisation branches
      by_role<G>(warp, [&](auto role) {
        constexpr int Q = decltype(role)::q;
DDP_UNROLL
        for (int q = 0; q < ROWS; ++q) {
          const int i = Q + q * G;
          if (i < N) {
DDP_UNROLL
            for (int j = 0; j < N; ++j) QxxR[q][j] = QxxR[q][j] + P.vh(dv, i, j);
          }
        }
      });
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
        for (int j = 0; j < N; ++j) Qux[mi][j] = Qux[mi][j] + P.vh(dv, j, N + mi);
DDP_UNROLL
        for (int mj = 0; mj < M; ++mj)
          Quu[mi][mj] = Quu[mi][mj] + P.vh(dv, N + mi, N + mj);
      }
    }

    float Qux_r[M][N], QuuF[M][M];
    if constexpr (GPS) {
      // GPS mode: Q terms scaled by 1/η plus the KL expansion of the
      // previous policy (read_kl :370-392; each sum over a control in the
      // JAX order), Quu symmetrised, λ unused (src/backward_pass.jl:293-299)
      const PrevStep<N, M> pv(ring + r + IN * RING_W);
      const float ie = 1.0f / eta_or_one(in(IN + PS));
      float Si[M][M], Sik[M], SiK[M][N];
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
        for (int mj = 0; mj < M; ++mj) Si[mi][mj] = pv.Si(mi, mj);
      }
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {        // Sik = Σ⁻¹·k
        float s = Si[mi][0] * pv.k(0);
DDP_UNROLL
        for (int mj = 1; mj < M; ++mj) s = s + Si[mi][mj] * pv.k(mj);
        Sik[mi] = s;
      }
DDP_UNROLL
      for (int i = 0; i < N; ++i) {           // cx_i = Σ_mi K[mi][i]·Sik[mi]
        float c = pv.K(0, i) * Sik[0];
DDP_UNROLL
        for (int mi = 1; mi < M; ++mi) c = c + pv.K(mi, i) * Sik[mi];
        Qx[i] = Qx[i] * ie + c;
      }
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) Qu[mi] = Qu[mi] * ie + (-Sik[mi]);
DDP_UNROLL
      for (int j = 0; j < N; ++j) {
DDP_UNROLL
        for (int mi = 0; mi < M; ++mi) {      // column j of Σ⁻¹·K
          float s = Si[mi][0] * pv.K(0, j);
DDP_UNROLL
          for (int mj = 1; mj < M; ++mj) s = s + Si[mi][mj] * pv.K(mj, j);
          SiK[mi][j] = s;
          Qux[mi][j] = Qux[mi][j] * ie + (-s);
          Qux_r[mi][j] = Qux[mi][j];
        }
      }
      by_role<G>(warp, [&](auto role) {          // this warp's rows of Qxx
        constexpr int Q = decltype(role)::q;
DDP_UNROLL
        for (int q = 0; q < ROWS; ++q) {
          const int i = Q + q * G;
          if (i < N) {
DDP_UNROLL
            for (int j = 0; j < N; ++j) {     // cxx_ij = Σ_mi K_mi,i·SiK_mi,j
              float c = pv.K(0, i) * SiK[0][j];
DDP_UNROLL
              for (int mi = 1; mi < M; ++mi) c = c + pv.K(mi, i) * SiK[mi][j];
              QxxR[q][j] = QxxR[q][j] * ie + c;
            }
          }
        }
      });
      float Qg[M][M];
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
        for (int mj = 0; mj < M; ++mj)
          Qg[mi][mj] = Quu[mi][mj] * ie + Si[mi][mj];
      }
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
        for (int mj = 0; mj < M; ++mj) {
          Quu[mi][mj] = 0.5f * (Qg[mi][mj] + Qg[mj][mi]);
          QuuF[mi][mj] = Quu[mi][mj];
        }
      }
    } else if (reg_type == 2) {
      // regularised gain matrices (src/backward_pass.jl:119-123)
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
        for (int j = 0; j < N; ++j) {
          float s = P.fu(dv, 0, mi) * P.fx(dv, 0, j);
DDP_UNROLL
          for (int a = 1; a < N; ++a) s = s + P.fu(dv, a, mi) * P.fx(dv, a, j);
          Qux_r[mi][j] = Qux[mi][j] + lm * s;
        }
DDP_UNROLL
        for (int mj = 0; mj < M; ++mj) {
          float s = P.fu(dv, 0, mi) * P.fu(dv, 0, mj);
DDP_UNROLL
          for (int a = 1; a < N; ++a)
            s = s + P.fu(dv, a, mi) * P.fu(dv, a, mj);
          QuuF[mi][mj] = Quu[mi][mj] + lm * s;
        }
      }
    } else {
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
DDP_UNROLL
        for (int j = 0; j < N; ++j) Qux_r[mi][j] = Qux[mi][j];
DDP_UNROLL
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
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) rhs[mi] = -Qu[mi];
      tiny_chol_solve<M>(L, rhs, k);
DDP_UNROLL
      for (int j = 0; j < N; ++j) {
DDP_UNROLL
        for (int mi = 0; mi < M; ++mi) rhs[mi] = -Qux_r[mi][j];
        tiny_chol_solve<M>(L, rhs, col);
DDP_UNROLL
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
DDP_UNROLL
      for (int j = 0; j < N; ++j)
        K[0][j] = clamped ? 0.0f : -Qux_r[0][j] / quu_s;
    } else if constexpr (M == 2) {
      // m = 2: the exact enumeration and its K rows
      const float lo[2] = {lim.lo[0] - u[0], lim.lo[1] - u[1]};
      const float hi[2] = {lim.hi[0] - u[0], lim.hi[1] - u[1]};
      bool fr[2];
      ok = boxqp_m2(QuuF, Qu, lo, hi, k, fr);
      const bool both = fr[0] && fr[1];
      const float a = QuuF[0][0], bb = QuuF[0][1], c = QuuF[1][1];
      const float det_s = guard(a * c - bb * bb);
      const float a_s = guard(a), c_s = guard(c);
DDP_UNROLL
      for (int j = 0; j < N; ++j) {
        const float q0 = Qux_r[0][j], q1 = Qux_r[1][j];
        const float kb0 = (-q0 * c + q1 * bb) / det_s;
        const float kb1 = (q0 * bb - q1 * a) / det_s;
        K[0][j] = both ? kb0 : (fr[0] ? -q0 / a_s : 0.0f);
        K[1][j] = both ? kb1 : (fr[1] ? -q1 / c_s : 0.0f);
      }
    } else {
      // m > 2: the masked projected-Newton box QP from the warm start,
      // then K on its final free subspace, clamped rows 0
      float lo[M], hi[M], L[M][M], rhs[M], col[M];
      bool fr[M];
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
        lo[mi] = lim.lo[mi] - u[mi];
        hi[mi] = lim.hi[mi] - u[mi];
      }
      ok = boxqp_masked<M>(QuuF, Qu, lo, hi, kw, qp_iters, k, fr, L);
DDP_UNROLL
      for (int j = 0; j < N; ++j) {
DDP_UNROLL
        for (int mi = 0; mi < M; ++mi)
          rhs[mi] = fr[mi] ? -Qux_r[mi][j] : 0.0f;
        tiny_chol_solve<M>(L, rhs, col);
DDP_UNROLL
        for (int mi = 0; mi < M; ++mi) K[mi][j] = fr[mi] ? col[mi] : 0.0f;
      }
    }
    // a non-PD lane gets zero gains; V keeps updating
DDP_UNROLL
    for (int mi = 0; mi < M; ++mi) {
      k[mi] = ok ? k[mi] : 0.0f;
DDP_UNROLL
      for (int j = 0; j < N; ++j) K[mi][j] = ok ? K[mi][j] : 0.0f;
    }
    if constexpr (M > 2) {
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) kw[mi] = k[mi];
    }


    // value update with the unregularised terms (src/backward_pass.jl:63-72)
    float Quu_k[M], QuuK[M][N];
DDP_UNROLL
    for (int mi = 0; mi < M; ++mi) {
      float s = Quu[mi][0] * k[0];
DDP_UNROLL
      for (int mj = 1; mj < M; ++mj) s = s + Quu[mi][mj] * k[mj];
      Quu_k[mi] = s;
DDP_UNROLL
      for (int j = 0; j < N; ++j) {
        float rr = Quu[mi][0] * K[0][j];
DDP_UNROLL
        for (int mj = 1; mj < M; ++mj) rr = rr + Quu[mi][mj] * K[mj][j];
        QuuK[mi][j] = rr;
      }
    }
    {
      float s1 = k[0] * Qu[0], s2 = k[0] * Quu_k[0];
DDP_UNROLL
      for (int mi = 1; mi < M; ++mi) {
        s1 = s1 + k[mi] * Qu[mi];
        s2 = s2 + k[mi] * Quu_k[mi];
      }
      dv1 = dv1 + s1;
      dv2 = dv2 + 0.5f * s2;
    }
DDP_UNROLL
    for (int i = 0; i < N; ++i) {
      float s1 = K[0][i] * (Quu_k[0] + Qu[0]), s2 = Qux[0][i] * k[0];
DDP_UNROLL
      for (int mi = 1; mi < M; ++mi) {
        s1 = s1 + K[mi][i] * (Quu_k[mi] + Qu[mi]);
        s2 = s2 + Qux[mi][i] * k[mi];
      }
      Vx[i] = Qx[i] + s1 + s2;
    }
    // Vraw, this warp's rows, to the exchange; then Vxx = (Vraw + Vrawᵀ)/2
    by_role<G>(warp, [&](auto role) {
      constexpr int Q = decltype(role)::q;
DDP_UNROLL
      for (int q = 0; q < ROWS; ++q) {
        const int i = Q + q * G;
        if (i < N) {
DDP_UNROLL
          for (int j = 0; j < N; ++j) {
            float r1 = K[0][i] * QuuK[0][j], r2 = K[0][i] * Qux[0][j],
                  r3 = Qux[0][i] * K[0][j];
DDP_UNROLL
            for (int mi = 1; mi < M; ++mi) {
              r1 = r1 + K[mi][i] * QuuK[mi][j];
              r2 = r2 + K[mi][i] * Qux[mi][j];
              r3 = r3 + Qux[mi][i] * K[mi][j];
            }
            VrawR[q][j] = QxxR[q][j] + r1 + r2 + r3;
            if constexpr (G > 1) xv[(i * N + j) * RING_W + lane] = VrawR[q][j];
          }
        }
      }
    });

    rows_bar<G>();                 // Vraw is whole
    by_role<G>(warp, [&](auto role) {
      constexpr int Q = decltype(role)::q;
DDP_UNROLL
      for (int q = 0; q < ROWS; ++q) {
        const int i = Q + q * G;
        if (i < N) {
DDP_UNROLL
          for (int j = 0; j < N; ++j) {
            float vt;                 // Vraw[j][i]
            if constexpr (G == 1) vt = VrawR[j][q];
            else vt = xv[(j * N + i) * RING_W + lane];
            VxxR[q][j] = 0.5f * (VrawR[q][j] + vt);
          }
        }
      }
    });

    // divergence latch: t+1 of the first failing step (backward order)
    const float bad = ok ? 0.0f : 1.0f;
    const float newly = bad * (1.0f - div);
    divt = divt * (1.0f - newly) + newly * (float)(t + 1);
    div = maxp(div, bad);

    // the step's slots: each warp its rows of Vxx, and every G-th other one
    float inv[M][M];
    if (QUU) tiny_inv<M>(Quu, inv);
    by_role<G>(warp, [&](auto role) {
      constexpr int Q = decltype(role)::q;
DDP_UNROLL
      for (int s = Q; s < OV; s += G)
        put(t, s, s < M ? k[s] : K[(s - M) / N][(s - M) % N]);
      if (VALUE) {
DDP_UNROLL
        for (int i = Q; i < N; i += G) put(t, OV + i, Vx[i]);
DDP_UNROLL
        for (int q = 0; q < ROWS; ++q) {
          const int i = Q + q * G;
          if (i < N) {
DDP_UNROLL
            for (int j = 0; j < N; ++j) put(t, OV + N + i * N + j, VxxR[q][j]);
          }
        }
      }
      if (QUU) {
DDP_UNROLL
        for (int s = Q; s < 2 * M * M; s += G) {
          const int e = s % (M * M);
          put(t, OQ + s, s < M * M ? Quu[e / M][e % M] : inv[e / M][e % M]);
        }
      }
    });
  }

  __syncthreads();                 // the last chunk is consumed
  if (warp == 0 && live) {
    stats[b] = dv1;
    stats[sB + b] = dv2;
    stats[2 * sB + b] = div;
    stats[3 * sB + b] = divt;
  }
}

// one instance of K1 for one model, launched on the caller's stream with
// the wrapper's plan
template <class Model, int EMIT, bool GPS>
int launch_one(const BwdArgs& a) {
  constexpr int N = Model::N, M = Model::M;
  constexpr int F = k1_in_slots<Model>() + (GPS ? M + M * N + M * M + 1 : 0);
  constexpr int G = K1_WARPS<N, M, EMIT, GPS>;
  const RingPlan& p = a.plan;
  if (Model::PACKED && a.s_in != k1_in_slots<Model>()) return ERR_ARGS;
  if (!plan_ok(p, a.B, RING_W * (G + 1), F,
               G > 1 ? RING_W * (N * (N + M) + N * N) : 0))
    return ERR_ARGS;
  typename Model::Consts mc;
  for (int i = 0; i < Model::N_CONSTS; ++i) mc.c[i] = a.consts[i];
  const auto kernel = backward_kernel<Model, EMIT, GPS>;
  const int rc = reserve_smem(kernel, p.smem);
  if (rc != 0) return rc;
  const bool vec = rows_aligned(a.B, a.traj) &&
                   (!GPS || (rows_aligned(a.B, a.prev) &&
                             rows_aligned(a.B, a.eta)));
  kernel<<<p.blocks, p.threads, p.smem, a.stream>>>(
      a.traj, a.s_in, a.lam, a.prev, a.eta, a.out, a.s_out, a.stats, a.T,
      a.B, a.reg_type, a.use_limits, a.lims, a.lims_lanes, a.params, mc,
      a.qp_iters, p.tc, p.stages, vec);
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

// K1 for one model in the iLQG entries' modes, "gains" and "full"
// without GPS mode (ilqg_batch_lanes and its replay); ERR_MODEL for the
// others
template <class Model>
int launch_ilqg(const BwdArgs& a) {
  if (a.prev != nullptr) return ERR_MODEL;
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
}

// K1 for one model in GPS "policy" emission only, the KL entries' mode
template <class Model>
int launch_gps_policy(const BwdArgs& a) {
  return a.prev != nullptr && a.emit == EMIT_POLICY
             ? launch_one<Model, EMIT_POLICY, true>(a)
             : ERR_MODEL;
}

// K1 for one model in the modes every fleet entry launches
template <class Model>
int launch_entries(const BwdArgs& a) {
  return a.prev != nullptr ? launch_gps_policy<Model>(a)
                           : launch_ilqg<Model>(a);
}

}  // namespace

// the LTI ⟨10,2⟩ instances: without GPS mode in backward_lti.cu, in GPS
// mode in backward_lti_gps.cu; LTI ⟨10,3⟩ likewise in backward_lti_10_3.cu
// and backward_lti_gps_10_3.cu; PendCartParam ⟨4,1⟩, "gains" and "full"
// without GPS mode, in backward_pendcart_param.cu; the autodiff instances
// (autodiff.cuh), "gains" and "full" without GPS mode: quadrotor ⟨6,2⟩ in
// backward_quad.cu, pendcart ⟨4,1⟩ in backward_pendcart_ad.cu; the
// second-order instances in backward_so.cu (PendCartSO, Autodiff<PendCart,
// true>) and backward_quad_so.cu; the packed instances in
// backward_packed.cu (⟨4,1⟩, ⟨6,2⟩) and backward_packed_lti.cu (⟨10,2⟩);
// the instances of every other public derivative source, each in the modes
// the fleet entries launch (launch_ilqg, launch_gps_policy, launch_entries):
// Autodiff<PendCartParam>, first and second order, in
// backward_pendcart_param_ad.cu; GPS "policy" of Autodiff<PendCart>,
// Autodiff<PendCart, true> and PendCartSO in backward_pendcart_gps.cu; and
// in the sources library (backward_sources.cu, built at its first launch)
// Autodiff<LTI> ⟨10,2⟩ and ⟨10,3⟩, first order in backward_lti_ad.cu and
// backward_lti_ad_10_3.cu, second order in backward_lti_ad_so.cu and
// backward_lti_ad_so_10_3.cu, and GPS "policy" of Autodiff<Quadrotor, true>
// in backward_quad_so_gps.cu
int launch_backward_lti_10_2(const BwdArgs& a);
int launch_backward_lti_gps_10_2(const BwdArgs& a);
int launch_backward_lti_10_3(const BwdArgs& a);
int launch_backward_lti_gps_10_3(const BwdArgs& a);
int launch_backward_pendcart_param(const BwdArgs& a);
int launch_backward_quad_6_2(const BwdArgs& a);
int launch_backward_pendcart_ad(const BwdArgs& a);
int launch_backward_pendcart_so(const BwdArgs& a);
int launch_backward_pendcart_ad_so(const BwdArgs& a);
int launch_backward_quad_so(const BwdArgs& a);
int launch_backward_packed(const BwdArgs& a, int n, int m);
int launch_backward_lti_ad_10_2(const BwdArgs& a);
int launch_backward_lti_ad_10_3(const BwdArgs& a);
int launch_backward_lti_ad_so_10_2(const BwdArgs& a);
int launch_backward_lti_ad_so_10_3(const BwdArgs& a);
int launch_backward_pendcart_param_ad(const BwdArgs& a);
int launch_backward_pendcart_param_ad_so(const BwdArgs& a);
int launch_backward_pendcart_ad_gps(const BwdArgs& a);
int launch_backward_pendcart_ad_so_gps(const BwdArgs& a);
int launch_backward_pendcart_so_gps(const BwdArgs& a);
int launch_backward_quad_so_gps(const BwdArgs& a);

}  // namespace ddp
