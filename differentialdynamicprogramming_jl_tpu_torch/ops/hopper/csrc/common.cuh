// Helpers shared by every kernel source: NaN-keeping min/max, the error
// codes of the launchers, the control limits (static, or per scenario), the
// per-scenario model, and the small dense Cholesky solves of the backward
// pass.
//
// The model interface. A model is a struct with compile-time N (state
// size), M (control size), ID (its device-model id), N_CONSTS and N_PARAMS
// (per-scenario parameters, 0 for most models), a nested
// Consts { float c[N_CONSTS]; } that a kernel takes by value as its
// descriptor, a constructor from `const Consts&` (N_PARAMS == 0) or from
// `const Consts&, const float (&par)[N_PARAMS]` (one scenario's parameters,
// read by make_model below), and the device functions
//   dynamics(x, u, t, xn), cost(x, u, t), terminal(x)  (forward.cuh)
//   derivs(x, u, t, d) and the accessors fx(d, i, j), fu(d, i, mi),
//   cx(d, i), cu(d, mi), cxx(d, i, j), cxu(d, i, mi), cuu(d, mi, mj)
//                                                      (backward.cuh)
// with x, xn as float (&)[N], u as float (&)[M] and t the int step index,
// the logical step 0…T-1 (JAX's kernels pass t_log): a time-varying model
// reads it, the hand-written ones take it and ignore it. `d` is the
// model's per-step Derivs: what the expansion at (x, u, t) holds beyond
// constants.
// Every loop over a model's dimensions is unrolled (DDP_UNROLL, below) in
// the kernel library, so the accessors' indices are compile-time
// constants; a library generated for m > 4 (DDP_ROLLED) rolls them,
// and its accessors take run-time indices. K2 and K3 read one compile-time
// flag of a model:
//   HAS_DIFF: the feedback term's state difference is the model's
//     diff(x, x_old, dx) (LanesModel.diff, e.g. angle wrapping) rather than
//     x - x_old; false for every hand-written model, set by a lowered one
//     (lowered.cuh) whose Python model has a diff.
// K1 reads two:
//   PACKED: the model is the packed-derivatives stream (packed.cuh): K1's
//     ring carries its D+M slots per step, Derivs points at the step's
//     ring row, and derivs() is not called;
//   SECOND_ORDER: full DDP. K1 calls derivs_so(x, u, t, Vx, d) in place of
//     derivs() away from the boundary, with Vx the value gradient of t+1,
//     and adds vh(d, i, j) = Σ_a Vx[a]·∂²f_a/∂z_i∂z_j (z = (x, u), a from
//     0) to Qxx, Qux and Quu before the regularisation.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ddp {

// controls a library is built for: the Lims arrays' size, and the bound of
// every model's M (the launchers refuse a larger m). The kernel library
// (csrc/*.cu) keeps 4, so that its instances' by-value Lims and registers
// stay as they are; a library generated for a larger m (a lowered model's
// or tiles' groups, the packed K1) defines DDP_MAX_M as its m before it
// includes this header (ops/hopper/_build.py), up to plan.MAX_CONTROLS
#ifndef DDP_MAX_M
#define DDP_MAX_M 4
#endif
constexpr int MAX_M = DDP_MAX_M;

// the loops over a model's dimensions (K1, K2, K3 and the autodiff
// passes): unrolled in full, so that each index is a compile-time constant
// and the arrays live in registers; rolled in a library generated for
// m > 4 (DDP_ROLLED, set by ops/hopper/_build.py with DDP_MAX_M), whose
// m×m and m×n arrays live in local memory anyway, so that nvcc's
// time and memory stay bounded (fully unrolled, the <16,16> instances ran
// a 96 GiB host out of memory). A rolled loop runs the same operations in
// the same order.
#ifndef DDP_ROLLED
#define DDP_ROLLED 0
#endif
#if DDP_ROLLED
#define DDP_UNROLL _Pragma("unroll 1")
#else
#define DDP_UNROLL _Pragma("unroll")
#endif

// error codes the launchers return for arguments they refuse (cudaError_t
// values are >= 0)
constexpr int ERR_MODEL = -1;   // no kernel built for this (model, n, m)
constexpr int ERR_ARGS = -2;    // shape or count outside what a kernel takes

// control limits, per control: the launch's static ones, or one
// scenario's (lane_lims)
struct Lims {
  float lo[MAX_M], hi[MAX_M];
};

// [lo_0, hi_0, lo_1, hi_1, ...] from the host into l; false, with l
// untouched, for an m outside 1..MAX_M, which the launchers refuse
// (ERR_ARGS) rather than drop the controls past MAX_M
inline bool lims_from_host(const float* lims, int m, Lims& l) {
  if (m < 1 || m > MAX_M) return false;
  l = Lims{};
  for (int i = 0; i < m; ++i) {
    l.lo[i] = lims[2 * i];
    l.hi[i] = lims[2 * i + 1];
  }
  return true;
}

// The limits of scenario b: the launch's static ones when lims_lanes is
// null, else that scenario's column of the (2m, B) stream
// [lo_0, hi_0, lo_1, hi_1, ...] (JAX: the kernels' dyn_lims input). Read
// once per thread, before the time loop.
template <int M>
__device__ __forceinline__ Lims lane_lims(const Lims& lims,
                                          const float* __restrict__ lims_lanes,
                                          int b, size_t sB) {
#if DDP_ROLLED
  // rolled loops index the limits at run time: read them into a local copy
  // one control at a time, the loop unrolled, so that no run-time index
  // reaches the by-value kernel parameter (a rolled K3 that clamped with
  // the copy of the parameter itself read wrong limits on an H100)
  Lims l;
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    l.lo[mi] = lims_lanes == nullptr
                   ? lims.lo[mi]
                   : lims_lanes[(size_t)(2 * mi) * sB + b];
    l.hi[mi] = lims_lanes == nullptr
                   ? lims.hi[mi]
                   : lims_lanes[(size_t)(2 * mi + 1) * sB + b];
  }
  return l;
#else
  if (lims_lanes == nullptr) return lims;
  Lims l = lims;
DDP_UNROLL
  for (int mi = 0; mi < M; ++mi) {
    l.lo[mi] = lims_lanes[(size_t)(2 * mi) * sB + b];
    l.hi[mi] = lims_lanes[(size_t)(2 * mi + 1) * sB + b];
  }
  return l;
#endif
}

// The model of scenario b: from the descriptor, and for a model with
// per-scenario parameters from that scenario's column of the (P, B) params
// stream (JAX: LanesModel.n_params and the kernels' params input).
template <class Model>
__device__ __forceinline__ Model make_model(
    const typename Model::Consts& mc, const float* __restrict__ params, int b,
    size_t sB) {
  if constexpr (Model::N_PARAMS == 0) {
    return Model(mc);
  } else {
    float par[Model::N_PARAMS];
DDP_UNROLL
    for (int p = 0; p < Model::N_PARAMS; ++p) par[p] = params[p * sB + b];
    return Model(mc, par);
  }
}

// NaN-propagating min/max/clip/sign, as jnp.minimum/maximum/clip/sign and
// torch.minimum/maximum behave (fminf/fmaxf would drop a NaN operand)
__device__ __forceinline__ float maxp(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minp(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float clipp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}
__device__ __forceinline__ float signp(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// Unrolled Cholesky of an MM×MM matrix (backward_kernel.py::_tiny_chol);
// returns whether every leading minor is positive. The pivot is
// sqrt(max(d, 1e-30)).
template <int MM>
__device__ __forceinline__ bool tiny_chol(const float (&Q)[MM][MM],
                                          float (&L)[MM][MM]) {
  bool ok = true;
DDP_UNROLL
  for (int j = 0; j < MM; ++j) {
    float d = Q[j][j];
DDP_UNROLL
    for (int p = 0; p < j; ++p) d = d - L[j][p] * L[j][p];
    ok = ok && (d > 0.0f);
    const float Ljj = sqrtf(maxp(d, 1e-30f));
    L[j][j] = Ljj;
DDP_UNROLL
    for (int i = j + 1; i < MM; ++i) {
      float s = Q[i][j];
DDP_UNROLL
      for (int p = 0; p < j; ++p) s = s - L[i][p] * L[j][p];
      L[i][j] = s / Ljj;
    }
  }
  return ok;
}

// L·Lᵀ·x = b by forward and back substitution (::_tiny_chol_solve)
template <int MM>
__device__ __forceinline__ void tiny_chol_solve(const float (&L)[MM][MM],
                                                const float (&b)[MM],
                                                float (&x)[MM]) {
  float y[MM];
DDP_UNROLL
  for (int i = 0; i < MM; ++i) {
    float s = b[i];
DDP_UNROLL
    for (int p = 0; p < i; ++p) s = s - L[i][p] * y[p];
    y[i] = s / L[i][i];
  }
DDP_UNROLL
  for (int i = MM - 1; i >= 0; --i) {
    float s = y[i];
DDP_UNROLL
    for (int p = i + 1; p < MM; ++p) s = s - L[p][i] * x[p];
    x[i] = s / L[i][i];
  }
}

// inverse by solves against the unit vectors (::_tiny_inv); m=1: (1/L)/L
template <int MM>
__device__ __forceinline__ void tiny_inv(const float (&Q)[MM][MM],
                                         float (&inv)[MM][MM]) {
  float L[MM][MM];
  tiny_chol<MM>(Q, L);
DDP_UNROLL
  for (int j = 0; j < MM; ++j) {
    float e[MM], col[MM];
DDP_UNROLL
    for (int i = 0; i < MM; ++i) e[i] = i == j ? 1.0f : 0.0f;
    tiny_chol_solve<MM>(L, e, col);
DDP_UNROLL
    for (int i = 0; i < MM; ++i) inv[i][j] = col[i];
  }
}

}  // namespace ddp
