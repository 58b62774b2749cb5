// The C entry points of a lowered model's or tiles' library: K1, K2 and K3
// instantiated for one struct that ops/hopper/lower.py emits (the model
// interface of common.cuh): `Lowered` (model id 5) from a model's traced
// Python functions, or `LoweredTiles` (model id 6) from a user's traced
// derivative tiles, K1's analytic expansion. ops/hopper/_build.py writes a
// source that defines DDP_LOWERED_GROUP, includes autodiff.cuh, defines
// the struct in namespace ddp and then includes this header, and compiles
// it into a library of its own, one per instance group, so that a call
// compiles only what it launches:
//   0 "fwd"     K3 and K2 (ddp_forward_lanes, ddp_linesearch_lanes), with
//               the model's diff where it has one (HAS_DIFF);
//   1 "k1"      K1 Autodiff<Lowered> in "gains" and "full" emission;
//   2 "k1_gps"  K1 Autodiff<Lowered> in GPS mode ("full", "policy") and
//               in "policy" emission without it;
//   3 "k1_so"   K1 Autodiff<Lowered, true> (full DDP), "gains" and "full";
//   4 "t1"      K1 LoweredTiles in "gains" and "full" emission;
//   5 "t1_gps"  K1 LoweredTiles in GPS mode ("full", "policy") and in
//               "policy" emission without it;
//   6 "t1_so"   K1 LoweredTiles of second-order tiles (full DDP), "gains"
//               and "full";
//   7 "k1_so_gps" K1 Autodiff<Lowered, true> in GPS mode ("full",
//               "policy");
//   8 "t1_so_gps" K1 LoweredTiles of second-order tiles in GPS mode
//               ("full", "policy").
// The entry points have the signatures of the kernel library's
// (_build.SIGNATURES) and return ERR_MODEL for an instance the group does
// not hold. Groups 1-3 and 7 make K1's derivatives by autodiff of the
// model's struct, groups 4-6 and 8 read the user's expansion.
#pragma once

#ifndef DDP_LOWERED_GROUP
#error "define DDP_LOWERED_GROUP before including lowered.cuh"
#endif

#if DDP_LOWERED_GROUP == 0
#include "forward.cuh"
#else
#include "backward.cuh"
#endif

namespace ddp {

// whether the group makes K1's derivatives by autodiff of a Lowered
// struct, or reads a user's LoweredTiles
#define DDP_LOWERED_AUTODIFF \
  (DDP_LOWERED_GROUP <= 3 || DDP_LOWERED_GROUP == 7)

// the group's struct
#if DDP_LOWERED_AUTODIFF
using LoweredStruct = Lowered;
#else
using LoweredStruct = LoweredTiles;
#endif

// the struct's shape against the launcher's arguments
inline bool is_lowered(int model_id, int n, int m, int n_consts,
                       int n_params) {
  using L = LoweredStruct;
  return model_id == L::ID && n == L::N && m == L::M &&
         n_consts == L::N_CONSTS && n_params == L::N_PARAMS;
}

}  // namespace ddp

#if DDP_LOWERED_GROUP == 0

extern "C" int ddp_forward_lanes(const float* traj, int s_traj,
                                 const float* gains, int s_g, int gk, int gK,
                                 const float* x0, const float* alphas, int A,
                                 float* totals, float* terminal,
                                 float* out_traj, int T, int B,
                                 const float* lims, const float* lims_lanes,
                                 const float* params, int n_params,
                                 int model_id, int n, int m,
                                 const float* consts, int n_consts,
                                 int blocks, int threads, int tc, int stages,
                                 int smem, int device, void* stream) {
  using namespace ddp;
  if (m < 1 || m > MAX_M) return ERR_ARGS;
  if (!is_lowered(model_id, n, m, n_consts, n_params)) return ERR_MODEL;
  FwdArgs a;
  const int rc = k3_args(traj, s_traj, gains, s_g, gk, gK, x0, alphas, A,
                         totals, terminal, out_traj, T, B, lims, lims_lanes,
                         params, n_params, n, m, consts, blocks, threads, tc,
                         stages, smem, stream, a);
  if (rc != 0) return rc;
  cudaSetDevice(device);
  return launch_forward<Lowered>(a);
}

extern "C" int ddp_linesearch_lanes(const float* traj, int s_traj,
                                    const float* gains, int s_g, int gk,
                                    int gK, const float* x0, const float* sel,
                                    const float* alphas, int A, float rr_min,
                                    float* out_traj, float* ls, int T, int B,
                                    const float* lims,
                                    const float* lims_lanes,
                                    const float* params, int n_params,
                                    int model_id, int n, int m,
                                    const float* consts, int n_consts,
                                    int blocks, int threads, int tc,
                                    int stages, int smem, int device,
                                    void* stream) {
  using namespace ddp;
  if (m < 1 || m > MAX_M) return ERR_ARGS;
  if (!is_lowered(model_id, n, m, n_consts, n_params)) return ERR_MODEL;
  FwdArgs a;
  const int rc = k2_args(traj, s_traj, gains, s_g, gk, gK, x0, sel, alphas,
                         A, rr_min, out_traj, ls, T, B, lims, lims_lanes,
                         params, n_params, n, m, consts, blocks, threads, tc,
                         stages, smem, stream, a);
  if (rc != 0) return rc;
  cudaSetDevice(device);
  return launch_linesearch<Lowered>(a);
}

#else

namespace ddp {
namespace {

// the group's K1 instances; ERR_MODEL for the others
int launch_lowered(const BwdArgs& a, bool gps, bool second_order) {
#if DDP_LOWERED_GROUP == 1 || DDP_LOWERED_GROUP == 4
#if DDP_LOWERED_GROUP == 1
  using Model = Autodiff<Lowered>;
#else
  using Model = LoweredTiles;
  static_assert(!Model::SECOND_ORDER, "first-order tiles");
#endif
  if (gps || second_order) return ERR_MODEL;
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
#elif DDP_LOWERED_GROUP == 2 || DDP_LOWERED_GROUP == 5
#if DDP_LOWERED_GROUP == 2
  using Model = Autodiff<Lowered>;
#else
  using Model = LoweredTiles;
  static_assert(!Model::SECOND_ORDER, "first-order tiles");
#endif
  if (second_order) return ERR_MODEL;
  if (gps) {
    switch (a.emit) {
      case EMIT_FULL: return launch_one<Model, EMIT_FULL, true>(a);
      case EMIT_POLICY: return launch_one<Model, EMIT_POLICY, true>(a);
      default: return ERR_MODEL;
    }
  }
  return a.emit == EMIT_POLICY ? launch_one<Model, EMIT_POLICY, false>(a)
                               : ERR_MODEL;
#elif DDP_LOWERED_GROUP == 3 || DDP_LOWERED_GROUP == 6
#if DDP_LOWERED_GROUP == 3
  using Model = Autodiff<Lowered, true>;
#else
  using Model = LoweredTiles;
  static_assert(Model::SECOND_ORDER, "second-order tiles");
#endif
  if (gps || !second_order) return ERR_MODEL;
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
#elif DDP_LOWERED_GROUP == 7 || DDP_LOWERED_GROUP == 8
#if DDP_LOWERED_GROUP == 7
  using Model = Autodiff<Lowered, true>;
#else
  using Model = LoweredTiles;
  static_assert(Model::SECOND_ORDER, "second-order tiles");
#endif
  if (!gps || !second_order) return ERR_MODEL;
  switch (a.emit) {
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, true>(a);
    case EMIT_POLICY: return launch_one<Model, EMIT_POLICY, true>(a);
    default: return ERR_MODEL;
  }
#else
#error "DDP_LOWERED_GROUP is 0 to 8"
#endif
}

}  // namespace
}  // namespace ddp

extern "C" int ddp_backward_lanes(const float* traj, int s_in,
                                  const float* lam, const float* prev,
                                  const float* eta, float* out, int s_out,
                                  float* stats, int T, int B, int emit,
                                  int reg_type, int use_limits,
                                  const float* lims, const float* lims_lanes,
                                  const float* params, int n_params,
                                  int model_id, int n, int m,
                                  const float* consts, int n_consts,
                                  int autodiff, int second_order,
                                  int qp_iters, int blocks, int threads,
                                  int tc, int stages, int smem, int device,
                                  void* stream) {
  using namespace ddp;
  BwdArgs a;
  const int rc = bwd_args(traj, s_in, lam, prev, eta, out, s_out, stats, T,
                          B, emit, reg_type, use_limits, lims, lims_lanes,
                          params, n_params, n, m, consts, qp_iters, blocks,
                          threads, tc, stages, smem, stream, a);
  if (rc != 0) return rc;
  // groups 1-3 and 7 differentiate the struct, groups 4-6 and 8 read the
  // tiles
  if ((autodiff != 0) != DDP_LOWERED_AUTODIFF ||
      !is_lowered(model_id, n, m, n_consts, n_params))
    return ERR_MODEL;
  cudaSetDevice(device);
  return launch_lowered(a, prev != nullptr, second_order != 0);
}

#endif

extern "C" const char* ddp_error_string(int code) {
  if (code == ddp::ERR_MODEL)
    return "this lowered library holds no instance for this model id, n, "
           "m, descriptor size, derivative source and order, GPS mode and "
           "emission";
  if (code == ddp::ERR_ARGS) return "arguments outside what the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
