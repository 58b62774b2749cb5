// K1 entry point: checks the arguments, picks the model's instance, and
// launches it. The kernel is in backward.cuh; the pendcart ⟨4,1⟩ instances
// are compiled here, the LTI ⟨10,2⟩ ones in backward_lti.cu (without GPS
// mode) and backward_lti_gps.cu (GPS mode), the LTI ⟨10,3⟩ ones in
// backward_lti_10_3.cu and backward_lti_gps_10_3.cu, the PendCartParam
// ⟨4,1⟩ ones in backward_pendcart_param.cu, and the autodiff instances
// (autodiff != 0: derivatives made in the kernel from the model's own
// functions; the quadrotor's also in GPS mode) in backward_quad.cu and
// backward_pendcart_ad.cu, the
// second-order (full DDP) ones in backward_so.cu and backward_quad_so.cu,
// and the packed-derivatives ones (model id 0: no model, the stream holds
// the expansion) in backward_packed.cu and backward_packed_lti.cu, and
// Autodiff<PendCartParam>, first and second order, without GPS mode in
// backward_pendcart_param_ad.cu and the GPS "policy" of Autodiff<PendCart>,
// Autodiff<PendCart, true> and PendCartSO in backward_pendcart_gps.cu; so
// that nvcc builds them in parallel. Autodiff<LTI> and the GPS "policy" of
// Autodiff<Quadrotor, true> are the sources library's (backward_sources.cu),
// built at their first launch. A model with autodiff set runs its
// autodiff instance or none: never its analytic one; second-order
// derivatives run a second-order instance or none. Per-scenario limits
// (lims_lanes) are a runtime input of every instance; an m outside
// 1..MAX_M is refused (ERR_ARGS), never cut to MAX_M controls. qp_iters is
// the m > 2 box QP's iteration count (backward_kernel.py's qp_iters). The
// launch plan (blocks, threads, tc, stages, shared bytes;
// ops/hopper/plan.py) is checked by the instance's launcher.
#include "backward.cuh"
#include "lti.cuh"
#include "pendcart.cuh"
#include "quadrotor.cuh"

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
  const bool gps = prev != nullptr;
  const bool packed = model_id == 0;
  BwdArgs a;
  const int rc = bwd_args(traj, s_in, lam, prev, eta, out, s_out, stats, T,
                          B, emit, reg_type, use_limits, lims, lims_lanes,
                          params, n_params, n, m, consts, qp_iters, blocks,
                          threads, tc, stages, smem, stream, a);
  if (rc != 0) return rc;
  cudaSetDevice(device);
  using LTI10x2 = LTI<10, 2>;
  using LTI10x3 = LTI<10, 3>;
  const bool pendcart = model_id == PendCart::ID && n == PendCart::N &&
                        m == PendCart::M && n_consts == PendCart::N_CONSTS;
  const bool quad = model_id == Quadrotor::ID && n == Quadrotor::N &&
                    m == Quadrotor::M && n_consts == Quadrotor::N_CONSTS;
  const bool lti2 = model_id == LTI10x2::ID && n == LTI10x2::N &&
                    m == LTI10x2::M && n_consts == LTI10x2::N_CONSTS;
  const bool lti3 = model_id == LTI10x3::ID && n == LTI10x3::N &&
                    m == LTI10x3::M && n_consts == LTI10x3::N_CONSTS;
  if (packed) {
    if (autodiff || second_order || n_params != 0 || n_consts != 0)
      return ERR_MODEL;
    return launch_backward_packed(a, n, m);
  }
  if (model_id == PendCartParam::ID) {
    if (gps || n != PendCartParam::N || m != PendCartParam::M ||
        n_consts != PendCartParam::N_CONSTS ||
        n_params != PendCartParam::N_PARAMS)
      return ERR_MODEL;
    if (autodiff)
      return second_order ? launch_backward_pendcart_param_ad_so(a)
                          : launch_backward_pendcart_param_ad(a);
    return second_order ? ERR_MODEL : launch_backward_pendcart_param(a);
  }
  if (n_params != 0) return ERR_MODEL;
  if (second_order) {
    if (pendcart && gps)
      return autodiff ? launch_backward_pendcart_ad_so_gps(a)
                      : launch_backward_pendcart_so_gps(a);
    if (pendcart)
      return autodiff ? launch_backward_pendcart_ad_so(a)
                      : launch_backward_pendcart_so(a);
    if (quad && autodiff && !gps) return launch_backward_quad_so(a);
    return ERR_MODEL;
  }
  if (autodiff) {
    if (pendcart)
      return gps ? launch_backward_pendcart_ad_gps(a)
                 : launch_backward_pendcart_ad(a);
    if (quad) return launch_backward_quad_6_2(a);
    return ERR_MODEL;
  }
  if (pendcart)
    return gps ? launch_backward<PendCart, true>(a)
               : launch_backward<PendCart, false>(a);
  if (lti2)
    return gps ? launch_backward_lti_gps_10_2(a)
               : launch_backward_lti_10_2(a);
  if (lti3)
    return gps ? launch_backward_lti_gps_10_3(a)
               : launch_backward_lti_10_3(a);
  return ERR_MODEL;
}

extern "C" const char* ddp_error_string(int code) {
  if (code == ddp::ERR_MODEL)
    return "no kernel is built for this model id, n, m, descriptor size, "
           "derivative source, GPS mode and emission";
  if (code == ddp::ERR_ARGS) return "arguments outside what the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
