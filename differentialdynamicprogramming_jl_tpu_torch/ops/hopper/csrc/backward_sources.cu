// K1's entry point of the sources library (ops/hopper/_build.py
// sources_library), built at its first launch apart from the kernel
// library: Autodiff<LTI> at ⟨10,2⟩ and ⟨10,3⟩, first and second order, in
// "gains" and "full" without GPS mode and "policy" in it
// (backward_lti_ad{,_10_3,_so,_so_10_3}.cu), and the GPS "policy" of
// Autodiff<Quadrotor, true> (backward_quad_so_gps.cu). These instances
// spill heavily (their expansion, 210-330 floats a lane, lives in the stack
// frame), and built with the kernel library they made its build on the
// card's host twice as long (≈100 s against ≈50 s). The arguments are the
// kernel library's (backward.cu); anything else returns ERR_MODEL.
#include "backward.cuh"
#include "lti.cuh"
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
  BwdArgs a;
  const int rc = bwd_args(traj, s_in, lam, prev, eta, out, s_out, stats, T,
                          B, emit, reg_type, use_limits, lims, lims_lanes,
                          params, n_params, n, m, consts, qp_iters, blocks,
                          threads, tc, stages, smem, stream, a);
  if (rc != 0) return rc;
  if (!autodiff || n_params != 0) return ERR_MODEL;
  cudaSetDevice(device);
  using LTI10x2 = LTI<10, 2>;
  using LTI10x3 = LTI<10, 3>;
  if (model_id == LTI10x2::ID && n == LTI10x2::N && m == LTI10x2::M &&
      n_consts == LTI10x2::N_CONSTS)
    return second_order ? launch_backward_lti_ad_so_10_2(a)
                        : launch_backward_lti_ad_10_2(a);
  if (model_id == LTI10x3::ID && n == LTI10x3::N && m == LTI10x3::M &&
      n_consts == LTI10x3::N_CONSTS)
    return second_order ? launch_backward_lti_ad_so_10_3(a)
                        : launch_backward_lti_ad_10_3(a);
  if (model_id == Quadrotor::ID && n == Quadrotor::N &&
      m == Quadrotor::M && n_consts == Quadrotor::N_CONSTS && second_order)
    return launch_backward_quad_so_gps(a);
  return ERR_MODEL;
}

extern "C" const char* ddp_error_string(int code) {
  if (code == ddp::ERR_MODEL)
    return "the sources library holds no instance for this model id, n, m, "
           "descriptor size, derivative source, GPS mode and emission";
  if (code == ddp::ERR_ARGS) return "arguments outside what the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
