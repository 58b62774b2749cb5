// K3 and K2 entry points: check the arguments, pick the model's instance,
// and launch it with the wrapper's launch plan (ops/hopper/plan.py). The
// kernels are in forward.cuh; the pendcart ⟨4,1⟩
// instances are compiled here, the LTI ⟨10,2⟩ ones in forward_lti.cu, the
// LTI ⟨10,3⟩ ones in forward_lti_10_3.cu, the quadrotor ⟨6,2⟩ ones in
// forward_quad.cu and the PendCartParam ⟨4,1⟩ ones in
// forward_pendcart_param.cu, so that nvcc builds them in parallel. An m
// outside 1..MAX_M is refused (ERR_ARGS), never cut to MAX_M controls.
#include "forward.cuh"
#include "lti.cuh"
#include "pendcart.cuh"
#include "quadrotor.cuh"

using namespace ddp;

namespace {

using LTI10x2 = LTI<10, 2>;
using LTI10x3 = LTI<10, 3>;

template <class Model>
bool is(int model_id, int n, int m, int n_consts, int n_params) {
  return model_id == Model::ID && n == Model::N && m == Model::M &&
         n_consts == Model::N_CONSTS && n_params == Model::N_PARAMS;
}

// which instance: 1 pendcart, 2 LTI ⟨10,2⟩, 3 quadrotor, 4 PendCartParam,
// 5 LTI ⟨10,3⟩, 0 none
int instance(int model_id, int n, int m, int n_consts, int n_params) {
  if (is<PendCart>(model_id, n, m, n_consts, n_params)) return 1;
  if (is<LTI10x2>(model_id, n, m, n_consts, n_params)) return 2;
  if (is<Quadrotor>(model_id, n, m, n_consts, n_params)) return 3;
  if (is<PendCartParam>(model_id, n, m, n_consts, n_params)) return 4;
  if (is<LTI10x3>(model_id, n, m, n_consts, n_params)) return 5;
  return 0;
}

int launch_k3(int which, const FwdArgs& a) {
  switch (which) {
    case 1: return launch_forward<PendCart>(a);
    case 2: return launch_forward_lti_10_2(a);
    case 3: return launch_forward_quad_6_2(a);
    case 5: return launch_forward_lti_10_3(a);
    default: return launch_forward_pendcart_param(a);
  }
}

int launch_k2(int which, const FwdArgs& a) {
  switch (which) {
    case 1: return launch_linesearch<PendCart>(a);
    case 2: return launch_linesearch_lti_10_2(a);
    case 3: return launch_linesearch_quad_6_2(a);
    case 5: return launch_linesearch_lti_10_3(a);
    default: return launch_linesearch_pendcart_param(a);
  }
}

}  // namespace

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
  if (m < 1 || m > MAX_M) return ERR_ARGS;
  const int which = instance(model_id, n, m, n_consts, n_params);
  if (which == 0) return ERR_MODEL;
  FwdArgs a;
  const int rc = k3_args(traj, s_traj, gains, s_g, gk, gK, x0, alphas, A,
                         totals, terminal, out_traj, T, B, lims, lims_lanes,
                         params, n_params, n, m, consts, blocks, threads, tc,
                         stages, smem, stream, a);
  if (rc != 0) return rc;
  cudaSetDevice(device);
  return launch_k3(which, a);
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
  if (m < 1 || m > MAX_M) return ERR_ARGS;
  const int which = instance(model_id, n, m, n_consts, n_params);
  if (which == 0) return ERR_MODEL;
  FwdArgs a;
  const int rc = k2_args(traj, s_traj, gains, s_g, gk, gK, x0, sel, alphas,
                         A, rr_min, out_traj, ls, T, B, lims, lims_lanes,
                         params, n_params, n, m, consts, blocks, threads, tc,
                         stages, smem, stream, a);
  if (rc != 0) return rc;
  cudaSetDevice(device);
  return launch_k2(which, a);
}
