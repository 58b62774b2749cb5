// K3 and K2 entry points: check the arguments, pick the model's instance,
// and launch it. The kernels are in forward.cuh; the pendcart ⟨4,1⟩
// instances are compiled here, the LTI ⟨10,2⟩ ones in forward_lti.cu and
// the quadrotor ⟨6,2⟩ ones in forward_quad.cu, so that nvcc builds them in
// parallel.
#include "forward.cuh"
#include "lti.cuh"
#include "pendcart.cuh"
#include "quadrotor.cuh"

using namespace ddp;

namespace {

using LTI10x2 = LTI<10, 2>;

bool stream_args_ok(const FwdArgs& a, int n, int m) {
  return a.T >= 1 && a.B >= 1 && a.s_traj >= n + m && a.gk >= 0 &&
         a.gK >= 0 && a.gk + m <= a.s_g && a.gK + m * n <= a.s_g &&
         a.A >= 1 && a.A <= MAX_A;
}

// which instance: 1 pendcart, 2 LTI ⟨10,2⟩, 3 quadrotor, 0 none
int instance(int model_id, int n, int m, int n_consts) {
  if (model_id == PendCart::ID && n == PendCart::N && m == PendCart::M &&
      n_consts == PendCart::N_CONSTS)
    return 1;
  if (model_id == LTI10x2::ID && n == LTI10x2::N && m == LTI10x2::M &&
      n_consts == LTI10x2::N_CONSTS)
    return 2;
  if (model_id == Quadrotor::ID && n == Quadrotor::N && m == Quadrotor::M &&
      n_consts == Quadrotor::N_CONSTS)
    return 3;
  return 0;
}

}  // namespace

extern "C" int ddp_forward_lanes(const float* traj, int s_traj,
                                 const float* gains, int s_g, int gk, int gK,
                                 const float* x0, const float* alphas, int A,
                                 float* totals, float* terminal,
                                 float* out_traj, int T, int B,
                                 const float* lims, int model_id, int n,
                                 int m, const float* consts, int n_consts,
                                 int device, void* stream) {
  const int which = instance(model_id, n, m, n_consts);
  if (which == 0) return ERR_MODEL;
  FwdArgs a{};
  a.traj = traj;
  a.s_traj = s_traj;
  a.gains = gains;
  a.s_g = s_g;
  a.gk = gk;
  a.gK = gK;
  a.x0 = x0;
  a.alphas = alphas;
  a.A = A;
  a.totals = totals;
  a.terminal = terminal;
  a.out = out_traj;
  a.T = T;
  a.B = B;
  a.lims = lims_from_host(lims, m);
  a.consts = consts;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!stream_args_ok(a, n, m)) return ERR_ARGS;
  cudaSetDevice(device);
  return which == 1   ? launch_forward<PendCart>(a)
         : which == 2 ? launch_forward_lti_10_2(a)
                      : launch_forward_quad_6_2(a);
}

extern "C" int ddp_linesearch_lanes(const float* traj, int s_traj,
                                    const float* gains, int s_g, int gk,
                                    int gK, const float* x0, const float* sel,
                                    const float* alphas, int A, float rr_min,
                                    float* out_traj, float* ls, int T, int B,
                                    const float* lims, int model_id, int n,
                                    int m, const float* consts, int n_consts,
                                    int device, void* stream) {
  const int which = instance(model_id, n, m, n_consts);
  if (which == 0) return ERR_MODEL;
  FwdArgs a{};
  a.traj = traj;
  a.s_traj = s_traj;
  a.gains = gains;
  a.s_g = s_g;
  a.gk = gk;
  a.gK = gK;
  a.x0 = x0;
  a.sel = sel;
  a.A = A;
  for (int i = 0; i < MAX_A; ++i) a.ladder.a[i] = i < A ? alphas[i] : 0.0f;
  a.rr_min = rr_min;
  a.out = out_traj;
  a.ls = ls;
  a.T = T;
  a.B = B;
  a.lims = lims_from_host(lims, m);
  a.consts = consts;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!stream_args_ok(a, n, m)) return ERR_ARGS;
  cudaSetDevice(device);
  return which == 1   ? launch_linesearch<PendCart>(a)
         : which == 2 ? launch_linesearch_lti_10_2(a)
                      : launch_linesearch_quad_6_2(a);
}
