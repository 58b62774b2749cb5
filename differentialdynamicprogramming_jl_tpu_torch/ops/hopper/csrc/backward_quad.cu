// K1's quadrotor ⟨6,2⟩ instances, Autodiff<Quadrotor>: the derivative
// expansion is made in the kernel by forward-mode autodiff of the model's
// dynamics and cost (autodiff.cuh). "gains" and "full" emission without
// GPS mode (the iLQG fleet), "full" and "policy" in GPS mode (KL on the
// quadrotor; the reference a lowered quadrotor, lowered.cuh, is held to
// bit for bit). Compiled apart from backward.cu so that nvcc builds the
// sources in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "quadrotor.cuh"

namespace ddp {

int launch_backward_quad_6_2(const BwdArgs& a) {
  using Model = Autodiff<Quadrotor>;
  if (a.prev != nullptr) {
    switch (a.emit) {
      case EMIT_FULL: return launch_one<Model, EMIT_FULL, true>(a);
      case EMIT_POLICY: return launch_one<Model, EMIT_POLICY, true>(a);
      default: return ERR_MODEL;
    }
  }
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
}

}  // namespace ddp
