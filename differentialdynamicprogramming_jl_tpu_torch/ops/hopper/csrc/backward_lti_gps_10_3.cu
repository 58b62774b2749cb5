// K1's LTI ⟨10,3⟩ instances in GPS mode, in each emission ("policy" is the
// one the KL/GPS loop launches; without limits, the unrolled 3×3 Cholesky
// solve), compiled apart from the other sources so that nvcc builds them
// in parallel.
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_gps_10_3(const BwdArgs& a) {
  return launch_backward<LTI<10, 3>, true>(a);
}

}  // namespace ddp
