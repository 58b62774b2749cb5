// K1's LTI ⟨10,2⟩ instances in GPS mode, in each emission ("policy" is the
// one the KL/GPS loop launches), compiled apart from backward.cu and
// backward_lti.cu so that nvcc builds the sources in parallel.
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_gps_10_2(const BwdArgs& a) {
  return launch_backward<LTI<10, 2>, true>(a);
}

}  // namespace ddp
