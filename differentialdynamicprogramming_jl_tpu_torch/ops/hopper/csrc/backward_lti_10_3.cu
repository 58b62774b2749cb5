// K1's LTI ⟨10,3⟩ instances without GPS mode, in each emission, compiled
// apart from backward.cu so that nvcc builds the sources in parallel. With
// limits they run the m > 2 masked projected-Newton box QP (backward.cuh
// boxqp_masked).
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_10_3(const BwdArgs& a) {
  return launch_backward<LTI<10, 3>, false>(a);
}

}  // namespace ddp
