// K1's LTI ⟨10,2⟩ instances without GPS mode, in each emission, compiled
// apart from backward.cu so that nvcc builds the sources in parallel.
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_10_2(const BwdArgs& a) {
  return launch_backward<LTI<10, 2>, false>(a);
}

}  // namespace ddp
