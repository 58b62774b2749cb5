// K1's LTI ⟨10,2⟩ instance ("gains" and "full" emission), compiled apart
// from backward.cu so that nvcc builds the two in parallel.
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_10_2(const BwdArgs& a) {
  return launch_backward<LTI<10, 2>>(a);
}

}  // namespace ddp
