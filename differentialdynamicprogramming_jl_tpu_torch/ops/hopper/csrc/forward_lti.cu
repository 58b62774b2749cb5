// K3's and K2's LTI ⟨10,2⟩ instances, compiled apart from forward.cu so
// that nvcc builds the two in parallel.
#include "forward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_forward_lti_10_2(const FwdArgs& a) {
  return launch_forward<LTI<10, 2>>(a);
}

int launch_linesearch_lti_10_2(const FwdArgs& a) {
  return launch_linesearch<LTI<10, 2>>(a);
}

}  // namespace ddp
