// K3's and K2's LTI ⟨10,3⟩ instances, compiled apart from forward.cu so
// that nvcc builds the sources in parallel.
#include "forward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_forward_lti_10_3(const FwdArgs& a) {
  return launch_forward<LTI<10, 3>>(a);
}

int launch_linesearch_lti_10_3(const FwdArgs& a) {
  return launch_linesearch<LTI<10, 3>>(a);
}

}  // namespace ddp
