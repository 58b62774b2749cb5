// K1's Autodiff<LTI<10, 3>> instances (the m > 2 box QP with limits), as
// backward_lti_ad.cu's at m = 3: "gains" and "full" without GPS mode,
// "policy" in it; compiled apart so that nvcc builds the sources in
// parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_ad_10_3(const BwdArgs& a) {
  return launch_entries<Autodiff<LTI<10, 3>>>(a);
}

}  // namespace ddp
