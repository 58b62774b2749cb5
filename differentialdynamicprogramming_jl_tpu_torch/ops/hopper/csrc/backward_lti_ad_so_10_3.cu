// K1's second-order Autodiff<LTI<10, 3>, true> instances, as
// backward_lti_ad_so.cu's at m = 3: "gains" and "full" without GPS mode,
// "policy" in it; compiled apart so that nvcc builds the sources in
// parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_ad_so_10_3(const BwdArgs& a) {
  return launch_entries<Autodiff<LTI<10, 3>, true>>(a);
}

}  // namespace ddp
