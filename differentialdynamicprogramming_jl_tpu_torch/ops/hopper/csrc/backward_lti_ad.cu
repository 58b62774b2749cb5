// K1's Autodiff<LTI<10, 2>> instances: the LTI expansion made by Dual and
// Jet passes over lti.cuh's templated dynamics and cost (autodiff.cuh,
// rolled), the kernel behind autodiff_derivs_tiles(lti_lanes(spec)) on the
// card. "gains" and "full" without GPS mode, "policy" in it; compiled apart
// so that nvcc builds the sources in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_ad_10_2(const BwdArgs& a) {
  return launch_entries<Autodiff<LTI<10, 2>>>(a);
}

}  // namespace ddp
