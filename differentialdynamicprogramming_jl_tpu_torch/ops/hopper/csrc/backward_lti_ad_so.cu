// K1's second-order (full DDP) Autodiff<LTI<10, 2>, true> instances: each
// Jet pass also runs the dynamics, its second tangents (zeros: the LTI is
// linear) contracted with V′x at once. The kernel behind
// autodiff_derivs_tiles(lti_lanes(spec), second_order=True). "gains" and
// "full" without GPS mode, "policy" in it; compiled apart so that nvcc
// builds the sources in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "lti.cuh"

namespace ddp {

int launch_backward_lti_ad_so_10_2(const BwdArgs& a) {
  return launch_entries<Autodiff<LTI<10, 2>, true>>(a);
}

}  // namespace ddp
