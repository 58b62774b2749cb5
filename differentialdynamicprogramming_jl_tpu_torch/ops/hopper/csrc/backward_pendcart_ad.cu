// K1's Autodiff<PendCart> ⟨4,1⟩ instance: the pendcart expansion made by
// forward-mode autodiff of its dynamics and cost (autodiff.cuh) instead of
// its analytic derivatives, the kernel behind
// autodiff_derivs_tiles(pendcart_lanes(spec)) on the card and the one
// check of autodiff.cuh against an analytic expansion. "gains" and "full"
// emission, no GPS mode; compiled apart so that nvcc builds it in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "pendcart.cuh"

namespace ddp {

int launch_backward_pendcart_ad(const BwdArgs& a) {
  using Model = Autodiff<PendCart>;
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
}

}  // namespace ddp
