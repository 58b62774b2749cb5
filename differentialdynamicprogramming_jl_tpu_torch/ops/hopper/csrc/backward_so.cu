// K1's second-order (full DDP) instances at ⟨4,1⟩: the analytic PendCartSO
// (pendcart.cuh), the kernel behind pendcart_derivs_tiles_so on the card,
// and Autodiff<PendCart, true> (autodiff.cuh), behind
// autodiff_derivs_tiles(pendcart_lanes(spec), second_order=True). "gains"
// and "full" emission, no GPS mode; compiled apart so that nvcc builds the
// sources in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "pendcart.cuh"

namespace ddp {

int launch_backward_pendcart_so(const BwdArgs& a) {
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<PendCartSO, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<PendCartSO, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
}

int launch_backward_pendcart_ad_so(const BwdArgs& a) {
  using Model = Autodiff<PendCart, true>;
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
}

}  // namespace ddp
