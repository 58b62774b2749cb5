// K1's pendcart ⟨4,1⟩ instances in GPS "policy" emission, the KL entries'
// mode, for the derivative sources beyond the analytic tiles:
// Autodiff<PendCart> (autodiff_derivs_tiles(pendcart_lanes(spec))),
// Autodiff<PendCart, true> (the same with second_order=True) and the
// analytic full-DDP PendCartSO (pendcart_derivs_tiles_so); compiled apart so
// that nvcc builds the sources in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "pendcart.cuh"

namespace ddp {

int launch_backward_pendcart_ad_gps(const BwdArgs& a) {
  return launch_gps_policy<Autodiff<PendCart>>(a);
}

int launch_backward_pendcart_ad_so_gps(const BwdArgs& a) {
  return launch_gps_policy<Autodiff<PendCart, true>>(a);
}

int launch_backward_pendcart_so_gps(const BwdArgs& a) {
  return launch_gps_policy<PendCartSO>(a);
}

}  // namespace ddp
