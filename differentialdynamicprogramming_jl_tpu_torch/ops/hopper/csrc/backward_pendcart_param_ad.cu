// K1's Autodiff<PendCartParam> ⟨4,1⟩ instances: the heterogeneous fleet's
// expansion by autodiff of PendCartParam's dynamics and cost, each
// scenario's [l, d] a constant of the passes (autodiff.cuh), first order
// and, Autodiff<PendCartParam, true>, second order (full DDP). The kernels
// behind autodiff_derivs_tiles(pendcart_lanes_param(spec), ...) with
// params. "gains" and "full" without GPS mode (the KL entries take no
// params); compiled apart so that nvcc builds the sources in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "pendcart.cuh"

namespace ddp {

int launch_backward_pendcart_param_ad(const BwdArgs& a) {
  return launch_ilqg<Autodiff<PendCartParam>>(a);
}

int launch_backward_pendcart_param_ad_so(const BwdArgs& a) {
  return launch_ilqg<Autodiff<PendCartParam, true>>(a);
}

}  // namespace ddp
