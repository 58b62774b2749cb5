// K3's and K2's PendCartParam ⟨4,1⟩ instances (per-scenario pole length and
// damping, pendcart.cuh), compiled apart from forward.cu so that nvcc builds
// the sources in parallel.
#include "forward.cuh"
#include "pendcart.cuh"

namespace ddp {

int launch_forward_pendcart_param(const FwdArgs& a) {
  return launch_forward<PendCartParam>(a);
}

int launch_linesearch_pendcart_param(const FwdArgs& a) {
  return launch_linesearch<PendCartParam>(a);
}

}  // namespace ddp
