// K1's PendCartParam ⟨4,1⟩ instances (per-scenario pole length and
// damping, pendcart.cuh) in "gains" and "full" emission without GPS mode,
// for the heterogeneous fleet's iLQG and MPC paths. Compiled apart from
// backward.cu so that nvcc builds the sources in parallel.
#include "backward.cuh"
#include "pendcart.cuh"

namespace ddp {

int launch_backward_pendcart_param(const BwdArgs& a) {
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<PendCartParam, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<PendCartParam, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
}

}  // namespace ddp
