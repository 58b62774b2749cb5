// K1's packed-derivatives instance at ⟨10,2⟩ (packed.cuh), the LTI fleet's
// size, in "gains" and "full" emission without GPS mode; "full" runs four
// compute warps (K1_WARPS). Compiled apart so that nvcc builds the sources
// in parallel.
#include "backward.cuh"
#include "packed.cuh"

namespace ddp {

int launch_backward_packed_10_2(const BwdArgs& a) {
  using Model = Packed<10, 2>;
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
}

}  // namespace ddp
