// K1's packed-derivatives instances (packed.cuh) at ⟨4,1⟩ ("gains", "full",
// and "full" in GPS mode for backward_pass_pallas) and ⟨6,2⟩ ("gains",
// "full"); ⟨10,2⟩ is in backward_packed_lti.cu. Compiled apart so that nvcc
// builds the sources in parallel.
#include "backward.cuh"
#include "packed.cuh"

namespace ddp {

int launch_backward_packed_10_2(const BwdArgs& a);

int launch_backward_packed(const BwdArgs& a, int n, int m) {
  const bool gps = a.prev != nullptr;
  if (n == 4 && m == 1) {
    using Model = Packed<4, 1>;
    if (gps)
      return a.emit == EMIT_FULL ? launch_one<Model, EMIT_FULL, true>(a)
                                 : ERR_MODEL;
    switch (a.emit) {
      case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
      case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
      default: return ERR_MODEL;
    }
  }
  if (gps) return ERR_MODEL;
  if (n == 6 && m == 2) {
    using Model = Packed<6, 2>;
    switch (a.emit) {
      case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
      case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
      default: return ERR_MODEL;
    }
  }
  if (n == 10 && m == 2) return launch_backward_packed_10_2(a);
  return ERR_MODEL;
}

}  // namespace ddp
