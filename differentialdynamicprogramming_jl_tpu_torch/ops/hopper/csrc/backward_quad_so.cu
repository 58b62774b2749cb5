// K1's second-order (full DDP) quadrotor ⟨6,2⟩ instance,
// Autodiff<Quadrotor, true>: the Jet passes run over dynamics and cost, and
// each pass's six second tangents are contracted with V′x at once
// (autodiff.cuh). The kernel behind
// autodiff_derivs_tiles(quadrotor_lanes(spec), second_order=True). "gains"
// and "full" emission, no GPS mode; compiled apart so that nvcc builds the
// sources in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "quadrotor.cuh"

namespace ddp {

int launch_backward_quad_so(const BwdArgs& a) {
  using Model = Autodiff<Quadrotor, true>;
  switch (a.emit) {
    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);
    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);
    default: return ERR_MODEL;
  }
}

}  // namespace ddp
