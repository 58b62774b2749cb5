// K1's second-order Autodiff<Quadrotor, true> ⟨6,2⟩ instance in GPS
// "policy" emission: full DDP inside the KL entries on the quadrotor
// (autodiff_derivs_tiles(quadrotor_lanes(spec), second_order=True));
// compiled apart so that nvcc builds the sources in parallel.
#include "autodiff.cuh"
#include "backward.cuh"
#include "quadrotor.cuh"

namespace ddp {

int launch_backward_quad_so_gps(const BwdArgs& a) {
  return launch_gps_policy<Autodiff<Quadrotor, true>>(a);
}

}  // namespace ddp
