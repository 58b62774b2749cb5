// K3's and K2's quadrotor ⟨6,2⟩ instances, compiled apart from forward.cu
// so that nvcc builds the sources in parallel.
#include "forward.cuh"
#include "quadrotor.cuh"

namespace ddp {

int launch_forward_quad_6_2(const FwdArgs& a) {
  return launch_forward<Quadrotor>(a);
}

int launch_linesearch_quad_6_2(const FwdArgs& a) {
  return launch_linesearch<Quadrotor>(a);
}

}  // namespace ddp
