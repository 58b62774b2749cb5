// The packed-derivatives stream as K1's model (common.cuh's interface):
// K1's ring carries the D+M slots of each step, the derivative stack in
// DerivLayout order (fx N·N, fu N·M, cx N, cu M, cxx N·N, cxu N·M, cuu M·M)
// then u, and the accessors read the expansion from the step's ring row.
//
// Device counterpart of the packed input of
//   differentialdynamicprogramming_jl_tpu/ops/pallas/backward_kernel.py
//   ::backward_lanes (derivs_tiles=None, :773-775; read_derivs :354-368)
// and of ops/hopper/backward_kernel.py::_packed_step, its plain version.
// The stream comes from a generator outside K1 (pendcart_packed_derivs,
// lti_packed_derivs, autodiff_packed_derivs, pack_backward_inputs), so no
// model enters the kernel: the instances are keyed by (N, M) alone.
//
// What bounds it: K1 reads D+M slots a step where the tiles' route reads
// N+M, 47 against 5 at ⟨4,1⟩, 110 against 8 at ⟨6,2⟩, 258 against 12 at
// ⟨10,2⟩, and forms no expansion. Its ring is planned with its own budget
// (plan.py::K1_PACKED_BUDGET): at ⟨10,2⟩ one step of 32 scenarios is 33 KB.
#pragma once

#include "ring.cuh"

namespace ddp {

template <int N_, int M_>
struct Packed {
  static constexpr int N = N_;
  static constexpr int M = M_;
  static constexpr int ID = 0;          // backward_kernel.py::PACKED_ID
  static constexpr int N_CONSTS = 0;
  static constexpr int N_PARAMS = 0;
  static constexpr bool PACKED = true;
  static constexpr bool SECOND_ORDER = false;
  // DerivLayout (pack.py)
  static constexpr int FX = 0, FU = N * N, CX = FU + N * M, CU = CX + N,
                       CXX = CU + M, CXU = CXX + N * N, CUU = CXU + N * M,
                       D = CUU + M * M;
  struct Consts {
    float c[1];
  };
  // the step's ring row, at this lane's column (slot stride RING_W)
  struct Derivs {
    const float* p;
  };

  __device__ __forceinline__ explicit Packed(const Consts&) {}

  __device__ __forceinline__ static float at(const Derivs& d, int s) {
    return d.p[s * RING_W];
  }
  __device__ __forceinline__ float fx(const Derivs& d, int i, int j) const {
    return at(d, FX + i * N + j);
  }
  __device__ __forceinline__ float fu(const Derivs& d, int i, int mi) const {
    return at(d, FU + i * M + mi);
  }
  __device__ __forceinline__ float cx(const Derivs& d, int i) const {
    return at(d, CX + i);
  }
  __device__ __forceinline__ float cu(const Derivs& d, int mi) const {
    return at(d, CU + mi);
  }
  __device__ __forceinline__ float cxx(const Derivs& d, int i, int j) const {
    return at(d, CXX + i * N + j);
  }
  __device__ __forceinline__ float cxu(const Derivs& d, int i, int mi) const {
    return at(d, CXU + i * M + mi);
  }
  __device__ __forceinline__ float cuu(const Derivs& d, int mi,
                                       int mj) const {
    return at(d, CUU + mi * M + mj);
  }
};

}  // namespace ddp
