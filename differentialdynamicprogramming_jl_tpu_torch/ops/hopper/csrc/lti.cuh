// Linear time-invariant model x' = A·x + B·u, cost ½x'Qx + ½u'Ru, no
// terminal term, in the model interface of common.cuh.
//
// Device counterpart of models/linear.py::lti_lanes and ::lti_derivs_tiles
// (JAX: models/linear.py:79-121, :160-197; reference demo_linear,
// src/demo_linear.jl:9-49). The descriptor is the flat f32 array
//   [A (N·N), B (N·M), Q (N·N), R (M·M)], row-major,
// 224 floats at N=10, M=2, passed by value as a kernel argument. The
// methods read it in place: every index is a compile-time constant of an
// unrolled loop, so each read is a uniform operand from the parameter bank,
// and the constant Jacobians fx = A, fu = B, cxx = Q, cuu = R cost no
// per-thread registers.
//
// The zero-skipping rule of the JAX lane functions is kept: a term whose
// constant is exactly 0 is left out, each sum starts at its first non-zero
// term, and ½·Q[i,j] is formed before it multiplies x[i]·x[j]. The test
// on a constant is uniform across the warp. A dense sum would differ where
// 0·Inf gives NaN and in the sign of a zero.
//
// Autodiff<LTI<N, M>> (autodiff.cuh; instances in backward_lti_ad*.cu) is
// the kernel behind autodiff_derivs_tiles(lti_lanes(spec)): K1's expansion
// by Dual and Jet passes over the same templated dynamics and cost, the
// zero-skipping rule applied to the tangents as torch.func applies it to
// the lane functions. Its passes run in a rolled loop (AD_ROLLED): at
// ⟨10,2⟩ unrolled they would be 78 Jet passes of a 104-term cost.
#pragma once

#include "common.cuh"

namespace ddp {

template <int N_, int M_>
struct LTI {
  static constexpr int N = N_;
  static constexpr int M = M_;
  static constexpr int ID = 2;
  static constexpr int OA = 0, OB = N * N, OQ = OB + N * M, OR = OQ + N * N;
  static constexpr int N_CONSTS = OR + M * M;
  static constexpr int N_PARAMS = 0;
  static constexpr bool PACKED = false;
  static constexpr bool SECOND_ORDER = false;
  static constexpr bool HAS_DIFF = false;
  static constexpr bool AD_ROLLED = true;   // Autodiff<LTI>: rolled passes
  struct Consts {
    float c[N_CONSTS];
  };

  const Consts& k;

  __device__ __forceinline__ explicit LTI(const Consts& mc) : k(mc) {}

  __device__ __forceinline__ float A(int i, int j) const {
    return k.c[OA + i * N + j];
  }
  __device__ __forceinline__ float Bm(int i, int j) const {
    return k.c[OB + i * M + j];
  }
  __device__ __forceinline__ float Q(int i, int j) const {
    return k.c[OQ + i * N + j];
  }
  __device__ __forceinline__ float R(int i, int j) const {
    return k.c[OR + i * M + j];
  }

  // s = first term, then s + term, over the terms whose constant is not 0
  template <class S>
  __device__ __forceinline__ static void acc(S& s, bool& any, float c,
                                             const S& v) {
    if (c != 0.0f) {
      const S t = c * v;
      s = any ? s + t : t;
      any = true;
    }
  }

  // dynamics, cost and terminal are templates over the scalar type: float
  // for K2, K3 and nothing else, Dual and Jet (autodiff.cuh) for
  // Autodiff<LTI>, whose passes apply the same zero-skipping rule to the
  // tangents (S{} is 0 with zero tangents)
  template <class S>
  __device__ __forceinline__ void dynamics(const S (&x)[N], const S (&u)[M],
                                           int, S (&xn)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      S s{};
      bool any = false;
#pragma unroll
      for (int j = 0; j < N; ++j) acc(s, any, A(i, j), x[j]);
#pragma unroll
      for (int j = 0; j < M; ++j) acc(s, any, Bm(i, j), u[j]);
      xn[i] = any ? s : S{};
    }
  }

  template <class S>
  __device__ __forceinline__ S cost(const S (&x)[N], const S (&u)[M],
                                    int) const {
    S c{};
    bool any = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float q = Q(i, j);
        if (q != 0.0f) {
          const S t = 0.5f * q * x[i] * x[j];
          c = any ? c + t : t;
          any = true;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float r = R(i, j);
        if (r != 0.0f) {
          const S t = 0.5f * r * u[i] * u[j];
          c = any ? c + t : t;
          any = true;
        }
      }
    }
    return c;
  }

  template <class S>
  __device__ __forceinline__ S terminal(const S (&)[N]) const {
    return S{};
  }

  // what the expansion at (x, u) holds beyond constants: cx = Q·x, cu = R·u
  struct Derivs {
    float cx[N], cu[M];
  };

  __device__ __forceinline__ void derivs(const float (&x)[N],
                                         const float (&u)[M], int,
                                         Derivs& d) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < N; ++j) acc(s, any, Q(i, j), x[j]);
      d.cx[i] = any ? s : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < M; ++j) acc(s, any, R(i, j), u[j]);
      d.cu[i] = any ? s : 0.0f;
    }
  }

  __device__ __forceinline__ float fx(const Derivs&, int i, int j) const {
    return A(i, j);
  }
  __device__ __forceinline__ float fu(const Derivs&, int i, int mi) const {
    return Bm(i, mi);
  }
  __device__ __forceinline__ float cx(const Derivs& d, int i) const {
    return d.cx[i];
  }
  __device__ __forceinline__ float cu(const Derivs& d, int mi) const {
    return d.cu[mi];
  }
  __device__ __forceinline__ float cxx(const Derivs&, int i, int j) const {
    return Q(i, j);
  }
  __device__ __forceinline__ float cxu(const Derivs&, int, int) const {
    return 0.0f;
  }
  __device__ __forceinline__ float cuu(const Derivs&, int mi, int mj) const {
    return R(mi, mj);
  }
};

}  // namespace ddp
