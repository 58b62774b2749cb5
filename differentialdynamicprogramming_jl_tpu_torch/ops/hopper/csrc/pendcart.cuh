// Pendulum-on-a-cart model (n=4, m=1) for the backward, forward and
// line-search kernels, in the model interface of common.cuh.
//
// Device counterpart of models/pendcart.py::pendcart_lanes and
// ::pendcart_derivs_tiles (JAX: models/pendcart.py:161-195, :233-263): the
// Euler step of the reference dynamics (src/system_pendcart.jl:75-89), the
// diagonal quadratic cost with its terminal term (:92-106) and the analytic
// Jacobians of the Euler step. One thread evaluates one scenario.
// Autodiff<PendCart> (autodiff.cuh, instance in backward_pendcart_ad.cu)
// makes the same expansion by forward-mode autodiff of dynamics and cost,
// the counterpart of autodiff_derivs_tiles(pendcart_lanes(spec)).
//
// The model is read from a device-model descriptor, a flat f32 array
//   [g, l, h, d, Q0, Q1, Q2, Q3, R, goal0, goal1, goal2, goal3]
// passed by value as a kernel argument. Derived constants (-g/l, 1-h·d,
// Q/2, R/2) are formed here in f32, exactly as the plain PyTorch version
// forms them from the same descriptor. Every expression below keeps the
// operation order of that version; the library is built with --fmad=false,
// so no multiply-add is contracted.
//
// PendCartSO is the pendcart of full DDP: the same model with its two
// nonzero dynamics Hessian entries (instances in backward_so.cu).
//
// PendCartParam (model id 4) is the heterogeneous fleet's pendcart, the
// counterpart of models/pendcart.py::pendcart_lanes_param and
// ::pendcart_derivs_tiles_param (JAX: models/pendcart.py:295-359): the same
// descriptor, with l and d replaced per scenario by that scenario's
// params = [l, d]. It runs through PendCart's constructor, so -g/l and 1-h·d
// are formed per scenario in the same f32 order, and a fleet whose every
// row is the descriptor's (l, d) gives PendCart's results bit for bit.
#pragma once

#include "common.cuh"

namespace ddp {

struct PendCart {
  static constexpr int N = 4;
  static constexpr int M = 1;
  static constexpr int ID = 1;
  static constexpr int N_CONSTS = 13;
  static constexpr int N_PARAMS = 0;
  static constexpr bool PACKED = false;
  static constexpr bool SECOND_ORDER = false;
  static constexpr bool HAS_DIFF = false;
  struct Consts {
    float c[N_CONSTS];
  };

  float l, h, d, ngl, hd1, R, halfR;
  float Q[4], halfQ[4], goal[4];

  __device__ __forceinline__ explicit PendCart(const Consts& mc)
      : PendCart(mc, mc.c[1], mc.c[3]) {}

  // the descriptor's constants with pole length l_ and damping d_
  __device__ __forceinline__ PendCart(const Consts& mc, float l_, float d_) {
    const float g = mc.c[0];
    l = l_;
    h = mc.c[2];
    d = d_;
    ngl = -g / l;
    hd1 = 1.0f - h * d;
    R = mc.c[8];
    halfR = 0.5f * R;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Q[i] = mc.c[4 + i];
      halfQ[i] = 0.5f * Q[i];
      goal[i] = mc.c[9 + i];
    }
  }

  // Euler step: θ̈ = -g/l·sinθ + f/l·cosθ - d·θ̇. dynamics, cost and
  // terminal are templates over the scalar type: float for the kernels,
  // Dual and Jet (autodiff.cuh) for Autodiff<PendCart>
  template <class S>
  __device__ __forceinline__ void dynamics(const S (&x)[4], const S (&u)[1],
                                           int, S (&xn)[4]) const {
    const S f = u[0];
    const S thdd = ngl * sinf(x[0]) + (f / l) * cosf(x[0]) - d * x[1];
    xn[0] = x[0] + h * x[1];
    xn[1] = x[1] + h * thdd;
    xn[2] = x[2] + h * x[3];
    xn[3] = x[3] + h * f;
  }

  template <class S>
  __device__ __forceinline__ S cost(const S (&x)[4], const S (&u)[1],
                                     int) const {
    S c = halfR * u[0] * u[0];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const S dx = x[i] - goal[i];
      c = c + halfQ[i] * dx * dx;
    }
    return c;
  }

  template <class S>
  __device__ __forceinline__ S terminal(const S (&x)[4]) const {
    S dx = x[0] - goal[0];
    S c = halfQ[0] * dx * dx;
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      dx = x[i] - goal[i];
      c = c + halfQ[i] * dx * dx;
    }
    return c;
  }

  // first-order expansion at (x, u): the Jacobians of the Euler step and
  // the cost derivatives; fu, cxu are the m=1 columns
  struct Derivs {
    float fx[4][4], fu[4], cx[4], cu, cxx[4][4], cxu[4], cuu;
  };

  __device__ __forceinline__ void derivs(const float (&x)[4],
                                         const float (&uu)[1], int,
                                         Derivs& dv) const {
    const float th = x[0];
    const float u = uu[0];
    const float a21 = h * (ngl * cosf(th) - (u / l) * sinf(th));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dv.fx[i][j] = 0.0f;
        dv.cxx[i][j] = (i == j) ? Q[i] : 0.0f;
      }
      dv.cx[i] = Q[i] * (x[i] - goal[i]);
      dv.cxu[i] = 0.0f;
    }
    dv.fx[0][0] = 1.0f;
    dv.fx[0][1] = h;
    dv.fx[1][0] = a21;
    dv.fx[1][1] = hd1;
    dv.fx[2][2] = 1.0f;
    dv.fx[2][3] = h;
    dv.fx[3][3] = 1.0f;
    dv.fu[0] = 0.0f;
    dv.fu[1] = h * cosf(th) / l;
    dv.fu[2] = 0.0f;
    dv.fu[3] = h;
    dv.cu = R * u;
    dv.cuu = R;
  }

  __device__ __forceinline__ float fx(const Derivs& d, int i, int j) const {
    return d.fx[i][j];
  }
  __device__ __forceinline__ float fu(const Derivs& d, int i, int) const {
    return d.fu[i];
  }
  __device__ __forceinline__ float cx(const Derivs& d, int i) const {
    return d.cx[i];
  }
  __device__ __forceinline__ float cu(const Derivs& d, int) const {
    return d.cu;
  }
  __device__ __forceinline__ float cxx(const Derivs& d, int i, int j) const {
    return d.cxx[i][j];
  }
  __device__ __forceinline__ float cxu(const Derivs& d, int i, int) const {
    return d.cxu[i];
  }
  __device__ __forceinline__ float cuu(const Derivs& d, int, int) const {
    return d.cuu;
  }
};

// Full DDP with the analytic expansion (models/pendcart.py::
// pendcart_derivs_tiles_so; JAX models/pendcart.py:267-290): only f₁ =
// θ̇ + h·θ̈ is nonlinear, with ∂²f₁/∂θ² = h·(g/l·sinθ − u/l·cosθ) and
// ∂²f₁/∂θ∂u = −(h/l)·sinθ; every other Hessian entry is 0. The
// contraction Σ_a Vx[a]·H_a[i][j] multiplies the zeros too, as the plain
// version's zero tensors do: nvcc folds no 0·x, so a NaN or Inf in Vx
// propagates alike.
struct PendCartSO : PendCart {
  static constexpr bool SECOND_ORDER = true;
  struct Derivs : PendCart::Derivs {
    float vh[5][5];
  };

  __device__ __forceinline__ explicit PendCartSO(const Consts& mc)
      : PendCart(mc) {}

  __device__ __forceinline__ void derivs_so(const float (&x)[4],
                                            const float (&uu)[1], int t,
                                            const float (&Vx)[4],
                                            Derivs& dv) const {
    derivs(x, uu, t, dv);
    const float s = sinf(x[0]);
    const float d2_thth = h * ((-ngl) * s - (uu[0] / l) * cosf(x[0]));
    const float d2_thu = (-(h / l)) * s;
    // H_a[i][j] over z = (θ, θ̇, p, ṗ, u)
    auto H = [&](int a, int i, int j) {
      return a != 1 ? 0.0f
             : (i == 0 && j == 0)                        ? d2_thth
             : ((i == 0 && j == 4) || (i == 4 && j == 0)) ? d2_thu
                                                          : 0.0f;
    };
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        float v = Vx[0] * H(0, i, j);
#pragma unroll
        for (int a = 1; a < 4; ++a) v = v + Vx[a] * H(a, i, j);
        dv.vh[i][j] = v;
      }
    }
  }

  __device__ __forceinline__ float vh(const Derivs& d, int i, int j) const {
    return d.vh[i][j];
  }
};

// per-scenario params = [l, d] (N_PARAMS = 2), everything else from the
// descriptor
struct PendCartParam : PendCart {
  static constexpr int ID = 4;
  static constexpr int N_PARAMS = 2;

  __device__ __forceinline__ PendCartParam(const Consts& mc,
                                           const float (&par)[2])
      : PendCart(mc, par[0], par[1]) {}
};

}  // namespace ddp
