// Planar quadrotor (n=6, m=2) for the forward and line-search kernels, and
// through Autodiff<Quadrotor> (autodiff.cuh) for the backward kernel, in
// the model interface of common.cuh.
//
// Device counterpart of models/quadrotor.py::quadrotor_lanes (JAX:
// models/quadrotor.py:57-111): the Euler step of the planar birotor
//   v̇x = -(u₁+u₂)·sinθ/mass, v̇z = (u₁+u₂)·cosθ/mass − g,
//   ω̇ = arm·(u₁−u₂)/inertia,
// the diagonal quadratic cost to the hover goal with the controls penalised
// around u_hover, and the terminal state cost. There is no hand-written
// Jacobian: K1 differentiates dynamics and cost, written once as templates
// over the scalar type, by forward-mode autodiff.
//
// The descriptor is the flat f32 array
//   [mass, inertia, arm, g, h, u_hover, Q0..Q5, R, goal0..goal5]
// passed by value. ½·Q and ½·R are formed here in f32, equal to the plain
// version's f32(0.5·Q) because halving is exact. Every expression keeps the
// operation order of the JAX and PyTorch lane functions; the library is
// built with --fmad=false.
#pragma once

#include "common.cuh"

namespace ddp {

struct Quadrotor {
  static constexpr int N = 6;
  static constexpr int M = 2;
  static constexpr int ID = 3;
  static constexpr int N_CONSTS = 19;
  static constexpr int N_PARAMS = 0;
  static constexpr bool HAS_DIFF = false;
  struct Consts {
    float c[N_CONSTS];
  };

  float mass, inertia, arm, g, h, u_hover, halfR;
  float halfQ[6], goal[6];

  __device__ __forceinline__ explicit Quadrotor(const Consts& mc) {
    mass = mc.c[0];
    inertia = mc.c[1];
    arm = mc.c[2];
    g = mc.c[3];
    h = mc.c[4];
    u_hover = mc.c[5];
    halfR = 0.5f * mc.c[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      halfQ[i] = 0.5f * mc.c[6 + i];
      goal[i] = mc.c[13 + i];
    }
  }

  template <class S>
  __device__ __forceinline__ void dynamics(const S (&x)[6], const S (&u)[2],
                                           int, S (&xn)[6]) const {
    const S thrust = u[0] + u[1];
    const S s = sinf(x[4]);
    const S c = cosf(x[4]);
    const S ax = -thrust * s / mass;
    const S az = thrust * c / mass - g;
    const S al = arm * (u[0] - u[1]) / inertia;
    xn[0] = x[0] + h * x[1];
    xn[1] = x[1] + h * ax;
    xn[2] = x[2] + h * x[3];
    xn[3] = x[3] + h * az;
    xn[4] = x[4] + h * x[5];
    xn[5] = x[5] + h * al;
  }

  template <class S>
  __device__ __forceinline__ S terminal(const S (&x)[6]) const {
    S dx = x[0] - goal[0];
    S c = halfQ[0] * dx * dx;
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      dx = x[i] - goal[i];
      c = c + halfQ[i] * dx * dx;
    }
    return c;
  }

  template <class S>
  __device__ __forceinline__ S cost(const S (&x)[6], const S (&u)[2],
                                     int) const {
    S c = terminal(x);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const S du = u[j] - u_hover;
      c = c + halfR * du * du;
    }
    return c;
  }
};

}  // namespace ddp
