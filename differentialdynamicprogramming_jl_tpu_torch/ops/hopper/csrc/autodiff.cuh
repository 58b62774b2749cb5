// Forward-mode autodiff in registers: K1's derivative expansion for any
// model whose dynamics and cost are templates over the scalar type.
//
// Device counterpart of
//   differentialdynamicprogramming_jl_tpu/ops/pallas/autodiff_tiles.py
//   ::autodiff_derivs_tiles
// and of ops/hopper/autodiff_tiles.py, its plain PyTorch version. The JAX
// function differentiates the model with jax.jvp at trace time, so the TPU
// kernel streams only the trajectory. Here C++ templates do the same at
// compile time: the model's own functions, instantiated on Dual and Jet,
// are the tangent program, unrolled into K1's step.
//
// - Dual: a value and one tangent. One pass per input direction (n+m
//   passes over dynamics and cost) gives a column of fx/fu and an entry of
//   cx/cu.
// - Jet: a value, the tangents along two directions (a, the inner one, and
//   b, the outer one) and the mixed second tangent ab. One pass of the cost
//   per direction pair i ≤ j ((n+m)(n+m+1)/2 passes) gives the Hessian
//   entry, mirrored. For full DDP (Autodiff<Body, true>) each pair's pass
//   runs the dynamics too, and its n second tangents are contracted with
//   V′ (Vx of t+1) at once, Σ_a Vx[a]·∂²f_a from a = 0: the (n, n+m, n+m)
//   dynamics Hessian (312 floats at ⟨6,2⟩) is never held, only its
//   contraction's upper triangle (36 floats).
// One direction at a time, as the JAX function does: the registers hold one
// jet per input, not a dense gradient per value. Every tangent is a unit
// vector with its zeros; nvcc folds no 0·x (x may be Inf or NaN), so the
// zero-tangent products are real work.
//
// Each rule is the one PyTorch's forward-mode autodiff applies, but for
// abs, the clamps, maximum and minimum, which take JAX's (below)
// (torchgen derivatives.yaml: mul `other_t*self_p + self_t*other_p`, div
// `(self_t - other_t*result)/other_p`, sin `self_t*cos(self_p)`, cos
// `self_t*-sin(self_p)`, tanh `tanh_backward(self_t, result)` =
// `self_t*(1 - result*result)`, exp `self_t*result`, sqrt
// `self_t/(2*result)`), and for Jet that rule differentiated once more
// along b in the same order (tanh_backward's own rule for tanh), so the
// plain version (torch.func.jvp, nested) and the kernel form the same
// products. Two-term sums commute in IEEE arithmetic; longer sums keep
// PyTorch's grouping.
//
// The boundary step t = T-1 differentiates the running cost, as
// autodiff_tiles.py:27-31 says.
#pragma once

#include "common.cuh"

namespace ddp {

// the float functions stay visible beside the overloads below, so that a
// model's template finds both for S = float
using ::cosf;
using ::expf;
using ::fabsf;
using ::logf;
using ::sinf;
using ::sqrtf;
using ::tanhf;

struct Dual {
  float v, t;
};

struct Jet {
  float v, a, b, ab;
};

// ---- Dual
__device__ __forceinline__ Dual operator+(Dual x, Dual y) {
  return {x.v + y.v, x.t + y.t};
}
__device__ __forceinline__ Dual operator+(Dual x, float c) {
  return {x.v + c, x.t};
}
__device__ __forceinline__ Dual operator+(float c, Dual y) {
  return {c + y.v, y.t};
}
__device__ __forceinline__ Dual operator-(Dual x) { return {-x.v, -x.t}; }
__device__ __forceinline__ Dual operator-(Dual x, Dual y) {
  return {x.v - y.v, x.t - y.t};
}
__device__ __forceinline__ Dual operator-(Dual x, float c) {
  return {x.v - c, x.t};
}
__device__ __forceinline__ Dual operator-(float c, Dual y) {
  return {c - y.v, -y.t};
}
__device__ __forceinline__ Dual operator*(Dual x, Dual y) {
  return {x.v * y.v, y.t * x.v + x.t * y.v};
}
__device__ __forceinline__ Dual operator*(Dual x, float c) {
  return {x.v * c, x.t * c};
}
__device__ __forceinline__ Dual operator*(float c, Dual y) {
  return {c * y.v, y.t * c};
}
__device__ __forceinline__ Dual operator/(Dual x, Dual y) {
  const float q = x.v / y.v;
  return {q, (x.t - y.t * q) / y.v};
}
__device__ __forceinline__ Dual operator/(Dual x, float c) {
  return {x.v / c, x.t / c};
}
__device__ __forceinline__ Dual operator/(float c, Dual y) {
  return Dual{c, 0.0f} / y;
}
__device__ __forceinline__ Dual sinf(Dual x) {
  return {::sinf(x.v), x.t * ::cosf(x.v)};
}
__device__ __forceinline__ Dual cosf(Dual x) {
  return {::cosf(x.v), x.t * -::sinf(x.v)};
}
__device__ __forceinline__ Dual tanhf(Dual x) {
  const float y = ::tanhf(x.v);
  return {y, x.t * (1.0f - y * y)};
}
__device__ __forceinline__ Dual expf(Dual x) {
  const float y = ::expf(x.v);
  return {y, x.t * y};
}
__device__ __forceinline__ Dual sqrtf(Dual x) {
  const float y = ::sqrtf(x.v);
  return {y, x.t / (y * 2.0f)};
}

// ---- Jet: a along the inner direction, b along the outer one
__device__ __forceinline__ Jet operator+(Jet x, Jet y) {
  return {x.v + y.v, x.a + y.a, x.b + y.b, x.ab + y.ab};
}
__device__ __forceinline__ Jet operator+(Jet x, float c) {
  return {x.v + c, x.a, x.b, x.ab};
}
__device__ __forceinline__ Jet operator+(float c, Jet y) {
  return {c + y.v, y.a, y.b, y.ab};
}
__device__ __forceinline__ Jet operator-(Jet x) {
  return {-x.v, -x.a, -x.b, -x.ab};
}
__device__ __forceinline__ Jet operator-(Jet x, Jet y) {
  return {x.v - y.v, x.a - y.a, x.b - y.b, x.ab - y.ab};
}
__device__ __forceinline__ Jet operator-(Jet x, float c) {
  return {x.v - c, x.a, x.b, x.ab};
}
__device__ __forceinline__ Jet operator-(float c, Jet y) {
  return {c - y.v, -y.a, -y.b, -y.ab};
}
__device__ __forceinline__ Jet operator*(Jet x, Jet y) {
  // a = y.a·x.v + x.a·y.v, each product differentiated along b
  return {x.v * y.v, y.a * x.v + x.a * y.v, y.b * x.v + x.b * y.v,
          (x.b * y.a + y.ab * x.v) + (y.b * x.a + x.ab * y.v)};
}
__device__ __forceinline__ Jet operator*(Jet x, float c) {
  return {x.v * c, x.a * c, x.b * c, x.ab * c};
}
__device__ __forceinline__ Jet operator*(float c, Jet y) {
  return y * c;
}
__device__ __forceinline__ Jet operator/(Jet x, Jet y) {
  // q = x/y, qb its b tangent; a = (x.a - y.a·q)/y.v, differentiated along b
  const float q = x.v / y.v;
  const float qb = (x.b - y.b * q) / y.v;
  const float d = x.a - y.a * q;
  const float db = x.ab - (qb * y.a + y.ab * q);
  const float a = d / y.v;
  return {q, a, qb, (db - y.b * a) / y.v};
}
__device__ __forceinline__ Jet operator/(Jet x, float c) {
  return {x.v / c, x.a / c, x.b / c, x.ab / c};
}
__device__ __forceinline__ Jet operator/(float c, Jet y) {
  return Jet{c, 0.0f, 0.0f, 0.0f} / y;
}
__device__ __forceinline__ Jet sinf(Jet x) {
  const float s = ::sinf(x.v), c = ::cosf(x.v);
  return {s, x.a * c, x.b * c, (x.b * -s) * x.a + x.ab * c};
}
__device__ __forceinline__ Jet cosf(Jet x) {
  const float s = ::sinf(x.v), c = ::cosf(x.v);
  return {c, x.a * -s, x.b * -s, -(x.b * c) * x.a + x.ab * -s};
}
__device__ __forceinline__ Jet tanhf(Jet x) {
  // a = tanh_backward(x.a, y); along b, tanh_backward's rule:
  // tanh_backward(x.ab, y) + y_b·((y·-2)·x.a)
  const float y = ::tanhf(x.v);
  const float yb = x.b * (1.0f - y * y);
  return {y, x.a * (1.0f - y * y), yb,
          x.ab * (1.0f - y * y) + yb * ((y * -2.0f) * x.a)};
}
__device__ __forceinline__ Jet expf(Jet x) {
  // a = x.a·y; along b: y_b·x.a + x.ab·y
  const float y = ::expf(x.v);
  const float yb = x.b * y;
  return {y, x.a * y, yb, yb * x.a + x.ab * y};
}
__device__ __forceinline__ Jet sqrtf(Jet x) {
  // a = x.a/(2y); along b, the quotient rule with (2y)_b = y_b·2
  const float y = ::sqrtf(x.v);
  const float y2 = y * 2.0f;
  const float yb = x.b / y2;
  const float a = x.a / y2;
  return {y, a, yb, (x.ab - (yb * 2.0f) * a) / y2};
}

// ---- the NaN-keeping helpers of common.cuh on Dual and Jet: the value as
// there; the tangents of the operand taken, averaged at a tie (PyTorch's
// maximum/minimum rule), summed where a NaN makes the value a + b
template <class D>
__device__ __forceinline__ D pick_(D x, D y, bool take_x) {
  return take_x ? x : y;
}
__device__ __forceinline__ Dual tie_(Dual x, Dual y) {
  return {x.v, 0.5f * (x.t + y.t)};
}
__device__ __forceinline__ Jet tie_(Jet x, Jet y) {
  return {x.v, 0.5f * (x.a + y.a), 0.5f * (x.b + y.b), 0.5f * (x.ab + y.ab)};
}
template <class D>
__device__ __forceinline__ D maxp(D x, D y) {
  if (isnan(x.v) || isnan(y.v)) return x + y;
  return x.v == y.v ? tie_(x, y) : pick_(x, y, x.v > y.v);
}
template <class D>
__device__ __forceinline__ D minp(D x, D y) {
  if (isnan(x.v) || isnan(y.v)) return x + y;
  return x.v == y.v ? tie_(x, y) : pick_(x, y, x.v < y.v);
}
__device__ __forceinline__ Dual constant_(Dual, float c) {
  return {c, 0.0f};
}
__device__ __forceinline__ Jet constant_(Jet, float c) {
  return {c, 0.0f, 0.0f, 0.0f};
}
template <class D>
__device__ __forceinline__ D clipp(D x, float lo, float hi) {
  return minp(maxp(x, constant_(x, lo)), constant_(x, hi));
}
template <class D>
__device__ __forceinline__ D signp(D x) {   // derivative 0 almost everywhere
  return constant_(x, signp(x.v));
}

// ---- the rest of the lowering's op set (ops/hopper/lower.py OPS) at
// S = float, Dual and Jet. Each value is what PyTorch's CUDA kernel for the
// op computes, each tangent the op's forward-mode rule (derivatives.yaml),
// and each Jet that rule differentiated along b in the same order, as
// torch.func's nested jvp forms it, so that K1 and its plain version
// (autodiff_tiles.py) stay bit-equal. A constant operand (float) has no
// tangent: it enters the Dual/Jet forms as constant_.
//
// abs, the clamps, maximum and minimum take JAX's rules, as the JAX
// package's kernels differentiate a model (jax/_src/lax/lax.py), and so do
// their plain versions (ops/tie_rules.py): |x|' = select(x >= 0, 1, -1), 1
// at ±0 (PyTorch: sgn, 0 at 0); maximum/minimum tx·wx + ty·wy with the
// balanced weights of the result, ½ each at a tie; a clamp is
// minimum(maximum(x, lo), hi), (t·w1)·w2, ½ on a bound (PyTorch: 1).

// the value of a scalar: comparisons read it, never a tangent
__device__ __forceinline__ float val_(float x) { return x; }
__device__ __forceinline__ float val_(Dual x) { return x.v; }
__device__ __forceinline__ float val_(Jet x) { return x.v; }

// pow(x, e) for a constant exponent as PyTorch's pow.Tensor_Scalar forms
// it on a CUDA tensor: 0 fills 1, 1 copies; ½, -½ and -1 go to sqrt, rsqrt
// and the reciprocal; 2, 3 and -2 to x·x, x·x·x and 1/(x·x) (the quotient
// of two floats rounded once: in double then to float, or in float, alike);
// any other exponent to powf. The literal e folds every branch.
__device__ __forceinline__ float powc_(float x, float e, float = 0.0f,
                                       float = 0.0f) {
  if (e == 0.0f) return 1.0f;
  if (e == 1.0f) return x;
  if (e == 0.5f) return ::sqrtf(x);
#ifdef __CUDACC__
  if (e == -0.5f) return ::rsqrtf(x);
#else
  if (e == -0.5f) return 1.0f / ::sqrtf(x);   // a host build: PyTorch's CPU form
#endif
  if (e == -1.0f) return 1.0f / x;
  if (e == 2.0f) return x * x;
  if (e == 3.0f) return x * x * x;
  if (e == -2.0f) return 1.0f / (x * x);
  return ::powf(x, e);
}

// pow_backward: t·(e·x^(e-1)), exactly 0 for e = 0; e1 = e - 1 and
// e2 = e - 2 in double, then rounded, as the rule's Scalar arithmetic
__device__ __forceinline__ Dual powc_(Dual x, float e, float e1, float) {
  if (e == 0.0f) return {1.0f, 0.0f};
  return {powc_(x.v, e), x.t * (powc_(x.v, e1) * e)};
}
__device__ __forceinline__ Jet powc_(Jet x, float e, float e1, float e2) {
  // q = x^(e1)·e; a = x.a·q; along b: q_b·x.a + x.ab·q, with
  // q_b = (x.b·(x^(e2)·e1))·e, exactly 0 for e1 = 0
  if (e == 0.0f) return {1.0f, 0.0f, 0.0f, 0.0f};
  const float q = powc_(x.v, e1) * e;
  const float qb =
      (e1 == 0.0f ? 0.0f : x.b * (powc_(x.v, e2) * e1)) * e;
  return {powc_(x.v, e), x.a * q, x.b * q, qb * x.a + x.ab * q};
}

// abs: JAX's select(x >= 0, t, -t), along b the same select of x.ab
__device__ __forceinline__ Dual fabsf(Dual x) {
  const bool p = x.v >= 0.0f;
  return {::fabsf(x.v), p ? x.t : -x.t};
}
__device__ __forceinline__ Jet fabsf(Jet x) {
  const bool p = x.v >= 0.0f;
  return {::fabsf(x.v), p ? x.a : -x.a, p ? x.b : -x.b, p ? x.ab : -x.ab};
}

__device__ __forceinline__ Dual logf(Dual x) {
  return {::logf(x.v), x.t / x.v};
}
__device__ __forceinline__ Jet logf(Jet x) {
  // a = x.a/x.v; along b, the quotient rule (x.ab - x.b·a)/x.v
  const float a = x.a / x.v;
  return {::logf(x.v), a, x.b / x.v, (x.ab - x.b * a) / x.v};
}

// relu = clamp_min(x, 0); its rule threshold_backward(t, result, 0) keeps t
// where the result is above 0; along b, zeros_like(·) + threshold_backward
__device__ __forceinline__ float relu_(float x) {
  return isnan(x) ? x : ::fmaxf(x, 0.0f);
}
__device__ __forceinline__ Dual relu_(Dual x) {
  const float r = relu_(x.v);
  return {r, r <= 0.0f ? 0.0f : x.t};
}
__device__ __forceinline__ Jet relu_(Jet x) {
  const float r = relu_(x.v);
  const bool z = r <= 0.0f;
  return {r, z ? 0.0f : x.a, z ? 0.0f : x.b, 0.0f + (z ? 0.0f : x.ab)};
}

// maximum/minimum: NaN-keeping values
__device__ __forceinline__ float maximum_(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : ::fmaxf(a, b));
}
__device__ __forceinline__ float minimum_(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : ::fminf(a, b));
}

// JAX's _balanced_eq(x, z, y) of a chooser's result z: 1 where x is z and
// y is not, ½ where both are, 0 where x is not (a NaN is no one's)
__device__ __forceinline__ float balanced_(float x, float z, float y) {
  return (x == z ? 1.0f : 0.0f) / (y == z ? 2.0f : 1.0f);
}
// a tangent times a weight, each component
__device__ __forceinline__ Dual scale_(Dual x, float v, float w) {
  return {v, x.t * w};
}
__device__ __forceinline__ Jet scale_(Jet x, float v, float w) {
  return {v, x.a * w, x.b * w, x.ab * w};
}
// the chooser's tangent tx·wx + ty·wy, each component
__device__ __forceinline__ Dual weigh_(Dual x, Dual y, float v, float wx,
                                       float wy) {
  return {v, x.t * wx + y.t * wy};
}
__device__ __forceinline__ Jet weigh_(Jet x, Jet y, float v, float wx,
                                      float wy) {
  return {v, x.a * wx + y.a * wy, x.b * wx + y.b * wy,
          x.ab * wx + y.ab * wy};
}
template <class D>
__device__ __forceinline__ D maximum_(D x, D y) {
  const float z = maximum_(x.v, y.v);
  return weigh_(x, y, z, balanced_(x.v, z, y.v), balanced_(y.v, z, x.v));
}
template <class D>
__device__ __forceinline__ D minimum_(D x, D y) {
  const float z = minimum_(x.v, y.v);
  return weigh_(x, y, z, balanced_(x.v, z, y.v), balanced_(y.v, z, x.v));
}
template <class D>
__device__ __forceinline__ D maximum_(D x, float c) {
  return maximum_(x, constant_(x, c));
}
template <class D>
__device__ __forceinline__ D maximum_(float c, D y) {
  return maximum_(constant_(y, c), y);
}
template <class D>
__device__ __forceinline__ D minimum_(D x, float c) {
  return minimum_(x, constant_(x, c));
}
template <class D>
__device__ __forceinline__ D minimum_(float c, D y) {
  return minimum_(constant_(y, c), y);
}

// clamp with scalar bounds (either absent): NaN kept; the tangent is JAX's
// clip, minimum(maximum(x, lo), hi): t·w1 from the maximum, then ·w2 from
// the minimum, each a balanced weight (½ on a bound)
__device__ __forceinline__ float clamp_(float x, float lo, float hi) {
  return isnan(x) ? x : ::fminf(::fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min_(float x, float lo) {
  return isnan(x) ? x : ::fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max_(float x, float hi) {
  return isnan(x) ? x : ::fminf(x, hi);
}
template <class D>
__device__ __forceinline__ D clamp_(D x, float lo, float hi) {
  const float r = maximum_(x.v, lo);
  const D s = scale_(x, r, balanced_(x.v, r, lo));
  return scale_(s, clamp_(x.v, lo, hi),
                balanced_(r, minimum_(r, hi), hi));
}
template <class D>
__device__ __forceinline__ D clamp_min_(D x, float lo) {
  return scale_(x, clamp_min_(x.v, lo),
                balanced_(x.v, maximum_(x.v, lo), lo));
}
template <class D>
__device__ __forceinline__ D clamp_max_(D x, float hi) {
  return scale_(x, clamp_max_(x.v, hi),
                balanced_(x.v, minimum_(x.v, hi), hi));
}

// where(c, a, b): value and tangents from the chosen branch
__device__ __forceinline__ float where_(bool c, float a, float b) {
  return c ? a : b;
}
template <class D>
__device__ __forceinline__ D where_(bool c, D a, D b) {
  return c ? a : b;
}
template <class D>
__device__ __forceinline__ D where_(bool c, D a, float b) {
  return c ? a : constant_(a, b);
}
template <class D>
__device__ __forceinline__ D where_(bool c, float a, D b) {
  return c ? constant_(b, a) : b;
}

// Body::AD_ROLLED, false where the body does not set it: Autodiff<Body>
// then runs its passes in rolled loops over the directions (each pass's
// body unrolled, the expansion in the stack frame), where unrolled they
// would be too much code for nvcc (the LTI at ⟨10,2⟩: 78 Jet passes of a
// 104-term cost). The same operations either way, so the same bits.
template <class Body, class = void>
struct AdRolled {
  static constexpr bool value = false;
};
template <class Body>
struct AdRolled<Body, decltype(void(Body::AD_ROLLED))> {
  static constexpr bool value = Body::AD_ROLLED;
};

// K1's model interface (common.cuh) for a Body whose dynamics, cost and
// terminal are templates over the scalar type: the forward functions pass
// through at S = float, and derivs() makes the expansion by the passes
// above. The cost Hessian over (x, u) is held as its upper triangle, 36
// floats at ⟨6,2⟩ where cxx, cxu and cuu apart take 52. With SO (full
// DDP), derivs_so() also forms the V′-contraction of the dynamics
// Hessians, as its upper triangle.
template <class Body, bool SO = false>
struct Autodiff {
  static constexpr int N = Body::N;
  static constexpr int M = Body::M;
  static constexpr int ID = Body::ID;
  static constexpr int N_CONSTS = Body::N_CONSTS;
  static constexpr int N_PARAMS = Body::N_PARAMS;
  static constexpr bool PACKED = false;
  static constexpr bool SECOND_ORDER = SO;
  static constexpr int NM = N + M;
  static constexpr int NH = NM * (NM + 1) / 2;
  static constexpr bool ROLLED = AdRolled<Body>::value;
  using Consts = typename Body::Consts;

  Body body;

  __device__ __forceinline__ explicit Autodiff(const Consts& mc) : body(mc) {}
  // one scenario's parameters (make_model, common.cuh); constants of the
  // expansion, never differentiated, as JAX's tiles close over them
  template <int P>
  __device__ __forceinline__ Autodiff(const Consts& mc, const float (&par)[P])
      : body(mc, par) {}

  template <class S>
  __device__ __forceinline__ void dynamics(const S (&x)[N], const S (&u)[M],
                                           int t, S (&xn)[N]) const {
    body.dynamics(x, u, t, xn);
  }
  template <class S>
  __device__ __forceinline__ S cost(const S (&x)[N], const S (&u)[M],
                                    int t) const {
    return body.cost(x, u, t);
  }
  template <class S>
  __device__ __forceinline__ S terminal(const S (&x)[N]) const {
    return body.terminal(x);
  }

  struct Derivs {
    float fx[N][N], fu[N][M], cx[N], cu[M], H[NH];
    float HV[SO ? NH : 1];   // Σ_a Vx[a]·∂²f_a, upper triangle (SO)
  };

  // entry (i, j), i ≤ j, of the upper triangle, row by row
  __host__ __device__ static constexpr int hidx(int i, int j) {
    return i > j ? hidx(j, i) : i * NM - i * (i - 1) / 2 + (j - i);
  }

  // the Dual pass along input direction dir (x for dir < N, then u); the
  // step index t is a constant of every pass, without a tangent
  __device__ __forceinline__ Dual pass1(const float (&x)[N],
                                        const float (&u)[M], int t, int dir,
                                        Dual (&f)[N]) const {
    Dual xd[N], ud[M];
DDP_UNROLL
    for (int k = 0; k < N; ++k) xd[k] = Dual{x[k], k == dir ? 1.0f : 0.0f};
DDP_UNROLL
    for (int k = 0; k < M; ++k)
      ud[k] = Dual{u[k], N + k == dir ? 1.0f : 0.0f};
    body.dynamics(xd, ud, t, f);
    return body.cost(xd, ud, t);
  }

  // the Jet inputs along directions j (inner) and i (outer)
  __device__ __forceinline__ static void jets(const float (&x)[N],
                                              const float (&u)[M], int i,
                                              int j, Jet (&xj)[N],
                                              Jet (&uj)[M]) {
DDP_UNROLL
    for (int k = 0; k < N; ++k)
      xj[k] = Jet{x[k], k == j ? 1.0f : 0.0f, k == i ? 1.0f : 0.0f, 0.0f};
DDP_UNROLL
    for (int k = 0; k < M; ++k)
      uj[k] = Jet{u[k], N + k == j ? 1.0f : 0.0f, N + k == i ? 1.0f : 0.0f,
                  0.0f};
  }

  // the Jet pass of the cost along directions j (inner) and i (outer)
  __device__ __forceinline__ float pass2(const float (&x)[N],
                                         const float (&u)[M], int t, int i,
                                         int j) const {
    Jet xj[N], uj[M];
    jets(x, u, i, j, xj, uj);
    return body.cost(xj, uj, t).ab;
  }

  // full DDP: the Jet pass of dynamics and cost along j and i; returns the
  // cost's entry and writes Σ_a Vx[a]·∂²f_a/∂z_i∂z_j to hv
  __device__ __forceinline__ float pass2_so(const float (&x)[N],
                                            const float (&u)[M], int t,
                                            int i, int j,
                                            const float (&Vx)[N],
                                            float& hv) const {
    Jet xj[N], uj[M], f[N];
    jets(x, u, i, j, xj, uj);
    body.dynamics(xj, uj, t, f);
    float s = Vx[0] * f[0].ab;
DDP_UNROLL
    for (int a = 1; a < N; ++a) s = s + Vx[a] * f[a].ab;
    hv = s;
    return body.cost(xj, uj, t).ab;
  }

  // the first-order passes, then the Jet passes of the cost
  __device__ __forceinline__ void derivs(const float (&x)[N],
                                         const float (&u)[M], int t,
                                         Derivs& d) const {
    first(x, u, t, d);
    if constexpr (ROLLED) {
#pragma unroll 1
      for (int j = 0; j < NM; ++j) {
#pragma unroll 1
        for (int i = 0; i <= j; ++i) d.H[hidx(i, j)] = pass2(x, u, t, i, j);
      }
    } else {
DDP_UNROLL
      for (int j = 0; j < NM; ++j) {
DDP_UNROLL
        for (int i = 0; i <= j; ++i) d.H[hidx(i, j)] = pass2(x, u, t, i, j);
      }
    }
  }

  // full DDP: the first-order passes, then the Jet passes of dynamics and
  // cost, each pair's dynamics contracted with Vx at once
  __device__ __forceinline__ void derivs_so(const float (&x)[N],
                                            const float (&u)[M], int t,
                                            const float (&Vx)[N],
                                            Derivs& d) const {
    static_assert(SO, "derivs_so is the full-DDP expansion");
    first(x, u, t, d);
    if constexpr (ROLLED) {
#pragma unroll 1
      for (int j = 0; j < NM; ++j) {
#pragma unroll 1
        for (int i = 0; i <= j; ++i)
          d.H[hidx(i, j)] = pass2_so(x, u, t, i, j, Vx, d.HV[hidx(i, j)]);
      }
    } else {
DDP_UNROLL
      for (int j = 0; j < NM; ++j) {
DDP_UNROLL
        for (int i = 0; i <= j; ++i)
          d.H[hidx(i, j)] = pass2_so(x, u, t, i, j, Vx, d.HV[hidx(i, j)]);
      }
    }
  }

  __device__ __forceinline__ float vh(const Derivs& d, int i, int j) const {
    return d.HV[hidx(i, j)];
  }

  __device__ __forceinline__ void first(const float (&x)[N],
                                        const float (&u)[M], int t,
                                        Derivs& d) const {
    if constexpr (ROLLED) {
#pragma unroll 1
      for (int i = 0; i < NM; ++i) {
        Dual f[N];
        const float c = pass1(x, u, t, i, f).t;
        if (i < N) {
          d.cx[i] = c;
DDP_UNROLL
          for (int a = 0; a < N; ++a) d.fx[a][i] = f[a].t;
        } else {
          d.cu[i - N] = c;
DDP_UNROLL
          for (int a = 0; a < N; ++a) d.fu[a][i - N] = f[a].t;
        }
      }
    } else {
DDP_UNROLL
      for (int i = 0; i < N; ++i) {
        Dual f[N];
        d.cx[i] = pass1(x, u, t, i, f).t;
DDP_UNROLL
        for (int a = 0; a < N; ++a) d.fx[a][i] = f[a].t;
      }
DDP_UNROLL
      for (int mi = 0; mi < M; ++mi) {
        Dual f[N];
        d.cu[mi] = pass1(x, u, t, N + mi, f).t;
DDP_UNROLL
        for (int a = 0; a < N; ++a) d.fu[a][mi] = f[a].t;
      }
    }
  }

  __device__ __forceinline__ float fx(const Derivs& d, int i, int j) const {
    return d.fx[i][j];
  }
  __device__ __forceinline__ float fu(const Derivs& d, int i, int mi) const {
    return d.fu[i][mi];
  }
  __device__ __forceinline__ float cx(const Derivs& d, int i) const {
    return d.cx[i];
  }
  __device__ __forceinline__ float cu(const Derivs& d, int mi) const {
    return d.cu[mi];
  }
  __device__ __forceinline__ float cxx(const Derivs& d, int i, int j) const {
    return d.H[hidx(i, j)];
  }
  __device__ __forceinline__ float cxu(const Derivs& d, int i, int mi) const {
    return d.H[hidx(i, N + mi)];
  }
  __device__ __forceinline__ float cuu(const Derivs& d, int mi,
                                       int mj) const {
    return d.H[hidx(N + mi, N + mj)];
  }
};

}  // namespace ddp
