// K1, the wide design: the batched backward pass for states and controls
// whose per-scenario terms outgrow the lane design of backward.cuh, from
// n = 21 to 30 (by m and mode, plan.py::backward_plan) up to the ceilings
// n ≤ plan.MAX_STATES = 64, m ≤ plan.MAX_CONTROLS = 32.
//
// Replaces the TPU kernel
//   differentialdynamicprogramming_jl_tpu/ops/pallas/backward_kernel.py
//   ::backward_lanes (built by ::_make_kernel)
// at those sizes, on the packed-derivatives stream (T, D+m, B) in
// DerivLayout order (pack.py; D = 8616 slots a step at ⟨54,21⟩), which the
// wrapper forms with torch from the tiles where it is given tiles
// (backward_kernel.py::_wide_stream). Every mode of the lane design but
// second order: reg_type 1 and 2, limits static or per scenario (the m=1
// clamp, the m=2 enumeration, the masked projected-Newton box QP at m > 2),
// "gains", "full" and "policy" emission, GPS mode.
//
// Layout: one warp a scenario, S = blockDim.x / 32 of them a block (as
// many as fit, at most plan.WIDE_MAX_WARPS). n and m are run-time
// arguments: one build serves every size. Each warp keeps its scenario's
// terms in shared memory (wide_floats, plan.py::wide_floats): Vxx (which
// holds Qxx and then Vraw in place during a step), Vx, the step's fx and
// fu, W = Vxx·fx and U = Vxx·fu, the m×n terms Qux, Qux_r, K and Σ⁻¹K, the
// m×m terms Quu, QuuF and L, and m-vectors. At ⟨54,21⟩ that is 69 KB a
// scenario, three a block. Its lanes split each product's elements (or a
// Cholesky column's rows, or the gains' columns), each element's sum run
// by one lane from its first term in the JAX order, with __syncwarp
// between phases; the chains that are sequential in the reference (the
// forward and back substitutions of one right-hand side, the box QP's
// objective) run on one lane, the QP's four objectives a step on four.
//
// What bounds it. ⟨54,21⟩ gains at B=512, T=100: the stream is ≈1.77 GB
// (0.53 ms at 3.35 TB/s) against ≈0.4 Mflop a scenario-step (≈20 GFLOP,
// 0.3 ms at 67 TFLOP/s): bytes. A warp reads its scenario's slots one
// 4-byte word a lane, 32 sectors a request where 4 would do, and
// B=512 gives 171 blocks of 3 warps: about one block an SM, so each SM
// runs three dependent chains. Right before fast: staging 32 scenarios'
// slots through shared memory and splitting a scenario over more warps are
// untried (PERF.md §7).
//
// Semantics kept: those of backward.cuh ("Semantics kept"), with every
// sum, clamp and guard in the same order, so that the kernel is bit-equal
// to backward_kernel.py::backward_lanes_ref on the same stream.
#pragma once

#include "backward.cuh"

namespace ddp {

// the largest sizes the wide K1 takes (plan.py::MAX_STATES, MAX_CONTROLS;
// the library is built with DDP_MAX_M = MAX_CONTROLS)
constexpr int WIDE_MAX_N = 64;
constexpr int WIDE_MAX_WARPS = 8;

// shared floats of one scenario (plan.py::wide_floats)
__host__ __device__ inline int wide_floats(int n, int m) {
  const int f = n * n + n + 2 * n * (n + m) + n + 4 * m * n + 3 * m * m +
                16 * m + 4;
  return (f + 3) / 4 * 4;
}

namespace {

// one scenario's shared floats, in wide_floats' order
struct WideTerms {
  float *Vxx, *Vx, *F, *W, *Qx, *Qux, *QR, *KB, *SK, *Quu, *QuuF, *L;
  float *kw, *Qu, *kv, *QK, *qx, *gr, *fr, *dx, *lo, *hi, *u, *llo, *lhi;
  float *xc, *val;
  __device__ WideTerms(float* p, int n, int m) {
    auto take = [&](int k) {
      float* q = p;
      p += k;
      return q;
    };
    Vxx = take(n * n);
    Vx = take(n);
    F = take(n * (n + m));      // fx[c][j] at c·n+j, fu[c][mi] at n²+c·m+mi
    W = take(n * (n + m));      // W[a][j] at a·(n+m)+j, U[a][mi] at +n+mi
    Qx = take(n);
    Qux = take(m * n);
    QR = take(m * n);           // Qux_r, then Quu·K
    KB = take(m * n);           // K (GPS mode: first the previous K)
    SK = take(m * n);           // GPS mode: Σ⁻¹·K_prev
    Quu = take(m * m);
    QuuF = take(m * m);
    L = take(m * m);            // Cholesky factor (GPS mode: first Σ⁻¹)
    kw = take(m);               // the box QP's warm start
    Qu = take(m);
    kv = take(m);               // k (GPS mode: first k_prev)
    QK = take(m);               // Quu·k (GPS mode: first Σ⁻¹·k_prev)
    qx = take(m);
    gr = take(m);
    fr = take(m);               // the box QP's free set, 1 or 0
    dx = take(m);
    lo = take(m);
    hi = take(m);
    u = take(m);
    llo = take(m);              // the scenario's limits
    lhi = take(m);
    xc = take(3 * m);           // the box QP's three step candidates
    val = take(4);              // and the objectives of x and of them
  }
};

// a row-major m×m matrix in shared memory
struct Dense {
  const float* H;
  int m;
  __device__ float operator()(int i, int j) const { return H[i * m + j]; }
};

// H on the box QP's free set, the clamped rows and columns replaced by the
// identity's (backward.cuh::masked_chol)
struct Masked {
  const float* H;
  const float* fr;
  int m;
  __device__ float operator()(int i, int j) const {
    const bool fi = fr[i] != 0.0f, fj = fr[j] != 0.0f;
    return ((fi && fj) ? H[i * m + j] : 0.0f) +
           (i == j ? (fi ? 0.0f : 1.0f) : 0.0f);
  }
};

// Cholesky of the m×m matrix q(i, j) into L (lower triangle), column by
// column: every lane forms the pivot, the lanes split the column's rows;
// tiny_chol's operations in its order. Returns whether every leading
// minor is positive (the same on every lane); ends with __syncwarp.
template <class Q>
__device__ bool warp_chol(const Q& q, float* L, int m, int lane) {
  bool ok = true;
  for (int j = 0; j < m; ++j) {
    float d = q(j, j);
    for (int p = 0; p < j; ++p) d = d - L[j * m + p] * L[j * m + p];
    ok = ok && (d > 0.0f);
    const float Ljj = sqrtf(maxp(d, 1e-30f));
    for (int i = j + 1 + lane; i < m; i += RING_W) {
      float s = q(i, j);
      for (int p = 0; p < j; ++p) s = s - L[i * m + p] * L[j * m + p];
      L[i * m + j] = s / Ljj;
    }
    if (lane == 0) L[j * m + j] = Ljj;
    __syncwarp();
  }
  return ok;
}

// L·Lᵀ·x = b(i) by forward and back substitution on one lane
// (tiny_chol_solve)
template <class Rhs>
__device__ void chol_solve1(const float* L, int m, const Rhs& b, float* x) {
  float y[MAX_M];
  for (int i = 0; i < m; ++i) {
    float s = b(i);
    for (int p = 0; p < i; ++p) s = s - L[i * m + p] * y[p];
    y[i] = s / L[i * m + i];
  }
  for (int i = m - 1; i >= 0; --i) {
    float s = y[i];
    for (int p = i + 1; p < m; ++p) s = s - L[p * m + i] * x[p];
    x[i] = s / L[i * m + i];
  }
}

// Q⁻¹ by solves against the unit vectors (tiny_inv), the lanes splitting
// the columns, each entry i, j handed to put(i·m + j, value)
template <class Put>
__device__ void warp_inv(const float* Q, float* L, int m, int lane,
                         const Put& put) {
  warp_chol(Dense{Q, m}, L, m, lane);
  for (int j = lane; j < m; j += RING_W) {
    float col[MAX_M];
    chol_solve1(L, m, [&](int i) { return i == j ? 1.0f : 0.0f; }, col);
    for (int i = 0; i < m; ++i) put(i * m + j, col[i]);
  }
}

// the box QP's gradient H·x + g and KKT free set at x (qp_kkt), the lanes
// splitting the controls; ends with __syncwarp
__device__ void warp_kkt(const float* H, const float* g, WideTerms& s,
                         int m, int lane) {
  for (int i = lane; i < m; i += RING_W) {
    float a = 0.0f;
    for (int j = 0; j < m; ++j) a = a + H[i * m + j] * s.qx[j];
    const float gi = g[i] + a, xi = s.qx[i];
    s.gr[i] = gi;
    s.fr[i] = ((xi <= s.lo[i]) && (gi > 0.0f)) ||
                      ((xi >= s.hi[i]) && (gi < 0.0f))
                  ? 0.0f
                  : 1.0f;
  }
  __syncwarp();
}

// ½xᵀHx + gᵀx in the JAX order (qp_val), on one lane
__device__ float qp_val1(const float* H, const float* g, const float* x,
                         int m) {
  float v = 0.0f;
  for (int i = 0; i < m; ++i) v = v + x[i] * g[i];
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < m; ++j) v = v + 0.5f * x[i] * H[i * m + j] * x[j];
  }
  return v;
}

// the masked projected-Newton box QP for m > 2 (backward.cuh
// ::boxqp_masked) from the warm start s.kw within [s.lo, s.hi]: the
// solution in s.qx, its free set in s.fr and factor in s.L; returns ok
// (the same on every lane). Each iteration's three step candidates and
// their objectives and that of x are formed at once (they depend on x and
// the Newton step alone), then every lane takes the same decisions in the
// reference's order.
__device__ bool warp_boxqp(const float* H, const float* g, WideTerms& s,
                           int m, int qp_iters, int lane) {
  for (int i = lane; i < m; i += RING_W)
    s.qx[i] = clipp(s.kw[i], s.lo[i], s.hi[i]);
  __syncwarp();
  bool ok = true, improved = false;
  const float steps[3] = {1.0f, 0.5f, 0.25f};
  for (int it = 0; it < qp_iters; ++it) {
    warp_kkt(H, g, s, m, lane);
    ok = warp_chol(Masked{H, s.fr, m}, s.L, m, lane) && ok;
    if (lane == 0)
      chol_solve1(s.L, m, [&](int i) {
        return -(s.fr[i] != 0.0f ? s.gr[i] : 0.0f);
      }, s.dx);
    __syncwarp();
    for (int e = lane; e < 3 * m; e += RING_W) {
      const int a = e / m, i = e - a * m;
      const float d = s.fr[i] != 0.0f ? s.dx[i] : 0.0f;
      s.xc[e] = clipp(s.qx[i] + steps[a] * d, s.lo[i], s.hi[i]);
    }
    __syncwarp();
    if (lane < 4)
      s.val[lane] = qp_val1(H, g, lane == 0 ? s.qx : s.xc + (lane - 1) * m,
                            m);
    __syncwarp();
    float vb = s.val[0];
    int sel = -1;
    improved = false;
    for (int a = 0; a < 3; ++a) {
      const float vc = s.val[a + 1];
      const bool take = vc < vb;
      improved = improved || take;
      sel = take ? a : sel;
      vb = minp(vc, vb);
    }
    if (sel >= 0) {
      for (int i = lane; i < m; i += RING_W) s.qx[i] = s.xc[sel * m + i];
    }
    __syncwarp();
  }
  // the free set and its factor at the solution
  warp_kkt(H, g, s, m, lane);
  ok = warp_chol(Masked{H, s.fr, m}, s.L, m, lane) && ok;
  if (qp_iters > 0) {
    float gf2 = 0.0f, g2 = 0.0f;
    for (int i = 0; i < m; ++i) {
      const float v = s.fr[i] != 0.0f ? s.gr[i] : 0.0f;
      gf2 = gf2 + v * v;
    }
    for (int i = 0; i < m; ++i) g2 = g2 + g[i] * g[i];
    const bool stuck = (gf2 > 1e-6f * (g2 + 1e-30f)) && !improved;
    ok = ok && !stuck;
  }
  return ok;
}

__global__ void __launch_bounds__(RING_W* WIDE_MAX_WARPS)
backward_wide_kernel(const float* __restrict__ traj, int s_in,
                     const float* __restrict__ lam,
                     const float* __restrict__ prev,
                     const float* __restrict__ eta, float* __restrict__ out,
                     int s_out, float* __restrict__ stats, int T, int B,
                     int n, int m, int emit, int reg_type, bool use_limits,
                     Lims lims, const float* __restrict__ lims_lanes,
                     int qp_iters) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / RING_W, lane = threadIdx.x & (RING_W - 1);
  const int S = blockDim.x / RING_W;
  const int b = blockIdx.x * S + warp;
  if (b >= B) return;       // the warp's scenario is past B; no block sync
  const size_t sB = (size_t)B;
  WideTerms s(smem + (size_t)warp * wide_floats(n, m), n, m);
  const bool gps = prev != nullptr;
  const bool VALUE = emit == EMIT_FULL, QUU = emit != EMIT_GAINS;
  const int nm = n + m, nn = n * n, mn = m * n, mm = m * m;
  const int OV = m + mn, OQ = VALUE ? OV + n + nn : OV;
  const int PS = m + mn + mm;
  // DerivLayout (pack.py)
  const int FU = nn, CX = FU + mn, CU = CX + n, CXX = CU + m, CXU = CXX + nn,
            CUU = CXU + mn, D = CUU + mm;
  auto in = [&](int t, int sl) {
    return traj[((size_t)t * s_in + sl) * sB + b];
  };
  auto pv = [&](int t, int sl) {
    return prev[((size_t)t * PS + sl) * sB + b];
  };
  auto put = [&](int t, int sl, float v) {
    out[((size_t)t * s_out + sl) * sB + b] = v;
  };
  auto fx = [&](int a, int j) { return s.F[a * n + j]; };
  auto fu = [&](int a, int mi) { return s.F[FU + a * m + mi]; };
  const float lm = lam[b];
  if (use_limits && lane == 0) {
    // unrolled, so that no run-time index reaches the by-value parameter
#pragma unroll
    for (int mi = 0; mi < MAX_M; ++mi) {
      if (mi < m) {
        s.llo[mi] = lims_lanes == nullptr
                        ? lims.lo[mi]
                        : lims_lanes[(size_t)(2 * mi) * sB + b];
        s.lhi[mi] = lims_lanes == nullptr
                        ? lims.hi[mi]
                        : lims_lanes[(size_t)(2 * mi + 1) * sB + b];
      }
    }
  }
  float dv1 = 0.0f, dv2 = 0.0f, div = 0.0f, divt = 0.0f;

  {  // boundary t = T-1: V = the cost expansion; zero gains
    const int t = T - 1;
    for (int i = lane; i < n; i += RING_W) {
      s.Vx[i] = in(t, CX + i);
      if (VALUE) put(t, OV + i, s.Vx[i]);
    }
    for (int e = lane; e < nn; e += RING_W) {
      s.Vxx[e] = in(t, CXX + e);
      if (VALUE) put(t, OV + n + e, s.Vxx[e]);
    }
    for (int sl = lane; sl < OV; sl += RING_W) put(t, sl, 0.0f);
    for (int mi = lane; mi < m; mi += RING_W) s.kw[mi] = 0.0f;
    if (QUU) {
      // in GPS mode only the emitted Quu is cuu/η + Σ⁻¹_prev
      const float e = gps ? eta_or_one(eta[(size_t)t * sB + b]) : 1.0f;
      for (int k = lane; k < mm; k += RING_W) {
        float c = in(t, CUU + k);
        if (gps) c = c / e + pv(t, m + mn + k);
        s.Quu[k] = c;
        put(t, OQ + k, c);
      }
      __syncwarp();
      warp_inv(s.Quu, s.L, m, lane,
               [&](int k, float v) { put(t, OQ + mm + k, v); });
    }
    __syncwarp();
  }

  for (int t = T - 2; t >= 0; --t) {
    // the step's fx and fu (slots 0 .. n(n+m)-1), and u
    for (int e = lane; e < n * nm; e += RING_W) s.F[e] = in(t, e);
    for (int mi = lane; mi < m; mi += RING_W) s.u[mi] = in(t, D + mi);
    __syncwarp();

    // Q expansions (src/backward_pass.jl:103-123); each sum runs a = 0..n-1
    // W = Vxx·fx and U = Vxx·fu
    for (int e = lane; e < n * nm; e += RING_W) {
      const int a = e / nm, j = e - a * nm;
      const float* V = s.Vxx + a * n;
      float acc;
      if (j < n) {
        acc = V[0] * fx(0, j);
        for (int c = 1; c < n; ++c) acc = acc + V[c] * fx(c, j);
      } else {
        acc = V[0] * fu(0, j - n);
        for (int c = 1; c < n; ++c) acc = acc + V[c] * fu(c, j - n);
      }
      s.W[e] = acc;
    }
    for (int i = lane; i < n; i += RING_W) {
      float acc = fx(0, i) * s.Vx[0];
      for (int a = 1; a < n; ++a) acc = acc + fx(a, i) * s.Vx[a];
      s.Qx[i] = in(t, CX + i) + acc;
    }
    for (int mi = lane; mi < m; mi += RING_W) {
      float acc = fu(0, mi) * s.Vx[0];
      for (int a = 1; a < n; ++a) acc = acc + fu(a, mi) * s.Vx[a];
      s.Qu[mi] = in(t, CU + mi) + acc;
    }
    __syncwarp();
    // Qxx (into Vxx, read for the last time above), Quu, Qux
    for (int e = lane; e < nn; e += RING_W) {
      const int i = e / n, j = e - i * n;
      float acc = fx(0, i) * s.W[j];
      for (int a = 1; a < n; ++a) acc = acc + fx(a, i) * s.W[a * nm + j];
      s.Vxx[e] = in(t, CXX + e) + acc;
    }
    for (int e = lane; e < mm; e += RING_W) {
      const int mi = e / m, mj = e - mi * m;
      float acc = fu(0, mi) * s.W[n + mj];
      for (int a = 1; a < n; ++a) acc = acc + fu(a, mi) * s.W[a * nm + n + mj];
      s.Quu[e] = in(t, CUU + e) + acc;
    }
    for (int e = lane; e < mn; e += RING_W) {
      const int mi = e / n, j = e - mi * n;
      float acc = fu(0, mi) * s.W[j];
      for (int a = 1; a < n; ++a) acc = acc + fu(a, mi) * s.W[a * nm + j];
      s.Qux[e] = in(t, CXU + j * m + mi) + acc;
    }
    __syncwarp();

    if (gps) {
      // GPS mode: Q terms scaled by 1/η plus the KL expansion of the
      // previous policy (read_kl :370-392), Quu symmetrised, λ unused
      const float ie = 1.0f / eta_or_one(eta[(size_t)t * sB + b]);
      for (int e = lane; e < mn; e += RING_W) s.KB[e] = pv(t, m + e);
      for (int e = lane; e < mm; e += RING_W) s.L[e] = pv(t, m + mn + e);
      for (int mi = lane; mi < m; mi += RING_W) s.kv[mi] = pv(t, mi);
      __syncwarp();
      const float* Si = s.L;
      for (int mi = lane; mi < m; mi += RING_W) {     // Σ⁻¹·k
        float acc = Si[mi * m] * s.kv[0];
        for (int mj = 1; mj < m; ++mj) acc = acc + Si[mi * m + mj] * s.kv[mj];
        s.QK[mi] = acc;
      }
      for (int e = lane; e < mn; e += RING_W) {       // Σ⁻¹·K
        const int mi = e / n, j = e - mi * n;
        float acc = Si[mi * m] * s.KB[j];
        for (int mj = 1; mj < m; ++mj)
          acc = acc + Si[mi * m + mj] * s.KB[mj * n + j];
        s.SK[e] = acc;
        s.Qux[e] = s.Qux[e] * ie + (-acc);
      }
      for (int e = lane; e < mm; e += RING_W)
        s.QuuF[e] = s.Quu[e] * ie + Si[e];
      __syncwarp();
      for (int i = lane; i < n; i += RING_W) {
        float c = s.KB[i] * s.QK[0];
        for (int mi = 1; mi < m; ++mi) c = c + s.KB[mi * n + i] * s.QK[mi];
        s.Qx[i] = s.Qx[i] * ie + c;
      }
      for (int mi = lane; mi < m; mi += RING_W)
        s.Qu[mi] = s.Qu[mi] * ie + (-s.QK[mi]);
      for (int e = lane; e < nn; e += RING_W) {
        const int i = e / n, j = e - i * n;
        float c = s.KB[i] * s.SK[j];
        for (int mi = 1; mi < m; ++mi)
          c = c + s.KB[mi * n + i] * s.SK[mi * n + j];
        s.Vxx[e] = s.Vxx[e] * ie + c;
      }
      for (int e = lane; e < mm; e += RING_W) {
        const int mi = e / m, mj = e - mi * m;
        s.Quu[e] = 0.5f * (s.QuuF[mi * m + mj] + s.QuuF[mj * m + mi]);
      }
      __syncwarp();
      for (int e = lane; e < mm; e += RING_W) s.QuuF[e] = s.Quu[e];
      for (int e = lane; e < mn; e += RING_W) s.QR[e] = s.Qux[e];
    } else if (reg_type == 2) {
      // regularised gain matrices (src/backward_pass.jl:119-123)
      for (int e = lane; e < mn; e += RING_W) {
        const int mi = e / n, j = e - mi * n;
        float acc = fu(0, mi) * fx(0, j);
        for (int a = 1; a < n; ++a) acc = acc + fu(a, mi) * fx(a, j);
        s.QR[e] = s.Qux[e] + lm * acc;
      }
      for (int e = lane; e < mm; e += RING_W) {
        const int mi = e / m, mj = e - mi * m;
        float acc = fu(0, mi) * fu(0, mj);
        for (int a = 1; a < n; ++a) acc = acc + fu(a, mi) * fu(a, mj);
        s.QuuF[e] = s.Quu[e] + lm * acc;
      }
    } else {
      for (int e = lane; e < mn; e += RING_W) s.QR[e] = s.Qux[e];
      for (int e = lane; e < mm; e += RING_W) {
        const int mi = e / m, mj = e - mi * m;
        s.QuuF[e] = s.Quu[e] + (mi == mj ? lm : 0.0f);
      }
    }
    __syncwarp();

    // ---- gain solve: k in kv, K in KB, ok the same on every lane
    bool ok;
    if (!use_limits) {
      // unconstrained: the Cholesky solve
      ok = warp_chol(Dense{s.QuuF, m}, s.L, m, lane);
      if (lane == 0)
        chol_solve1(s.L, m, [&](int i) { return -s.Qu[i]; }, s.kv);
      for (int j = lane; j < n; j += RING_W) {
        float col[MAX_M];
        chol_solve1(s.L, m, [&](int mi) { return -s.QR[mi * n + j]; }, col);
        for (int mi = 0; mi < m; ++mi) s.KB[mi * n + j] = col[mi];
      }
    } else if (m == 1) {
      // closed-form box QP with limits relative to u_t
      const float q = s.QuuF[0];
      const float lo = s.llo[0] - s.u[0], hi = s.lhi[0] - s.u[0];
      const float xq = clipp(-s.Qu[0] / q, lo, hi);
      const float grad = s.Qu[0] + q * xq;
      const bool clamped = ((xq <= lo) && (grad > 0.0f)) ||
                           ((xq >= hi) && (grad < 0.0f));
      const float quu_s = guard(q);
      ok = q > 0.0f;
      if (lane == 0) s.kv[0] = xq;
      for (int j = lane; j < n; j += RING_W)
        s.KB[j] = clamped ? 0.0f : -s.QR[j] / quu_s;
    } else if (m == 2) {
      // the exact enumeration and its K rows, on every lane
      const float Q[2][2] = {{s.QuuF[0], s.QuuF[1]}, {s.QuuF[2], s.QuuF[3]}};
      const float g[2] = {s.Qu[0], s.Qu[1]};
      const float lo[2] = {s.llo[0] - s.u[0], s.llo[1] - s.u[1]};
      const float hi[2] = {s.lhi[0] - s.u[0], s.lhi[1] - s.u[1]};
      float x[2];
      bool fr[2];
      ok = boxqp_m2(Q, g, lo, hi, x, fr);
      if (lane == 0) {
        s.kv[0] = x[0];
        s.kv[1] = x[1];
      }
      const bool both = fr[0] && fr[1];
      const float a = Q[0][0], bb = Q[0][1], c = Q[1][1];
      const float det_s = guard(a * c - bb * bb);
      const float a_s = guard(a), c_s = guard(c);
      for (int j = lane; j < n; j += RING_W) {
        const float q0 = s.QR[j], q1 = s.QR[n + j];
        const float kb0 = (-q0 * c + q1 * bb) / det_s;
        const float kb1 = (q0 * bb - q1 * a) / det_s;
        s.KB[j] = both ? kb0 : (fr[0] ? -q0 / a_s : 0.0f);
        s.KB[n + j] = both ? kb1 : (fr[1] ? -q1 / c_s : 0.0f);
      }
    } else {
      // m > 2: the masked projected-Newton box QP from the warm start,
      // then K on its final free subspace, clamped rows 0
      for (int mi = lane; mi < m; mi += RING_W) {
        s.lo[mi] = s.llo[mi] - s.u[mi];
        s.hi[mi] = s.lhi[mi] - s.u[mi];
      }
      __syncwarp();
      ok = warp_boxqp(s.QuuF, s.Qu, s, m, qp_iters, lane);
      for (int mi = lane; mi < m; mi += RING_W) s.kv[mi] = s.qx[mi];
      for (int j = lane; j < n; j += RING_W) {
        float col[MAX_M];
        chol_solve1(s.L, m, [&](int mi) {
          return s.fr[mi] != 0.0f ? -s.QR[mi * n + j] : 0.0f;
        }, col);
        for (int mi = 0; mi < m; ++mi)
          s.KB[mi * n + j] = s.fr[mi] != 0.0f ? col[mi] : 0.0f;
      }
    }
    __syncwarp();
    // a non-PD lane gets zero gains; V keeps updating; k is the next
    // step's warm start
    for (int mi = lane; mi < m; mi += RING_W) {
      s.kv[mi] = ok ? s.kv[mi] : 0.0f;
      s.kw[mi] = s.kv[mi];
    }
    for (int e = lane; e < mn; e += RING_W) s.KB[e] = ok ? s.KB[e] : 0.0f;
    __syncwarp();

    // value update with the unregularised terms (src/backward_pass.jl:63-72)
    for (int mi = lane; mi < m; mi += RING_W) {
      float acc = s.Quu[mi * m] * s.kv[0];
      for (int mj = 1; mj < m; ++mj) acc = acc + s.Quu[mi * m + mj] * s.kv[mj];
      s.QK[mi] = acc;
    }
    for (int e = lane; e < mn; e += RING_W) {          // Quu·K into QR
      const int mi = e / n, j = e - mi * n;
      float acc = s.Quu[mi * m] * s.KB[j];
      for (int mj = 1; mj < m; ++mj)
        acc = acc + s.Quu[mi * m + mj] * s.KB[mj * n + j];
      s.QR[e] = acc;
    }
    __syncwarp();
    {
      float s1 = s.kv[0] * s.Qu[0], s2 = s.kv[0] * s.QK[0];
      for (int mi = 1; mi < m; ++mi) {
        s1 = s1 + s.kv[mi] * s.Qu[mi];
        s2 = s2 + s.kv[mi] * s.QK[mi];
      }
      dv1 = dv1 + s1;
      dv2 = dv2 + 0.5f * s2;
    }
    for (int i = lane; i < n; i += RING_W) {
      float s1 = s.KB[i] * (s.QK[0] + s.Qu[0]), s2 = s.Qux[i] * s.kv[0];
      for (int mi = 1; mi < m; ++mi) {
        s1 = s1 + s.KB[mi * n + i] * (s.QK[mi] + s.Qu[mi]);
        s2 = s2 + s.Qux[mi * n + i] * s.kv[mi];
      }
      s.Vx[i] = s.Qx[i] + s1 + s2;
    }
    for (int e = lane; e < nn; e += RING_W) {           // Vraw, in place
      const int i = e / n, j = e - i * n;
      float r1 = s.KB[i] * s.QR[j], r2 = s.KB[i] * s.Qux[j],
            r3 = s.Qux[i] * s.KB[j];
      for (int mi = 1; mi < m; ++mi) {
        r1 = r1 + s.KB[mi * n + i] * s.QR[mi * n + j];
        r2 = r2 + s.KB[mi * n + i] * s.Qux[mi * n + j];
        r3 = r3 + s.Qux[mi * n + i] * s.KB[mi * n + j];
      }
      s.Vxx[e] = s.Vxx[e] + r1 + r2 + r3;
    }
    __syncwarp();
    // Vxx = (Vraw + Vrawᵀ)/2, each pair by one lane
    for (int e = lane; e < nn; e += RING_W) {
      const int i = e / n, j = e - i * n;
      if (i <= j) {
        const float a = s.Vxx[i * n + j], c = s.Vxx[j * n + i];
        s.Vxx[i * n + j] = 0.5f * (a + c);
        s.Vxx[j * n + i] = 0.5f * (c + a);
      }
    }
    __syncwarp();

    // divergence latch: t+1 of the first failing step (backward order)
    const float bad = ok ? 0.0f : 1.0f;
    const float newly = bad * (1.0f - div);
    divt = divt * (1.0f - newly) + newly * (float)(t + 1);
    div = maxp(div, bad);

    // the step's slots
    for (int sl = lane; sl < OV; sl += RING_W)
      put(t, sl, sl < m ? s.kv[sl] : s.KB[sl - m]);
    if (VALUE) {
      for (int i = lane; i < n; i += RING_W) put(t, OV + i, s.Vx[i]);
      for (int e = lane; e < nn; e += RING_W) put(t, OV + n + e, s.Vxx[e]);
    }
    if (QUU) {
      for (int k = lane; k < mm; k += RING_W) put(t, OQ + k, s.Quu[k]);
      warp_inv(s.Quu, s.L, m, lane,
               [&](int k, float v) { put(t, OQ + mm + k, v); });
    }
    __syncwarp();
  }

  if (lane == 0) {
    stats[b] = dv1;
    stats[sB + b] = dv2;
    stats[2 * sB + b] = div;
    stats[3 * sB + b] = divt;
  }
}

}  // namespace

// the C entry's checks and launch: ERR_ARGS for arguments the kernel does
// not take or a plan (plan.py::wide_plan) that does not match
inline int launch_backward_wide(const float* traj, int s_in, const float* lam,
                                const float* prev, const float* eta,
                                float* out, int s_out, float* stats, int T,
                                int B, int emit, int reg_type, int use_limits,
                                const float* lims, const float* lims_lanes,
                                int n, int m, int qp_iters, int blocks,
                                int threads, int smem, cudaStream_t stream) {
  const int D = 2 * n * n + 2 * n * m + n + m + m * m;
  const int S = threads / RING_W;
  Lims lim;
  if (T < 2 || B < 1 || n < 1 || n > WIDE_MAX_N || m < 1 || m > MAX_M ||
      s_in != D + m || s_out != out_slots(emit, n, m) ||
      (reg_type != 1 && reg_type != 2) ||
      (prev == nullptr) != (eta == nullptr) || qp_iters < 0 ||
      !lims_from_host(lims, m, lim) || threads % RING_W != 0 || S < 1 ||
      S > WIDE_MAX_WARPS || blocks != (B + S - 1) / S ||
      smem != S * 4 * wide_floats(n, m) || smem > MAX_SMEM)
    return ERR_ARGS;
  const int rc = reserve_smem(backward_wide_kernel, smem);
  if (rc != 0) return rc;
  backward_wide_kernel<<<blocks, threads, smem, stream>>>(
      traj, s_in, lam, prev, eta, out, s_out, stats, T, B, n, m, emit,
      reg_type, use_limits != 0 || lims_lanes != nullptr, lim, lims_lanes,
      qp_iters);
  return (int)cudaGetLastError();
}

}  // namespace ddp
