// K3: multi-α forward rollout, and K2: fused line search, templated on the
// model (common.cuh describes the interface).
//
// Replace the TPU kernels
//   differentialdynamicprogramming_jl_tpu/ops/pallas/forward_kernel.py
//   ::forward_lanes (built by ::_make_kernel)        -> forward_kernel
//   ::linesearch_lanes (built by ::_make_fused_kernel) -> linesearch_kernel
// with static per-control limits, or per-scenario limits (lims_lanes, a
// (2m, B) stream read once per thread), and per-scenario model parameters
// for a model that takes them (params, (P, B)). Without limits the wrapper
// passes lo = -inf, hi = +inf: the NaN-keeping clipp then returns its input
// unchanged, as the JAX rollout's missing clamp does. Instances: pendcart
// ⟨4,1⟩ (forward.cu), LTI ⟨10,2⟩ (forward_lti.cu), quadrotor ⟨6,2⟩
// (forward_quad.cu) and the parametrised pendcart PendCartParam ⟨4,1⟩
// (forward_pendcart_param.cu); K3 at A = 1..8 each, K2 one kernel for any
// A ≤ MAX_A.
//
// Layout: streams are (T, S, B) f32 with the scenario axis contiguous.
// K3: one thread owns one scenario and walks t = 0 .. T-1, holding the A
// candidate states (A·(n+2) floats) in registers, loading each step from
// device memory as it comes. K2: a block owns 32 scenarios and runs one
// warp per candidate; lane l is scenario 32·blockIdx.x + l, and each thread
// holds one candidate's n+2 floats. The step inputs of the block (x_old,
// u_nom from the trajectory, k, K from the gains: n+2m+mn slots) are
// staged in chunks of tc steps in a shared-memory ring of `stages` stages
// (ring.cuh), which all A warps read; pass 1 and pass 2 are one sequence
// of 2·⌈T/tc⌉ chunks, so the ring also prefetches pass 2's first chunks
// while pass 1 ends. The plan (tc, stages, shared bytes) comes from
// ops/hopper/plan.py.
//
// What bounds them. Pendcart at B=4096, T=500: a pass reads the x,u slots
// of the trajectory (≈41 MB) and the gain slots (≈41 MB); the line search
// writes the new [x, u, c] stream (≈49 MB): ≈131 MB, 0.039 ms at 3.35
// TB/s, against ≈40 f32 operations a scenario-step and candidate. K3 runs
// one warp per scheduler on 32 SMs and waits on each step's loads. K2 puts
// 128 blocks on 128 SMs, moves each input byte once per pass, and no step
// waits on device memory: a step costs its dependent chain of arithmetic
// (sinf/cosf and the divisions of the pendcart, the n×n product of LTI),
// T steps in pass 1 and T again in pass 2, which one warp of the block
// rolls for its 32 scenarios while the others only stage the ring. LTI
// ⟨10,2⟩ at B=4096, T=1000, A=6: the line search reads x,u (12 slots) and
// k,K (22 slots) and writes 13 slots (≈770 MB) against ≈11 GFLOP.
//
// Semantics kept from the TPU kernels (forward_kernel.py line numbers):
// - per control, u = clip(u_nom + α·k + Σ_j K_j·(x_j − x_old_j), lo, hi)
//   in that operation order (:156-169, :454-461);
// - the terminal cost is evaluated at the STORED state x[T-1], not at the
//   state after the last step (:150-151, :178-181, :475-478);
// - the accept rule at the pass boundary: ratio = dcost/expected, or
//   sign(dcost) when expected <= 0; the first α in ladder order with
//   ratio > rr_min wins; α_eff = 0 where allow = 0 (:401-436);
// - pass 2 re-rolls α_eff through the same rollout_step as pass 1 and as
//   forward_kernel, so an α=0 retrace reproduces a trajectory bit for bit.
// In place (:530-534, :599-611): the launcher may be given out == traj
// (the wrapper's in_place, for a stream of exactly n+m+1 slots), so traj,
// x0 and out are not __restrict__: aliased __restrict__ pointers would be
// undefined behaviour. Aliasing is safe: a block reads and writes only its
// own 32 columns; every warp has read x0 and finished pass 1 before the
// barrier after which pass 2 writes step 0; and pass 2 stages only steps
// it has not yet written. The solve loop keeps writing a fresh stream,
// since its backward replay needs the entry stream; the MPC step
// (ilqg_iteration_lanes) updates in place.
// Not kept: the echo of the input x,u slots, which the TPU kernels emitted
// only to avoid XLA while-loop carry copies (:136-146).
#pragma once

#include "ring.cuh"

namespace ddp {

constexpr int MAX_A = 8;

struct Ladder {
  float a[MAX_A];
};

// the launchers' arguments, checked by ddp_forward_lanes and
// ddp_linesearch_lanes; out is the emitted [x, u, c] stream or null
struct FwdArgs {
  const float* traj;
  int s_traj;
  const float* gains;
  int s_g, gk, gK;
  const float* x0;
  const float* alphas;   // K3: (A, B) on the card
  const float* sel;      // K2: (4, B) [dV1, dV2, cost, allow] on the card
  Ladder ladder;         // K2: the static α ladder
  float rr_min;
  int A;
  float* totals;
  float* terminal;
  float* out;            // K2: == traj for the in-place update
  float* ls;
  int T, B;
  RingPlan plan;         // K2's launch plan (ops/hopper/plan.py)
  Lims lims;
  const float* lims_lanes;   // (2m, B) per-scenario limits, or null
  const float* params;       // (P, B) per-scenario parameters, or null
  const float* consts;   // host copy of the model descriptor
  cudaStream_t stream;
};

namespace {

constexpr int FWD_THREADS = 128;

template <class Model>
struct StepIn {
  float x_old[Model::N], u_nom[Model::M], k[Model::M];
  float K[Model::M][Model::N];
};

template <class Model>
__device__ __forceinline__ void load_step(const float* __restrict__ traj,
                                          int s_traj,
                                          const float* __restrict__ gains,
                                          int s_g, int gk, int gK, int t,
                                          int b, size_t sB,
                                          StepIn<Model>& s) {
  constexpr int N = Model::N, M = Model::M;
  const float* tr = traj + (size_t)t * s_traj * sB + b;
  const float* gn = gains + (size_t)t * s_g * sB + b;
#pragma unroll
  for (int i = 0; i < N; ++i) s.x_old[i] = tr[i * sB];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    s.u_nom[mi] = tr[(N + mi) * sB];
    s.k[mi] = gn[(gk + mi) * sB];
#pragma unroll
    for (int j = 0; j < N; ++j) s.K[mi][j] = gn[(gK + mi * N + j) * sB];
  }
}

// one rollout step of one candidate: control law, running cost, terminal
// cost at the stored last state, model step
template <class Model>
__device__ __forceinline__ void rollout_step(
    const Model& P, float (&x)[Model::N], float& acc, float& term,
    float alpha, const StepIn<Model>& s, const Lims& lims, bool last,
    float (&u)[Model::M], float& c_out) {
  constexpr int N = Model::N, M = Model::M;
  float dx[N];
#pragma unroll
  for (int j = 0; j < N; ++j) dx[j] = x[j] - s.x_old[j];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    float v = s.u_nom[mi] + alpha * s.k[mi];
#pragma unroll
    for (int j = 0; j < N; ++j) v = v + s.K[mi][j] * dx[j];
    u[mi] = clipp(v, lims.lo[mi], lims.hi[mi]);
  }
  const float c = P.cost(x, u);
  if (last) term = P.terminal(x);
  float xn[N];
  P.dynamics(x, u, xn);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xn[i];
  acc = acc + c;
  c_out = c;
}

template <class Model, int A, bool EMIT>
__global__ void __launch_bounds__(FWD_THREADS)
forward_kernel(const float* __restrict__ traj, int s_traj,
               const float* __restrict__ gains, int s_g, int gk, int gK,
               const float* __restrict__ x0, const float* __restrict__ alphas,
               float* __restrict__ totals, float* __restrict__ terminal,
               float* __restrict__ out, int T, int B, Lims lims,
               const float* __restrict__ lims_lanes,
               const float* __restrict__ params, typename Model::Consts mc) {
  constexpr int N = Model::N, M = Model::M;
  constexpr int SO = N + M + 1;   // output slots [x, u, c]
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const Model P = make_model<Model>(mc, params, b, sB);
  const Lims lm = lane_lims<M>(lims, lims_lanes, b, sB);
  float x[A][N], acc[A], term[A], al[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    al[a] = alphas[a * sB + b];
#pragma unroll
    for (int i = 0; i < N; ++i) x[a][i] = x0[i * sB + b];
    acc[a] = 0.0f;
    term[a] = 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    StepIn<Model> s;
    load_step<Model>(traj, s_traj, gains, s_g, gk, gK, t, b, sB, s);
    const bool last = t == T - 1;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float xs[N];
#pragma unroll
      for (int i = 0; i < N; ++i) xs[i] = x[a][i];
      float u[M], c;
      rollout_step<Model>(P, x[a], acc[a], term[a], al[a], s, lm, last, u,
                          c);
      if (EMIT && a == 0) {
        float* o = out + (size_t)t * SO * sB + b;
#pragma unroll
        for (int i = 0; i < N; ++i) o[i * sB] = xs[i];
#pragma unroll
        for (int mi = 0; mi < M; ++mi) o[(N + mi) * sB] = u[mi];
        o[(N + M) * sB] = c;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    totals[a * sB + b] = acc[a] + term[a];
    terminal[a * sB + b] = term[a];
  }
}

// K2 with a fresh output, or in place: out == traj, and x0 may be a view
// of the same stream, so these three are not __restrict__. Block: 32
// scenarios × A warps (A = blockDim.x / 32); dynamic shared memory: the
// ring, then the A×32 candidate totals.
template <class Model>
__global__ void __launch_bounds__(RING_W * MAX_A)
linesearch_kernel(const float* traj, int s_traj,
                  const float* __restrict__ gains, int s_g, int gk, int gK,
                  const float* x0, const float* __restrict__ sel,
                  Ladder ladder, float rr_min, float* out,
                  float* __restrict__ ls, int T, int B, Lims lims,
                  const float* __restrict__ lims_lanes,
                  const float* __restrict__ params,
                  typename Model::Consts mc, int tc, int stages, bool vec) {
  constexpr int N = Model::N, M = Model::M;
  constexpr int SO = N + M + 1;
  constexpr int F = N + 2 * M + M * N;   // ring slots [x_old, u_nom, k, K]
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x & (RING_W - 1), w = threadIdx.x / RING_W;
  const int A = blockDim.x / RING_W;
  const int b0 = blockIdx.x * RING_W, b = b0 + lane;
  const int cols = min(RING_W, B - b0);
  const bool live = b < B;
  // a lane past B reads scenario B-1's inputs and drops its results
  const int bl = live ? b : B - 1;
  const size_t sB = (size_t)B;
  const Model P = make_model<Model>(mc, params, bl, sB);
  const Lims lm = lane_lims<M>(lims, lims_lanes, bl, sB);
  const int nc = (T + tc - 1) / tc;          // chunks a pass
  const int stage = tc * F * RING_W;         // floats a stage
  float* tot = ring + stages * stage;        // [A][32] pass-1 totals

  // chunk j of the sequence: pass j / nc, steps from (j % nc)·tc
  auto issue = [&](int j) {
    if (j < 2 * nc) {
      const int t0 = (j % nc) * tc, steps = min(tc, T - t0);
      stage_rows<F>(ring + (j % stages) * stage, steps, cols, vec,
                    threadIdx.x, blockDim.x, [&](int tt, int s) {
                      const size_t t = (size_t)(t0 + tt);
                      const float* row =
                          s < N + M ? traj + (t * s_traj + s) * sB
                          : s < N + 2 * M
                              ? gains + (t * s_g + gk + (s - N - M)) * sB
                              : gains + (t * s_g + gK + (s - N - 2 * M)) * sB;
                      return row + b0;
                    });
    }
    cp_async_commit();
  };

  // pass 1: warp w rolls candidate w of the ladder
  float x[N], acc = 0.0f, term = 0.0f, alpha = ladder.a[w];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0[i * sB + bl];

  for (int j = 0; j < stages - 1; ++j) issue(j);
  for (int j = 0; j < 2 * nc; ++j) {
    issue(j + stages - 1);      // into the stage consumed at chunk j-1
    cp_async_wait(stages - 1);  // this thread's copies of chunk j landed
    __syncthreads();            // and everyone's
    const bool pass2 = j >= nc;
    if (j == nc && w == 0) {
      // pass boundary: the accept decision (src/iLQG.jl:269-280) over the
      // A totals, in ladder order
      const float dv1 = sel[bl], dv2 = sel[sB + bl];
      const float ctot = sel[2 * sB + bl], allow = sel[3 * sB + bl];
      float al_sel = 0.0f, dc_sel = 0.0f, rt_sel = 0.0f;
      bool found = false;
      for (int a = 0; a < A; ++a) {
        const float al = ladder.a[a];
        const float dcost = ctot - tot[a * RING_W + lane];
        const float expected = (-al) * (dv1 + al * dv2);
        const float ratio =
            expected > 0.0f ? dcost / expected : signp(dcost);
        const bool ok = ratio > rr_min;
        if (a == 0) {
          dc_sel = dcost;
          rt_sel = ratio;
          found = ok;
          al_sel = ok ? al : 0.0f;
        } else {
          const bool take = ok && !found;
          al_sel = take ? al : al_sel;
          dc_sel = take ? dcost : dc_sel;
          rt_sel = take ? ratio : rt_sel;
          found = found || ok;
        }
      }
      if (live) {
        ls[b] = al_sel;
        ls[sB + b] = found ? 1.0f : 0.0f;
        ls[2 * sB + b] = dc_sel;
        ls[3 * sB + b] = rt_sel;
      }
      // pass 2: warp 0 re-rolls α_eff and writes the new [x, u, c] stream
      alpha = (found && allow > 0.5f) ? al_sel : 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = x0[i * sB + bl];
      acc = 0.0f;
      term = 0.0f;
    }
    if (!pass2 || w == 0) {
      const int t0 = (pass2 ? j - nc : j) * tc, steps = min(tc, T - t0);
      const float* st = ring + (j % stages) * stage + lane;
      for (int tt = 0; tt < steps; ++tt) {
        const int t = t0 + tt;
        const float* r = st + tt * F * RING_W;
        StepIn<Model> s;
#pragma unroll
        for (int i = 0; i < N; ++i) s.x_old[i] = r[i * RING_W];
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
          s.u_nom[mi] = r[(N + mi) * RING_W];
          s.k[mi] = r[(N + M + mi) * RING_W];
#pragma unroll
          for (int jj = 0; jj < N; ++jj)
            s.K[mi][jj] = r[(N + 2 * M + mi * N + jj) * RING_W];
        }
        float* o = out + (size_t)t * SO * sB + b;
        if (pass2 && live) {
#pragma unroll
          for (int i = 0; i < N; ++i) o[i * sB] = x[i];
        }
        float u[M], c;
        rollout_step<Model>(P, x, acc, term, alpha, s, lm, t == T - 1, u, c);
        if (pass2 && live) {
#pragma unroll
          for (int mi = 0; mi < M; ++mi) o[(N + mi) * sB] = u[mi];
          o[(N + M) * sB] = c;
        }
      }
      if (j == nc - 1) tot[w * RING_W + lane] = acc + term;
    }
    __syncthreads();            // chunk j's stage may be refilled
  }
  if (w == 0 && live) ls[4 * sB + b] = acc + term;
}

template <class Model>
typename Model::Consts consts_of(const FwdArgs& a) {
  typename Model::Consts mc;
  for (int i = 0; i < Model::N_CONSTS; ++i) mc.c[i] = a.consts[i];
  return mc;
}

// K3 for one model, A candidates (1..MAX_A)
template <class Model>
int launch_forward(const FwdArgs& a) {
  const auto mc = consts_of<Model>(a);
  const dim3 grid((a.B + FWD_THREADS - 1) / FWD_THREADS);
  const bool emit = a.out != nullptr;
#define DDP_FWD(AA)                                                         \
  case AA:                                                                  \
    if (emit)                                                               \
      forward_kernel<Model, AA, true><<<grid, FWD_THREADS, 0, a.stream>>>(  \
          a.traj, a.s_traj, a.gains, a.s_g, a.gk, a.gK, a.x0, a.alphas,     \
          a.totals, a.terminal, a.out, a.T, a.B, a.lims, a.lims_lanes,      \
          a.params, mc);                                                    \
    else                                                                    \
      forward_kernel<Model, AA, false><<<grid, FWD_THREADS, 0, a.stream>>>( \
          a.traj, a.s_traj, a.gains, a.s_g, a.gk, a.gK, a.x0, a.alphas,     \
          a.totals, a.terminal, a.out, a.T, a.B, a.lims, a.lims_lanes,      \
          a.params, mc);                                                    \
    break;
  switch (a.A) {
    DDP_FWD(1) DDP_FWD(2) DDP_FWD(3) DDP_FWD(4)
    DDP_FWD(5) DDP_FWD(6) DDP_FWD(7) DDP_FWD(8)
    default: return ERR_ARGS;
  }
#undef DDP_FWD
  return (int)cudaGetLastError();
}

// K2 for one model, a ladder of A α values (1..MAX_A), one warp each; in
// place when a.out == a.traj
template <class Model>
int launch_linesearch(const FwdArgs& a) {
  constexpr int F = Model::N + 2 * Model::M + Model::M * Model::N;
  const RingPlan& p = a.plan;
  if (!plan_ok(p, a.B, RING_W * a.A, F, RING_W * a.A)) return ERR_ARGS;
  const auto kernel = linesearch_kernel<Model>;
  const int rc = reserve_smem(kernel, p.smem);
  if (rc != 0) return rc;
  const bool vec = rows_aligned(a.B, a.traj) && rows_aligned(a.B, a.gains);
  kernel<<<p.blocks, p.threads, p.smem, a.stream>>>(
      a.traj, a.s_traj, a.gains, a.s_g, a.gk, a.gK, a.x0, a.sel, a.ladder,
      a.rr_min, a.out, a.ls, a.T, a.B, a.lims, a.lims_lanes, a.params,
      consts_of<Model>(a), p.tc, p.stages, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// the LTI ⟨10,2⟩ instances, compiled in forward_lti.cu, the quadrotor
// ⟨6,2⟩ ones, in forward_quad.cu, and the PendCartParam ⟨4,1⟩ ones, in
// forward_pendcart_param.cu
int launch_forward_lti_10_2(const FwdArgs& a);
int launch_linesearch_lti_10_2(const FwdArgs& a);
int launch_forward_quad_6_2(const FwdArgs& a);
int launch_linesearch_quad_6_2(const FwdArgs& a);
int launch_forward_pendcart_param(const FwdArgs& a);
int launch_linesearch_pendcart_param(const FwdArgs& a);

}  // namespace ddp
