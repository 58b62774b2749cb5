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
// ⟨4,1⟩ (forward.cu), LTI ⟨10,2⟩ (forward_lti.cu), LTI ⟨10,3⟩
// (forward_lti_10_3.cu), quadrotor ⟨6,2⟩
// (forward_quad.cu) and the parametrised pendcart PendCartParam ⟨4,1⟩
// (forward_pendcart_param.cu); K3 one kernel a model for any A ≤ K3_MAX_A
// with and one without the emitted stream (the wrapper launches a longer
// ladder in groups of K3_MAX_A candidates), K2 two kernels a model: one
// warp a candidate for A ≤ K2_MAX_WARPS, and K2_MAX_WARPS warps rolling
// A ≤ MAX_A candidates in rounds beyond.
//
// Layout: streams are (T, S, B) f32 with the scenario axis contiguous.
// Both kernels give a block 32 scenarios and run one warp per candidate
// (K2: one warp per candidate of a round);
// lane l is scenario 32·blockIdx.x + l, and each thread holds one
// candidate's n+2 floats. The step inputs of the block (x_old, u_nom from
// the trajectory, k, K from the gains: n+2m+mn slots) are staged in chunks
// of tc steps in a shared-memory ring of `stages` stages (ring.cuh), which
// all A warps read. K2: pass 1 runs R = ⌈A/W⌉ rounds of W = min(A,
// K2_MAX_WARPS) candidates (R = 1 up to K2_MAX_WARPS), each over the whole
// horizon, and pass 1 and pass 2 are one sequence of (R+1)·⌈T/tc⌉ chunks,
// so the ring refills for each round and prefetches pass 2's first chunks
// while pass 1 ends; every warp stages. K3: one pass of ⌈T/tc⌉ chunks, staged by two or
// more producer warps after the A candidate warps, which also store the
// emitted stream from a shared output buffer; the candidate warps touch
// device memory only for x0, α and their totals. The plans (threads, tc,
// stages, shared bytes) come from ops/hopper/plan.py.
//
// What bounds them. Pendcart at B=4096, T=500: a pass reads the x,u slots
// of the trajectory (≈41 MB) and the gain slots (≈41 MB); the line search
// writes the new [x, u, c] stream (≈49 MB): ≈131 MB, 0.039 ms at 3.35
// TB/s, against ≈40 f32 operations a scenario-step and candidate. Both put
// 128 blocks on 128 SMs and move each input byte once per pass, so a step
// costs its dependent chain of arithmetic (sinf/cosf and the divisions of
// the pendcart, the n×n product of LTI, whose zero-skipping branches cut
// it into short blocks), T steps for K3 and for K2's pass 1, T again for
// K2's pass 2, which one warp of the block rolls for its 32 scenarios. One
// warp keeps too few cp.async copies in flight to fill a chunk while the
// candidates roll the one before (measured on an H100: a K3 block with one
// producer warp took 1.5-2× as long as with two), so K3's producers are
// several and issue their copies after the chunk's barrier, off the
// candidates' path. LTI ⟨10,2⟩ at B=4096, T=1000, A=6: the line search
// reads x,u (12 slots) and k,K (22 slots) and writes 13 slots (≈770 MB)
// against ≈11 GFLOP.
//
// Semantics kept from the TPU kernels (forward_kernel.py line numbers):
// - per control, u = clip(u_nom + α·k + Σ_j K_j·(x_j − x_old_j), lo, hi)
//   in that operation order (:156-169, :454-461), with the model's
//   diff(x, x_old) in place of x − x_old where it has one (HAS_DIFF,
//   :156-159, :450-451);
// - the terminal cost is evaluated at the STORED state x[T-1], not at the
//   state after the last step (:150-151, :178-181, :475-478);
// - the accept rule at the pass boundary: ratio = dcost/expected, or
//   sign(dcost) when expected <= 0; the first α in ladder order with
//   ratio > rr_min wins; α_eff = 0 where allow = 0 (:401-436);
// - pass 2 re-rolls α_eff through the same rollout_step as pass 1 and as
//   forward_kernel, so an α=0 retrace reproduces a trajectory bit for bit;
// - lanes past B (the last block of a B that is not a multiple of 32) read
//   scenario B-1's inputs and write nothing.
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

// K2's ladder, by value: at most MAX_A α values, rolled W = min(A,
// K2_MAX_WARPS) at a time
constexpr int MAX_A = 64;
constexpr int K2_MAX_WARPS = 8;
// K3's block: at most K3_MAX_A candidate warps and its producers, at most
// K3_MAX_WARPS warps (the wrapper splits a longer ladder into launches)
constexpr int K3_MAX_A = 8;
constexpr int K3_MAX_WARPS = 10;

// K2's ladder by value: LadderN<K2_MAX_WARPS> for a single round (the
// kernel reads it by a warp's index), Ladder for rounds
template <int LA>
struct LadderN {
  float a[LA];
};
using Ladder = LadderN<MAX_A>;

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
  Ladder ladder;         // K2: the static α ladder, A ≤ MAX_A
  float rr_min;
  int A;
  float* totals;
  float* terminal;
  float* out;            // K2: == traj for the in-place update
  float* ls;
  int T, B;
  RingPlan plan;         // the launch plan (ops/hopper/plan.py)
  Lims lims;
  const float* lims_lanes;   // (2m, B) per-scenario limits, or null
  const float* params;       // (P, B) per-scenario parameters, or null
  const float* consts;   // host copy of the model descriptor
  cudaStream_t stream;
};

// the stream shapes, and an in-place K2 only on an [x, u, c] stream
inline bool stream_args_ok(const FwdArgs& a, int n, int m) {
  return a.T >= 1 && a.B >= 1 && a.s_traj >= n + m && a.gk >= 0 &&
         a.gK >= 0 && a.gk + m <= a.s_g && a.gK + m * n <= a.s_g &&
         a.A >= 1 && a.A <= MAX_A &&
         (a.out != a.traj || a.s_traj == n + m + 1);
}

// The argument checks of the K3 and K2 C entry points (ddp_forward_lanes
// and ddp_linesearch_lanes in forward.cu, and in a lowered model's library,
// lowered.cuh) and their FwdArgs; ERR_ARGS for arguments no instance takes.
inline int k3_args(const float* traj, int s_traj, const float* gains,
                   int s_g, int gk, int gK, const float* x0,
                   const float* alphas, int A, float* totals, float* terminal,
                   float* out_traj, int T, int B, const float* lims,
                   const float* lims_lanes, const float* params,
                   int n_params, int n, int m, const float* consts,
                   int blocks, int threads, int tc, int stages, int smem,
                   void* stream, FwdArgs& a) {
  if ((params != nullptr) != (n_params > 0)) return ERR_ARGS;
  a = FwdArgs{};
  a.traj = traj;
  a.s_traj = s_traj;
  a.gains = gains;
  a.s_g = s_g;
  a.gk = gk;
  a.gK = gK;
  a.x0 = x0;
  a.alphas = alphas;
  a.A = A;
  a.totals = totals;
  a.terminal = terminal;
  a.out = out_traj;
  a.T = T;
  a.B = B;
  if (!lims_from_host(lims, m, a.lims)) return ERR_ARGS;
  a.lims_lanes = lims_lanes;
  a.params = params;
  a.consts = consts;
  a.plan = RingPlan{blocks, threads, tc, stages, smem};
  a.stream = static_cast<cudaStream_t>(stream);
  if (!stream_args_ok(a, n, m) || a.out == a.traj || A > K3_MAX_A)
    return ERR_ARGS;
  return 0;
}

inline int k2_args(const float* traj, int s_traj, const float* gains,
                   int s_g, int gk, int gK, const float* x0, const float* sel,
                   const float* alphas, int A, float rr_min, float* out_traj,
                   float* ls, int T, int B, const float* lims,
                   const float* lims_lanes, const float* params,
                   int n_params, int n, int m, const float* consts,
                   int blocks, int threads, int tc, int stages, int smem,
                   void* stream, FwdArgs& a) {
  if ((params != nullptr) != (n_params > 0)) return ERR_ARGS;
  a = FwdArgs{};
  a.traj = traj;
  a.s_traj = s_traj;
  a.gains = gains;
  a.s_g = s_g;
  a.gk = gk;
  a.gK = gK;
  a.x0 = x0;
  a.sel = sel;
  a.A = A;
  for (int i = 0; i < MAX_A; ++i) a.ladder.a[i] = i < A ? alphas[i] : 0.0f;
  a.rr_min = rr_min;
  a.out = out_traj;
  a.ls = ls;
  a.T = T;
  a.B = B;
  if (!lims_from_host(lims, m, a.lims)) return ERR_ARGS;
  a.lims_lanes = lims_lanes;
  a.params = params;
  a.consts = consts;
  a.plan = RingPlan{blocks, threads, tc, stages, smem};
  a.stream = static_cast<cudaStream_t>(stream);
  if (!stream_args_ok(a, n, m)) return ERR_ARGS;
  return 0;
}

namespace {

// ring slots of a step: [x_old, u_nom, k, K] (a variable template: device
// code may not call a constexpr host function)
template <class Model>
constexpr int STEP_SLOTS = Model::N + 2 * Model::M + Model::M * Model::N;

// A model whose step slots outgrow a block (plan.py::_k23_plan): the most
// floats K2 or K3 keep after a ring of one step a chunk (K2's MAX_A
// totals, K3's output buffer); K23_WIDE where two stages of one step and
// those may not fit, so that the plan may take one stage; K23_DIRECT
// where one does not fit either (plan.py::k23_direct, from ⟨64,14⟩): the
// ring then holds [x_old, u_nom, k] alone and each candidate reads its K
// row from device memory. Both false for every model of the kernel
// library, whose code they leave as it was.
template <class Model>
constexpr long long K23_EXTRA =
    RING_W * MAX_A > 2 * (Model::N + Model::M + 1) * RING_W
        ? RING_W * MAX_A
        : 2 * (Model::N + Model::M + 1) * RING_W;
template <class Model>
constexpr bool K23_WIDE =
    4LL * (2LL * STEP_SLOTS<Model> * RING_W + K23_EXTRA<Model>) > MAX_SMEM;
template <class Model>
constexpr bool K23_DIRECT =
    4LL * ((long long)STEP_SLOTS<Model> * RING_W + K23_EXTRA<Model>) >
    MAX_SMEM;
// the ring's slots a step
template <class Model>
constexpr int RING_SLOTS =
    K23_DIRECT<Model> ? Model::N + 2 * Model::M : STEP_SLOTS<Model>;

// one step's inputs: K as an array, or for a wide model a pointer to its
// rows (in the ring, or with K23_DIRECT in device memory) and their stride
template <class Model, bool WIDE = K23_WIDE<Model>>
struct StepIn {
  float x_old[Model::N], u_nom[Model::M], k[Model::M];
  float K[Model::M][Model::N];
};
template <class Model>
struct StepIn<Model, true> {
  float x_old[Model::N], u_nom[Model::M], k[Model::M];
  const float* Kp;
  size_t ks;
  __device__ __forceinline__ float Kv(int mi, int j) const {
    return Kp[(size_t)(mi * Model::N + j) * ks];
  }
};

// slot s of step t of the ring's input, at column 0, in device memory: the
// trajectory's x, u slots, then the gains' k and K slots
template <class Model>
__device__ __forceinline__ const float* step_row(const float* traj,
                                                 int s_traj,
                                                 const float* gains, int s_g,
                                                 int gk, int gK, size_t t,
                                                 int s, size_t sB) {
  constexpr int N = Model::N, M = Model::M;
  return s < N + M ? traj + (t * s_traj + s) * sB
         : s < N + 2 * M ? gains + (t * s_g + gk + (s - N - M)) * sB
                         : gains + (t * s_g + gK + (s - N - 2 * M)) * sB;
}

// one step's inputs from the ring: r points at this lane's column of the
// step's first slot
template <class Model>
__device__ __forceinline__ void ring_step(const float* r, StepIn<Model>& s) {
  constexpr int N = Model::N, M = Model::M;
DDP_UNROLL
  for (int i = 0; i < N; ++i) s.x_old[i] = r[i * RING_W];
DDP_UNROLL
  for (int mi = 0; mi < M; ++mi) {
    s.u_nom[mi] = r[(N + mi) * RING_W];
    s.k[mi] = r[(N + M + mi) * RING_W];
DDP_UNROLL
    for (int j = 0; j < N; ++j)
      s.K[mi][j] = r[(N + 2 * M + mi * N + j) * RING_W];
  }
}

// a wide model's step (K23_WIDE): x_old, u_nom and k from the ring, K read
// where it lies: after them in the ring, or with K23_DIRECT at step t of
// the gains stream, column bl
template <class Model>
__device__ __forceinline__ void ring_step_wide(
    const float* r, StepIn<Model, true>& s, const float* __restrict__ gains,
    int s_g, int gK, int t, int bl, size_t sB) {
  constexpr int N = Model::N, M = Model::M;
DDP_UNROLL
  for (int i = 0; i < N; ++i) s.x_old[i] = r[i * RING_W];
DDP_UNROLL
  for (int mi = 0; mi < M; ++mi) {
    s.u_nom[mi] = r[(N + mi) * RING_W];
    s.k[mi] = r[(N + M + mi) * RING_W];
  }
  if constexpr (K23_DIRECT<Model>) {
    s.Kp = gains + ((size_t)t * s_g + gK) * sB + bl;
    s.ks = sB;
  } else {
    s.Kp = r + (N + 2 * M) * RING_W;
    s.ks = RING_W;
  }
}

// step t's inputs at ring row r for any model
template <class Model>
__device__ __forceinline__ void step_in(const float* r, StepIn<Model>& s,
                                        const float* __restrict__ gains,
                                        int s_g, int gK, int t, int bl,
                                        size_t sB) {
  if constexpr (K23_WIDE<Model>) {
    ring_step_wide<Model>(r, s, gains, s_g, gK, t, bl, sB);
  } else {
    ring_step<Model>(r, s);
  }
}

// one rollout step t (the logical step 0…T-1, which the model's dynamics
// and cost may read) of one candidate: control law, running cost, terminal
// cost at the stored last state, model step
template <class Model>
__device__ __forceinline__ void rollout_step(
    const Model& P, float (&x)[Model::N], float& acc, float& term,
    float alpha, const StepIn<Model>& s, const Lims& lims, int t, bool last,
    float (&u)[Model::M], float& c_out) {
  constexpr int N = Model::N, M = Model::M;
  float dx[N];
  if constexpr (Model::HAS_DIFF) {
    P.diff(x, s.x_old, dx);
  } else {
DDP_UNROLL
    for (int j = 0; j < N; ++j) dx[j] = x[j] - s.x_old[j];
  }
DDP_UNROLL
  for (int mi = 0; mi < M; ++mi) {
    float v = s.u_nom[mi] + alpha * s.k[mi];
    if constexpr (K23_WIDE<Model>) {
DDP_UNROLL
      for (int j = 0; j < N; ++j) v = v + s.Kv(mi, j) * dx[j];
    } else {
DDP_UNROLL
      for (int j = 0; j < N; ++j) v = v + s.K[mi][j] * dx[j];
    }
    u[mi] = clipp(v, lims.lo[mi], lims.hi[mi]);
  }
  const float c = P.cost(x, u, t);
  if (last) term = P.terminal(x);
  float xn[N];
  P.dynamics(x, u, t, xn);
DDP_UNROLL
  for (int i = 0; i < N; ++i) x[i] = xn[i];
  acc = acc + c;
  c_out = c;
}

// K3. Block: 32 scenarios × A candidate warps (warp a rolls candidate a,
// alphas[a]), then the plan's producer warps, which alone move data
// between device memory and shared memory. One barrier a chunk: at barrier
// c chunk c has landed and every candidate warp is done with chunk c-1,
// whose stage the producers then refill with chunk c+stages-1 while the
// candidates roll chunk c, so that the copies never hold the candidates
// up. With EMIT, warp 0 writes each step's [x, u, c] into a shared output
// buffer of two chunks after the ring, [2][tc][SO][32], and the producers
// store chunk c-1's half to device memory after barrier c (one more
// barrier after the last chunk), 16 bytes a store where ovec.
template <class Model, bool EMIT>
__global__ void __launch_bounds__(RING_W * K3_MAX_WARPS)
forward_kernel(const float* __restrict__ traj, int s_traj,
               const float* __restrict__ gains, int s_g, int gk, int gK,
               const float* __restrict__ x0, const float* __restrict__ alphas,
               float* __restrict__ totals, float* __restrict__ terminal,
               float* __restrict__ out, int T, int B, int A, Lims lims,
               const float* __restrict__ lims_lanes,
               const float* __restrict__ params, typename Model::Consts mc,
               int tc, int stages, bool vec, bool ovec) {
  constexpr int N = Model::N, M = Model::M;
  constexpr int SO = N + M + 1;   // output slots [x, u, c]
  constexpr int F = RING_SLOTS<Model>;
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x & (RING_W - 1), w = threadIdx.x / RING_W;
  const int b0 = blockIdx.x * RING_W, b = b0 + lane;
  const int cols = min(RING_W, B - b0);
  const int nc = (T + tc - 1) / tc;          // chunks
  const int stage = tc * F * RING_W;         // floats a stage
  float* const obuf = ring + stages * stage;     // EMIT: [2][tc][SO][32]
  const int ostage = tc * SO * RING_W;

  if (w >= A) {
    // a producer: keeps stages-1 chunks in flight ahead of the candidates
    const int tid = threadIdx.x - RING_W * A;
    const int nthr = blockDim.x - RING_W * A;
    auto issue = [&](int c) {
      if (c < nc) {
        const int t0 = c * tc, steps = min(tc, T - t0);
        stage_rows<F>(ring + (c % stages) * stage, steps, cols, vec, tid,
                      nthr, [&](int tt, int s) {
                        return step_row<Model>(traj, s_traj, gains, s_g, gk,
                                               gK, (size_t)(t0 + tt), s,
                                               (size_t)B) +
                               b0;
                      });
      }
      cp_async_commit();
    };
    // chunk c's emitted steps, from its half of the output buffer
    auto flush = [&](int c) {
      const int t0 = c * tc, steps = min(tc, T - t0);
      const float* src = obuf + (c & 1) * ostage;
      float* dst = out + (size_t)t0 * SO * B + b0;
      if (ovec) {
        for (int i = tid; i < steps * SO * (RING_W / 4); i += nthr) {
          const int row = i >> 3, p = 4 * (i & 7);
          if (p < cols)
            *reinterpret_cast<float4*>(dst + (size_t)row * B + p) =
                *reinterpret_cast<const float4*>(src + row * RING_W + p);
        }
      } else {
        for (int i = tid; i < steps * SO * RING_W; i += nthr) {
          const int row = i >> 5, col = i & 31;
          if (col < cols) dst[(size_t)row * B + col] = src[i];
        }
      }
    };
    if constexpr (K23_WIDE<Model>) {
      if (stages == 1) {
        // one stage: chunk c is copied once chunk c-1 is consumed, two
        // barriers a chunk (the candidates' too)
        for (int c = 0; c < nc + EMIT; ++c) {
          __syncthreads();         // chunk c-1 is consumed
          if (EMIT && c > 0) flush(c - 1);
          if (c < nc) {
            issue(c);
            cp_async_wait(0);
            __syncthreads();       // chunk c is ready
          }
        }
        return;
      }
    }
    for (int c = 0; c < stages - 1; ++c) issue(c);
    for (int c = 0; c < nc + EMIT; ++c) {
      if (c < nc) cp_async_wait(stages - 2);   // chunk c landed
      __syncthreads();             // everyone's; chunk c-1 is consumed
      if (c < nc) issue(c + stages - 1);       // into chunk c-1's stage
      if (EMIT && c > 0) flush(c - 1);
    }
    return;
  }

  const bool live = b < B;
  // a lane past B reads scenario B-1's inputs and drops its results
  const int bl = live ? b : B - 1;
  const size_t sB = (size_t)B;
  const Model P = make_model<Model>(mc, params, bl, sB);
  const Lims lm = lane_lims<M>(lims, lims_lanes, bl, sB);
  const float alpha = alphas[w * sB + bl];
  float x[N], acc = 0.0f, term = 0.0f;
DDP_UNROLL
  for (int i = 0; i < N; ++i) x[i] = x0[i * sB + bl];

  for (int c = 0; c < nc; ++c) {
    if constexpr (K23_WIDE<Model>) {
      if (stages == 1) __syncthreads();   // chunk c-1 is consumed
    }
    __syncthreads();               // chunk c is ready, c-1 consumed
    const int t0 = c * tc, steps = min(tc, T - t0);
    const float* st = ring + (c % stages) * stage + lane;
    float* ob = obuf + (c & 1) * ostage + lane;
    for (int tt = 0; tt < steps; ++tt) {
      const int t = t0 + tt;
      StepIn<Model> s;
      step_in<Model>(st + tt * F * RING_W, s, gains, s_g, gK, t, bl, sB);
      const bool put = EMIT && w == 0;
      float* o = ob + tt * SO * RING_W;
      if (put) {
DDP_UNROLL
        for (int i = 0; i < N; ++i) o[i * RING_W] = x[i];
      }
      float u[M], cst;
      rollout_step<Model>(P, x, acc, term, alpha, s, lm, t, t == T - 1, u,
                          cst);
      if (put) {
DDP_UNROLL
        for (int mi = 0; mi < M; ++mi) o[(N + mi) * RING_W] = u[mi];
        o[(N + M) * RING_W] = cst;
      }
    }
  }
  if (EMIT) __syncthreads();       // the last chunk's output is complete
  if (live) {
    totals[w * sB + b] = acc + term;
    terminal[w * sB + b] = term;
  }
}

// K2 with a fresh output, or in place: out == traj, and x0 may be a view
// of the same stream, so these three are not __restrict__. Block: 32
// scenarios × W warps (W = blockDim.x / 32); dynamic shared memory: the
// ring, then the A×32 candidate totals. ROUNDS false: one warp a
// candidate, A = W ≤ K2_MAX_WARPS, pass 1 in one round. ROUNDS true: A >
// K2_MAX_WARPS candidates in R = ⌈A/W⌉ rounds, warp w rolling candidate
// r·W + w in round r (none past A), the ring refilled for each round.
template <class Model, bool ROUNDS, class L>
__device__ __forceinline__ void linesearch_body(
    const float* traj, int s_traj, const float* __restrict__ gains, int s_g,
    int gk, int gK, const float* x0, const float* __restrict__ sel,
    const L& ladder, int A_ladder, float rr_min, float* out,
    float* __restrict__ ls, int T, int B, const Lims& lims,
    const float* __restrict__ lims_lanes, const float* __restrict__ params,
    const typename Model::Consts& mc, int tc, int stages, bool vec) {
  constexpr int N = Model::N, M = Model::M;
  constexpr int SO = N + M + 1;
  constexpr int F = RING_SLOTS<Model>;
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x & (RING_W - 1), w = threadIdx.x / RING_W;
  const int W = blockDim.x / RING_W;
  const int A = ROUNDS ? A_ladder : W;
  const int b0 = blockIdx.x * RING_W, b = b0 + lane;
  const int cols = min(RING_W, B - b0);
  const bool live = b < B;
  // a lane past B reads scenario B-1's inputs and drops its results
  const int bl = live ? b : B - 1;
  const size_t sB = (size_t)B;
  const Model P = make_model<Model>(mc, params, bl, sB);
  const Lims lm = lane_lims<M>(lims, lims_lanes, bl, sB);
  const int nc = (T + tc - 1) / tc;          // chunks a pass (a round)
  const int n1 = ROUNDS ? (A + W - 1) / W * nc : nc;   // chunks of pass 1
  const int stage = tc * F * RING_W;         // floats a stage
  float* tot = ring + stages * stage;        // [A][32] pass-1 totals

  // chunk j of the sequence: pass 1 (its round j / nc) while j < n1, then
  // pass 2; steps from (j % nc)·tc
  auto issue = [&](int j) {
    if (j < n1 + nc) {
      const int t0 = (j % nc) * tc, steps = min(tc, T - t0);
      stage_rows<F>(ring + (j % stages) * stage, steps, cols, vec,
                    threadIdx.x, blockDim.x, [&](int tt, int s) {
                      return step_row<Model>(traj, s_traj, gains, s_g, gk,
                                             gK, (size_t)(t0 + tt), s, sB) +
                             b0;
                    });
    }
    cp_async_commit();
  };

  // pass 1: warp w rolls candidate cand = r·W + w of the ladder in round r
  int cand = w;
  float x[N], acc = 0.0f, term = 0.0f, alpha = ladder.a[w];
DDP_UNROLL
  for (int i = 0; i < N; ++i) x[i] = x0[i * sB + bl];

  for (int j = 0; j < stages - 1; ++j) issue(j);
  for (int j = 0; j < n1 + nc; ++j) {
    issue(j + stages - 1);      // into the stage consumed at chunk j-1
    cp_async_wait(stages - 1);  // this thread's copies of chunk j landed
    __syncthreads();            // and everyone's
    const bool pass2 = j >= n1;
    if (ROUNDS && !pass2 && j > 0 && j % nc == 0) {
      // the next round: this warp's next candidate, from x0
      cand += W;
      alpha = cand < A ? ladder.a[cand] : 0.0f;
DDP_UNROLL
      for (int i = 0; i < N; ++i) x[i] = x0[i * sB + bl];
      acc = 0.0f;
      term = 0.0f;
    }
    if (j == n1 && w == 0) {
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
DDP_UNROLL
      for (int i = 0; i < N; ++i) x[i] = x0[i * sB + bl];
      acc = 0.0f;
      term = 0.0f;
    }
    if (pass2 ? w == 0 : (!ROUNDS || cand < A)) {
      const int t0 = (ROUNDS ? j % nc : pass2 ? j - nc : j) * tc;
      const int steps = min(tc, T - t0);
      const float* st = ring + (j % stages) * stage + lane;
      for (int tt = 0; tt < steps; ++tt) {
        const int t = t0 + tt;
        StepIn<Model> s;
        step_in<Model>(st + tt * F * RING_W, s, gains, s_g, gK, t, bl, sB);
        float* o = out + (size_t)t * SO * sB + b;
        if (pass2 && live) {
DDP_UNROLL
          for (int i = 0; i < N; ++i) o[i * sB] = x[i];
        }
        float u[M], c;
        rollout_step<Model>(P, x, acc, term, alpha, s, lm, t, t == T - 1, u,
                            c);
        if (pass2 && live) {
DDP_UNROLL
          for (int mi = 0; mi < M; ++mi) o[(N + mi) * sB] = u[mi];
          o[(N + M) * sB] = c;
        }
      }
      if (!pass2 && (ROUNDS ? j % nc == nc - 1 : j == nc - 1))
        tot[cand * RING_W + lane] = acc + term;
    }
    __syncthreads();            // chunk j's stage may be refilled
  }
  if (w == 0 && live) ls[4 * sB + b] = acc + term;
}

// K2 at A ≤ K2_MAX_WARPS: one warp a candidate (A = blockDim.x / 32)
template <class Model>
__global__ void __launch_bounds__(RING_W * K2_MAX_WARPS)
linesearch_kernel(const float* traj, int s_traj,
                  const float* __restrict__ gains, int s_g, int gk, int gK,
                  const float* x0, const float* __restrict__ sel,
                  LadderN<K2_MAX_WARPS> ladder, float rr_min, float* out,
                  float* __restrict__ ls, int T, int B, Lims lims,
                  const float* __restrict__ lims_lanes,
                  const float* __restrict__ params,
                  typename Model::Consts mc, int tc, int stages, bool vec) {
  linesearch_body<Model, false>(traj, s_traj, gains, s_g, gk, gK, x0, sel,
                                ladder, 0, rr_min, out, ls, T, B, lims,
                                lims_lanes, params, mc, tc, stages, vec);
}

// K2 at K2_MAX_WARPS < A ≤ MAX_A: K2_MAX_WARPS warps in rounds
template <class Model>
__global__ void __launch_bounds__(RING_W * K2_MAX_WARPS)
linesearch_rounds_kernel(const float* traj, int s_traj,
                         const float* __restrict__ gains, int s_g, int gk,
                         int gK, const float* x0,
                         const float* __restrict__ sel, Ladder ladder, int A,
                         float rr_min, float* out, float* __restrict__ ls,
                         int T, int B, Lims lims,
                         const float* __restrict__ lims_lanes,
                         const float* __restrict__ params,
                         typename Model::Consts mc, int tc, int stages,
                         bool vec) {
  linesearch_body<Model, true>(traj, s_traj, gains, s_g, gk, gK, x0, sel,
                               ladder, A, rr_min, out, ls, T, B, lims,
                               lims_lanes, params, mc, tc, stages, vec);
}

template <class Model>
typename Model::Consts consts_of(const FwdArgs& a) {
  typename Model::Consts mc;
  for (int i = 0; i < Model::N_CONSTS; ++i) mc.c[i] = a.consts[i];
  return mc;
}

// K3 for one model, A candidates (1..K3_MAX_A), with the wrapper's plan:
// 32·A threads and at least one producer warp, K3_MAX_WARPS warps at most
template <class Model>
int launch_forward(const FwdArgs& a) {
  const RingPlan& p = a.plan;
  const int warps = p.threads / RING_W;
  const bool emit = a.out != nullptr;
  // with emission, the output buffer of two chunks after the ring
  const int extra = emit ? 2 * p.tc * (Model::N + Model::M + 1) * RING_W : 0;
  if (warps <= a.A || warps > K3_MAX_WARPS ||
      !plan_ok(p, a.B, RING_W * warps, RING_SLOTS<Model>, extra))
    return ERR_ARGS;
  const auto kernel = emit ? forward_kernel<Model, true>
                           : forward_kernel<Model, false>;
  const int rc = reserve_smem(kernel, p.smem);
  if (rc != 0) return rc;
  const bool vec = rows_aligned(a.B, a.traj) && rows_aligned(a.B, a.gains);
  kernel<<<p.blocks, p.threads, p.smem, a.stream>>>(
      a.traj, a.s_traj, a.gains, a.s_g, a.gk, a.gK, a.x0, a.alphas,
      a.totals, a.terminal, a.out, a.T, a.B, a.A, a.lims, a.lims_lanes,
      a.params, consts_of<Model>(a), p.tc, p.stages, vec,
      emit && rows_aligned(a.B, a.out));
  return (int)cudaGetLastError();
}

// K2 for one model, a ladder of A α values (1..MAX_A): one warp each up to
// K2_MAX_WARPS, else K2_MAX_WARPS warps rolling them in rounds; in place
// when a.out == a.traj
template <class Model>
int launch_linesearch(const FwdArgs& a) {
  const RingPlan& p = a.plan;
  const bool rounds = a.A > K2_MAX_WARPS;
  if (!plan_ok(p, a.B, RING_W * (rounds ? K2_MAX_WARPS : a.A),
               RING_SLOTS<Model>, RING_W * a.A))
    return ERR_ARGS;
  const bool vec = rows_aligned(a.B, a.traj) && rows_aligned(a.B, a.gains);
  if (rounds) {
    const auto kernel = linesearch_rounds_kernel<Model>;
    const int rc = reserve_smem(kernel, p.smem);
    if (rc != 0) return rc;
    kernel<<<p.blocks, p.threads, p.smem, a.stream>>>(
        a.traj, a.s_traj, a.gains, a.s_g, a.gk, a.gK, a.x0, a.sel, a.ladder,
        a.A, a.rr_min, a.out, a.ls, a.T, a.B, a.lims, a.lims_lanes,
        a.params, consts_of<Model>(a), p.tc, p.stages, vec);
  } else {
    const auto kernel = linesearch_kernel<Model>;
    const int rc = reserve_smem(kernel, p.smem);
    if (rc != 0) return rc;
    LadderN<K2_MAX_WARPS> first;
    for (int i = 0; i < K2_MAX_WARPS; ++i) first.a[i] = a.ladder.a[i];
    kernel<<<p.blocks, p.threads, p.smem, a.stream>>>(
        a.traj, a.s_traj, a.gains, a.s_g, a.gk, a.gK, a.x0, a.sel, first,
        a.rr_min, a.out, a.ls, a.T, a.B, a.lims, a.lims_lanes, a.params,
        consts_of<Model>(a), p.tc, p.stages, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// the LTI ⟨10,2⟩ instances, compiled in forward_lti.cu, the LTI ⟨10,3⟩
// ones, in forward_lti_10_3.cu, the quadrotor ⟨6,2⟩ ones, in
// forward_quad.cu, and the PendCartParam ⟨4,1⟩ ones, in
// forward_pendcart_param.cu
int launch_forward_lti_10_2(const FwdArgs& a);
int launch_linesearch_lti_10_2(const FwdArgs& a);
int launch_forward_lti_10_3(const FwdArgs& a);
int launch_linesearch_lti_10_3(const FwdArgs& a);
int launch_forward_quad_6_2(const FwdArgs& a);
int launch_linesearch_quad_6_2(const FwdArgs& a);
int launch_forward_pendcart_param(const FwdArgs& a);
int launch_linesearch_pendcart_param(const FwdArgs& a);

}  // namespace ddp
