// K3: multi-α forward rollout, and K2: fused line search.
//
// Replace the TPU kernels
//   differentialdynamicprogramming_jl_tpu/ops/pallas/forward_kernel.py
//   ::forward_lanes (built by ::_make_kernel)        -> forward_kernel
//   ::linesearch_lanes (built by ::_make_fused_kernel) -> linesearch_kernel
// for the pendcart model with static control limits. Without limits the
// wrapper passes lo = -inf, hi = +inf: the NaN-keeping clipp then returns
// its input unchanged, as the JAX rollout's missing clamp does.
//
// Layout: streams are (T, S, B) f32 with the scenario axis contiguous; one
// thread owns one scenario and walks t = 0 .. T-1, holding the A candidate
// states (A·(n+2) floats) in registers where the TPU kept them in VMEM
// scratch. A is bounded by MAX_A and checked by the launcher.
//
// What bounds them: at B=4096, T=500 a pass reads the x,u slots of the
// trajectory (≈41 MB) and the gain slots (≈41 MB); the line search reads
// both twice (pass 2 re-reads the same input, mostly from the 50 MB L2) and
// writes the new [x, u, c] stream (≈49 MB). The arithmetic per
// scenario-step is small, so these kernels are memory- or latency-bound. At
// B=4096 the grid is 32 blocks of 128 threads for 132 SMs: one warp per SM,
// nothing hides the per-step load latency. Raising occupancy and
// prefetching the next step are work for later changes.
//
// Semantics kept from the TPU kernels (forward_kernel.py line numbers):
// - u = clip(u_nom + α·k + Σ_j K_j·(x_j − x_old_j)) in that operation order
//   (:156-169, :454-461);
// - the terminal cost is evaluated at the STORED state x[T-1], not at the
//   state after the last step (:150-151, :178-181, :475-478);
// - the accept rule at the pass boundary: ratio = dcost/expected, or
//   sign(dcost) when expected <= 0; the first α in ladder order with
//   ratio > rr_min wins; α_eff = 0 where allow = 0 (:401-436);
// - pass 2 re-rolls α_eff through the same rollout_step as pass 1 and as
//   forward_kernel, so an α=0 retrace reproduces a trajectory bit for bit.
// Not kept: the TPU line search aliased its output with the trajectory
// input and emitted an echo of the input x,u slots, both only to avoid
// XLA while-loop carry copies (:599-611, :136-146). Here the kernel writes a
// fresh output buffer and the solve loop keeps the previous stream alive as
// the backward replay's input, so no echo is written.
#include "pendcart.cuh"

namespace ddp {

namespace {

constexpr int N = PendCart::N;
constexpr int THREADS = 128;
constexpr int MAX_A = 8;

struct Ladder {
  float a[MAX_A];
};

// one rollout step of one candidate: control law, running cost, terminal
// cost at the stored last state, Euler step
__device__ __forceinline__ void rollout_step(
    const PendCart& P, float (&x)[N], float& acc, float& term, float alpha,
    const float (&x_old)[N], float u_nom, float k, const float (&K)[N],
    float lo, float hi, bool last, float& u_out, float& c_out) {
  float v = u_nom + alpha * k;
#pragma unroll
  for (int j = 0; j < N; ++j) v = v + K[j] * (x[j] - x_old[j]);
  v = clipp(v, lo, hi);
  const float c = P.cost(x, v);
  if (last) term = P.terminal(x);
  float xn[N];
  P.dynamics(x, v, xn);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xn[i];
  acc = acc + c;
  u_out = v;
  c_out = c;
}

struct StepIn {
  float x_old[N], u_nom, k, K[N];
};

__device__ __forceinline__ void load_step(const float* __restrict__ traj,
                                          int s_traj,
                                          const float* __restrict__ gains,
                                          int s_g, int gk, int gK, int t,
                                          int b, size_t sB, StepIn& s) {
  const float* tr = traj + (size_t)t * s_traj * sB + b;
  const float* gn = gains + (size_t)t * s_g * sB + b;
#pragma unroll
  for (int i = 0; i < N; ++i) s.x_old[i] = tr[i * sB];
  s.u_nom = tr[N * sB];
  s.k = gn[gk * sB];
#pragma unroll
  for (int j = 0; j < N; ++j) s.K[j] = gn[(gK + j) * sB];
}

template <int A, bool EMIT>
__global__ void __launch_bounds__(THREADS)
forward_kernel(const float* __restrict__ traj, int s_traj,
               const float* __restrict__ gains, int s_g, int gk, int gK,
               const float* __restrict__ x0, const float* __restrict__ alphas,
               float* __restrict__ totals, float* __restrict__ terminal,
               float* __restrict__ out, int T, int B, float lo, float hi,
               ModelConsts mc) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const PendCart P(mc);
  const size_t sB = (size_t)B;
  constexpr int SO = N + 2;   // output slots [x, u, c]
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
    StepIn s;
    load_step(traj, s_traj, gains, s_g, gk, gK, t, b, sB, s);
    const bool last = t == T - 1;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float xs[N];
#pragma unroll
      for (int i = 0; i < N; ++i) xs[i] = x[a][i];
      float u, c;
      rollout_step(P, x[a], acc[a], term[a], al[a], s.x_old, s.u_nom, s.k,
                   s.K, lo, hi, last, u, c);
      if (EMIT && a == 0) {
        float* o = out + (size_t)t * SO * sB + b;
#pragma unroll
        for (int i = 0; i < N; ++i) o[i * sB] = xs[i];
        o[N * sB] = u;
        o[(N + 1) * sB] = c;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    totals[a * sB + b] = acc[a] + term[a];
    terminal[a * sB + b] = term[a];
  }
}

template <int A>
__global__ void __launch_bounds__(THREADS)
linesearch_kernel(const float* __restrict__ traj, int s_traj,
                  const float* __restrict__ gains, int s_g, int gk, int gK,
                  const float* __restrict__ x0, const float* __restrict__ sel,
                  Ladder ladder, float rr_min, float* __restrict__ out,
                  float* __restrict__ ls, int T, int B, float lo, float hi,
                  ModelConsts mc) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const PendCart P(mc);
  const size_t sB = (size_t)B;
  constexpr int SO = N + 2;

  // pass 1: every candidate of the ladder
  float x[A][N], acc[A], term[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[a][i] = x0[i * sB + b];
    acc[a] = 0.0f;
    term[a] = 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    StepIn s;
    load_step(traj, s_traj, gains, s_g, gk, gK, t, b, sB, s);
    const bool last = t == T - 1;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float u, c;
      rollout_step(P, x[a], acc[a], term[a], ladder.a[a], s.x_old, s.u_nom,
                   s.k, s.K, lo, hi, last, u, c);
    }
  }

  // pass boundary: the accept decision (src/iLQG.jl:269-280)
  const float dv1 = sel[b], dv2 = sel[sB + b];
  const float ctot = sel[2 * sB + b], allow = sel[3 * sB + b];
  float al_sel = 0.0f, dc_sel = 0.0f, rt_sel = 0.0f;
  bool found = false;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float al = ladder.a[a];
    const float tot = acc[a] + term[a];
    const float dcost = ctot - tot;
    const float expected = (-al) * (dv1 + al * dv2);
    const float ratio = expected > 0.0f ? dcost / expected : signp(dcost);
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
  const float al_eff = (found && allow > 0.5f) ? al_sel : 0.0f;
  ls[b] = al_sel;
  ls[sB + b] = found ? 1.0f : 0.0f;
  ls[2 * sB + b] = dc_sel;
  ls[3 * sB + b] = rt_sel;

  // pass 2: re-roll α_eff and write the new [x, u, c] stream
  float xe[N], acc_e = 0.0f, term_e = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) xe[i] = x0[i * sB + b];
  for (int t = 0; t < T; ++t) {
    StepIn s;
    load_step(traj, s_traj, gains, s_g, gk, gK, t, b, sB, s);
    float* o = out + (size_t)t * SO * sB + b;
#pragma unroll
    for (int i = 0; i < N; ++i) o[i * sB] = xe[i];
    float u, c;
    rollout_step(P, xe, acc_e, term_e, al_eff, s.x_old, s.u_nom, s.k, s.K,
                 lo, hi, t == T - 1, u, c);
    o[N * sB] = u;
    o[(N + 1) * sB] = c;
  }
  ls[4 * sB + b] = acc_e + term_e;
}

template <int A>
void launch_forward(bool emit, dim3 grid, cudaStream_t st, const float* traj,
                    int s_traj, const float* gains, int s_g, int gk, int gK,
                    const float* x0, const float* alphas, float* totals,
                    float* terminal, float* out, int T, int B, float lo,
                    float hi, const ModelConsts& mc) {
  if (emit)
    forward_kernel<A, true><<<grid, THREADS, 0, st>>>(
        traj, s_traj, gains, s_g, gk, gK, x0, alphas, totals, terminal, out,
        T, B, lo, hi, mc);
  else
    forward_kernel<A, false><<<grid, THREADS, 0, st>>>(
        traj, s_traj, gains, s_g, gk, gK, x0, alphas, totals, terminal, out,
        T, B, lo, hi, mc);
}

bool stream_args_ok(int T, int B, int s_traj, int s_g, int gk, int gK) {
  return T >= 1 && B >= 1 && s_traj >= N + 1 && gk >= 0 && gK >= 0 &&
         gk < s_g && gK + N <= s_g;
}

}  // namespace

}  // namespace ddp

extern "C" int ddp_forward_lanes(const float* traj, int s_traj,
                                 const float* gains, int s_g, int gk, int gK,
                                 const float* x0, const float* alphas, int A,
                                 float* totals, float* terminal,
                                 float* out_traj, int T, int B, float lim_lo,
                                 float lim_hi, int model_id,
                                 const float* consts, int device,
                                 void* stream) {
  using namespace ddp;
  if (model_id != MODEL_PENDCART) return ERR_MODEL;
  if (!stream_args_ok(T, B, s_traj, s_g, gk, gK) || A < 1 || A > MAX_A)
    return ERR_ARGS;
  cudaSetDevice(device);
  ModelConsts mc;
  for (int i = 0; i < N_CONSTS; ++i) mc.c[i] = consts[i];
  const dim3 grid((B + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool emit = out_traj != nullptr;
#define DDP_FWD(AA)                                                          \
  case AA:                                                                   \
    launch_forward<AA>(emit, grid, st, traj, s_traj, gains, s_g, gk, gK, x0, \
                       alphas, totals, terminal, out_traj, T, B, lim_lo,     \
                       lim_hi, mc);                                          \
    break;
  switch (A) {
    DDP_FWD(1) DDP_FWD(2) DDP_FWD(3) DDP_FWD(4)
    DDP_FWD(5) DDP_FWD(6) DDP_FWD(7) DDP_FWD(8)
  }
#undef DDP_FWD
  return (int)cudaGetLastError();
}

extern "C" int ddp_linesearch_lanes(const float* traj, int s_traj,
                                    const float* gains, int s_g, int gk,
                                    int gK, const float* x0, const float* sel,
                                    const float* alphas, int A, float rr_min,
                                    float* out_traj, float* ls, int T, int B,
                                    float lim_lo, float lim_hi, int model_id,
                                    const float* consts, int device,
                                    void* stream) {
  using namespace ddp;
  if (model_id != MODEL_PENDCART) return ERR_MODEL;
  if (!stream_args_ok(T, B, s_traj, s_g, gk, gK) || A < 1 || A > MAX_A)
    return ERR_ARGS;
  cudaSetDevice(device);
  ModelConsts mc;
  for (int i = 0; i < N_CONSTS; ++i) mc.c[i] = consts[i];
  Ladder ladder;
  for (int a = 0; a < MAX_A; ++a) ladder.a[a] = a < A ? alphas[a] : 0.0f;
  const dim3 grid((B + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DDP_LS(AA)                                                          \
  case AA:                                                                  \
    linesearch_kernel<AA><<<grid, THREADS, 0, st>>>(                        \
        traj, s_traj, gains, s_g, gk, gK, x0, sel, ladder, rr_min,          \
        out_traj, ls, T, B, lim_lo, lim_hi, mc);                            \
    break;
  switch (A) {
    DDP_LS(1) DDP_LS(2) DDP_LS(3) DDP_LS(4)
    DDP_LS(5) DDP_LS(6) DDP_LS(7) DDP_LS(8)
  }
#undef DDP_LS
  return (int)cudaGetLastError();
}
