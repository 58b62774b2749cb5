// K5: the bandwidth probe. Three kernels over one (T, 47, B) f32 stream,
// each writing a (T, 27, B) stream:
//   copy   out[t][s] = in[t][s] for the first 27 slots (memory traffic only);
//   light  acc = acc + in[t][i % 47]·mult for i < 60, then all 27 output
//          slots = acc (the Qx/Qu-level work of a backward step), walking
//          t = T-1 .. 0 as the backward pass does;
//   full   the same with 600 terms a step.
// acc starts at 0 and mult is 1, passed by value so that the compiler cannot
// fold the multiply away.
//
// Replaces the TPU kernel tools/probe_kernel_cost.py::make (its three
// kinds of pallas_call, the repository's measurement probe). That probe
// never initialised its two scratch values (acc and mult); here they are
// fixed to 0 and 1.
//
// What bounds them, at B=4096, T=500: copy moves 442.4 MB (27 slots read,
// 27 written), light and full 606.2 MB (47 read, 27 written), 0.132 and
// 0.181 ms at 3.35 TB/s. full's running sum is also a chain of 600
// dependent adds a step, T steps long: ≈1.2 M cycles, ≈0.68 ms at 1.755
// GHz, which binds it before its bytes do.
//
// copy has no dependence between steps or scenarios, so it is spread over
// the whole card: a grid of up to 8 blocks an SM (the plan's), each thread
// moving 16-byte vectors (B % 4 == 0 and 16-byte aligned streams, else
// 4 bytes), PROBE_UNROLL loads in flight before their stores. light and
// full give a block 32 scenarios (128 blocks at B=4096), as K1 does: the
// 47 input slots of each chunk of tc steps, walked from t = T-1 down, are
// staged in a shared-memory ring (ring.cuh) by the plan's producer warps
// with cp.async, issued after each chunk's barrier so that the compute
// warp's chain only reads shared memory; it keeps the sum order (t from
// T-1 down, i from 0), so the output stays bit-identical to the plain
// version. The plans come from ops/hopper/plan.py::probe_plan.
//
// The floor of the (T, S, B) stream layout: this copy moves the 442.4 MB
// in 0.165 ms, ≈2.68 TB/s, 80% of the data sheet's 3.35 TB/s, where
// x[:, :27].clone() takes 0.183 ms (H100 80GB HBM3, 700 W,
// tools_torch/kernel_ab.py). The earlier design gave one thread a scenario
// in 32 blocks of 128 threads, 32 of the 132 SMs: its 0.72-0.75 ms
// (≈600 GB/s) measured that grid, not the layout.
#include "ring.cuh"

namespace ddp {

namespace {

constexpr int PROBE_S_IN = 47, PROBE_S_OUT = 27;   // JAX probe's DU and S
constexpr int PROBE_COPY_THREADS = 256;
constexpr int PROBE_COPY_BLOCKS = 8 * 132;         // 8 blocks an SM
constexpr int PROBE_UNROLL = 4;                    // vectors a thread a turn
constexpr int PROBE_MAX_THREADS = 8 * RING_W;      // ring: compute + producers

// copy: the (T·27) rows of B floats, in units of a block's PROBE_UNROLL
// vectors of each of its threads; Vec is float4 or float
template <class Vec>
__global__ void __launch_bounds__(PROBE_COPY_THREADS)
probe_copy_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int T, int B) {
  constexpr int V = sizeof(Vec) / sizeof(float);
  constexpr int SPAN = PROBE_COPY_THREADS * PROBE_UNROLL;   // vectors a unit
  const int W = B / V;                           // vectors a row
  const int per_row = (W + SPAN - 1) / SPAN;     // units a row
  const long long units = (long long)T * PROBE_S_OUT * per_row;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = (int)(u / per_row);
    const int col0 =
        (int)(u - (long long)row * per_row) * SPAN + (int)threadIdx.x;
    const int t = row / PROBE_S_OUT, s = row - t * PROBE_S_OUT;
    const Vec* src = reinterpret_cast<const Vec*>(
        in + ((size_t)t * PROBE_S_IN + s) * B);
    Vec* dst = reinterpret_cast<Vec*>(out + (size_t)row * B);
    Vec v[PROBE_UNROLL];
#pragma unroll
    for (int k = 0; k < PROBE_UNROLL; ++k) {
      const int c = col0 + k * PROBE_COPY_THREADS;
      if (c < W) v[k] = src[c];
    }
#pragma unroll
    for (int k = 0; k < PROBE_UNROLL; ++k) {
      const int c = col0 + k * PROBE_COPY_THREADS;
      if (c < W) dst[c] = v[k];
    }
  }
}

// light and full: TERMS multiply-add terms a step. Warp 0 computes; the
// plan's producer warps (warps 1..) fill the ring stages-1 chunks ahead.
// One barrier a chunk: at barrier c chunk c has landed and the compute
// warp is done with chunk c-1, whose stage the producers then refill while
// it computes chunk c.
template <int TERMS>
__global__ void __launch_bounds__(PROBE_MAX_THREADS)
probe_ring_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int T, int B, float mult, int tc, int stages, bool vec) {
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x & (RING_W - 1), w = threadIdx.x / RING_W;
  const int b0 = blockIdx.x * RING_W, b = b0 + lane;
  const int cols = min(RING_W, B - b0);
  const size_t sB = (size_t)B;
  // chunk c: steps T-1-c·tc downwards, at most tc of them
  const int nc = (T + tc - 1) / tc, stage = tc * PROBE_S_IN * RING_W;

  if (w > 0) {
    auto issue = [&](int c) {
      if (c < nc) {
        const int th = T - 1 - c * tc, steps = min(tc, th + 1);
        stage_rows<PROBE_S_IN>(
            ring + (c % stages) * stage, steps, cols, vec,
            threadIdx.x - RING_W, blockDim.x - RING_W, [&](int tt, int s) {
              return in + ((size_t)(th - tt) * PROBE_S_IN + s) * sB + b0;
            });
      }
      cp_async_commit();
    };
    for (int c = 0; c < stages - 1; ++c) issue(c);
    for (int c = 0; c < nc; ++c) {
      cp_async_wait(stages - 2);   // this thread's copies of chunk c landed
      __syncthreads();             // everyone's; chunk c-1 is consumed
      issue(c + stages - 1);       // into the stage of chunk c-1
    }
    return;
  }

  float acc = 0.0f;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();               // chunk c is ready, c-1 consumed
    const int th = T - 1 - c * tc, steps = min(tc, th + 1);
    const float* st = ring + (c % stages) * stage + lane;
    for (int tt = 0; tt < steps; ++tt) {
      const float* r = st + tt * PROBE_S_IN * RING_W;
      float x[PROBE_S_IN];
#pragma unroll
      for (int s = 0; s < PROBE_S_IN; ++s) x[s] = r[s * RING_W];
#pragma unroll
      for (int i = 0; i < TERMS; ++i) acc = acc + x[i % PROBE_S_IN] * mult;
      if (b < B) {
        float* o = out + (size_t)(th - tt) * PROBE_S_OUT * sB + b;
#pragma unroll
        for (int s = 0; s < PROBE_S_OUT; ++s) o[s * sB] = acc;
      }
    }
  }
}

// copy's plan: PROBE_COPY_THREADS threads, 1..PROBE_COPY_BLOCKS blocks, no
// ring
bool copy_plan_ok(const RingPlan& p) {
  return p.threads == PROBE_COPY_THREADS && p.blocks >= 1 &&
         p.blocks <= PROBE_COPY_BLOCKS && p.tc == 0 && p.stages == 0 &&
         p.smem == 0;
}

template <int TERMS>
int launch_ring(const float* in, float* out, int T, int B, float mult,
                const RingPlan& p, cudaStream_t st) {
  if (p.threads < 2 * RING_W || p.threads > PROBE_MAX_THREADS ||
      !plan_ok(p, B, p.threads, PROBE_S_IN, 0))
    return ERR_ARGS;
  const auto kernel = probe_ring_kernel<TERMS>;
  const int rc = reserve_smem(kernel, p.smem);
  if (rc != 0) return rc;
  const bool vec = rows_aligned(B, in);
  kernel<<<p.blocks, p.threads, p.smem, st>>>(in, out, T, B, mult, p.tc,
                                              p.stages, vec);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace ddp

// mode: 0 copy, 1 light, 2 full (probe_kernel.py MODES); the plan from
// ops/hopper/plan.py::probe_plan
extern "C" int ddp_probe_lanes(const float* in, float* out, int T, int s_in,
                               int s_out, int B, int mode, float mult,
                               int blocks, int threads, int tc, int stages,
                               int smem, int device, void* stream) {
  using namespace ddp;
  if (T < 1 || B < 1 || s_in != PROBE_S_IN || s_out != PROBE_S_OUT)
    return ERR_ARGS;
  cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RingPlan p{blocks, threads, tc, stages, smem};
  switch (mode) {
    case 0: {
      if (!copy_plan_ok(p)) return ERR_ARGS;
      if (rows_aligned(B, in) && rows_aligned(B, out))
        probe_copy_kernel<float4><<<blocks, threads, 0, st>>>(in, out, T, B);
      else
        probe_copy_kernel<float><<<blocks, threads, 0, st>>>(in, out, T, B);
      return (int)cudaGetLastError();
    }
    case 1: return launch_ring<60>(in, out, T, B, mult, p, st);
    case 2: return launch_ring<600>(in, out, T, B, mult, p, st);
    default: return ERR_ARGS;
  }
}
