// K5: the bandwidth-floor probe. Three kernels over one (T, 47, B) f32
// stream, walking t = T-1 .. 0 as the backward pass does, each writing a
// (T, 27, B) stream:
//   copy   out[t][s] = in[t][s] for the first 27 slots (memory traffic only);
//   light  acc = acc + in[t][i % 47]·mult for i < 60, then all 27 output
//          slots = acc (the Qx/Qu-level work of a backward step);
//   full   the same with 600 terms a step.
// acc starts at 0 and mult is 1, passed by value so that the compiler cannot
// fold the multiply away.
//
// Replaces the TPU kernel tools/probe_kernel_cost.py::make (its three
// kinds of pallas_call, the repository's measurement probe). That probe
// never initialised its two scratch values (acc and mult); here they are
// fixed to 0 and 1.
//
// Layout as the other kernels: one thread per scenario, the scenario axis
// contiguous, so each slot of a step is one coalesced 4-byte load or store
// per thread. What bounds it: bytes. At B=4096, T=500 the light and full
// kernels read the whole input (385.0 MB) and write the output (221.2 MB),
// copy reads only the 27 slots it copies (221.2 MB each way); 120 and 1200
// operations a scenario-step are far below the byte time. The copy kernel's
// time is the card's measured floor for this stream layout, which the other
// kernels of the port are read against.
#include "common.cuh"

namespace ddp {

namespace {

constexpr int PROBE_THREADS = 128;
constexpr int PROBE_S_IN = 47, PROBE_S_OUT = 27;   // JAX probe's DU and S

// MODE 0 copy, else the number of multiply-add terms a step (60 or 600)
template <int MODE>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_kernel(const float* __restrict__ in, float* __restrict__ out, int T,
             int B, float mult) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  float acc = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const float* x = in + (size_t)t * PROBE_S_IN * sB + b;
    float* o = out + (size_t)t * PROBE_S_OUT * sB + b;
    if constexpr (MODE == 0) {
#pragma unroll
      for (int s = 0; s < PROBE_S_OUT; ++s) o[s * sB] = x[s * sB];
    } else {
#pragma unroll
      for (int i = 0; i < MODE; ++i)
        acc = acc + x[(i % PROBE_S_IN) * sB] * mult;
#pragma unroll
      for (int s = 0; s < PROBE_S_OUT; ++s) o[s * sB] = acc;
    }
  }
}

template <int MODE>
int launch_probe(const float* in, float* out, int T, int B, float mult,
                 cudaStream_t st) {
  const dim3 grid((B + PROBE_THREADS - 1) / PROBE_THREADS);
  probe_kernel<MODE><<<grid, PROBE_THREADS, 0, st>>>(in, out, T, B, mult);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace ddp

// mode: 0 copy, 1 light, 2 full (probe_kernel.py MODES)
extern "C" int ddp_probe_lanes(const float* in, float* out, int T, int s_in,
                               int s_out, int B, int mode, float mult,
                               int device, void* stream) {
  using namespace ddp;
  if (T < 1 || B < 1 || s_in != PROBE_S_IN || s_out != PROBE_S_OUT)
    return ERR_ARGS;
  cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_probe<0>(in, out, T, B, mult, st);
    case 1: return launch_probe<60>(in, out, T, B, mult, st);
    case 2: return launch_probe<600>(in, out, T, B, mult, st);
    default: return ERR_ARGS;
  }
}
