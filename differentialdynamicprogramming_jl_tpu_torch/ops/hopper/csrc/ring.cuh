// The shared-memory ring that K1 (backward.cuh), K2 and K3 (forward.cuh)
// and K5's light and full modes (probe.cu) stage their step inputs in, and
// the launch plan that sizes it.
//
// A block owns RING_W = 32 consecutive scenarios. A ring stage holds a chunk
// of tc time steps of the F input slots of those scenarios, laid out
// [step][slot][32 columns] f32, so one slot row of a step is one 128-byte
// line of the (T, S, B) stream and a warp reads it from shared memory
// without bank conflicts. The ring has `stages` stages: while the block
// computes on chunk c, chunks c+1 .. c+stages-1 are in flight. One stage
// (K1 where two of one step do not fit a block: GPS mode at large n·m)
// overlaps nothing: each chunk is copied after the last one is consumed.
//
// The copy route is cp.async (global → shared, asynchronous, tracked per
// thread by commit and wait groups): 16-byte cp.async.cg where every row
// start is 16-byte aligned (B % 4 == 0 and 16-byte aligned stream bases),
// else 4-byte cp.async.ca. TMA (cp.async.bulk.tensor) would need a tensor
// map per stream from the driver API's cuTensorMapEncodeTiled, and the
// library links with a plain nvcc -shared and no libcuda; the rows here are
// 128 bytes each, which cp.async moves at the same cost, so the ring stays
// with cp.async.
//
// The plan (blocks, threads, tc, stages, shared bytes) is made in Python
// (ops/hopper/plan.py) and checked here against the instance's slot count
// before a launch; a plan that does not match returns ERR_ARGS.
#pragma once

#include "common.cuh"

namespace ddp {

constexpr int RING_W = 32;           // scenarios (columns) a block owns
constexpr int MAX_STAGES = 4;
constexpr int MAX_SMEM = 232448;     // opt-in shared memory of a block, sm_90

// the launch plan the wrappers pass to the launchers
struct RingPlan {
  int blocks, threads, tc, stages, smem;
};

// shared bytes of a ring of `stages` stages of tc steps × F slots × 32
// columns, plus `extra` floats after it
inline long long ring_bytes(int stages, int tc, int F, int extra) {
  return 4LL * ((long long)stages * tc * F * RING_W + extra);
}

inline bool plan_ok(const RingPlan& p, int B, int threads, int F,
                    int extra) {
  return p.blocks == (B + RING_W - 1) / RING_W && p.threads == threads &&
         p.tc >= 1 && p.stages >= 1 && p.stages <= MAX_STAGES &&
         p.smem == ring_bytes(p.stages, p.tc, F, extra) &&
         p.smem <= MAX_SMEM;
}

// the 16-byte copies need every row start 16-byte aligned
inline bool rows_aligned(int B, const void* p) {
  return B % 4 == 0 && reinterpret_cast<size_t>(p) % 16 == 0;
}

// a kernel above the 48 KB default asks for its shared memory first
template <class Kernel>
int reserve_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// barrier `id` (1..15) among `count` threads of the block, a multiple of
// 32 (__syncthreads is barrier 0, of every thread)
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wait until at most `pending` (0 .. MAX_STAGES-1) of this thread's groups
// are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Start the copy of `steps` steps × F slots of one block's columns into a
// ring stage `dst` ([step][slot][32]). src(tt, s) points at column b0 of
// step tt's slot s in device memory; only the first `cols` columns exist
// (the last block of a B that is not a multiple of 32), and the rest of
// the stage is left as it was. Thread `tid` of `nthr` takes every nthr-th
// copy. With `vec`, cols is a multiple of 4 and each copy moves 16 bytes.
template <int F, class Src>
__device__ __forceinline__ void stage_rows(float* dst, int steps, int cols,
                                           bool vec, int tid, int nthr,
                                           const Src& src) {
  if (vec) {
    const int total = steps * F * (RING_W / 4);
    for (int i = tid; i < total; i += nthr) {
      const int row = i >> 3, p = 4 * (i & 7);
      if (p < cols) {
        const int tt = row / F;
        cp_async16(dst + row * RING_W + p, src(tt, row - tt * F) + p);
      }
    }
  } else {
    const int total = steps * F * RING_W;
    for (int i = tid; i < total; i += nthr) {
      const int row = i >> 5, c = i & 31;
      if (c < cols) {
        const int tt = row / F;
        cp_async4(dst + row * RING_W + c, src(tt, row - tt * F) + c);
      }
    }
  }
}

}  // namespace ddp
