// A block-wide exclusive scan and the look-back words of a scan across
// blocks, shared by merge_insert.cu (the tile bucketing, the table's
// occurrence prefix) and lf.cu (the radix-2 column pair's tile offsets and
// word prefixes).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Exclusive scan of K ints across a block of NT threads: v[] is replaced
// by the exclusive prefix, total[] receives the block sums. One barrier:
// every warp adds up the warp sums before its own. The warp sums go to the
// caller's shared array, or to one per <NT, K>: two calls on one array need
// a barrier between them.
template <int NT, int K>
__device__ __forceinline__ void block_exclusive_scan(int v[K], int total[K],
                                                     int (*warp_sums)[K]) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    int x = v[s];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    incl[s] = x;
    if (lane == 31) warp_sums[warp][s] = x;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < K; ++s) {
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = warp_sums[w][s];
      before += w < warp ? x : 0;
      all += x;
    }
    v[s] = before + incl[s] - v[s];
    total[s] = all;
  }
}

template <int NT, int K>
__device__ __forceinline__ void block_exclusive_scan(int v[K], int total[K]) {
  __shared__ int warp_sums[NT / 32][K];
  block_exclusive_scan<NT, K>(v, total, warp_sums);
}

// A look-back word: a flag in the high 32 bits (0: not yet published), a
// value in the low 32, read and written whole with relaxed GPU-scope
// accesses.
__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long flag,
                                            int value) {
  const unsigned long long v = flag | (uint32_t)value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

}  // namespace
