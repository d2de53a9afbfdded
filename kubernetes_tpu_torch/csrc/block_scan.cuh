// Block-wide scans shared by kernels C (waterfill.cu) and G (cover_curve.cu).
//
// block_scan<THREADS> scans x[0, len) in place, uint32 with wraparound
// (int32 sums as XLA computes them, mod 2^32), exclusive or inclusive, in
// chunks of THREADS: a warp scan by shuffles, the warp totals scanned by warp
// 0, and a carry across chunks. Every thread of the block calls it; `ws` is
// THREADS / 32 words of shared memory. Returns the total (to every thread).
// `x` may be in shared or global memory: the __syncthreads between steps
// orders both for the block.

#pragma once

#include <cuda_runtime.h>

template <int THREADS>
__device__ unsigned block_scan(unsigned* x, int len, bool inclusive, unsigned* ws) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block_scan: THREADS");
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned carry = 0;
  for (int c0 = 0; c0 < len; c0 += THREADS) {
    const int i = c0 + tid;
    const unsigned v0 = i < len ? x[i] : 0u;
    unsigned v = v0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane == 31) ws[warp] = v;
    __syncthreads();
    if (warp == 0) {
      unsigned t = lane < WARPS ? ws[lane] : 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += y;
      }
      if (lane < WARPS) ws[lane] = t;  // inclusive over the warps
    }
    __syncthreads();
    const unsigned before = carry + (warp > 0 ? ws[warp - 1] : 0u);
    if (i < len) x[i] = before + (inclusive ? v : v - v0);
    carry += ws[WARPS - 1];
    __syncthreads();  // ws is rewritten by the next chunk
  }
  return carry;
}

// the sum of one value a thread over the block (uint32, wrapping)
template <int THREADS>
__device__ unsigned block_sum(unsigned v, unsigned* ws) {
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  unsigned s = 0;
  for (int w = 0; w < WARPS; ++w) s += ws[w];
  __syncthreads();
  return s;
}
