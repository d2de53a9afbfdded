// Kernel G: the gang victim cover curve (sm_90a).
//
// Replaces: kubernetes_tpu/models/gangcover.py:78 cover_curve. The plain
// PyTorch version is models/gangcover.py cover_curve_plain.
//
//   caps[k], k = 0..k_max: gang members one slice fits after evicting the
//   first k victims. Per eligible node
//     cap = max(0, min(min_{r: req_r > 0} floor((free_r + freed_r) / req_r),
//                      headroom + released))
//   (2^30 before the headroom min when req is all zero); an ineligible node
//   contributes 0; caps[k] is the int32 sum over nodes.
//
// What bounds it: bytes, and at the main path's shape (256 slots, 1,024
// victims, R = 3) barely those: ~25 KB in, 4 KB out, a few nanoseconds of
// HBM time, so the launch and the single block's latency set the time. The
// JAX body builds the [K+1, Ns, R] prefix-freed tensor and reduces it; this
// kernel never materializes it. A victim changes only its own node's
// capacity, so
//     caps[0]   = sum_n cap_n(0)
//     caps[k+1] = caps[k] + cap_v(after k+1 victims) - cap_v(after k),
//                 v = v_node[k] (pads and out-of-range nodes add 0).
// Design: ONE block. Each thread owns nodes (n = tid, tid + blockDim, ...),
// walks the victim list in order (tiles of v_node staged in shared memory,
// every thread reading the same entry: a broadcast), carries its node's
// running free/headroom and writes the capacity delta of each of its
// node's victims into caps[k+1]. A block reduction gives caps[0], and a
// block-wide inclusive scan (warp shuffles plus a carry across chunks)
// turns the deltas into the curve: O(Ns * K) compares, O(K * R) arithmetic.
//
// Parity with XLA: int32 wraps (additions done in uint32), floor division
// (C `/` truncates toward zero), the 2^30 sentinel, pads (v_node < 0) and
// nodes >= n_slots change nothing; the sum mod 2^32 telescopes, so the
// order of the additions does not matter.

#include <cuda_runtime.h>
#include <stdint.h>

#define CC_THREADS 512
#define CC_TILE 1024
#define CC_MAX_R 32
#define CC_BIG (1 << 30)

struct CoverCurveArgs {
  int n_slots, k_max, R;
  const int* free;               // [n_slots, R]
  const int* headroom;           // [n_slots]
  const unsigned char* eligible; // [n_slots] (torch.bool)
  const int* v_node;             // [k_max]
  const int* v_req;              // [k_max, R]
  const int* req;                // [R]
  int* caps;                     // [k_max + 1]
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// the node's capacity for the gang's request; avail[] holds free + freed
__device__ __forceinline__ int node_cap(const int* avail, int head, const int* req_s, int R) {
  int c = CC_BIG;
  for (int r = 0; r < R; ++r)
    if (req_s[r] > 0) c = min(c, floor_div(avail[r], req_s[r]));
  c = min(c, head);
  return max(c, 0);
}

__global__ void __launch_bounds__(CC_THREADS, 1) cover_curve_kernel(const CoverCurveArgs a) {
  __shared__ int vn_s[CC_TILE];
  __shared__ int req_s[CC_MAX_R];
  __shared__ unsigned warp_s[CC_THREADS / 32];
  __shared__ unsigned carry_s;
  const int tid = threadIdx.x;
  const int R = a.R;
  for (int r = tid; r < R; r += blockDim.x) req_s[r] = a.req[r];
  // deltas default to 0 (pads, ineligible and out-of-range nodes)
  for (int k = tid; k < a.k_max; k += blockDim.x) a.caps[k + 1] = 0;
  __syncthreads();

  unsigned base = 0;
  int avail[CC_MAX_R];
  for (int n0 = 0; n0 < a.n_slots; n0 += blockDim.x) {
    const int n = n0 + tid;
    const bool active = n < a.n_slots && a.eligible[n];
    int head = 0, cur = 0;
    if (active) {
      for (int r = 0; r < R; ++r) avail[r] = a.free[(size_t)n * R + r];
      head = a.headroom[n];
      cur = node_cap(avail, head, req_s, R);
      base += (unsigned)cur;
    }
    for (int t0 = 0; t0 < a.k_max; t0 += CC_TILE) {
      const int len = min(CC_TILE, a.k_max - t0);
      __syncthreads();
      for (int j = tid; j < len; j += blockDim.x) vn_s[j] = a.v_node[t0 + j];
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < len; ++j) {
        if (vn_s[j] != n) continue;
        const int k = t0 + j;
        for (int r = 0; r < R; ++r) avail[r] = wrap_add(avail[r], a.v_req[(size_t)k * R + r]);
        head = wrap_add(head, 1);
        const int nc = node_cap(avail, head, req_s, R);
        a.caps[k + 1] = (int)((unsigned)nc - (unsigned)cur);
        cur = nc;
      }
    }
  }

  // caps[0] = block sum of the base capacities
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) base += __shfl_down_sync(0xffffffffu, base, off);
  if (lane == 0) warp_s[warp] = base;
  __syncthreads();
  if (tid == 0) {
    unsigned s = 0;
    for (int w = 0; w < n_warps; ++w) s += warp_s[w];
    a.caps[0] = (int)s;
    carry_s = 0;
  }
  __syncthreads();

  // inclusive scan of caps[0..k_max] in chunks of blockDim, uint32 wrap
  const int total = a.k_max + 1;
  for (int c0 = 0; c0 < total; c0 += blockDim.x) {
    const int i = c0 + tid;
    unsigned v = i < total ? (unsigned)a.caps[i] : 0u;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane == 31) warp_s[warp] = v;
    __syncthreads();
    if (tid == 0) {
      unsigned run = carry_s;
      for (int w = 0; w < n_warps; ++w) {
        const unsigned t = warp_s[w];
        warp_s[w] = run;  // exclusive prefix of the warps, carry included
        run += t;
      }
      carry_s = run;
    }
    __syncthreads();
    if (i < total) a.caps[i] = (int)(v + warp_s[warp]);
    __syncthreads();
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch. The
// wrapper checks shapes and R <= CC_MAX_R.
extern "C" int cover_curve_launch(const CoverCurveArgs* args, void* stream) {
  cover_curve_kernel<<<1, CC_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int cover_curve_args_size() { return (int)sizeof(CoverCurveArgs); }
extern "C" int cover_curve_max_r() { return CC_MAX_R; }
