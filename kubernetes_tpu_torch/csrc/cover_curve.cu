// Kernel G: the gang victim cover curve, victim-parallel, every slice of a
// cover attempt in one launch (sm_90a).
//
// Replaces: kubernetes_tpu/models/gangcover.py:78 cover_curve. The plain
// PyTorch version is models/gangcover.py cover_curve_plain (one slice) and
// cover_curve_batch_plain (S slices); they must agree exactly.
//
//   caps[k], k = 0..k_max: gang members one slice fits after evicting the
//   first k victims. Per eligible node
//     cap = max(0, min(min_{r: req_r > 0} floor((free_r + freed_r) / req_r),
//                      headroom + released))
//   (2^30 before the headroom min when req is all zero); an ineligible node
//   contributes 0; caps[k] is the int32 sum over nodes.
//
// What bounds it: bytes, and at the main path's shape (256 slots, 1,024
// victims, R = 3) barely those: ~25 KB in, 4 KB out, nanoseconds of HBM
// time. The first design (one block a curve, every node's thread walking
// the whole victim list, one launch a slice) took ~0.167 ms of device time a
// curve: a serial chain of K steps. Here no thread walks the list, and every
// slice of an attempt is one CTA of one launch.
//
// A victim changes only its own node's capacity, so
//     caps[0]   = sum_n cap_n(no eviction)
//     caps[k+1] = caps[k] + cap_v(after victim k) - cap_v(before victim k),
//                 v = v_node[k] (pads and nodes >= n_slots add 0).
// Per slice (one CTA, O(K + Ns) work in log depth):
//   1. stage v_node (pads and out-of-range nodes as -1);
//   2. a stable counting sort of the victims by node: each victim's rank
//      among the earlier victims on its node (the warps of a chunk take
//      turns in victim order; within a warp __match_any_sync), the per-node
//      counts scanned into segment starts, each victim scattered to
//      start + rank;
//   3. per resource, a block scan of the node-sorted requests; the freed
//      resources up to and including a victim are its prefix minus the
//      prefix before its node's segment (uint32 differences are exact mod
//      2^32), and its released slots are its rank + 1;
//   4. each victim writes its node's capacity after minus before into
//      caps[k+1]; a block sum gives caps[0], and a block scan turns the
//      deltas into the curve.
// Regions (ints): counts [n_slots], free [n_slots, R], headroom and
// eligible [n_slots], v_node [K], v_req [K, R], rank [K], sorted [K],
// prefixes [R][K], curve [K + 1], in dynamic shared memory while a slice's
// fit the budget, else in the CTA's slice of a global scratch buffer.
//
// Parity with XLA: int32 wraps (additions done in uint32, associative mod
// 2^32, so the scan's order gives the sequential sums), floor division (C
// `/` truncates toward zero), the 2^30 sentinel, pads (v_node < 0) and nodes
// >= n_slots change nothing, ineligible nodes contribute 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

#define CC_THREADS 512
#define CC_WARPS (CC_THREADS / 32)
#define CC_MAX_R 32
#define CC_BIG (1 << 30)
// dynamic shared memory a CTA may take (the card allows 227 KB per block)
#define CC_SMEM_BUDGET (220 * 1024)

struct CoverCurveArgs {
  int S, n_slots, k_max, R;
  int in_smem;      // regions in dynamic shared memory, else gscratch
  int slice_words;  // ints of one slice's regions
  const int* free;                // [S, n_slots, R]
  const int* headroom;            // [S, n_slots]
  const unsigned char* eligible;  // [S, n_slots] (torch.bool)
  const int* v_node;              // [S, k_max]
  const int* v_req;               // [S, k_max, R]
  const int* req;                 // [R]
  int* caps;                      // [S, k_max + 1]
  unsigned* gscratch;             // S slices of slice_words, when !in_smem
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void __launch_bounds__(CC_THREADS, 1) cover_curve_kernel(const CoverCurveArgs a) {
  extern __shared__ __align__(16) unsigned dyn[];
  __shared__ int req_s[CC_MAX_R];
  __shared__ unsigned ws[CC_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, R = a.R, NS = a.n_slots, K = a.k_max;
  unsigned* base = a.in_smem ? dyn : a.gscratch + (size_t)s * a.slice_words;
  unsigned* cnt = base;         // [NS] per-node counts, then segment starts
  int* free = (int*)(cnt + NS);  // [NS, R]
  int* head = free + (size_t)NS * R;  // [NS]
  int* elig = head + NS;        // [NS]
  int* vn = elig + NS;          // [K]
  int* v_req = vn + K;          // [K, R]
  unsigned* rk = (unsigned*)(v_req + (size_t)K * R);  // [K] rank among the node's earlier victims
  int* srt = (int*)(rk + K);    // [K] victims in node order
  unsigned* pre = (unsigned*)(srt + K);  // [R][K] prefix sums of the sorted requests
  unsigned* curve = pre + (size_t)R * K;  // [K + 1]

  // ---- 1. stage (coalesced; the later gathers read shared memory) ----
  for (int r = tid; r < R; r += CC_THREADS) req_s[r] = a.req[r];
  for (int n = tid; n < NS; n += CC_THREADS) {
    cnt[n] = 0u;
    head[n] = a.headroom[(size_t)s * NS + n];
    elig[n] = a.eligible[(size_t)s * NS + n];
  }
  for (int i = tid; i < NS * R; i += CC_THREADS) free[i] = a.free[(size_t)s * NS * R + i];
  for (int i = tid; i < K * R; i += CC_THREADS) v_req[i] = a.v_req[(size_t)s * K * R + i];
  for (int k = tid; k < K; k += CC_THREADS) {
    const int v = a.v_node[(size_t)s * K + k];
    vn[k] = (v >= 0 && v < NS) ? v : -1;
  }
  __syncthreads();

  // ---- 2. stable counting sort by node ----
  for (int c0 = 0; c0 < K; c0 += CC_THREADS) {
    const int k = c0 + tid;
    const int n = k < K ? vn[k] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, n);
    const unsigned below = (unsigned)__popc(peers & ((1u << lane) - 1u));
    const int leader = __ffs(peers) - 1;
    for (int w = 0; w < CC_WARPS && c0 + 32 * w < K; ++w) {
      if (warp == w) {
        const unsigned start = n >= 0 ? cnt[n] : 0u;
        __syncwarp();  // every lane has read its node's count
        if (n >= 0) {
          rk[k] = start + below;
          if (lane == leader) cnt[n] = start + (unsigned)__popc(peers);
        }
      }
      __syncthreads();
    }
  }
  const int V = (int)block_scan<CC_THREADS>(cnt, NS, false, ws);  // cnt -> segment starts
  for (int k = tid; k < K; k += CC_THREADS) {
    const int n = vn[k];
    if (n >= 0) srt[cnt[n] + rk[k]] = k;
  }
  __syncthreads();

  // ---- 3. prefix sums of the node-sorted requests, per resource ----
  for (int r = 0; r < R; ++r) {
    if (req_s[r] <= 0) continue;  // a zero-request resource does not bind
    unsigned* p = pre + (size_t)r * K;
    for (int i = tid; i < V; i += CC_THREADS) p[i] = (unsigned)v_req[(size_t)srt[i] * R + r];
    __syncthreads();
    block_scan<CC_THREADS>(p, V, true, ws);
  }

  // ---- 4. capacity deltas, caps[0], the curve ----
  for (int k = tid; k < K; k += CC_THREADS) {
    const int n = vn[k];
    unsigned delta = 0u;
    if (n >= 0 && elig[n]) {
      const unsigned seg = cnt[n], rank = rk[k];
      const unsigned at = seg + rank;
      int after = CC_BIG, before = CC_BIG;
      for (int r = 0; r < R; ++r) {
        const int q = req_s[r];
        if (q <= 0) continue;
        const unsigned* p = pre + (size_t)r * K;
        const unsigned freed = p[at] - (seg > 0 ? p[seg - 1] : 0u);
        const int fr = free[(size_t)n * R + r];
        const int av_after = wrap_add(fr, (int)freed);
        const int av_before = (int)((unsigned)av_after - (unsigned)v_req[(size_t)k * R + r]);
        after = min(after, floor_div(av_after, q));
        before = min(before, floor_div(av_before, q));
      }
      after = max(min(after, wrap_add(head[n], (int)(rank + 1u))), 0);
      before = max(min(before, wrap_add(head[n], (int)rank)), 0);
      delta = (unsigned)after - (unsigned)before;
    }
    curve[k + 1] = delta;
  }
  unsigned cap0 = 0u;
  for (int n = tid; n < NS; n += CC_THREADS) {
    if (!elig[n]) continue;
    int c = CC_BIG;
    for (int r = 0; r < R; ++r)
      if (req_s[r] > 0) c = min(c, floor_div(free[(size_t)n * R + r], req_s[r]));
    cap0 += (unsigned)max(min(c, head[n]), 0);
  }
  cap0 = block_sum<CC_THREADS>(cap0, ws);
  if (tid == 0) curve[0] = cap0;
  __syncthreads();
  block_scan<CC_THREADS>(curve, K + 1, true, ws);
  int* caps = a.caps + (size_t)s * (K + 1);
  for (int i = tid; i <= K; i += CC_THREADS) caps[i] = (int)curve[i];
}

// Launch the S slices on `stream`; returns the first CUDA error (0 if
// none). The wrapper checks shapes and R <= CC_MAX_R and sizes the regions.
extern "C" int cover_curve_launch(const CoverCurveArgs* args, void* stream) {
  static int smem_set = 0;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        cover_curve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CC_SMEM_BUDGET);
    if (e != cudaSuccess) return (int)e;
    smem_set = 1;
  }
  if (args->S < 1) return 0;
  const size_t smem = args->in_smem ? (size_t)args->slice_words * 4 : 0;
  if (smem > CC_SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  cover_curve_kernel<<<args->S, CC_THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int cover_curve_args_size() { return (int)sizeof(CoverCurveArgs); }
extern "C" int cover_curve_max_r() { return CC_MAX_R; }
extern "C" int cover_curve_smem_budget() { return CC_SMEM_BUDGET; }
