// Kernel C: one waterfill group, hand-written for Hopper (sm_90a).
//
// Replaces: kubernetes_tpu/models/waterfill.py waterfill_group (jax.jit,
// :79-154). Same function: for a group of identical pods, per node the fit
// depth j_cap (floor(free/req) min over resources, pod headroom, filter row,
// host-port cap, clipped to [0, j_max]); a static score 2*napref + 3*taint +
// img (+ gang) normalized over the nodes with j_cap > 0; per slot (n, j) the
// marginal LeastAllocated + Balanced score, a running min along j, and the
// int32 key score * (N*j_max + 1) - (n*j_max + j); the top k_slots keys in
// descending order; chosen_nodes[i] = slot / j_max for the first
// min(valid keys, group_size) of them, -1 after; k_per_node counts them.
// The plain PyTorch version is models/waterfill.py waterfill_group_plain;
// the two must agree exactly.
//
// What bounds it: neither bytes nor operations. At 5,000 nodes x j_max 128
// the key matrix is 640,000 int32 (2.5 MB) and the scoring ~30 operations a
// slot, both microseconds of the card's rates; the cost is the chain of
// dependent passes (normalizer max -> keys -> a 4-pass radix select -> sort)
// and their launches.
//
// Design, one wrapper call = one stream of launches:
//   1. node pass (one block): j_cap per node, block max of napref/taint over
//      j_cap > 0, then the static score per node.
//   2. key pass (one warp per node row): lanes walk j in chunks of 32, carry
//      the running min with a warp scan, write order-preserving uint32 keys
//      (0 = never chosen) coalesced, and count the valid keys.
//   3. radix select (4 passes of 8 bits, shared-memory histograms merged with
//      global atomics): the m-th largest key, m = min(valid, group, k_slots).
//      Valid keys are unique (the slot budget of bucket_j_max keeps
//      score * slots < 2^31, so the key never wraps), so exactly m keys are
//      at or above it.
//   4. compact those m keys with their slot index into a 64-bit sort key
//      (key << 32 | ~slot: equal keys would order by lowest slot first, as
//      lax.top_k does) and bitonic-sort them descending: in shared memory up
//      to 4,096 entries, with global-memory merge steps beyond that.
//   5. write chosen_nodes and k_per_node (integer atomics).
//
// Parity: int32 arithmetic wraps as in XLA (done in uint32); Python/JAX
// floor division via floordiv(); Balanced in float32 with explicit _rn
// intrinsics and --fmad=false (no FMA contraction), truncated to int32.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define NODE_THREADS 1024
#define NODE_WARPS (NODE_THREADS / 32)
#define SORT_BLOCK 4096  // entries sorted in shared memory by one block (32 KB)
#define SCAN_THREADS 256

struct WaterfillArgs {
  int N, R, j_max, k_slots, sort_len, group_size, has_port, has_gang;
  const int* alloc;
  const int* used;
  const int* used_nz;
  const int* pod_count;
  const int* max_pods;
  const uint8_t* filter_ok;
  const uint8_t* port_conflict;
  const int* napref;
  const uint8_t* has_napref;
  const int* taint;
  const int* img;
  const int* gang;
  const int* req;
  const int* req_nz;
  const uint8_t* bal_active;
  // outputs
  int* k_per_node;
  int* chosen_nodes;
  // scratch: j_cap [N], static [N], keys [N*j_max], sort buffer [sort_len],
  // state [2 + 4*256] (valid count, compact count, four histograms)
  int* j_cap;
  int* static_score;
  unsigned* keys;
  unsigned long long* sortbuf;
  int* state;
};

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

// Python/JAX floor division (C++ `/` truncates toward zero)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) q -= 1;
  return q;
}

// ---- 1. node pass ----------------------------------------------------------

__global__ void __launch_bounds__(NODE_THREADS, 1) wf_node_pass(const WaterfillArgs a) {
  __shared__ int red[NODE_WARPS * 2];
  __shared__ int mx[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, R = a.R, j_max = a.j_max;
  int v0 = INT_MIN, v1 = INT_MIN;
  for (int n = tid; n < N; n += NODE_THREADS) {
    int jc = INT_MAX;
    for (int r = 0; r < R; ++r) {
      const int q = a.req[r];
      const int fr = wsub(a.alloc[(size_t)n * R + r], a.used[(size_t)n * R + r]);
      jc = min(jc, q > 0 ? floordiv(fr, max(q, 1)) : j_max);
    }
    jc = min(jc, wsub(a.max_pods[n], a.pod_count[n]));
    if (!a.filter_ok[n]) jc = 0;
    if (a.has_port) jc = a.port_conflict[n] ? 0 : min(jc, 1);  // before the clip
    jc = min(max(jc, 0), j_max);
    a.j_cap[n] = jc;
    const int f = jc > 0;
    v0 = max(v0, f ? a.napref[n] : 0);
    v1 = max(v1, f ? a.taint[n] : 0);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v0 = max(v0, __shfl_down_sync(0xffffffffu, v0, off));
    v1 = max(v1, __shfl_down_sync(0xffffffffu, v1, off));
  }
  if (lane == 0) {
    red[warp * 2] = v0;
    red[warp * 2 + 1] = v1;
  }
  __syncthreads();
  if (warp == 0) {
    int x0 = lane < NODE_WARPS ? red[lane * 2] : INT_MIN;
    int x1 = lane < NODE_WARPS ? red[lane * 2 + 1] : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x0 = max(x0, __shfl_down_sync(0xffffffffu, x0, off));
      x1 = max(x1, __shfl_down_sync(0xffffffffu, x1, off));
    }
    if (lane == 0) {
      mx[0] = x0;
      mx[1] = x1;
    }
  }
  __syncthreads();
  const int mx_napref = mx[0], mx_taint = mx[1];
  const int has_napref = a.has_napref[0] != 0;
  for (int n = tid; n < N; n += NODE_THREADS) {
    int napref = 0;
    if (has_napref && mx_napref > 0) napref = floordiv(wmul(100, a.napref[n]), max(mx_napref, 1));
    const int tscaled = mx_taint > 0 ? floordiv(wmul(100, a.taint[n]), max(mx_taint, 1)) : 0;
    const int taint = mx_taint > 0 ? 100 - tscaled : 100;
    unsigned st = 2u * (unsigned)napref + 3u * (unsigned)taint + (unsigned)a.img[n];
    if (a.has_gang) st += (unsigned)a.gang[n];
    a.static_score[n] = (int)st;
  }
}

// ---- 2. key pass -----------------------------------------------------------

__global__ void wf_key_pass(const WaterfillArgs a) {
  const int lane = threadIdx.x & 31;
  const int n = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  if (n >= a.N) return;  // whole warps leave together
  const int R = a.R, j_max = a.j_max;
  const int SCORE_MIN = INT_MIN + 1;  // ops/solver.py INT_MIN
  const int SENTINEL = INT_MIN + 1;   // waterfill.py sentinel
  const int slots1 = wadd(wmul(a.N, j_max), 1);
  int al[2], us[2], unz[2], rq[2], rqnz[2];
  for (int r = 0; r < 2; ++r) {
    al[r] = a.alloc[(size_t)n * R + r];
    us[r] = a.used[(size_t)n * R + r];
    unz[r] = a.used_nz[(size_t)n * R + r];
    rq[r] = a.req[r];
    rqnz[r] = a.req_nz[r];
  }
  const int bal_active = a.bal_active[0] != 0;
  const int st = a.static_score[n], jc = a.j_cap[n];
  int carry = INT_MAX, n_valid = 0;
  for (int base = 0; base < j_max; base += 32) {
    const int j = base + lane;
    int s = INT_MAX;
    if (j < j_max) {
      // LeastAllocated over cpu + memory with j pods of this group added
      int per_sum = 0, npos = 0;
      for (int r = 0; r < 2; ++r) {
        const int A = al[r];
        const int u = wadd(wadd(unz[r], wmul(j, rqnz[r])), rqnz[r]);
        if (A > 0) {
          npos += 1;
          if (u <= A) per_sum = wadd(per_sum, floordiv(wmul(wsub(A, u), 100), max(A, 1)));
        }
      }
      const int least = floordiv(per_sum, max(npos, 1));
      // BalancedAllocation (float32)
      int bal = 0;
      if (bal_active) {
        float frac[2];
        int nf = 0;
        for (int r = 0; r < 2; ++r) {
          const float af = (float)al[r];
          const float u = (float)wadd(wadd(us[r], wmul(j, rq[r])), rq[r]);
          frac[r] = af > 0.0f ? fminf(__fdiv_rn(u, fmaxf(af, 1.0f)), 1.0f) : 0.0f;
          if (af > 0.0f) nf += 1;
        }
        const float sd = nf == 2 ? __fdiv_rn(fabsf(__fsub_rn(frac[0], frac[1])), 2.0f) : 0.0f;
        bal = (int)__fmul_rn(__fsub_rn(1.0f, sd), 100.0f);
      }
      s = wadd(wadd(least, bal), st);
    }
    // running min along j: inclusive warp scan, then the carry
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s = min(s, o);
    }
    s = min(s, carry);
    carry = __shfl_sync(0xffffffffu, s, 31);
    int valid = 0;
    if (j < j_max) {
      const int flat = j < jc ? s : SCORE_MIN;
      const int rank = n * j_max + j;
      const int key = wsub(wmul(flat, slots1), rank);
      valid = flat > SCORE_MIN && key > SENTINEL;
      a.keys[(size_t)rank] = valid ? ((unsigned)key ^ 0x80000000u) : 0u;
    }
    n_valid += __popc(__ballot_sync(0xffffffffu, valid));
  }
  if (lane == 0 && n_valid) atomicAdd(&a.state[0], n_valid);
}

// ---- 3. radix select -------------------------------------------------------

// The prefix of the m-th largest key fixed by passes 0..passes-1, and how
// many keys equal to that prefix are still wanted. m = 0 means no key.
__device__ void radix_prefix(const WaterfillArgs& a, int passes, unsigned* prefix, int* want,
                             int* m_out) {
  const int m = min(min(a.state[0], a.group_size), a.k_slots);
  int k = m;
  unsigned p = 0;
  for (int q = 0; q < passes && m > 0; ++q) {
    const int* h = a.state + 2 + q * 256;
    const int shift = 24 - 8 * q;
    int cum = 0;
    for (int b = 255; b >= 0; --b) {
      const int c = h[b];
      if (cum + c >= k) {
        p |= (unsigned)b << shift;
        k -= cum;
        break;
      }
      cum += c;
    }
  }
  *prefix = p;
  *want = k;
  *m_out = m;
}

__global__ void wf_radix_pass(const WaterfillArgs a, int pass) {
  __shared__ int hist[256];
  __shared__ unsigned prefix_s;
  __shared__ int m_s;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0;
  if (threadIdx.x == 0) {
    unsigned p;
    int want, m;
    radix_prefix(a, pass, &p, &want, &m);
    prefix_s = p;
    m_s = m;
  }
  __syncthreads();
  if (m_s == 0) return;
  const unsigned prefix = prefix_s;
  const int shift = 24 - 8 * pass;
  const size_t S = (size_t)a.N * a.j_max;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < S;
       i += (size_t)gridDim.x * blockDim.x) {
    const unsigned u = a.keys[i];
    if (u == 0u) continue;
    if (pass > 0 && (u >> (shift + 8)) != (prefix >> (shift + 8))) continue;
    atomicAdd(&hist[(u >> shift) & 255u], 1);
  }
  __syncthreads();
  int* g = a.state + 2 + pass * 256;
  for (int b = threadIdx.x; b < 256; b += blockDim.x)
    if (hist[b]) atomicAdd(&g[b], hist[b]);
}

// ---- 4. compact + bitonic sort ---------------------------------------------

__global__ void wf_compact(const WaterfillArgs a) {
  __shared__ unsigned thr_s;
  __shared__ int m_s;
  if (threadIdx.x == 0) {
    unsigned p;
    int want, m;
    radix_prefix(a, 4, &p, &want, &m);
    thr_s = p;
    m_s = m;
  }
  __syncthreads();
  const int m = m_s;
  if (m == 0) return;
  const unsigned thr = thr_s;
  const size_t S = (size_t)a.N * a.j_max;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < S;
       i += (size_t)gridDim.x * blockDim.x) {
    const unsigned u = a.keys[i];
    if (u == 0u || u < thr) continue;
    const int pos = atomicAdd(&a.state[1], 1);
    if (pos < m)
      a.sortbuf[pos] = ((unsigned long long)u << 32) | (unsigned long long)(0xffffffffu - (unsigned)i);
  }
}

// compare-exchange for a descending bitonic sort: the sub-sequence holding
// global index gi runs descending when (gi & k) == 0
__device__ __forceinline__ void cmp_swap(unsigned long long* x, int i, int l, unsigned gi, unsigned k) {
  const unsigned long long p = x[i], q = x[l];
  const bool desc = (gi & k) == 0;
  if (desc ? (p < q) : (p > q)) {
    x[i] = q;
    x[l] = p;
  }
}

// Each block sorts one chunk of `len` entries (all stages k = 2..len), or,
// with k_merge > 0, runs the in-chunk steps j = len/2..1 of stage k_merge.
__global__ void wf_bitonic_block(unsigned long long* buf, int len, unsigned k_merge) {
  __shared__ unsigned long long s[SORT_BLOCK];
  const unsigned base = blockIdx.x * (unsigned)len;
  for (int i = threadIdx.x; i < len; i += blockDim.x) s[i] = buf[base + i];
  __syncthreads();
  const unsigned k_lo = k_merge ? k_merge : 2u;
  const unsigned k_hi = k_merge ? k_merge : (unsigned)len;
  for (unsigned k = k_lo; k <= k_hi; k <<= 1) {
    for (unsigned j = (k_merge ? (unsigned)len : k) >> 1; j > 0; j >>= 1) {
      for (unsigned t = threadIdx.x; t < (unsigned)len / 2; t += blockDim.x) {
        const unsigned i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        cmp_swap(s, i, i + j, base + i, k);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) buf[base + i] = s[i];
}

__global__ void wf_bitonic_global(unsigned long long* buf, int len, unsigned k, unsigned j) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (unsigned)len / 2) return;
  const unsigned i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  cmp_swap(buf, i, i + j, i, k);
}

// ---- 5. outputs ------------------------------------------------------------

__global__ void wf_write(const WaterfillArgs a) {
  const int m = min(min(a.state[0], a.group_size), a.k_slots);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.k_slots; i += gridDim.x * blockDim.x) {
    int node = -1;
    if (i < m) {
      const unsigned slot = 0xffffffffu - (unsigned)(a.sortbuf[i] & 0xffffffffull);
      node = (int)(slot / (unsigned)a.j_max);
      atomicAdd(&a.k_per_node[node], 1);
    }
    a.chosen_nodes[i] = node;
  }
}

static int grid_for(size_t work, int threads, int cap) {
  size_t b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  return (int)(b < (size_t)cap ? b : (size_t)cap);
}

// Launch one group on `stream`; returns the first CUDA error (0 if none).
// sort_len is a power of two >= k_slots; the wrapper sizes every buffer.
extern "C" int waterfill_launch(const WaterfillArgs* args, void* stream_ptr) {
  const WaterfillArgs& a = *args;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t e;
#define WF_CHECK()                      \
  do {                                  \
    e = cudaGetLastError();             \
    if (e != cudaSuccess) return (int)e; \
  } while (0)
  if ((e = cudaMemsetAsync(a.state, 0, sizeof(int) * (2 + 4 * 256), stream)) != cudaSuccess) return (int)e;
  if ((e = cudaMemsetAsync(a.k_per_node, 0, sizeof(int) * a.N, stream)) != cudaSuccess) return (int)e;
  if ((e = cudaMemsetAsync(a.sortbuf, 0, sizeof(unsigned long long) * a.sort_len, stream)) != cudaSuccess)
    return (int)e;
  wf_node_pass<<<1, NODE_THREADS, 0, stream>>>(a);
  WF_CHECK();
  const int key_threads = 256;
  wf_key_pass<<<grid_for((size_t)a.N * 32, key_threads, 1 << 30), key_threads, 0, stream>>>(a);
  WF_CHECK();
  const size_t S = (size_t)a.N * a.j_max;
  const int scan_blocks = grid_for(S, SCAN_THREADS, 132 * 8);
  for (int pass = 0; pass < 4; ++pass) {
    wf_radix_pass<<<scan_blocks, SCAN_THREADS, 0, stream>>>(a, pass);
    WF_CHECK();
  }
  wf_compact<<<scan_blocks, SCAN_THREADS, 0, stream>>>(a);
  WF_CHECK();
  const int len = a.sort_len;
  if (len <= SORT_BLOCK) {
    wf_bitonic_block<<<1, len / 2 < 1024 ? (len / 2 < 32 ? 32 : len / 2) : 1024, 0, stream>>>(
        a.sortbuf, len, 0u);
    WF_CHECK();
  } else {
    const int chunks = len / SORT_BLOCK;
    wf_bitonic_block<<<chunks, 1024, 0, stream>>>(a.sortbuf, SORT_BLOCK, 0u);
    WF_CHECK();
    for (unsigned k = 2u * SORT_BLOCK; k <= (unsigned)len; k <<= 1) {
      for (unsigned j = k >> 1; j >= (unsigned)SORT_BLOCK; j >>= 1) {
        wf_bitonic_global<<<grid_for((size_t)len / 2, 256, 1 << 30), 256, 0, stream>>>(a.sortbuf, len, k, j);
        WF_CHECK();
      }
      wf_bitonic_block<<<chunks, 1024, 0, stream>>>(a.sortbuf, SORT_BLOCK, k);
      WF_CHECK();
    }
  }
  wf_write<<<grid_for((size_t)a.k_slots, 256, 132 * 8), 256, 0, stream>>>(a);
  WF_CHECK();
#undef WF_CHECK
  return 0;
}

extern "C" int waterfill_args_size() { return (int)sizeof(WaterfillArgs); }
