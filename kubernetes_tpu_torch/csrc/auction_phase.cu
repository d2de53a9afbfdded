// Kernel E: one eps-phase of the forward auction (sm_90a).
//
// Replaces: kubernetes_tpu/models/transport.py:130 _auction_phase (jax.jit
// around a lax.while_loop). The plain PyTorch version is
// models/transport.py _auction_phase_plain; the two must agree exactly in x,
// price, level and rounds.
//
// One round of the reference body, on the [G, N] transportation problem:
//   bids     per group g with unassigned = supply - sum_n x > 0: the values
//            v = jcap > x ? utility - price : NEG_INF, its top K = min(16, N)
//            nodes in lax.top_k's order (value desc, lowest index on ties),
//            v_next = the best value outside them (with the reference's two
//            substitutions), then per k: avail, the exclusive prefix, units
//            and beta = (u - v_next) + eps, in that order
//   accept   per node: its holders (rows 0..G-1, level = the cell's level)
//            and bidders (rows G..2G-1, level = beta) merged by level
//            descending, STABLE (equal levels keep row order: holders first;
//            +0.0 == -0.0), then a sequential int32 knapsack: fit = min over
//            resources of floor((free - used) / req) (2^30 for a zero
//            request), capped by slots - count, clipped to [0, units]; the
//            price rises to the highest rejected level; kept units fold back
//            into x and the cell's level takes the min of the kept levels
//   cond     any(supply - sum_n x > 0) & progress & rounds < max_rounds,
//            kept on the device in ctrl[0]
// A round whose flag is clear does nothing, so the host launches rounds in
// chunks and reads the flag between chunks; `rounds` is still JAX's count.
//
// What bounds it: neither bytes nor operations but the round's dependency
// chain: each round is three launches (bids, accept, finish) whose work is
// a few passes over [G, N]. The bids step is G blocks of 17 block-wide
// argmax passes over N (the top 16 and v_next) plus one thread's bid
// arithmetic; the accept step is one block per node: gather the candidates
// with units > 0 (rows with no units keep nothing and reject nothing, so
// they are skipped), a bitonic sort of packed (level desc, row asc) keys
// with the units as payload (a total order, so the sort is stable in
// effect), and one thread's knapsack walk. The wrapper places the keys in
// shared memory up to 4,096 candidates (2G <= 4,096; one block per node)
// and beyond that in a global scratch slice per block (a grid of at most
// 264 blocks striding over the nodes).
//
// Parity: int32 arithmetic wraps (uint32), Python floor division, float32
// adds/subtracts with _rn intrinsics (the file is built with --fmad=false);
// bid levels are fmaxf(NEG_INF, beta) as `.at[].max` on a NEG_INF fill.

#include <cuda_runtime.h>
#include <stdint.h>

#define AU_THREADS 256
#define AU_WARPS (AU_THREADS / 32)
#define AU_TOPK 16
#define AU_MAX_R 32
#define AU_BIG (1 << 30)
#define NEG_INF (-1e30f)

struct AuctionArgs {
  int G, N, R, K, max_rounds;
  int key_cap, keys_in_smem, accept_blocks;  // the accept step's key slice and grid
  float eps;
  const float* utility;  // [G, N]
  const int* jcap;       // [G, N]
  const int* supply;     // [G]
  const int* slots;      // [N]
  const int* req;        // [G, R]
  const int* free;       // [N, R]
  const int* x0;         // [G, N]
  const float* price0;   // [N]
  const float* level0;   // [G, N]
  int* x;                // [G, N] out
  float* price;          // [N] out
  float* level;          // [G, N] out
  int* bid_units;        // [G, N] scratch, all zero between rounds
  float* bid_level;      // [G, N] scratch, read only where bid_units > 0
  int* xsum;             // [G] sum_n x[g, n]
  int* xsum_next;        // [G] the next round's sums (atomics)
  int* ctrl;             // [3] active, rounds, progress of this round's bids
  unsigned long long* keys_g;  // [accept_blocks, key_cap] (global path only)
  int* vals_g;                 // [accept_blocks, key_cap]
};

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) q -= 1;
  return q;
}

// float -> uint32 whose unsigned order is the float order (+0.0 == -0.0)
__device__ __forceinline__ unsigned ord_of(float v) {
  if (v == 0.0f) v = 0.0f;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned o) {
  const unsigned u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ unsigned long long block_max_u64(unsigned long long v,
                                                            unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  unsigned long long m = 0ull;
  for (int w = 0; w < AU_WARPS; ++w) m = red[w] > m ? red[w] : m;
  return m;
}

// phase start: x, level, price from the inputs, the row sums, zero bids
__global__ void __launch_bounds__(AU_THREADS) au_init(const AuctionArgs a) {
  __shared__ int red[AU_WARPS];
  const int g = blockIdx.x, N = a.N;
  unsigned s = 0;
  for (int n = threadIdx.x; n < N; n += AU_THREADS) {
    const size_t i = (size_t)g * N + n;
    const int xv = a.x0[i];
    a.x[i] = xv;
    a.level[i] = a.level0[i];
    a.bid_units[i] = 0;
    s += (unsigned)xv;
    if (g == 0) a.price[n] = a.price0[n];
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (int)s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
    for (int w = 0; w < AU_WARPS; ++w) t += (unsigned)red[w];
    a.xsum[g] = (int)t;
    a.xsum_next[g] = 0;
  }
}

// the loop condition; after_round also closes the round (rounds + 1, the
// new row sums, the round's progress flag)
__global__ void __launch_bounds__(1024) au_cond(const AuctionArgs a, int after_round) {
  __shared__ int ctrl_s[3];
  if (threadIdx.x == 0) {
    ctrl_s[0] = a.ctrl[0];
    ctrl_s[1] = a.ctrl[1];
    ctrl_s[2] = a.ctrl[2];
  }
  __syncthreads();
  if (after_round && !ctrl_s[0]) return;
  int any_un = 0;
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    int s = a.xsum[g];
    if (after_round) {
      s = a.xsum_next[g];
      a.xsum[g] = s;
      a.xsum_next[g] = 0;
    }
    if (wsub(a.supply[g], s) > 0) any_un = 1;
  }
  any_un = __syncthreads_or(any_un);
  if (threadIdx.x == 0) {
    const int rounds = after_round ? ctrl_s[1] + 1 : 0;
    const int progress = after_round ? ctrl_s[2] : 1;
    a.ctrl[1] = rounds;
    a.ctrl[2] = 0;
    a.ctrl[0] = (any_un && progress && rounds < a.max_rounds) ? 1 : 0;
  }
}

// bids: one block per group
__global__ void __launch_bounds__(AU_THREADS) au_bids(const AuctionArgs a) {
  __shared__ unsigned long long red[AU_WARPS];
  __shared__ unsigned long long top_s[AU_TOPK + 1];
  if (!a.ctrl[0]) return;
  const int g = blockIdx.x, N = a.N, K = a.K;
  const int unassigned = wsub(a.supply[g], a.xsum[g]);
  if (unassigned <= 0) return;  // units_k = 0: this group bids nothing
  const float* urow = a.utility + (size_t)g * N;
  const int* jrow = a.jcap + (size_t)g * N;
  const int* xrow = a.x + (size_t)g * N;
  // the K + 1 first elements of v in (value desc, index asc) order: key =
  // ord(v) << 32 | ~index, each pass the largest key below the previous one
  unsigned long long prev = ~0ull;
  for (int t = 0; t <= K; ++t) {
    unsigned long long best = 0ull;
    for (int n = threadIdx.x; n < N; n += AU_THREADS) {
      const float v = jrow[n] > xrow[n] ? __fsub_rn(urow[n], a.price[n]) : NEG_INF;
      const unsigned long long key =
          ((unsigned long long)ord_of(v) << 32) | (unsigned long long)(0xffffffffu - (unsigned)n);
      if (key < prev && key > best) best = key;
    }
    best = block_max_u64(best, red);
    if (threadIdx.x == 0) top_s[t] = best;
    prev = best;
  }
  if (threadIdx.x != 0) return;
  const float half = NEG_INF * 0.5f;
  float vk[AU_TOPK];
  int jk[AU_TOPK];
  for (int t = 0; t < K; ++t) {
    vk[t] = float_of((unsigned)(top_s[t] >> 32));
    jk[t] = (int)(0xffffffffu - (unsigned)(top_s[t] & 0xffffffffu));
  }
  const float v1 = vk[0];
  // v.at[rows, jk].set(NEG_INF).max(): the (K+1)-th value, NEG_INF if N == K
  float v_next = N > K ? float_of((unsigned)(top_s[K] >> 32)) : NEG_INF;
  if (v_next <= half) v_next = vk[K - 1] > half ? vk[K - 1] : v1;
  const bool bidding = v1 > half;  // and unassigned > 0, checked above
  if (!bidding) return;
  int run = 0;
  int any_units = 0;
  for (int t = 0; t < K; ++t) {
    const int n = jk[t];
    int avail = max(wsub(jrow[n], xrow[n]), 0);
    if (!(vk[t] > half)) avail = 0;
    const int prefix = run;
    run = wadd(run, avail);
    const int units = min(max(wsub(unassigned, prefix), 0), avail);
    if (units > 0) {
      const float beta = __fadd_rn(__fsub_rn(urow[n], v_next), a.eps);
      a.bid_units[(size_t)g * N + n] = units;
      a.bid_level[(size_t)g * N + n] = fmaxf(NEG_INF, beta);
      any_units = 1;
    }
  }
  if (any_units) a.ctrl[2] = 1;
}

// accept: one block per node (grid-strided over nodes)
__global__ void __launch_bounds__(AU_THREADS) au_accept(const AuctionArgs a) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  __shared__ int cnt_s;
  if (!a.ctrl[0]) return;
  const int G = a.G, N = a.N, R = a.R, tid = threadIdx.x;
  unsigned long long* keys;
  int* vals;
  if (a.keys_in_smem) {
    keys = (unsigned long long*)smem_raw;
    vals = (int*)(keys + a.key_cap);
  } else {
    keys = a.keys_g + (size_t)blockIdx.x * a.key_cap;
    vals = a.vals_g + (size_t)blockIdx.x * a.key_cap;
  }
  const float half = NEG_INF * 0.5f;
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    if (tid == 0) cnt_s = 0;
    __syncthreads();
    // gather the rows with units > 0: key = ~ord(level) << 32 | row
    for (int g = tid; g < G; g += AU_THREADS) {
      const size_t i = (size_t)g * N + n;
      const int hx = a.x[i];
      if (hx > 0) {
        const int s = atomicAdd(&cnt_s, 1);
        keys[s] = ((unsigned long long)(~ord_of(a.level[i])) << 32) | (unsigned)g;
        vals[s] = hx;
      }
      const int hb = a.bid_units[i];
      if (hb > 0) {
        const int s = atomicAdd(&cnt_s, 1);
        keys[s] = ((unsigned long long)(~ord_of(a.bid_level[i])) << 32) | (unsigned)(G + g);
        vals[s] = hb;
        a.bid_units[i] = 0;
      }
    }
    __syncthreads();
    const int C = cnt_s;
    int p2 = 1;
    while (p2 < C) p2 <<= 1;
    for (int j = C + tid; j < p2; j += AU_THREADS) {
      keys[j] = ~0ull;
      vals[j] = 0;
    }
    // the column is rewritten from the kept units below
    for (int g = tid; g < G; g += AU_THREADS) {
      const size_t i = (size_t)g * N + n;
      a.x[i] = 0;
      a.level[i] = NEG_INF;
    }
    __syncthreads();
    for (int k = 2; k <= p2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < p2; i += AU_THREADS) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long ki = keys[i], kj = keys[ixj];
            const bool up = (i & k) == 0;
            if ((ki > kj) == up) {
              keys[i] = kj;
              keys[ixj] = ki;
              const int t = vals[i];
              vals[i] = vals[ixj];
              vals[ixj] = t;
            }
          }
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      int used[AU_MAX_R];
      for (int r = 0; r < R; ++r) used[r] = 0;
      int cnt = 0;
      bool any_rej = false;
      float top_rej = NEG_INF;
      const int slots = a.slots[n];
      const int* fr = a.free + (size_t)n * R;
      for (int c = 0; c < C; ++c) {
        const unsigned long long key = keys[c];
        const float l = float_of(~(unsigned)(key >> 32));
        const int row = (int)(key & 0xffffffffu);
        const int g = row < G ? row : row - G;
        const int u = vals[c];
        const int* rq = a.req + (size_t)g * R;
        int fit = AU_BIG;
        for (int r = 0; r < R; ++r)
          if (rq[r] > 0) fit = min(fit, floordiv(wsub(fr[r], used[r]), max(rq[r], 1)));
        fit = min(fit, wsub(slots, cnt));
        int k = min(max(fit, 0), u);
        if (!(l > half)) k = 0;
        for (int r = 0; r < R; ++r) used[r] = wadd(used[r], wmul(k, rq[r]));
        cnt = wadd(cnt, k);
        if (wsub(u, k) > 0) {
          any_rej = true;
          top_rej = fmaxf(top_rej, l);
        }
        if (k > 0) {
          const size_t i = (size_t)g * N + n;
          const int xi = a.x[i];
          a.level[i] = xi == 0 ? l : fminf(a.level[i], l);
          a.x[i] = wadd(xi, k);
          atomicAdd(&a.xsum_next[g], k);
        }
      }
      if (any_rej) a.price[n] = fmaxf(a.price[n], top_rej);
    }
    __syncthreads();
  }
}

// phase start: copy the initial state, evaluate the loop condition
extern "C" int auction_launch(const AuctionArgs* args, void* stream_ptr) {
  const AuctionArgs& a = *args;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t e = cudaMemsetAsync(a.ctrl, 0, 3 * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  au_init<<<a.G, AU_THREADS, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  au_cond<<<1, 1024, 0, stream>>>(a, 0);
  return (int)cudaGetLastError();
}

// n_rounds rounds (each a no-op once the device flag is clear)
extern "C" int auction_rounds_launch(const AuctionArgs* args, int n_rounds, void* stream_ptr) {
  const AuctionArgs& a = *args;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t e;
  const size_t smem = a.keys_in_smem ? (size_t)a.key_cap * (sizeof(unsigned long long) + sizeof(int)) : 0;
  if (smem > 0) {  // the 48 KB default counts the static cnt_s too
    e = cudaFuncSetAttribute(au_accept, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  for (int i = 0; i < n_rounds; ++i) {
    au_bids<<<a.G, AU_THREADS, 0, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    au_accept<<<a.accept_blocks, AU_THREADS, smem, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    au_cond<<<1, 1024, 0, stream>>>(a, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int auction_args_size() { return (int)sizeof(AuctionArgs); }
extern "C" int auction_max_r() { return AU_MAX_R; }
