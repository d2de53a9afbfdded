// Kernel E: one eps-phase of the forward auction as one thread-block
// cluster launch (sm_90a).
//
// Replaces: kubernetes_tpu/models/transport.py:130 _auction_phase (jax.jit
// around a lax.while_loop). The plain PyTorch version is models/transport.py
// _auction_phase_plain; the two must agree exactly in x, price, level and
// rounds.
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
//   cond     any(supply - sum_n x > 0) & progress & rounds < max_rounds
//
// What bounds it: neither bytes nor operations but the rounds' dependency
// chain. The first design launched three kernels a round (G blocks of 17
// block-wide argmax passes over N, one block per node, a one-block finish)
// and the host read the loop flag every eight rounds: ~44 us of device and
// ~22 us of host time a round on an H100. Here a round costs one cluster
// exchange and a few short warp-level chains, and a phase is one launch and
// one host read (rounds).
//
// Design: one cluster of CS CTAs (16, else 8; cluster_exchange.cuh) loops
// over the rounds on the device. CTA c owns the nodes c, c + CS, c + 2 CS, ...
// (round robin, so the lowest indices, where tied bids land, spread over
// the CTAs' accept steps) and keeps their cells (x, level, utility, jcap,
// this round's bids), price, slots and free in its shared memory for the
// whole phase.
//  - One exchange a round. Each CTA sends, per group, the K + 1 best keys of
//    its own nodes (key = ord(v) << 32 | ~index: value desc, lowest index on
//    ties), with each node's free units (jcap - x) and the CTA's change of
//    the group's row sum from the previous accept. One warp a group finds
//    them: each lane sorts the keys of a block of the CTA's nodes, all below
//    the next lane's, in registers (a bitonic network) into a list, and 17
//    steps of a warp maximum and a ballot take the heads.
//    Every CTA then sums the changes into its replica of sum_n x (the loop
//    condition, evaluated alike everywhere) and merges each bidding group's
//    CS sorted lists the same way (one warp a group, lane c holding CTA c's
//    list; a second maximum, of the low words, breaks ties, since the CTAs'
//    nodes interleave), so all CTAs hold the same top K + 1 and compute the
//    same bids (the exclusive prefix as a warp scan); each keeps the bids on
//    its own nodes.
//  - Accept only where something can change: a node that received no bid
//    keeps its holders, level and price, because its holders are the set its
//    last knapsack kept, which fit free and slots (free does not change in a
//    phase), so re-walking them keeps all and rejects none. So after round 1
//    the accept walks only the nodes that got bids (at most 16 G); round 1
//    also walks every node whose x0 is not zero (an x0 may overfill a node)
//    and resets the level of every empty cell to NEG_INF as the reference's
//    fold does. (testing.py auction_phase_touched is this round in numpy,
//    held against the reference on the CPU.) A walked node goes to one warp:
//    its candidates are ranked by packed (~ord(level) << 32 | row) keys and
//    one lane walks the knapsack.
//  - Where a region does not fit in shared memory (large G), it sits in a
//    per-CTA slice of a global scratch buffer, and the exchange in a global
//    array with barrier.cluster; the layout is chosen by shape by the
//    wrapper's plan (ops/kernels.py auction_plan).
//
// Parity: int32 arithmetic wraps (uint32), Python floor division, float32
// adds/subtracts with _rn intrinsics (the file is built with --fmad=false);
// bid levels are fmaxf(NEG_INF, beta) as `.at[].max` on a NEG_INF fill.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

#define AU_THREADS 256
#define AU_WARPS (AU_THREADS / 32)
#define AU_TOPK 16
#define AU_LIST (AU_TOPK + 1)  // entries a CTA sends per group: the K + 1 best
#define AU_MAX_R 32
#define AU_MAX_CS 16
#define AU_BIG (1 << 30)
#define NEG_INF (-1e30f)
// dynamic shared memory a CTA may take (the card allows 227 KB per block)
#define AU_SMEM_BUDGET (220 * 1024)

// regions of a CTA, in the order the plan places them in shared memory
enum { RG_GROUPS, RG_NODES, RG_EXCHANGE, RG_LISTS, RG_CELLS, RG_CANDIDATES, AU_NRG };

struct AuctionArgs {
  int G, N, R, K, max_rounds;
  int cs, threads, chunk, smem_bytes;
  int off[AU_NRG];         // byte offset in dynamic shared memory, -1: global
  long long goff[AU_NRG];  // byte offset in the CTA's global slice
  long long gbytes;        // one CTA's global slice
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
  int* rounds;           // [1] out
  char* gscratch;        // cs slices of gbytes
  int4* xslots;          // [2][cs][G][AU_LIST]: the exchange when it is global
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

// A lane's AU_LIST best keys, descending, in registers (static indices
// only), where a lane has more than 16 keys.
struct TopList {
  unsigned long long k[AU_LIST];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int q = 0; q < AU_LIST; ++q) k[q] = 0ull;
  }
  __device__ __forceinline__ void insert(unsigned long long v) {
    if (v <= k[AU_LIST - 1]) return;
#pragma unroll
    for (int q = AU_LIST - 1; q > 0; --q) k[q] = v > k[q - 1] ? k[q - 1] : (v > k[q] ? v : k[q]);
    k[0] = v > k[0] ? v : k[0];
  }
};

// The warp's AU_LIST best keys over the lanes' lists (each AU_LIST keys,
// descending, 0-padded; lane l's key q at list[q * stride], list null for
// no list): lane t gets the t-th (0 past the end) and *from the lane whose
// list it came from and *at its place there. A step is a warp maximum of
// the high words, then (unless `lane_order`) of the low words among the
// lanes holding the highest, and a ballot; the winner's next key is loaded
// a step ahead. `lane_order` says every key of lane l is of lower node
// index than lane l + 1's, so among equal values the lowest lane wins and
// the second maximum is not needed.
__device__ __forceinline__ unsigned long long warp_select(const unsigned long long* list, int stride,
                                                          int in_smem, bool lane_order, int lane,
                                                          int* from, int* at) {
  auto key = [&](int q) -> unsigned long long {
    if (!list || q >= AU_LIST) return 0ull;
    return in_smem ? list[(size_t)q * stride] : __ldcg(list + (size_t)q * stride);
  };
  unsigned long long head = key(0), next = key(1), mine = 0ull;
  int pos = 0, src = -1;
  for (int t = 0; t < AU_LIST; ++t) {
    const unsigned hi = (unsigned)(head >> 32);
    const unsigned mhi = __reduce_max_sync(0xffffffffu, hi);
    if (mhi == 0u) break;
    const unsigned lo = (unsigned)head;
    const unsigned mlo = lane_order ? 0u : __reduce_max_sync(0xffffffffu, hi == mhi ? lo : 0u);
    const int wl =
        __ffs(__ballot_sync(0xffffffffu, hi == mhi && (lane_order || lo == mlo))) - 1;
    if (lane_order) {  // the winner's key, off the chain of steps
      const unsigned long long m = __shfl_sync(0xffffffffu, head, wl);
      if (lane == t) mine = m;
    } else if (lane == t) {
      mine = ((unsigned long long)mhi << 32) | mlo;
    }
    if (lane == t) src = wl;
    if (lane == wl) {
      head = next;
      next = key(++pos + 1);
    }
  }
  // the place in its list: the earlier picks from the same lane
  const unsigned same = __match_any_sync(0xffffffffu, src);
  *from = src;
  *at = __popc(same & ((1u << lane) - 1u));
  return mine;
}

// Sorts a lane's 16 keys (0-padded) descending: a bitonic network with
// static indices, so the keys stay in registers.
__device__ __forceinline__ void sort16_desc(unsigned long long (&k)[16]) {
#pragma unroll
  for (int size = 2; size <= 16; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = k[i], b = k[l];
          const bool swap = (i & size) == 0 ? a < b : a > b;
          k[i] = swap ? b : a;
          k[l] = swap ? a : b;
        }
      }
    }
  }
}

// an exchange slot: in this CTA's shared memory, or in the cluster's global
// array past barrier.cluster (read from L2, not from this SM's L1)
__device__ __forceinline__ int4 slot_at(const int4* p, int in_smem) {
  return in_smem ? *p : __ldcg(p);
}

// One walked node's knapsack, by one thread: the candidates in (level desc,
// row asc) order, a sequential int32 knapsack against free and slots, the
// kept units folded into x and level, the price raised to the highest
// rejected level. RS bounds R at compile time, so `used` stays in registers;
// R <= 4 (cpu, memory, ephemeral storage and at most one extended resource)
// takes the short loops: with RS = AU_MAX_R for every R the accept step took
// twice as long on an H100 (tools/kernel_sections.py).
struct Walk {
  int G, R, chunk, i;
  int* x;
  float* level;
  const int* req;
  const int* fr;
  int slots;
  int* delta;
  const unsigned long long* ckey;
  const int* cunits;
  const int* corder;
};

template <int RS>
__device__ __forceinline__ void knapsack(const Walk& w, int C, float* price) {
  const float half = NEG_INF * 0.5f;
  int used[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) used[r] = 0;
  int count = 0;
  bool any_rej = false;
  float top_rej = NEG_INF;
  for (int c = 0; c < C; ++c) {
    const int j = w.corder[c];
    const unsigned long long key = w.ckey[j];
    const float l = float_of(~(unsigned)(key >> 32));
    const int row = (int)(key & 0xffffffffu);
    const int g = row < w.G ? row : row - w.G;
    const int u = w.cunits[j];
    const int* rq = w.req + (size_t)g * w.R;
    int fit = AU_BIG;
#pragma unroll
    for (int r = 0; r < RS; ++r)
      if (r < w.R && rq[r] > 0) fit = min(fit, floordiv(wsub(w.fr[r], used[r]), max(rq[r], 1)));
    fit = min(fit, wsub(w.slots, count));
    int k = min(max(fit, 0), u);
    if (!(l > half)) k = 0;
#pragma unroll
    for (int r = 0; r < RS; ++r)
      if (r < w.R) used[r] = wadd(used[r], wmul(k, rq[r]));
    count = wadd(count, k);
    if (wsub(u, k) > 0) {
      any_rej = true;
      top_rej = fmaxf(top_rej, l);
    }
    if (k > 0) {
      const size_t cc = (size_t)g * w.chunk + w.i;
      const int xi = w.x[cc];
      w.level[cc] = xi == 0 ? l : fminf(w.level[cc], l);
      w.x[cc] = wadd(xi, k);
      atomicAdd(&w.delta[g], k);
    }
  }
  if (any_rej) price[w.i] = fmaxf(price[w.i], top_rej);
}

__global__ void __launch_bounds__(AU_THREADS, 1) auction_phase_kernel(const AuctionArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bars[2];
  __shared__ int n_touched;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = a.cs, G = a.G, N = a.N, R = a.R, K = a.K, chunk = a.chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // local node i is node rank + cs * i (round robin: the lowest indices,
  // where tied bids land, spread over the CTAs)
  const int cnt = rank < N ? (N - rank + cs - 1) / cs : 0;
  const float half = NEG_INF * 0.5f;
  char* gslice = a.gscratch ? a.gscratch + (size_t)rank * a.gbytes : nullptr;
#define REGION(T, r) ((T*)(a.off[r] >= 0 ? (char*)smem + a.off[r] : gslice + a.goff[r]))
  int* supply = REGION(int, RG_GROUPS);
  int* xsum = supply + G;  // the replica of sum_n x, alike in every CTA
  int* delta = xsum + G;   // this CTA's change of it since its last message
  int* req = delta + G;    // [G, R]
  float* price = REGION(float, RG_NODES);
  int* slots = (int*)(price + chunk);
  int* tflag = slots + chunk;  // the node is walked this round
  int* tlist = tflag + chunk;
  int* freen = tlist + chunk;  // [chunk, R]
  const size_t GC = (size_t)G * chunk;  // cell (g, i) at g * chunk + i
  int* x = REGION(int, RG_CELLS);
  float* level = (float*)(x + GC);
  float* util = level + GC;
  int* jcap = (int*)(util + GC);
  int* bid_units = jcap + GC;
  float* bid_level = (float*)(bid_units + GC);
  const int xsmem = a.off[RG_EXCHANGE] >= 0;
  int4* xs = xsmem ? (int4*)(smem + a.off[RG_EXCHANGE]) : a.xslots;  // [2][cs][G][AU_LIST]
  unsigned long long* lists = REGION(unsigned long long, RG_LISTS);  // [warps][32][AU_LIST]
  unsigned long long* ckey = (unsigned long long*)(REGION(char, RG_CANDIDATES) +
                                                   (size_t)warp * 2 * G * 16);
  int* cunits = (int*)(ckey + 2 * G);
  int* corder = cunits + 2 * G;
#undef REGION

  // ---- load the CTA's share of the phase's state ----
  for (int j = tid; j < G; j += AU_THREADS) {
    supply[j] = a.supply[j];
    xsum[j] = 0;
  }
  for (int j = tid; j < G * R; j += AU_THREADS) req[j] = a.req[j];
  for (int i = tid; i < cnt; i += AU_THREADS) {
    const int n = rank + cs * i;
    price[i] = a.price0[n];
    slots[i] = a.slots[n];
    tflag[i] = 0;
    for (int r = 0; r < R; ++r) freen[i * R + r] = a.free[(size_t)n * R + r];
  }
  for (size_t j = tid; j < (size_t)G * cnt; j += AU_THREADS) {
    const int g = (int)(j / cnt), i = (int)(j % cnt);
    const size_t s = (size_t)g * N + rank + (size_t)cs * i, c = (size_t)g * chunk + i;
    x[c] = a.x0[s];
    level[c] = a.level0[s];
    util[c] = a.utility[s];
    jcap[c] = a.jcap[s];
    bid_units[c] = 0;
  }
  __syncthreads();
  // the first message's changes are the CTA's row sums of x0; round 1 walks
  // every node whose x0 is not zero
  for (int g = warp; g < G; g += AU_WARPS) {
    unsigned s = 0u;
    for (int i = lane; i < cnt; i += 32) {
      const int xv = x[(size_t)g * chunk + i];
      s += (unsigned)xv;
      if (xv != 0) tflag[i] = 1;
    }
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0) delta[g] = (int)s;
  }
  Xchg xc;
  const unsigned xbytes = (unsigned)(cs * G * AU_LIST * 16);  // either parity
  xchg_init(xc, smem_addr(bars), xbytes, xbytes, xsmem);
  __syncthreads();
  cluster.sync();  // every CTA has started and armed its barriers

  int rounds = 0, progress = 1, p = 0;
  for (;;) {
    if (tid == 0) n_touched = 0;
    // ---- the message: per group the K + 1 best keys of this CTA's nodes
    // with their free units, and the change of the row sum ----
    for (int g = warp; g < G; g += AU_WARPS) {
      const float* ug = util + (size_t)g * chunk;
      const int* jg = jcap + (size_t)g * chunk;
      const int* xg = x + (size_t)g * chunk;
      auto key_of = [&](int i) {
        const float v = jg[i] > xg[i] ? __fsub_rn(ug[i], price[i]) : NEG_INF;
        return ((unsigned long long)ord_of(v) << 32) |
               (unsigned long long)(0xffffffffu - (unsigned)(rank + cs * i));
      };
      // lane l sorts the keys of the local nodes [l * per, (l + 1) * per),
      // all below lane l + 1's, into its list (16 in registers; more, its 17
      // best by insertion)
      const int per = (cnt + 31) / 32, i0 = lane * per, i1 = min(i0 + per, cnt);
      unsigned long long* mylist = lists + ((size_t)warp * 32 + lane) * AU_LIST;
      if (per <= 16) {
        unsigned long long k[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) k[q] = i0 + q < i1 ? key_of(i0 + q) : 0ull;
        sort16_desc(k);
#pragma unroll
        for (int q = 0; q < 16; ++q) mylist[q] = k[q];
        mylist[16] = 0ull;
      } else {
        TopList top;
        top.clear();
        for (int i = i0; i < i1; ++i) top.insert(key_of(i));
#pragma unroll
        for (int q = 0; q < AU_LIST; ++q) mylist[q] = top.k[q];
      }
      int from, at;
      const unsigned long long m = warp_select(mylist, 1, 1, true, lane, &from, &at);
      int4 e = make_int4(0, 0, 0, 0);  // lane t's entry; 0 pads a short list
      if (m) {
        const int i = ((int)(0xffffffffu - (unsigned)m) - rank) / cs;
        e = make_int4((int)(unsigned)m, (int)(unsigned)(m >> 32), max(wsub(jg[i], xg[i]), 0), 0);
      }
      if (lane == 0) {
        e.w = delta[g];
        delta[g] = 0;
      }
      if (lane < AU_LIST) {
        const size_t slot = ((size_t)(p * cs + rank) * G + g) * AU_LIST + lane;
        if (xsmem) {
          const unsigned dst = smem_addr(&xs[slot]), bar = xc.bar + 8 * p;
          for (int d = 0; d < cs; ++d) st_async_v4(remote_addr(dst, d), e, remote_addr(bar, d));
        } else {
          xs[slot] = e;
        }
      }
    }
    xchg_wait(xc, p);
    const int4* msg = xs + (size_t)p * cs * G * AU_LIST;  // CTA c's group g: (c * G + g) * AU_LIST

    // ---- the loop condition on the summed changes (alike in every CTA) ----
    int any_un = 0;
    for (int g = tid; g < G; g += AU_THREADS) {
      unsigned d[AU_MAX_CS];
#pragma unroll
      for (int c = 0; c < AU_MAX_CS; ++c)
        d[c] = c < cs ? (unsigned)slot_at(msg + ((size_t)c * G + g) * AU_LIST, xsmem).w : 0u;
      unsigned s = (unsigned)xsum[g];
#pragma unroll
      for (int c = 0; c < AU_MAX_CS; ++c) s += d[c];
      xsum[g] = (int)s;
      if (wsub(supply[g], (int)s) > 0) any_un = 1;
    }
    any_un = __syncthreads_or(any_un);
    if (!(any_un && progress && rounds < a.max_rounds)) break;

    // ---- bids: merge every bidding group's CS lists, keep the bids on
    // this CTA's nodes ----
    int prog = 0;
    for (int g = warp; g < G; g += AU_WARPS) {
      const int unassigned = wsub(supply[g], xsum[g]);
      if (unassigned <= 0) continue;
      const int4* gl = msg + (size_t)g * AU_LIST;  // CTA c's list at gl + c * G * AU_LIST
      // lane c: CTA c's list (sorted), the keys in the entries' first 8 bytes
      const unsigned long long* own =
          lane < cs ? (const unsigned long long*)(gl + (size_t)lane * G * AU_LIST) : nullptr;
      int from, at;
      const unsigned long long tk =
          warp_select(own, 2, xsmem, false, lane, &from, &at);  // lane t: the t-th
      const int tav = tk ? slot_at(gl + (size_t)from * G * AU_LIST + at, xsmem).z : 0;
      const float vk = float_of((unsigned)(tk >> 32));
      const int jk = (int)(0xffffffffu - (unsigned)tk);
      const float v1 = __shfl_sync(0xffffffffu, vk, 0);
      const float vlast = __shfl_sync(0xffffffffu, vk, K - 1);
      const unsigned long long knext = __shfl_sync(0xffffffffu, tk, K);
      // v.at[rows, jk].set(NEG_INF).max(): the (K+1)-th value, NEG_INF if N == K
      float v_next = N > K ? float_of((unsigned)(knext >> 32)) : NEG_INF;
      if (v_next <= half) v_next = vlast > half ? vlast : v1;
      if (!(v1 > half)) continue;  // not bidding
      const int avail = (lane < K && vk > half) ? tav : 0;
      unsigned inc = (unsigned)avail;  // the inclusive prefix (wrapping)
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
      }
      const int prefix = (int)(inc - (unsigned)avail);
      const int units = lane < K ? min(max(wsub(unassigned, prefix), 0), avail) : 0;
      if (units > 0) {
        prog = 1;
        if (jk % cs == rank) {
          const int i = jk / cs;
          const size_t c = (size_t)g * chunk + i;
          bid_units[c] = units;
          bid_level[c] = fmaxf(NEG_INF, __fadd_rn(__fsub_rn(util[c], v_next), a.eps));
          tflag[i] = 1;
        }
      }
    }
    if (rounds == 0)  // the reference's fold gives every empty cell NEG_INF
      for (size_t j = tid; j < (size_t)G * cnt; j += AU_THREADS) {
        const size_t c = (j / cnt) * chunk + j % cnt;
        if (x[c] == 0) level[c] = NEG_INF;
      }
    progress = __syncthreads_or(prog);  // every thread is past its last read of the slots
    xchg_rearm(xc, p);
    p ^= 1;
    for (int i = tid; i < cnt; i += AU_THREADS)
      if (tflag[i]) tlist[atomicAdd(&n_touched, 1)] = i;
    __syncthreads();

    // ---- accept: one warp a walked node ----
    const int nt = n_touched;
    for (int t = warp; t < nt; t += AU_WARPS) {
      const int i = tlist[t];
      int C = 0;
      for (int b = 0; b < G; b += 32) {  // holders, then bidders, with units > 0
        const int g = b + lane;
        int hx = 0, hb = 0;
        float hl = 0.0f, bl = 0.0f;
        if (g < G) {
          const size_t c = (size_t)g * chunk + i;
          hx = x[c];
          hb = bid_units[c];
          if (hx > 0) hl = level[c];
          if (hb > 0) bl = bid_level[c];
          if (hx != 0) atomicAdd(&delta[g], -hx);
          x[c] = 0;  // the column is rewritten from the kept units
          level[c] = NEG_INF;
          bid_units[c] = 0;
        }
        const unsigned mh = __ballot_sync(0xffffffffu, hx > 0);
        const unsigned mb = __ballot_sync(0xffffffffu, hb > 0);
        const unsigned below = (1u << lane) - 1u;
        if (hx > 0) {
          const int s = C + __popc(mh & below);
          ckey[s] = ((unsigned long long)(~ord_of(hl)) << 32) | (unsigned)g;
          cunits[s] = hx;
        }
        if (hb > 0) {
          const int s = C + __popc(mh) + __popc(mb & below);
          ckey[s] = ((unsigned long long)(~ord_of(bl)) << 32) | (unsigned)(G + g);
          cunits[s] = hb;
        }
        C += __popc(mh) + __popc(mb);
      }
      __syncwarp();
      // (level desc, row asc): the keys are distinct, a key's rank is its place
      for (int j = lane; j < C; j += 32) {
        const unsigned long long kj = ckey[j];
        int rk = 0;
        for (int k = 0; k < C; ++k) rk += ckey[k] < kj;
        corder[rk] = j;
      }
      __syncwarp();
      if (lane == 0) {
        const Walk w{G, R, chunk, i, x, level, req, freen + (size_t)i * R, slots[i], delta,
                     ckey, cunits, corder};
        if (R <= 4) knapsack<4>(w, C, price);
        else knapsack<AU_MAX_R>(w, C, price);
        tflag[i] = 0;
      }
      __syncwarp();
    }
    __syncthreads();
    ++rounds;
  }

  // ---- write the phase's result back ----
  __syncthreads();
  for (size_t j = tid; j < (size_t)G * cnt; j += AU_THREADS) {
    const int g = (int)(j / cnt), i = (int)(j % cnt);
    const size_t s = (size_t)g * N + rank + (size_t)cs * i, c = (size_t)g * chunk + i;
    a.x[s] = x[c];
    a.level[s] = level[c];
  }
  for (int i = tid; i < cnt; i += AU_THREADS) a.price[rank + cs * i] = price[i];
  if (rank == 0 && tid == 0) a.rounds[0] = rounds;
  cluster.sync();  // no CTA leaves while another may still use its slots
}

// ---------------------------------------------------------------------------
// host side: the cluster size (once per process), the launch
// ---------------------------------------------------------------------------

static int g_cluster_size = 0;
static int g_cluster_error = 0;

// 16 or 8, or minus the CUDA error that refused both
extern "C" int auction_phase_cluster_size() {
  if (!g_cluster_size && !g_cluster_error)
    g_cluster_size = choose_cluster_size(auction_phase_kernel, AU_THREADS, AU_SMEM_BUDGET,
                                         &g_cluster_error);
  return g_cluster_size ? g_cluster_size : -g_cluster_error;
}

// One phase on `stream` as one cluster, with the layout the wrapper planned
// (ops/kernels.py auction_plan). *launched counts the kernels launched.
// Returns the CUDA error of the launch (a refused cluster launch never runs;
// nothing retries it).
extern "C" int auction_phase_launch(const AuctionArgs* args, void* stream, int* launched) {
  *launched = 0;
  const int cs = auction_phase_cluster_size();
  if (cs <= 0) return -cs;
  if (args->cs != cs || args->threads != AU_THREADS || args->smem_bytes > AU_SMEM_BUDGET)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(cs, AU_THREADS, args->smem_bytes, (cudaStream_t)stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, auction_phase_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int auction_args_size() { return (int)sizeof(AuctionArgs); }
extern "C" int auction_max_r() { return AU_MAX_R; }
