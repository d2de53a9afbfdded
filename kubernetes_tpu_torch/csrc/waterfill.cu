// Kernel C: one waterfill group as one thread-block-cluster launch, for
// Hopper (sm_90a).
//
// Replaces: kubernetes_tpu/models/waterfill.py waterfill_group (jax.jit,
// :79-154). Same function: for a group of identical pods, per node the fit
// depth j_cap (floor(free/req) min over resources, pod headroom, filter row,
// host-port cap, clipped to [0, j_max]); a static score 2*napref + 3*taint +
// img (+ gang) normalized over the nodes with j_cap > 0; per slot (n, j) the
// marginal LeastAllocated + Balanced score, a running min along j, and the
// int32 key score * (N*j_max + 1) - (n*j_max + j); the top k_slots keys in
// descending order; chosen_nodes[i] = slot / j_max for the first
// m = min(valid keys, group_size, k_slots) of them, -1 after; k_per_node
// counts them. The plain PyTorch version is models/waterfill.py
// waterfill_group_plain; the two must agree exactly.
//
// What bounds it: neither bytes nor operations. At 5,000 nodes x j_max 128
// the slots are 640,000 and the scoring ~30 operations a slot, microseconds
// of the card's rates. The first design launched nine kernels and three
// memsets a group (a one-block node pass, a 2.5 MB key matrix in global
// memory read back by a four-pass radix select over all 640,000 keys, a
// compaction and a one-block bitonic sort): ~0.14 ms a group, a chain of
// dependent passes and their launches. Here a group is one launch.
//
// The structure the design rests on. In a node's row the score after the
// running min is non-increasing in j and the rank n*j_max + j rises with
// j, so the key falls strictly along j, and the valid keys (j < j_cap) are
// a prefix of the row, sorted descending. PRECONDITION: this holds only
// while score * (N*j_max + 1) does not wrap int32, which the slot budgets
// of the callers guarantee (models/waterfill.py waterfill_solve's
// max_slots, models/repair.py REPAIR_MAX_SLOTS); the wrapper raises where a
// call's N*j_max is beyond every such budget. Keys are then also unique, so
// exactly m keys are at or above the m-th largest.
//
// Design: one cluster of CS CTAs (16, else 8; cluster_exchange.cuh),
// WF_THREADS threads each. CTA c owns the nodes [c*chunk, (c+1)*chunk).
//   1. Node pass: j_cap and the CTA's maxima of napref/taint over j_cap > 0;
//      a cluster barrier, every CTA reads the others' maxima (DSMEM) and
//      scores its nodes' static part; a block scan of j_cap places each
//      row in the CTA's key array.
//   2. Rows: a group of lanes a node (several short rows a warp) scores
//      j < j_cap (the running min by a segmented warp scan, a carry across
//      chunks of 32) and keeps the row's ordered keys
//      (key ^ 2^31, 0 = invalid) in shared memory. No key matrix is written
//      to global memory (a CTA whose rows exceed its shared memory keeps
//      them in its slice of a global scratch buffer).
//   3. Threshold select: the m-th largest key T by 4 radix passes of 8
//      bits. A pass counts the keys under the current prefix by digit from
//      the sorted rows: equal digits form runs, and only a run's first key
//      (minus its index) and last key (plus its index + 1) touch the CTA's
//      256-bin histogram. One exchange a pass: each CTA pushes its
//      histogram into every CTA's slots by st.async and waits on its own
//      mbarrier, then sums the CS histograms and takes the same digit. Pass 0's
//      histogram also gives the number of valid keys, hence m.
//   4. c_n = the keys of row n at or above T (a binary search in the
//      sorted row) is k_per_node[n], written by its owner, with no atomics.
//   5. Order: each CTA gathers its nodes' chosen keys (the first c_n of each
//      row) and bitonic-sorts them descending (in registers, one entry a
//      thread, while they fit, else in its list); after a
//      cluster barrier, an entry's place in the group's greedy order is its
//      place in its CTA's list plus, for every other CTA, the count of that
//      CTA's chosen keys above it (a binary search over DSMEM, the CS
//      searches in lockstep). chosen_nodes beyond m are -1.
// Every region a CTA keeps (node arrays, key rows, its chosen list) sits in
// dynamic shared memory while it fits, else in the CTA's slice of a global
// scratch buffer; nothing needs zeroing before the launch.
//
// Parity: int32 arithmetic wraps as in XLA (done in uint32); Python/JAX
// floor division via floordiv(); Balanced in float32 with explicit _rn
// intrinsics and --fmad=false (no FMA contraction), truncated to int32.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "cluster_exchange.cuh"

#define WF_THREADS 512
#define WF_WARPS (WF_THREADS / 32)
#define WF_MAX_CS 16
// dynamic shared memory a CTA may take (the card allows 227 KB per block)
#define WF_SMEM_BUDGET (216 * 1024)
// node arrays: j_cap, static, row offset, row length, c_n, list offset, and
// the rows' inputs alloc, used, used_nz of cpu and memory
#define WF_NODE_ARRAYS 12

struct WaterfillArgs {
  int N, R, j_max, k_slots, group_size, has_port, has_gang;
  int cs, chunk;   // cluster size, nodes a CTA (ceil(N / cs))
  int list_cap;    // entries of a CTA's list slot: pow2(min(k_slots, chunk * j_max))
  long long slice_bytes;  // one CTA's global fallback slice
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
  // cs slices of slice_bytes: [node arrays][key rows][chosen list]
  unsigned char* gscratch;
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

__device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// byte offsets of the regions in a CTA's global slice (ops/kernels.py
// launch_waterfill_group sizes the slice the same way)
__device__ __forceinline__ size_t g_keys_off(const WaterfillArgs& a) {
  return align16((size_t)WF_NODE_ARRAYS * (a.chunk + 1) * 4);
}
__device__ __forceinline__ size_t g_list_off(const WaterfillArgs& a) {
  return g_keys_off(a) + align16((size_t)a.chunk * a.j_max * 4);
}

__global__ void __launch_bounds__(WF_THREADS, 1) waterfill_kernel(const WaterfillArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned ws[WF_WARPS];
  __shared__ unsigned hist[256];
  __shared__ __align__(8) unsigned long long bars[2];
  __shared__ unsigned msum[256];
  __shared__ int red[3][WF_WARPS];
  __shared__ int group_w;  // lanes a row: pow2 of the CTA's longest row, at most 32
  __shared__ int mx[2], gmx[2];
  __shared__ unsigned sel_prefix;
  __shared__ int sel_want, sel_m;
  // this CTA's chosen list, for the others: length, where (byte offset in
  // dynamic shared memory, or -1: the global slice)
  __shared__ int desc_len;
  __shared__ long long desc_off;
  __shared__ const unsigned long long* rlist[WF_MAX_CS];
  __shared__ int rlen[WF_MAX_CS];
  __shared__ int steps_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = a.cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, R = a.R, j_max = a.j_max, chunk = a.chunk;
  const int n0 = rank * chunk;
  const int cnt = max(0, min(N - n0, chunk));
  unsigned char* gslice = a.gscratch + (size_t)rank * a.slice_bytes;

  // regions: shared memory while they fit, else the global slice
  size_t used_smem = 0;
  auto carve = [&](size_t bytes, size_t goff, bool* in_smem) -> unsigned char* {
    bytes = align16(bytes);
    if (used_smem + bytes <= WF_SMEM_BUDGET) {
      unsigned char* p = smem + used_smem;
      used_smem += bytes;
      if (in_smem) *in_smem = true;
      return p;
    }
    if (in_smem) *in_smem = false;
    return gslice + goff;
  };
  // the histogram exchange: [2 parities][cs senders][256 bins], always in
  // shared memory (the first region)
  unsigned* xs = (unsigned*)carve((size_t)2 * WF_MAX_CS * 256 * 4, 0, nullptr);
  Xchg xc;
  xchg_init(xc, smem_addr(bars), (unsigned)(cs * 256 * 4), (unsigned)(cs * 256 * 4), 1);
  int* node_arr = (int*)carve((size_t)WF_NODE_ARRAYS * (chunk + 1) * 4, 0, nullptr);
  int* jc_s = node_arr;                  // j_cap
  int* st_s = jc_s + (chunk + 1);        // static score
  unsigned* off_s = (unsigned*)(st_s + (chunk + 1));  // row offset in the key array
  int* len_s = (int*)(off_s + (chunk + 1));           // valid keys of the row
  int* cn_s = len_s + (chunk + 1);                    // c_n
  unsigned* coff_s = (unsigned*)(cn_s + (chunk + 1));  // offset in the chosen list
  int* row_in = (int*)(coff_s + (chunk + 1));  // [6][chunk + 1]: alloc, used, used_nz (r < 2)

  // ---- 1. node pass ----------------------------------------------------------
  int v0 = INT_MIN, v1 = INT_MIN, v2 = 0;
  for (int ln = tid; ln < cnt; ln += WF_THREADS) {
    const int n = n0 + ln;
    int jc = INT_MAX;
    for (int r = 0; r < R; ++r) {
      const int q = a.req[r];
      const int al = a.alloc[(size_t)n * R + r], us = a.used[(size_t)n * R + r];
      if (r < 2) {  // the rows' inputs
        row_in[(0 + r) * (chunk + 1) + ln] = al;
        row_in[(2 + r) * (chunk + 1) + ln] = us;
        row_in[(4 + r) * (chunk + 1) + ln] = a.used_nz[(size_t)n * R + r];
      }
      jc = min(jc, q > 0 ? floordiv(wsub(al, us), max(q, 1)) : j_max);
    }
    jc = min(jc, wsub(a.max_pods[n], a.pod_count[n]));
    if (!a.filter_ok[n]) jc = 0;
    if (a.has_port) jc = a.port_conflict[n] ? 0 : min(jc, 1);  // before the clip
    jc = min(max(jc, 0), j_max);
    jc_s[ln] = jc;
    off_s[ln] = (unsigned)jc;
    const int f = jc > 0;
    v0 = max(v0, f ? a.napref[n] : 0);
    v1 = max(v1, f ? a.taint[n] : 0);
    v2 = max(v2, jc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v0 = max(v0, __shfl_down_sync(0xffffffffu, v0, off));
    v1 = max(v1, __shfl_down_sync(0xffffffffu, v1, off));
    v2 = max(v2, __shfl_down_sync(0xffffffffu, v2, off));
  }
  if (lane == 0) {
    red[0][warp] = v0;
    red[1][warp] = v1;
    red[2][warp] = v2;
  }
  __syncthreads();
  if (tid == 0) {
    int x0 = INT_MIN, x1 = INT_MIN, x2 = 0;
    for (int w = 0; w < WF_WARPS; ++w) {
      x0 = max(x0, red[0][w]);
      x1 = max(x1, red[1][w]);
      x2 = max(x2, red[2][w]);
    }
    mx[0] = x0;
    mx[1] = x1;
    int g = 1;
    while (g < x2 && g < 32) g <<= 1;
    group_w = g;
  }
  const unsigned K_c = block_scan<WF_THREADS>(off_s, cnt, false, ws);  // row offsets
  cluster.sync();  // every CTA's maxima are in its shared memory, its barriers armed
  if (warp == 0) {
    int x0 = INT_MIN, x1 = INT_MIN;
    if (lane < cs) {
      const int* rmx = cluster.map_shared_rank(mx, lane);
      x0 = rmx[0];
      x1 = rmx[1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x0 = max(x0, __shfl_down_sync(0xffffffffu, x0, off));
      x1 = max(x1, __shfl_down_sync(0xffffffffu, x1, off));
    }
    if (lane == 0) {
      gmx[0] = x0;
      gmx[1] = x1;
    }
  }
  __syncthreads();
  {
    const int mx_napref = gmx[0], mx_taint = gmx[1];
    const int has_napref = a.has_napref[0] != 0;
    for (int ln = tid; ln < cnt; ln += WF_THREADS) {
      const int n = n0 + ln;
      int napref = 0;
      if (has_napref && mx_napref > 0) napref = floordiv(wmul(100, a.napref[n]), max(mx_napref, 1));
      const int tscaled = mx_taint > 0 ? floordiv(wmul(100, a.taint[n]), max(mx_taint, 1)) : 0;
      const int taint = mx_taint > 0 ? 100 - tscaled : 100;
      unsigned st = 2u * (unsigned)napref + 3u * (unsigned)taint + (unsigned)a.img[n];
      if (a.has_gang) st += (unsigned)a.gang[n];
      st_s[ln] = (int)st;
    }
  }
  unsigned* keys = (unsigned*)carve((size_t)K_c * 4, g_keys_off(a), nullptr);
  __syncthreads();

  // ---- 2. rows: ordered keys of j < j_cap --------------------------------------
  // A row takes a group of gw lanes (gw = pow2 of the CTA's longest row, at
  // most 32), so a warp scores 32 / gw rows at once; a row longer than 32
  // takes the whole warp in chunks of 32 with the running min carried.
  {
    const int SCORE_MIN = INT_MIN + 1;  // ops/solver.py INT_MIN
    const int SENTINEL = INT_MIN + 1;   // waterfill.py sentinel
    const int slots1 = wadd(wmul(N, j_max), 1);
    const int bal_active = a.bal_active[0] != 0;
    int rq[2], rqnz[2];
    for (int r = 0; r < 2; ++r) {
      rq[r] = a.req[r];
      rqnz[r] = a.req_nz[r];
    }
    const int gw = group_w, per = 32 / gw;
    const int sub = lane / gw, gl = lane % gw;  // the lane's row in the warp, its place in it
    const unsigned gmask = gw == 32 ? 0xffffffffu : ((1u << gw) - 1u) << (sub * gw);
    for (int ln0 = warp * per; ln0 < cnt; ln0 += WF_WARPS * per) {
      const int ln = ln0 + sub;
      const bool has = ln < cnt;
      const int n = n0 + ln, jc = has ? jc_s[ln] : 0;
      const unsigned row = has ? off_s[ln] : 0u;
      int al[2] = {0, 0}, us[2] = {0, 0}, unz[2] = {0, 0};
      for (int r = 0; r < 2 && has; ++r) {
        al[r] = row_in[(0 + r) * (chunk + 1) + ln];
        us[r] = row_in[(2 + r) * (chunk + 1) + ln];
        unz[r] = row_in[(4 + r) * (chunk + 1) + ln];
      }
      const int st = has ? st_s[ln] : 0;
      int carry = INT_MAX, n_valid = 0;
      // warp-uniform bound: one pass of gw lanes, or the one row in chunks of 32
      const int span = per > 1 ? gw : jc;
      for (int base = 0; base < span; base += gw) {
        const int j = base + gl;
        int s = INT_MAX;
        if (j < jc) {
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
          // floordiv(per_sum, max(npos, 1)) with npos in {0, 1, 2}
          const int least = npos == 2 ? per_sum >> 1 : per_sum;
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
            // x / 2 and x * 0.5 round the same real value: the same float
            const float sd = nf == 2 ? __fmul_rn(fabsf(__fsub_rn(frac[0], frac[1])), 0.5f) : 0.0f;
            bal = (int)__fmul_rn(__fsub_rn(1.0f, sd), 100.0f);
          }
          s = wadd(wadd(least, bal), st);
        }
        // running min along j: an inclusive scan over the row's lanes, then
        // the carry
        for (int off = 1; off < gw; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, s, off, gw);
          if (gl >= off) s = min(s, o);
        }
        s = min(s, carry);
        carry = __shfl_sync(0xffffffffu, s, gw - 1, gw);
        int valid = 0;
        if (j < jc) {
          const int key = wsub(wmul(s, slots1), n * j_max + j);
          valid = s > SCORE_MIN && key > SENTINEL;
          keys[row + j] = valid ? ((unsigned)key ^ 0x80000000u) : 0u;
        }
        n_valid += __popc(__ballot_sync(0xffffffffu, valid) & gmask);
      }
      if (gl == 0 && has) len_s[ln] = n_valid;
    }
  }
  __syncthreads();

  // ---- 3. threshold select: 4 radix passes over the sorted rows ---------------
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass, par = pass & 1;
    unsigned* h = hist;
    for (int b = tid; b < 256; b += WF_THREADS) h[b] = 0u;
    __syncthreads();
    const unsigned prefix = sel_prefix;  // bits above `shift + 8` (pass > 0)
    auto match = [&](unsigned u) {
      return u != 0u && (pass == 0 || (u >> (shift + 8)) == (prefix >> (shift + 8)));
    };
    if (pass == 0 || sel_m > 0) {
      for (unsigned i = tid; i < K_c; i += WF_THREADS) {
        const unsigned u = keys[i];
        if (!match(u)) continue;
        const unsigned v = u >> shift;
        const bool first = i == 0 || !match(keys[i - 1]) || (keys[i - 1] >> shift) != v;
        const bool last = i + 1 == K_c || !match(keys[i + 1]) || (keys[i + 1] >> shift) != v;
        if (first) atomicAdd(&h[v & 255u], 0u - i);
        if (last) atomicAdd(&h[v & 255u], i + 1u);
      }
    }
    __syncthreads();
    // push this CTA's histogram into every CTA's slots of this parity
    for (int b = tid; b < 256; b += WF_THREADS) {
      const unsigned dst = smem_addr(&xs[(par * cs + rank) * 256 + b]), bar = xc.bar + 8 * par;
      for (int d = 0; d < cs; ++d) st_async_b32(remote_addr(dst, d), h[b], remote_addr(bar, d));
    }
    xchg_wait(xc, par);  // every CTA's histogram of this pass has arrived
    for (int b = tid; b < 256; b += WF_THREADS) {
      unsigned s = 0;
      for (int c = 0; c < cs; ++c) s += xs[(par * cs + c) * 256 + b];
      msum[b] = s;
    }
    __syncthreads();
    xchg_rearm(xc, par);  // every thread is past its last read of the slots
    if (warp == 0) {
      unsigned s8 = 0;
      for (int b = 0; b < 8; ++b) s8 += msum[lane * 8 + b];
      unsigned suf = s8;  // bins of this lane and every lane above
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += y;
      }
      int m = sel_m, want = sel_want;
      if (pass == 0) {
        const unsigned total = __shfl_sync(0xffffffffu, suf, 0);
        m = (int)min(min(total, (unsigned)max(a.group_size, 0)), (unsigned)a.k_slots);
        want = m;
      }
      if (m > 0) {
        const unsigned hit = __ballot_sync(0xffffffffu, suf >= (unsigned)want);
        const int top = 31 - __clz(hit);  // the highest lane whose suffix reaches want
        if (lane == top) {
          unsigned cum = suf - s8;
          for (int b = 7; b >= 0; --b) {
            const unsigned c = msum[lane * 8 + b];
            if (cum + c >= (unsigned)want) {
              sel_prefix = (pass == 0 ? 0u : prefix) | ((unsigned)(lane * 8 + b) << shift);
              sel_want = want - (int)cum;
              break;
            }
            cum += c;
          }
        }
      }
      if (lane == 0) {
        sel_m = m;
        if (pass == 0 && m == 0) sel_prefix = 0u;
      }
    }
    __syncthreads();
  }
  const int m = sel_m;
  const unsigned T = sel_prefix;  // the m-th largest key (m > 0)

  // ---- 4. c_n = keys of the row at or above T ---------------------------------
  for (int ln = tid; ln < cnt; ln += WF_THREADS) {
    int c = 0;
    if (m > 0) {
      const unsigned row = off_s[ln];
      int lo = 0, hi = len_s[ln];
      while (lo < hi) {  // the row is descending
        const int mid = (lo + hi) >> 1;
        if (keys[row + mid] >= T) lo = mid + 1;
        else hi = mid;
      }
      c = lo;
    }
    cn_s[ln] = c;
    coff_s[ln] = (unsigned)c;
    a.k_per_node[n0 + ln] = c;
  }
  __syncthreads();
  const int M_c = (int)block_scan<WF_THREADS>(coff_s, cnt, false, ws);

  // ---- 5. the greedy order --------------------------------------------------
  if (m > 0) {
    const int Lp = M_c > 0 ? 1 << (32 - __clz(M_c - 1)) : 0;  // pow2 >= M_c
    bool list_in_smem = false;
    const size_t list_at = used_smem;
    unsigned long long* list =
        (unsigned long long*)carve((size_t)Lp * 8, g_list_off(a), &list_in_smem);
    for (int ln = tid; ln < cnt; ln += WF_THREADS) {  // c_n is mostly 0 or a few
      const int c = cn_s[ln];
      const unsigned row = off_s[ln], at = coff_s[ln];
      for (int j = 0; j < c; ++j)
        list[at + j] = ((unsigned long long)keys[row + j] << 32) | (unsigned)(n0 + ln);
    }
    for (int i = M_c + tid; i < Lp; i += WF_THREADS) list[i] = 0ull;  // below every key
    __syncthreads();
    // bitonic sort, descending: the sub-sequence holding i runs descending
    // when (i & k) == 0
    if (Lp <= WF_THREADS) {
      // one entry a thread in registers: strides below 32 by warp shuffles,
      // wider ones through the list in shared memory
      const int Lr = max(Lp, 32);
      const bool in = tid < Lr;  // whole warps
      unsigned long long v = tid < Lp ? list[tid] : 0ull;
      for (int k = 2; k <= Lr; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          unsigned long long o = 0ull;
          if (j >= 32) {
            __syncthreads();
            if (in) list[tid] = v;
            __syncthreads();
            if (in) o = list[tid ^ j];
          } else if (in) {
            o = __shfl_xor_sync(0xffffffffu, v, j);
          }
          const bool low = (tid & j) == 0, desc = (tid & k) == 0;
          v = (low == desc) ? (v > o ? v : o) : (v < o ? v : o);
        }
      }
      __syncthreads();
      if (tid < Lp) list[tid] = v;
    } else {
      for (int k = 2; k <= Lp; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int t = tid; t < Lp / 2; t += WF_THREADS) {
            const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
            const unsigned long long p = list[i], q = list[i + j];
            if (((i & k) == 0) ? (p < q) : (p > q)) {
              list[i] = q;
              list[i + j] = p;
            }
          }
          __syncthreads();
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      desc_len = M_c;
      desc_off = list_in_smem ? (long long)list_at : -1;
    }
    __syncthreads();
    cluster.sync();  // every CTA's list is sorted and described
    if (tid < cs) {
      const int len = *cluster.map_shared_rank(&desc_len, tid);
      const long long off = *cluster.map_shared_rank(&desc_off, tid);
      rlen[tid] = tid == rank ? 0 : len;
      rlist[tid] = off >= 0
          ? (const unsigned long long*)cluster.map_shared_rank(smem + off, tid)
          : (const unsigned long long*)(a.gscratch + (size_t)tid * a.slice_bytes + g_list_off(a));
    }
    __syncthreads();
    if (tid == 0) {
      int longest = 0;
      for (int c = 0; c < cs; ++c) longest = max(longest, rlen[c]);
      steps_s = 32 - __clz(longest);  // binary-search steps over the longest list
    }
    __syncthreads();
    const int steps = steps_s;
    for (int i = tid; i < M_c; i += WF_THREADS) {
      const unsigned long long e = list[i];
      const unsigned u = (unsigned)(e >> 32);
      int lo[WF_MAX_CS], hi[WF_MAX_CS];
#pragma unroll
      for (int c = 0; c < WF_MAX_CS; ++c) {
        lo[c] = 0;
        hi[c] = c < cs ? rlen[c] : 0;
      }
      for (int step = 0; step < steps; ++step) {
#pragma unroll
        for (int c = 0; c < WF_MAX_CS; ++c) {
          if (lo[c] < hi[c]) {  // count of CTA c's keys above u
            const int mid = (lo[c] + hi[c]) >> 1;
            if ((unsigned)(rlist[c][mid] >> 32) > u) lo[c] = mid + 1;
            else hi[c] = mid;
          }
        }
      }
      int pos = i;
#pragma unroll
      for (int c = 0; c < WF_MAX_CS; ++c) pos += lo[c];
      a.chosen_nodes[pos] = (int)(unsigned)(e & 0xffffffffull);
    }
  }
  for (int i = m + rank * WF_THREADS + tid; i < a.k_slots; i += cs * WF_THREADS)
    a.chosen_nodes[i] = -1;
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

// ---------------------------------------------------------------------------
// host side: the cluster size (once per process), the launch
// ---------------------------------------------------------------------------

static int g_cluster_size = 0;
static int g_cluster_error = 0;

// 16 or 8, or minus the CUDA error that refused both
extern "C" int waterfill_cluster_size() {
  if (!g_cluster_size && !g_cluster_error)
    g_cluster_size = choose_cluster_size(waterfill_kernel, WF_THREADS, WF_SMEM_BUDGET,
                                         &g_cluster_error);
  return g_cluster_size ? g_cluster_size : -g_cluster_error;
}

// One group on `stream` as one cluster. *launched counts the kernels
// launched. Returns the CUDA error of the launch (a refused cluster launch
// never runs; nothing retries it).
extern "C" int waterfill_launch(const WaterfillArgs* args, void* stream, int* launched) {
  *launched = 0;
  const int cs = waterfill_cluster_size();
  if (cs <= 0) return -cs;
  if (args->cs != cs) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(cs, WF_THREADS, WF_SMEM_BUDGET, (cudaStream_t)stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, waterfill_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int waterfill_args_size() { return (int)sizeof(WaterfillArgs); }
