// Kernel H: rank alignment of a gang's placements (sm_90a).
//
// Replaces: kubernetes_tpu/models/gangcover.py:174 rank_align_kernel. The
// plain PyTorch version is models/gangcover.py rank_align_plain.
//
//   order_rank = lexsort by (group, rank, index)
//   order_pos  = lexsort by (group, pos_key, index)
//   out[order_rank[i]] = assignment[order_pos[i]]
//
// All four inputs and the output are [p_max] int32, p_max a power of two
// (2,048 and 4,096 on the gang paths). Padding rows carry group 2^30 + i
// and non-members 2^29 + i, so their permutation is the identity.
//
// What bounds it: bytes by the roofline (20 bytes a row: ~80 KB at 4,096
// rows, some 25 ns of HBM time); in practice the sort's dependent steps.
// The earlier design ran three launches joined through a global key/index
// scratch (build, a 78-step bitonic network of block barriers, scatter) on
// two SMs.
//
// Design: one launch of one thread-block cluster of CS CTAs (16, else 8;
// chosen once per process), a team of H = CS / 2 a sort: CTAs 0 .. H - 1
// sort by rank, H .. CS - 1 by position. A row is (key, index): its (group,
// key) pair packed into 64 bits with the sign bits flipped (signed int32
// order becomes unsigned order), then its index, so the order is total and
// any correct sort yields exactly the stable lexsort. The plan (ops/
// kernels.py rank_align_plan) gives each of a team's A active CTAs a slice
// of p_max / A rows.
//   1. A CTA sorts its slice in chunks of at most RA_SMEM_ROWS in shared
//      memory (chunk_sort: each warp packs 32 rows, the old build launch,
//      and sorts them by a bitonic network of shuffles; the runs of 32 are
//      merged level by level, a block barrier a level) and writes each
//      chunk to a global scratch as (key, index) rows.
//   2. The team merges the chunks level by level through the scratch (it
//      stays in L2), each CTA writing its own slice of every level's
//      output, the levels separated by barrier.cluster.
//   3. Every CTA scatters a share of the rows, out[order_rank[i]] =
//      assignment[order_pos[i]] (the old scatter launch).
// Every merge is warp-cooperative: a 32-ary search (one probe a lane, a
// ballot) finds where the warp's outputs start on the merge path, then each
// window of 32 outputs loads the next 32 rows of each run (one a lane, in
// order) and places each row by its rank in the other window (a binary
// search by shuffles), so no thread walks a run alone and the loads are
// contiguous.
// Earlier designs, measured on an NVIDIA H100 80GB HBM3 (700 W): one CTA a sort
// (0.035-0.045 ms at 4,096 rows: the merge levels' conflicting shared-memory
// gathers and one SM's issue rate), and the team's levels read over DSMEM
// from the CTAs' shared memory (0.0245 ms, against 0.0166 through L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

#define RA_THREADS 1024
#define RA_WARPS (RA_THREADS / 32)
#define RA_SMEM_ROWS 8192  // rows a CTA sorts in shared memory (24 bytes each)

struct RankAlignArgs {
  int p_max;
  int cs;          // CTAs of the cluster (two teams)
  int active;      // CTAs of a team that hold a slice (p_max / slice)
  int slice;       // rows of a CTA
  int chunk;       // rows a CTA sorts in shared memory at a time
  int smem_bytes;  // 24 * chunk
  const int* assignment;  // [p_max]
  const int* group_id;    // [p_max]
  const int* rank;        // [p_max]
  const int* pos_key;     // [p_max]
  int* out;               // [p_max]
  unsigned long long* gkey;  // scratch [2 sorts][2 buffers][p_max]
  unsigned* gidx;            // scratch [2 sorts][2 buffers][p_max]
};

struct Row {
  unsigned long long k;
  unsigned x;
};

__device__ __forceinline__ bool lt(Row a, Row b) { return a.k < b.k || (a.k == b.k && a.x < b.x); }

__device__ __forceinline__ unsigned long long pack(int hi, int lo) {
  return ((unsigned long long)((unsigned)hi ^ 0x80000000u) << 32) |
         (unsigned long long)((unsigned)lo ^ 0x80000000u);
}

__device__ __forceinline__ Row shfl_row(Row r, int src) {
  return Row{__shfl_sync(0xffffffffu, r.k, src), __shfl_sync(0xffffffffu, r.x, src)};
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// rows of the window held one a lane (sorted) that are below v: a binary
// search by shuffles, 0..32
__device__ __forceinline__ int count_below(Row mine, Row v) {
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (lt(shfl_row(mine, pos + step - 1), v)) pos += step;
  if (lt(shfl_row(mine, pos), v)) pos += 1;
  return pos;
}

// The warp's outputs [o, o + cnt) (cnt a multiple of 32, inside one pair)
// of the merge of the sorted runs A = src(pb .. pb + L - 1) and B =
// src(pb + L .. pb + 2L - 1), written as dst(pb + position, row). Every lane
// of the warp calls it.
template <typename Src, typename Dst>
__device__ __forceinline__ void warp_merge(const Src& src, const Dst& dst, int pb, int L, int o,
                                           int cnt) {
  const int lane = threadIdx.x & 31;
  // where o lies on the merge path: a = the rows of A among its first o
  // outputs, the first i in [lo, hi) with A[i] > B[o - 1 - i]
  int lo = max(0, o - L), hi = min(o, L);
  while (lo < hi) {
    const int span = hi - lo;
    const int i = lo + (int)(((long long)span * lane) >> 5);
    const bool before = lt(src(pb + i), src(pb + L + o - 1 - i));
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    if (c == 0) {
      hi = lo;
    } else {
      const int last = lo + (int)(((long long)span * (c - 1)) >> 5);
      hi = c < 32 ? lo + (int)(((long long)span * c) >> 5) : hi;
      lo = last + 1;
    }
  }
  int a = lo, b = o - lo;
  const Row inf{~0ull, ~0u};
  for (int w = 0; w < cnt; w += 32) {
    const Row ra = a + lane < L ? src(pb + a + lane) : inf;
    const Row rb = b + lane < L ? src(pb + L + b + lane) : inf;
    const int qa = lane + count_below(rb, ra);
    const int qb = lane + count_below(ra, rb);
    if (qa < 32) dst(pb + o + w + qa, ra);
    if (qb < 32) dst(pb + o + w + qb, rb);
    const int ta = __popc(__ballot_sync(0xffffffffu, qa < 32));
    a += ta;
    b += 32 - ta;
  }
}

// the bitonic network of 32 rows, one a lane, ascending
__device__ __forceinline__ Row warp_sort32(Row r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 2; kk <= 32; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const Row p = shfl_row(r, lane ^ j);
      const bool keep_min = ((lane & j) == 0) == ((lane & kk) == 0);
      if (lt(r, p) != keep_min) r = p;
    }
  }
  return r;
}

// Sorts the n rows base .. base + n - 1 (n a power of two <= RA_SMEM_ROWS)
// by their (key, index) into buffer 0 or 1 of (K, X), whichever it
// returns; every thread of the block calls it. A row's index is its row.
__device__ int chunk_sort(unsigned long long* const* K, unsigned* const* X, int n,
                          const int* group, const int* key, int base) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int run = warp; run * 32 < n; run += RA_WARPS) {
    const int i = run * 32 + lane;
    Row r{~0ull, ~0u};
    if (i < n) r = Row{pack(group[base + i], key[base + i]), (unsigned)(base + i)};
    r = warp_sort32(r);
    if (i < n) {
      K[0][i] = r.k;
      X[0][i] = r.x;
    }
  }
  int b = 0;
  for (int L = 32; L < n; L <<= 1, b ^= 1) {
    __syncthreads();
    const unsigned long long* sk = K[b];
    const unsigned* sx = X[b];
    unsigned long long* dk = K[b ^ 1];
    unsigned* dx = X[b ^ 1];
    auto src = [&](int j) { return Row{sk[j], sx[j]}; };
    auto dst = [&](int j, Row r) {
      dk[j] = r.k;
      dx[j] = r.x;
    };
    const int cnt = max(32, n / RA_WARPS), seg = min(cnt, 2 * L);
    for (int o0 = warp * cnt; o0 < (warp + 1) * cnt && o0 < n; o0 += seg) {
      const int pb = o0 & ~(2 * L - 1);
      warp_merge(src, dst, pb, L, o0 - pb, seg);
    }
  }
  __syncthreads();
  return b;
}

__global__ void __launch_bounds__(RA_THREADS) rank_align_kernel(const RankAlignArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int p = a.p_max, n = a.chunk, S = a.slice;
  const int H = a.cs >> 1, s = rank / H, m = rank - s * H;
  unsigned long long* const K[2] = {(unsigned long long*)smem, (unsigned long long*)smem + n};
  unsigned* const X[2] = {(unsigned*)(K[1] + n), (unsigned*)(K[1] + n) + n};
  const int* key = s == 0 ? a.rank : a.pos_key;
  unsigned long long* gk = a.gkey + (size_t)(2 * s) * p;  // this team's two buffers
  unsigned* gx = a.gidx + (size_t)(2 * s) * p;

  // ---- 1. this CTA's slice, sorted a chunk at a time ----------------------
  if (m < a.active) {
    for (int base = m * S; base < (m + 1) * S; base += n) {
      const int b = chunk_sort(K, X, n, a.group_id, key, base);
      for (int i = tid; i < n; i += RA_THREADS) {
        gk[base + i] = K[b][i];
        gx[base + i] = X[b][i];
      }
      __syncthreads();  // before the next chunk overwrites the buffers
    }
  }
  cluster_sync_all();  // every chunk is sorted

  // ---- 2. the team's merge levels ----------------------------------------
  const int cnt = max(32, S / RA_WARPS);
  int b = 0;
  for (int L = n; L < p; L <<= 1, b ^= 1) {
    if (m < a.active && warp * cnt < S) {
      const unsigned long long* sk = gk + (size_t)b * p;
      const unsigned* sx = gx + (size_t)b * p;
      unsigned long long* dk = gk + (size_t)(b ^ 1) * p;
      unsigned* dx = gx + (size_t)(b ^ 1) * p;
      auto src = [&](int j) { return Row{sk[j], sx[j]}; };
      auto dst = [&](int j, Row r) {
        dk[j] = r.k;
        dx[j] = r.x;
      };
      // the warp's cnt outputs, one pair at a time
      const int seg = min(cnt, 2 * L);
      for (int w = 0; w < cnt; w += seg) {
        const int o0 = m * S + warp * cnt + w;
        const int pb = o0 & ~(2 * L - 1);
        warp_merge(src, dst, pb, L, o0 - pb, seg);
      }
    }
    cluster_sync_all();
  }

  // ---- 3. the scatter ------------------------------------------------------
  const unsigned* ord_rank = a.gidx + (size_t)b * p;
  const unsigned* ord_pos = a.gidx + (size_t)(2 + b) * p;
  for (int i = rank * RA_THREADS + tid; i < p; i += a.cs * RA_THREADS)
    a.out[ord_rank[i]] = a.assignment[ord_pos[i]];
}

// ---------------------------------------------------------------------------
// host side: the cluster size (once per process), the launch
// ---------------------------------------------------------------------------

static int g_cluster_size = 0;
static int g_cluster_error = 0;

// 16 or 8, or minus the CUDA error that refused both
extern "C" int rank_align_cluster_size() {
  if (!g_cluster_size && !g_cluster_error)
    g_cluster_size = choose_cluster_size(rank_align_kernel, RA_THREADS, 24 * RA_SMEM_ROWS,
                                         &g_cluster_error);
  return g_cluster_size ? g_cluster_size : -g_cluster_error;
}

extern "C" int rank_align_smem_rows() { return RA_SMEM_ROWS; }

// One launch of one cluster on `stream`. *launched counts the kernels
// launched. Returns the CUDA error of the launch (a refused cluster launch
// never runs; nothing retries it). The wrapper checks shapes, types and
// contiguity and plans the slices.
extern "C" int rank_align_launch(const RankAlignArgs* args, void* stream, int* launched) {
  *launched = 0;
  const RankAlignArgs& a = *args;
  const int cs = rank_align_cluster_size();
  if (cs <= 0) return -cs;
  auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (!pow2(a.p_max) || !pow2(a.slice) || !pow2(a.chunk) || !pow2(a.active) || a.cs != cs ||
      a.active > cs / 2 || (long long)a.active * a.slice != a.p_max || a.chunk > a.slice ||
      a.chunk > RA_SMEM_ROWS || a.smem_bytes != 24 * a.chunk || !a.out || !a.gkey || !a.gidx)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(cs, RA_THREADS, a.smem_bytes, (cudaStream_t)stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, rank_align_kernel, a);
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int rank_align_args_size() { return (int)sizeof(RankAlignArgs); }
