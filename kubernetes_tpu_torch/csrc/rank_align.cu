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
// (4,096 at the default batch size). Padding rows carry group 2^30 + i and
// non-members 2^29 + i, so their permutation is the identity.
//
// What bounds it: bytes by the roofline (20 bytes a row: ~80 KB at 4,096
// rows, some 25 ns of HBM time); in practice the sort's dependent
// compare-exchange steps (log2(p)(log2(p)+1)/2 of them, each a block
// barrier) and the launches. Design: the (group, key) pair is packed into
// one 64-bit key with the sign bits flipped (signed int32 order becomes
// unsigned order), and each row carries its index as a 32-bit payload that
// is also the last comparison, so the order is total and the non-stable
// bitonic network yields exactly the stable lexsort. Both sorts run at once
// (blockIdx.y picks the sort). Up to SORT_BLOCK = 4,096 rows a sort is one
// block in shared memory (48 KB of keys and indices); beyond, each block
// sorts a chunk, then global compare-exchange steps (one launch per step
// with distance >= SORT_BLOCK) and in-block merges finish the network, as
// csrc/waterfill.cu's sort does. A last pass scatters the assignments.

#include <cuda_runtime.h>
#include <stdint.h>

#define SORT_BLOCK 4096

struct RankAlignArgs {
  int p_max;
  const int* assignment;  // [p_max]
  const int* group_id;    // [p_max]
  const int* rank;        // [p_max]
  const int* pos_key;     // [p_max]
  int* out;               // [p_max]
  unsigned long long* keys;  // scratch [2, p_max]: rank sort, position sort
  unsigned* idx;             // scratch [2, p_max]
};

__device__ __forceinline__ unsigned long long pack(int hi, int lo) {
  return ((unsigned long long)((unsigned)hi ^ 0x80000000u) << 32) |
         (unsigned long long)((unsigned)lo ^ 0x80000000u);
}

__global__ void ra_build(const RankAlignArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.p_max) return;
  const int g = a.group_id[i];
  a.keys[i] = pack(g, a.rank[i]);
  a.idx[i] = (unsigned)i;
  a.keys[a.p_max + i] = pack(g, a.pos_key[i]);
  a.idx[a.p_max + i] = (unsigned)i;
}

__device__ __forceinline__ bool row_less(unsigned long long ka, unsigned ia,
                                         unsigned long long kb, unsigned ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// ascending bitonic network: the sub-sequence holding global index gi runs
// ascending when (gi & k) == 0
__device__ __forceinline__ void cmp_swap(unsigned long long* k, unsigned* x, unsigned i,
                                         unsigned l, unsigned gi, unsigned stage) {
  const unsigned long long p = k[i], q = k[l];
  const unsigned pi = x[i], qi = x[l];
  const bool asc = (gi & stage) == 0;
  if (asc ? row_less(q, qi, p, pi) : row_less(p, pi, q, qi)) {
    k[i] = q;
    k[l] = p;
    x[i] = qi;
    x[l] = pi;
  }
}

// One block sorts a chunk of `len` rows of sort blockIdx.y (all stages 2..len),
// or, with k_merge > 0, runs the in-chunk steps len/2..1 of stage k_merge.
__global__ void ra_sort_block(const RankAlignArgs a, int len, unsigned k_merge) {
  __shared__ unsigned long long sk[SORT_BLOCK];
  __shared__ unsigned si[SORT_BLOCK];
  const size_t off = (size_t)blockIdx.y * a.p_max;
  const unsigned base = blockIdx.x * (unsigned)len;
  unsigned long long* keys = a.keys + off;
  unsigned* idx = a.idx + off;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    sk[i] = keys[base + i];
    si[i] = idx[base + i];
  }
  __syncthreads();
  const unsigned k_lo = k_merge ? k_merge : 2u;
  const unsigned k_hi = k_merge ? k_merge : (unsigned)len;
  for (unsigned k = k_lo; k <= k_hi; k <<= 1) {
    for (unsigned j = (k_merge ? (unsigned)len : k) >> 1; j > 0; j >>= 1) {
      for (unsigned t = threadIdx.x; t < (unsigned)len / 2; t += blockDim.x) {
        const unsigned i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        cmp_swap(sk, si, i, i + j, base + i, k);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    keys[base + i] = sk[i];
    idx[base + i] = si[i];
  }
}

__global__ void ra_sort_global(const RankAlignArgs a, unsigned k, unsigned j) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (unsigned)a.p_max / 2) return;
  const size_t off = (size_t)blockIdx.y * a.p_max;
  const unsigned i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  cmp_swap(a.keys + off, a.idx + off, i, i + j, i, k);
}

__global__ void ra_scatter(const RankAlignArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.p_max) return;
  a.out[a.idx[i]] = a.assignment[a.idx[a.p_max + i]];
}

// Launch on `stream`; returns the first CUDA error (0 if none). p_max is a
// power of two; the wrapper sizes the scratch.
extern "C" int rank_align_launch(const RankAlignArgs* args, void* stream_ptr) {
  const RankAlignArgs& a = *args;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t e;
#define RA_CHECK()                       \
  do {                                   \
    e = cudaGetLastError();              \
    if (e != cudaSuccess) return (int)e; \
  } while (0)
  const int len = a.p_max;
  const int threads = 256;
  const unsigned row_blocks = (unsigned)((len + threads - 1) / threads);
  ra_build<<<row_blocks, threads, 0, stream>>>(a);
  RA_CHECK();
  if (len <= SORT_BLOCK) {
    const int t = len / 2 < 1024 ? (len / 2 < 32 ? 32 : len / 2) : 1024;
    ra_sort_block<<<dim3(1, 2), t, 0, stream>>>(a, len, 0u);
    RA_CHECK();
  } else {
    const unsigned chunks = (unsigned)(len / SORT_BLOCK);
    ra_sort_block<<<dim3(chunks, 2), 1024, 0, stream>>>(a, SORT_BLOCK, 0u);
    RA_CHECK();
    const unsigned half_blocks = (unsigned)((len / 2 + threads - 1) / threads);
    for (unsigned k = 2u * SORT_BLOCK; k <= (unsigned)len; k <<= 1) {
      for (unsigned j = k >> 1; j >= (unsigned)SORT_BLOCK; j >>= 1) {
        ra_sort_global<<<dim3(half_blocks, 2), threads, 0, stream>>>(a, k, j);
        RA_CHECK();
      }
      ra_sort_block<<<dim3(chunks, 2), 1024, 0, stream>>>(a, SORT_BLOCK, k);
      RA_CHECK();
    }
  }
  ra_scatter<<<row_blocks, threads, 0, stream>>>(a);
  RA_CHECK();
#undef RA_CHECK
  return 0;
}

extern "C" int rank_align_args_size() { return (int)sizeof(RankAlignArgs); }
