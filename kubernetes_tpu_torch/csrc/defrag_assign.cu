// Kernel I: the defrag assignment, a sequential best-fit (sm_90a).
//
// Replaces: kubernetes_tpu/models/defrag.py:99 defrag_assign. The plain
// PyTorch version is models/defrag.py defrag_assign_plain.
//
//   for each victim k in drain order, with (free, headroom) carried:
//     fits[n] = all_r(free[n,r] >= v_req[k,r]) && headroom[n] > 0 && target_ok[n]
//     key[n]  = fits[n] ? sum_r(free[n,r] - v_req[k,r]) : 2^30   (int32, wrapping)
//     tgt     = argmin_n key[n], the lowest index on ties
//     if key[tgt] < 2^30 && v_valid[k]: out[k] = tgt, free[tgt] -= v_req[k],
//                                       headroom[tgt] -= 1
//     else out[k] = -1 (nothing changes, not even at the argmin's index 0)
//
// What bounds it: neither bytes nor operations. The victims form one
// dependency chain (each sees what its predecessors consumed), so the time
// is v_max block-wide argmins back to back: a few microseconds each, while
// the bytes (~130 KB at the main path's 8,192 slots x R 3) and the
// operations (~v_max * n_slots * (2R + 3)) take about a microsecond of the
// card's rates. The design keeps that chain on the SM:
//   * ONE persistent block of 1,024 threads walks all victims in one launch;
//   * the carried state lives in dynamic shared memory, column-major
//     (free_s[r * n_slots + n], then head_s[n]: consecutive threads read
//     consecutive words), when n_slots * (R + 1) * 4 bytes fit (128 KiB at
//     8,192 x 3), else in a global scratch copy with the same layout;
//   * target_ok folds into the carried headroom (0 where the node is not a
//     target): a node that is not a target never fits and is never placed
//     on, so "headroom > 0 && target_ok" is exactly "head_s > 0";
//   * each thread scans its strided nodes into one packed 64-bit key
//     (ord(key) << 32 | n, ord flips the sign bit so the unsigned order is
//     the signed one): the smallest packed key is the argmin with the lowest
//     index on ties, with no second comparison. Warp __shfl_xor_sync minima,
//     one shared-memory pass over the 32 warp minima, and thread 0 updates
//     the one target node; two __syncthreads per victim.
//
// Parity with XLA: the waste sum is done in uint32 and read as int32 (XLA
// wraps, and the sentinel test then reads the wrapped value); nodes that do
// not fit take part in the argmin with the 2^30 sentinel, as in JAX; the
// comparisons are signed, so negative free compares as JAX's does; pad
// slots (target_ok false) and pad victims (v_valid false) change nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define DA_THREADS 1024
#define DA_MAX_R 32
#define DA_BIG (1 << 30)
// dynamic shared memory the state may take: the H100's 227 KiB a block,
// less the static arrays below and a margin
#define DA_SMEM_MAX (227 * 1024 - 2048)

struct DefragArgs {
  int n_slots, v_max, R, use_smem;
  const int* free;                 // [n_slots, R]
  const int* headroom;             // [n_slots]
  const unsigned char* target_ok;  // [n_slots] (torch.bool)
  const int* v_req;                // [v_max, R]
  const unsigned char* v_valid;    // [v_max] (torch.bool)
  int* out;                        // [v_max]
  int* scratch;                    // [n_slots * (R + 1)] when !use_smem
};

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

// RT > 0: R known at compile time (unrolled); RT == 0: R at run time
template <int RT>
__global__ void __launch_bounds__(DA_THREADS, 1) defrag_assign_kernel(const DefragArgs a) {
  extern __shared__ int dyn_s[];
  __shared__ unsigned long long warp_s[DA_THREADS / 32];
  __shared__ int vr_s[2][DA_MAX_R];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int ns = a.n_slots;
  const int R = RT > 0 ? RT : a.R;
  int* state = a.use_smem ? dyn_s : a.scratch;
  int* head_s = state + (size_t)R * ns;

  for (int n = tid; n < ns; n += blockDim.x) {
    for (int r = 0; r < R; ++r) state[(size_t)r * ns + n] = a.free[(size_t)n * R + r];
    head_s[n] = a.target_ok[n] ? a.headroom[n] : 0;
  }
  if (tid < R && a.v_max > 0) vr_s[0][tid] = a.v_req[tid];
  __syncthreads();

  for (int k = 0; k < a.v_max; ++k) {
    const int* vr = vr_s[k & 1];
    unsigned long long best = ~0ull;
    for (int n = tid; n < ns; n += blockDim.x) {
      bool fits = head_s[n] > 0;
      unsigned waste = 0;
#pragma unroll
      for (int r = 0; r < (RT > 0 ? RT : DA_MAX_R); ++r) {
        if (RT == 0 && r >= R) break;
        const int f = state[(size_t)r * ns + n];
        fits = fits && (f >= vr[r]);
        waste += (unsigned)f - (unsigned)vr[r];
      }
      const int key = fits ? (int)waste : DA_BIG;
      const unsigned long long packed =
          ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) | (unsigned)n;
      best = umin64(best, packed);
    }
    for (int off = 16; off > 0; off >>= 1)
      best = umin64(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) warp_s[warp] = best;
    __syncthreads();
    // stage the next victim's request while warp 0 picks this one's target
    if (tid >= 32 && tid - 32 < R && k + 1 < a.v_max)
      vr_s[(k + 1) & 1][tid - 32] = a.v_req[(size_t)(k + 1) * R + (tid - 32)];
    if (warp == 0) {
      unsigned long long m = lane < n_warps ? warp_s[lane] : ~0ull;
      for (int off = 16; off > 0; off >>= 1)
        m = umin64(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) {
        const int key = (int)((unsigned)(m >> 32) ^ 0x80000000u);
        const int tgt = (int)(unsigned)(m & 0xffffffffu);
        const bool place = key < DA_BIG && a.v_valid[k];
        if (place) {
          for (int r = 0; r < R; ++r) {
            int* f = &state[(size_t)r * ns + tgt];
            *f = (int)((unsigned)*f - (unsigned)vr[r]);
          }
          head_s[tgt] -= 1;
        }
        a.out[k] = place ? tgt : -1;
      }
    }
    __syncthreads();
  }
}

template <int RT>
static int launch_r(const DefragArgs* args, cudaStream_t stream) {
  size_t smem = 0;
  if (args->use_smem) {
    smem = (size_t)args->n_slots * (args->R + 1) * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(defrag_assign_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  defrag_assign_kernel<RT><<<1, DA_THREADS, smem, stream>>>(*args);
  return (int)cudaGetLastError();
}

// 1 when the carried state of n_slots x R fits the block's shared memory;
// the wrapper allocates the global scratch otherwise.
extern "C" int defrag_assign_uses_smem(int n_slots, int R) {
  return (size_t)n_slots * (R + 1) * sizeof(int) <= (size_t)DA_SMEM_MAX ? 1 : 0;
}

// Launch on `stream`; returns the first CUDA error of the attribute call or
// the launch. The wrapper checks shapes, 1 <= R <= DA_MAX_R and v_max >= 1.
extern "C" int defrag_assign_launch(const DefragArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (args->R) {
    case 1: return launch_r<1>(args, s);
    case 2: return launch_r<2>(args, s);
    case 3: return launch_r<3>(args, s);
    case 4: return launch_r<4>(args, s);
    default: return launch_r<0>(args, s);
  }
}

extern "C" int defrag_assign_args_size() { return (int)sizeof(DefragArgs); }
extern "C" int defrag_assign_max_r() { return DA_MAX_R; }
