// Kernel B: scatter of dirty node rows into the device mirrors (sm_90a).
//
// Replaces: kubernetes_tpu/snapshot/tensorizer.py TensorCache.device_views —
// `.at[rows].set(host[rows])` on the DEVICE_FIELDS node tensors (:417) and
// `.at[:, cols].set(...)` on selcls_count (:434). The plain PyTorch versions
// are snapshot/tensorizer.py scatter_rows_plain / scatter_cols_plain.
//
//   row mode: dst[idx[i], j] = src[i, j]   dst [N, w], src [k, w]
//   col mode: dst[s, idx[i]] = src[s, i]   dst [w, n_cols], src [w, k]
//
// What bounds it: bytes. Each element is read once and written once; the
// packed rows crossed from the host by a plain copy before the launch. The
// design is one thread per element, consecutive threads on consecutive
// source elements (coalesced reads; row mode also writes whole rows
// contiguously). At a few thousand dirty rows the launch itself dominates.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void row_scatter_kernel(int* __restrict__ dst, const int* __restrict__ idx,
                                   const int* __restrict__ src, int k, int w, int n_cols,
                                   int col_mode) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)k * w) return;
  if (!col_mode) {
    const long long i = e / w, j = e % w;
    dst[(long long)idx[i] * w + j] = src[e];
  } else {
    const long long s = e / k, i = e % k;
    dst[s * n_cols + idx[i]] = src[e];
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
extern "C" int row_scatter_launch(void* dst, const void* idx, const void* src, int k, int w,
                                  int n_cols, int col_mode, void* stream) {
  const long long total = (long long)k * w;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  row_scatter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int*)dst, (const int*)idx, (const int*)src, k, w, n_cols, col_mode);
  return (int)cudaGetLastError();
}
