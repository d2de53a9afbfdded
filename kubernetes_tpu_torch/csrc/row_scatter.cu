// Kernel B: one fused scatter of the dirty node rows into every device
// mirror of a batch (sm_90a).
//
// Replaces: kubernetes_tpu/snapshot/tensorizer.py TensorCache.device_views —
// `.at[rows].set(host[rows])` on each of the DEVICE_FIELDS node tensors
// (:417) and `.at[:, cols].set(...)` on selcls_count (:434), one update per
// field. The plain PyTorch versions are snapshot/tensorizer.py
// scatter_mirrors_plain (the fused form) and scatter_rows_plain /
// scatter_cols_plain (one mirror).
//
// The source is one packed int32 buffer [k, W]: column 0 holds the row
// index, then one segment per mirror (alloc, used and used_nz R wide,
// pod_count and max_pods 1 wide, selcls_count SC wide). A descriptor per
// mirror gives its destination, width, mode and segment offset:
//   row mode:    dst[row_i, j]  = packed[i, off + j]   dst [N, w] or [N]
//   column mode: dst[j, row_i]  = packed[i, off + j]   dst [w, n_cols]
// The single-mirror entry (scatter_rows / scatter_cols) is the same launch
// with one descriptor, on a [k, 1 + w] buffer packed on the device.
//
// What bounds it: at the main path's shape the launch. Each element is
// read once and written once (~150 KB for five fields at 4,096 dirty rows,
// ~0.05 us of HBM time), which is far below one launch (~2-3 us of device
// time and a few us of host time). The design is therefore one launch per
// batch for every mirror, fed by one host-to-device copy of the packed
// buffer: one thread per packed element, consecutive threads on
// consecutive packed columns of one row (coalesced reads; a row-mode
// segment writes contiguous destination words).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_MIRRORS 8

struct MirrorDesc {
  int* dst;
  int width;     // elements of the mirror's segment (row mode: the row width)
  int offset;    // first packed column of the segment
  int col_mode;  // 1: dst[j, row] ([width, n_cols]); 0: dst[row, j]
  int n_cols;
};

struct MirrorSet {
  int n;  // descriptors in use
  int W;  // packed row width
  MirrorDesc d[MAX_MIRRORS];
};

__global__ void mirror_scatter_kernel(const MirrorSet s, const int* __restrict__ packed, int k) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)k * s.W;
  if (e >= total) return;
  const long long i = e / s.W;
  const long long j = e - i * s.W;
  const long long row = packed[i * s.W];
#pragma unroll
  for (int m = 0; m < MAX_MIRRORS; ++m) {
    if (m >= s.n) break;
    const MirrorDesc& d = s.d[m];
    const long long c = j - d.offset;
    if (c < 0 || c >= d.width) continue;
    if (d.col_mode)
      d.dst[c * d.n_cols + row] = packed[e];
    else
      d.dst[row * d.width + c] = packed[e];
    break;
  }
}

// Every mirror of one batch in one launch: the descriptors of `set` (by
// value into the kernel), the row indices in the packed buffer's column 0.
// Returns cudaGetLastError() after the launch.
extern "C" int mirror_scatter_launch(const MirrorSet* set, const void* packed, int k,
                                     void* stream) {
  const long long total = (long long)k * set->W;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  mirror_scatter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*set, (const int*)packed,
                                                                      k);
  return (int)cudaGetLastError();
}

extern "C" int mirror_set_size() { return (int)sizeof(MirrorSet); }
