// Kernel J: feasibility and score rows against the initial state (sm_90a).
//
// Replaces: kubernetes_tpu/parallel/sharded.py:108 feasibility_cost_matrices,
// the vmap of kubernetes_tpu/ops/solver.py:238 pod_row_feasibility_score
// (the transport solvers reach it through models/transport.py:74
// _group_rows, one row per group representative). The plain PyTorch version
// is ops/solver.py feasibility_rows_plain; the two must agree exactly.
//
//   feas[i, n]  = filter_ok[c, n] & fit(req_i on n) & pod headroom
//                 & !any_p(node_ports[n, p] & class_ports[c, p])
//   total[i, n] = least + balanced + 2 napref + 3 taint + img[c, n]
//   with c = max(cls[i], 0), napref and taint DefaultNormalize'd over the
//   row's feasible nodes (the max of where(feas, raw, 0)).
//
// What bounds it: bytes. Per row it reads the node state (alloc, used,
// used_nz [N, R], counts, the class rows and the port bitmap) and writes a
// bool and an int32 per node; the arithmetic is ~40 integer operations a
// node. With G rows the node state is re-read G times, from L2 after the
// first.
//
// Design: one block per row, threads strided over N. Pass 1 computes the
// feasibility, writes it, writes the partial total (least + balanced + img)
// and reduces the two normalizer maxima over feasible nodes (warp shuffles,
// then shared memory). Pass 2 adds 2 napref + 3 taint. All int32 sums wrap
// (done in uint32) as XLA's do, so the split sum is exact.
//
// Parity with XLA: Python/JAX floor division via floordiv(); Balanced in
// float32 with explicit _rn intrinsics (the file is built with
// --fmad=false), truncation to int32 as astype does; the class id is
// clamped at 0.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define FR_THREADS 256
#define FR_WARPS (FR_THREADS / 32)

struct FeasRowsArgs {
  int Rw, N, R, C, Pt;
  const int* alloc;                  // [N, R]
  const int* used;                   // [N, R]
  const int* used_nz;                // [N, R]
  const int* pod_count;              // [N]
  const int* max_pods;               // [N]
  const unsigned char* filter_ok;    // [C, N]
  const int* napref_raw;             // [C, N]
  const unsigned char* has_napref;   // [C]
  const int* taint_cnt;              // [C, N]
  const int* img_score;              // [C, N]
  const unsigned char* class_ports;  // [C, Pt]
  const unsigned char* node_ports;   // [N, Pt]
  const int* reqs;                   // [Rw, R]
  const int* req_nzs;                // [Rw, R]
  const int* clss;                   // [Rw]
  const unsigned char* bals;         // [Rw]
  unsigned char* feas;               // [Rw, N] out
  int* total;                        // [Rw, N] out
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

__global__ void __launch_bounds__(FR_THREADS) feasibility_rows_kernel(const FeasRowsArgs a) {
  __shared__ int red_s[2 * FR_WARPS];
  __shared__ int mx_s[2];
  const int i = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, R = a.R, Pt = a.Pt;
  const int cls = max(a.clss[i], 0);
  const int* req = a.reqs + (size_t)i * R;
  const int* req_nz = a.req_nzs + (size_t)i * R;
  const int bal_active = a.bals[i] != 0;
  const unsigned char* fok = a.filter_ok + (size_t)cls * N;
  const unsigned char* cports = a.class_ports + (size_t)cls * Pt;
  const int* naprow = a.napref_raw + (size_t)cls * N;
  const int* taintrow = a.taint_cnt + (size_t)cls * N;
  const int* imgrow = a.img_score + (size_t)cls * N;
  unsigned char* feas_out = a.feas + (size_t)i * N;
  int* total_out = a.total + (size_t)i * N;

  // pass 1: feasibility, partial total, normalizer maxima over feasible nodes
  int mx_nap = 0, mx_taint = 0;  // max(where(feas, raw, 0)) starts at 0
  for (int n = tid; n < N; n += FR_THREADS) {
    const int* al = a.alloc + (size_t)n * R;
    const int* us = a.used + (size_t)n * R;
    const int* unz = a.used_nz + (size_t)n * R;
    bool f = fok[n] != 0;
    for (int r = 0; r < R; ++r) {
      const int q = req[r];
      if (!(q == 0 || q <= wsub(al[r], us[r]))) f = false;
    }
    if (!(wadd(a.pod_count[n], 1) <= a.max_pods[n])) f = false;
    for (int p = 0; p < Pt; ++p)
      if (a.node_ports[(size_t)n * Pt + p] && cports[p]) f = false;
    // LeastAllocated over cpu + memory (int32)
    int per_sum = 0, npos = 0;
    for (int r = 0; r < 2; ++r) {
      const int A = al[r];
      const int u = wadd(unz[r], req_nz[r]);
      if (A > 0) {
        npos += 1;
        if (u <= A) per_sum = wadd(per_sum, floordiv(wmul(wsub(A, u), 100), max(A, 1)));
      }
    }
    const int least = floordiv(per_sum, max(npos, 1));
    // BalancedAllocation, float32 without FMA (kernel A's formula)
    int bal = 0;
    if (bal_active) {
      float frac[2];
      int nf = 0;
      for (int r = 0; r < 2; ++r) {
        const float af = (float)al[r];
        const float u = (float)wadd(us[r], req[r]);
        frac[r] = af > 0.0f ? fminf(__fdiv_rn(u, fmaxf(af, 1.0f)), 1.0f) : 0.0f;
        if (af > 0.0f) nf += 1;
      }
      const float sd = nf == 2 ? __fdiv_rn(fabsf(__fsub_rn(frac[0], frac[1])), 2.0f) : 0.0f;
      bal = (int)__fmul_rn(__fsub_rn(1.0f, sd), 100.0f);
    }
    feas_out[n] = f ? 1 : 0;
    total_out[n] = wadd(wadd(least, bal), imgrow[n]);
    if (f) {
      mx_nap = max(mx_nap, naprow[n]);
      mx_taint = max(mx_taint, taintrow[n]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mx_nap = max(mx_nap, __shfl_down_sync(0xffffffffu, mx_nap, off));
    mx_taint = max(mx_taint, __shfl_down_sync(0xffffffffu, mx_taint, off));
  }
  if (lane == 0) {
    red_s[warp] = mx_nap;
    red_s[FR_WARPS + warp] = mx_taint;
  }
  __syncthreads();
  if (tid == 0) {
    int m0 = 0, m1 = 0;
    for (int w = 0; w < FR_WARPS; ++w) {
      m0 = max(m0, red_s[w]);
      m1 = max(m1, red_s[FR_WARPS + w]);
    }
    mx_s[0] = m0;
    mx_s[1] = m1;
  }
  __syncthreads();
  const int mxn = mx_s[0], mxt = mx_s[1];
  const int has_nap = a.has_napref[cls] != 0;

  // pass 2: + 2 napref + 3 taint (each thread revisits its own nodes)
  for (int n = tid; n < N; n += FR_THREADS) {
    int napref = 0;
    if (has_nap) napref = mxn > 0 ? floordiv(wmul(100, naprow[n]), max(mxn, 1)) : 0;
    const int tscaled = mxt > 0 ? floordiv(wmul(100, taintrow[n]), max(mxt, 1)) : 0;
    const int taint = mxt > 0 ? wsub(100, tscaled) : 100;
    total_out[n] = wadd(total_out[n], wadd(wmul(2, napref), wmul(3, taint)));
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch. The
// wrapper checks shapes, types and contiguity.
extern "C" int feasibility_rows_launch(const FeasRowsArgs* args, void* stream) {
  if (args->Rw > 0 && args->N > 0)
    feasibility_rows_kernel<<<args->Rw, FR_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int feasibility_rows_args_size() { return (int)sizeof(FeasRowsArgs); }
