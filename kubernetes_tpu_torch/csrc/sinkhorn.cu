// Kernel F: the Sinkhorn iterations of the entropic transport relaxation
// (sm_90a).
//
// Replaces: kubernetes_tpu/models/transport.py:326 _sinkhorn_iters (jax.jit
// around a lax.fori_loop). The plain PyTorch version is models/transport.py
// _sinkhorn_iters_plain; the two agree to float32 rounding (expf/logf and
// the reduction order differ from XLA:CPU's by a few ulps).
//
//   z = (utility + logmask) / eps,  logmask = feasible ? 0 : NEG_INF
//   iters times:
//     f_g = max(0, eps * (lse_n(z[g, n] - g_n / eps) - log max(supply_g, 1e-9)))
//     g_n = max(0, eps * (lse_g(z[g, n] - f_g / eps) - log max(cap_n, 1e-9)))
//   plan = exp((utility + logmask - f_g - g_n) / eps)
// with lse as jax.scipy.special.logsumexp: the max, a non-finite max taken
// as 0, then log(|sum exp(a - max)|) + max. A subnormal plan entry is
// written as 0, as XLA (which flushes subnormals) gives it.
//
// What bounds it: bytes. Each iteration reads utility and feasible twice
// ([G, N] float32 + bool, from L2 after the first pass at these sizes) and
// does ~4 operations and one expf per cell per pass; the plan is one more
// pass. At G = 1-8 groups and N = 5,000 nodes the data is a few hundred KB
// and the 121 dependent launches, not the card's rates, set the time.
//
// Design: per iteration two launches on the stream, no host sync: the row
// pass is one block per group (a block max, then a block sum of expf, logf
// and the clamp at 0); the column pass is one thread per node looping over
// the groups (coalesced across the warp). A last launch writes the plan.
// z is recomputed in each pass (the same rounded value each time) rather
// than stored. Precise expf/logf (no --use_fast_math), divisions by eps
// where the reference divides, _rn intrinsics (the file is built with
// --fmad=false).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#define SK_THREADS 256
#define SK_WARPS (SK_THREADS / 32)
#define NEG_INF (-1e30f)

struct SinkhornArgs {
  int G, N;
  float eps;
  const float* utility;          // [G, N]
  const unsigned char* feasible; // [G, N]
  const int* supply;             // [G]
  const float* cap;              // [N]
  float* f;                      // [G] in: f0, out: f
  float* g;                      // [N] in: g0, out: g
  float* plan;                   // [G, N] out
};

__device__ __forceinline__ float z_of(const SinkhornArgs& a, size_t i) {
  const float mask = a.feasible[i] ? 0.0f : NEG_INF;
  return __fdiv_rn(__fadd_rn(a.utility[i], mask), a.eps);
}

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : __fadd_rn(v, o);
  }
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < SK_WARPS; ++w) r = is_max ? fmaxf(r, red[w]) : __fadd_rn(r, red[w]);
  return r;
}

// row pass: f_g from the current g
__global__ void __launch_bounds__(SK_THREADS) sk_rows(const SinkhornArgs a) {
  __shared__ float red[SK_WARPS];
  const int gi = blockIdx.x, N = a.N;
  const size_t base = (size_t)gi * N;
  float m = -INFINITY;
  for (int n = threadIdx.x; n < N; n += SK_THREADS)
    m = fmaxf(m, __fsub_rn(z_of(a, base + n), __fdiv_rn(a.g[n], a.eps)));
  m = block_reduce(m, true, red);
  if (!isfinite(m)) m = 0.0f;
  float s = 0.0f;
  for (int n = threadIdx.x; n < N; n += SK_THREADS)
    s = __fadd_rn(s, expf(__fsub_rn(__fsub_rn(z_of(a, base + n), __fdiv_rn(a.g[n], a.eps)), m)));
  s = block_reduce(s, false, red);
  if (threadIdx.x == 0) {
    const float lse = __fadd_rn(logf(fabsf(s)), m);
    const float logs = logf(fmaxf((float)a.supply[gi], 1e-9f));
    a.f[gi] = fmaxf(0.0f, __fmul_rn(a.eps, __fsub_rn(lse, logs)));
  }
}

// column pass: g_n from the new f, one thread per node
__global__ void __launch_bounds__(SK_THREADS) sk_cols(const SinkhornArgs a) {
  const int n = blockIdx.x * SK_THREADS + threadIdx.x;
  if (n >= a.N) return;
  const int G = a.G, N = a.N;
  float m = -INFINITY;
  for (int gi = 0; gi < G; ++gi)
    m = fmaxf(m, __fsub_rn(z_of(a, (size_t)gi * N + n), __fdiv_rn(a.f[gi], a.eps)));
  if (!isfinite(m)) m = 0.0f;
  float s = 0.0f;
  for (int gi = 0; gi < G; ++gi)
    s = __fadd_rn(s, expf(__fsub_rn(__fsub_rn(z_of(a, (size_t)gi * N + n),
                                              __fdiv_rn(a.f[gi], a.eps)), m)));
  const float lse = __fadd_rn(logf(fabsf(s)), m);
  const float logc = logf(fmaxf(a.cap[n], 1e-9f));
  a.g[n] = fmaxf(0.0f, __fmul_rn(a.eps, __fsub_rn(lse, logc)));
}

__global__ void __launch_bounds__(SK_THREADS) sk_plan(const SinkhornArgs a) {
  const size_t total = (size_t)a.G * a.N;
  for (size_t i = (size_t)blockIdx.x * SK_THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * SK_THREADS) {
    const int gi = (int)(i / a.N), n = (int)(i % a.N);
    const float mask = a.feasible[i] ? 0.0f : NEG_INF;
    const float t = __fsub_rn(__fsub_rn(__fadd_rn(a.utility[i], mask), a.f[gi]), a.g[n]);
    const float v = expf(__fdiv_rn(t, a.eps));
    a.plan[i] = v < FLT_MIN ? 0.0f : v;  // XLA flushes subnormal results to zero
  }
}

// iters row/column passes and the plan, back to back on `stream`; returns
// the first launch error (0 when every launch was accepted)
extern "C" int sinkhorn_launch(const SinkhornArgs* args, int iters, void* stream_ptr) {
  const SinkhornArgs& a = *args;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t e;
  const int col_blocks = (a.N + SK_THREADS - 1) / SK_THREADS;
  for (int it = 0; it < iters; ++it) {
    sk_rows<<<a.G, SK_THREADS, 0, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    sk_cols<<<col_blocks, SK_THREADS, 0, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const size_t total = (size_t)a.G * a.N;
  size_t blocks = (total + SK_THREADS - 1) / SK_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  sk_plan<<<(int)blocks, SK_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int sinkhorn_args_size() { return (int)sizeof(SinkhornArgs); }
