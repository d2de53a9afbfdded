// Kernel F: the Sinkhorn iterations of the entropic transport relaxation
// as one thread-block cluster launch (sm_90a).
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
// What bounds it: the iterations' dependency chain, not bytes or operations.
// At G = 1-8 groups and N = 5,000 nodes the problem is 20-160 KB and a pass
// is a few operations a cell; the first design's 121 dependent launches a
// call (a row pass of G blocks and a column pass a launch each, ~11.6 us
// apiece on an H100) set its time.
//
// Design: one cluster of CS CTAs (16, else 8; cluster_exchange.cuh) runs
// every iteration and the plan in one launch. Each CTA owns a set of nodes
// for every group and keeps z (computed once, as the reference does), g,
// g / eps and log cap for them in its shared memory. An iteration:
//  - g / eps once a node;
//  - the row pass: one warp a group takes the CTA's partial max of
//    z - g/eps, the CTAs exchange the G partials (st.async into every CTA's
//    slots) and every CTA takes the max; then expf(z - g/eps - max) a cell,
//    the CTA's partial sums, a second exchange, and every CTA completes each
//    row's sum in the same fixed order, so every CTA computes the same f
//    (and f / eps) bit for bit;
//  - the column pass is CTA-local: each node over its G groups.
// Then each CTA writes its nodes' g and plan entries (from utility and the
// mask, as the reference does), CTA 0 writes f.
//
// The order of the sums: an ulp of f moves g by up to ~1e-5 where g is near
// 0, so the row and column sums add in the order torch's CUDA sum does for
// the plain version's [G, N] tensors (ops/kernels.py sinkhorn_order: bw x by
// threads a row, float4 vectors into four accumulators, stride-halving trees
// over x then y; by threads a column, four accumulators). A CTA owns the
// nodes of the row threads x = rank, rank + cx, ... (cx = min(CS, bw)) for
// every y, so the levels of the x tree at offsets >= cx are CTA-local; the
// CTAs exchange one partial per (group, y) and every CTA finishes the x tree
// over the CTAs and the y tree. Where torch's order is not the same for
// every row (N % 4 != 0 at N >= 128) or splits a sum across blocks, F keeps
// this order and agrees to rounding.
//
// Where z, or the exchange slots, do not fit in shared memory they
// sit in a per-CTA slice of a global scratch buffer, or a global array with
// barrier.cluster; the layout is chosen by shape by the wrapper's plan
// (ops/kernels.py sinkhorn_plan). Precise expf/logf (no --use_fast_math),
// divisions by eps where the reference divides, _rn intrinsics (the file is
// built with --fmad=false).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

#define SK_MAX_THREADS 512
#define SK_MAX_Y 16  // threads torch splits a column's sum over, at most
#define SK_MAX_CS 16
#define NEG_INF (-1e30f)
// dynamic shared memory a CTA may take (the card allows 227 KB per block)
#define SK_SMEM_BUDGET (220 * 1024)

// regions of a CTA, in the order the plan places them in shared memory
enum { RG_GROUPS, RG_NODES, RG_EXCHANGE, RG_Z, SK_NRG };

struct SinkhornArgs {
  int G, N, iters;
  int cs, threads, chunk, smem_bytes;
  int vec, bw, by, cy;     // torch's sum layout (ops/kernels.py sinkhorn_order)
  int off[SK_NRG];         // byte offset in dynamic shared memory, -1: global
  long long goff[SK_NRG];  // byte offset in the CTA's global slice
  long long gbytes;        // one CTA's global slice
  float eps;
  const float* utility;           // [G, N]
  const unsigned char* feasible;  // [G, N]
  const int* supply;              // [G]
  const float* cap;               // [N]
  const float* f0;                // [G]
  const float* g0;                // [N]
  float* f;                       // [G] out
  float* g;                       // [N] out
  float* plan;                    // [G, N] out
  char* gscratch;                 // cs slices of gbytes
  float* xslots;                  // [cs][G] maxima, then [cs][G * by] partials, when global
};

__device__ __forceinline__ float slot_at(const float* p, int in_smem) {
  return in_smem ? *p : __ldcg(p);
}

// torch's combine of a thread's four accumulators
__device__ __forceinline__ float combine4(const float (&acc)[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

// stride-halving tree over v[0..n) in place (n a power of two, lower index
// on the left); returns v[0]
__device__ __forceinline__ float halving_tree(float* v, int n) {
  for (int o = n >> 1; o > 0; o >>= 1)
    for (int k = 0; k < o; ++k) v[k] = __fadd_rn(v[k], v[k + o]);
  return v[0];
}

// the same over 16 values with static indices (registers); values past the
// real width are +0.0, which leaves the sums of non-negative terms exact
__device__ __forceinline__ float halving16(float (&v)[16]) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < o; ++k) v[k] = __fadd_rn(v[k], v[k + o]);
  }
  return v[0];
}

__global__ void __launch_bounds__(SK_MAX_THREADS, 1) sinkhorn_kernel(const SinkhornArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bars[2];
  __shared__ int n_local;
  __shared__ float fe_w[SK_MAX_THREADS / 32][32];  // a warp's copy of f / eps (G <= 32)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = a.cs, G = a.G, N = a.N, chunk = a.chunk;
  const int bw = a.bw, by = a.by, cy = a.cy, W = bw * by;
  const int cx = min(cs, bw), mxn = bw / cx, own = mxn * by;  // the CTA's row threads
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const float eps = a.eps;
  char* gslice = a.gscratch ? a.gscratch + (size_t)rank * a.gbytes : nullptr;
#define REGION(r) ((float*)(a.off[r] >= 0 ? (char*)smem + a.off[r] : gslice + a.goff[r]))
  float* f = REGION(RG_GROUPS);  // alike in every CTA
  float* fe = f + G;             // f / eps
  float* logs = fe + G;
  float* mx = logs + G;          // this iteration's row maxima
  float* part = mx + G;  // [G][own][4]: the row threads' accumulators (16-byte aligned)
  int* base = (int*)(part + (size_t)G * own * 4);  // [own + 1]: row thread j's first node
  float* gv = REGION(RG_NODES);  // g of this CTA's nodes
  float* ge = gv + chunk;        // g / eps
  float* logc = ge + chunk;
  int* node = (int*)(logc + chunk);  // local node i -> its index n
  float* z = REGION(RG_Z);           // [G, chunk]
#undef REGION
  const int xsmem = a.off[RG_EXCHANGE] >= 0;
  float* xmax = xsmem ? (float*)(smem + a.off[RG_EXCHANGE]) : a.xslots;  // [cs][G]
  float* xsum = xmax + (size_t)cs * G;                                    // [cs][G * by]

  // ---- the CTA's nodes: row thread j = y * mxn + m is t = x + bw * y with
  // x = rank + cx * m; its nodes in the order torch adds them ----
  const int nv = N / 4;
  auto t_count = [&](int j) {
    if (rank >= cx) return 0;
    const int y = j / mxn, x = rank + cx * (j % mxn), t = x + bw * y;
    if (a.vec) {
      const int k = nv > t ? (nv - t + W - 1) / W : 0;
      return 4 * k + ((y == 0 && x < N - 4 * nv) ? 1 : 0);
    }
    return N > t ? (N - t + W - 1) / W : 0;
  };
  if (tid == 0) {
    int s = 0;
    for (int j = 0; j < own; ++j) {
      base[j] = s;
      s += t_count(j);
    }
    base[own] = s;
    n_local = s;
  }
  __syncthreads();
  const int L = n_local;
  for (int j = tid; j < own; j += T) {
    const int y = j / mxn, x = rank + cx * (j % mxn), t = x + bw * y;
    const int b = base[j], c = base[j + 1] - b;
    for (int s = 0; s < c; ++s) {
      int n;
      if (!a.vec) n = t + s * W;
      else if (s < (c & ~3)) n = 4 * (t + (s >> 2) * W) + (s & 3);
      else n = 4 * nv + x;  // the tail element
      node[b + s] = n;
    }
  }
  for (int j = tid; j < G; j += T) {
    f[j] = a.f0[j];
    logs[j] = logf(fmaxf((float)a.supply[j], 1e-9f));
  }
  __syncthreads();
  for (int i = tid; i < L; i += T) {
    const int n = node[i];
    gv[i] = a.g0[n];
    logc[i] = logf(fmaxf(a.cap[n], 1e-9f));
  }
  for (size_t j = tid; j < (size_t)G * L; j += T) {
    const int g = (int)(j / L), i = (int)(j % L);
    const size_t s = (size_t)g * N + node[i];
    const float mask = a.feasible[s] ? 0.0f : NEG_INF;
    z[(size_t)g * chunk + i] = __fdiv_rn(__fadd_rn(a.utility[s], mask), eps);
  }
  Xchg xc;
  xchg_init(xc, smem_addr(bars), (unsigned)(cs * G * 4), (unsigned)(cs * G * by * 4), xsmem);
  __syncthreads();
  cluster.sync();  // every CTA has started and armed its barriers

  // this CTA's value into slot k of every CTA's array `arr` (use p)
  auto publish = [&](int p, float* arr, size_t k, float v, int sender) {
    if (xsmem) {
      if (sender < cs)
        st_async_b32(remote_addr(smem_addr(&arr[k]), sender), __float_as_uint(v),
                     remote_addr(xc.bar + 8 * p, sender));
    } else if (sender == 0) {
      arr[k] = v;
    }
  };

  for (int it = 0; it < a.iters; ++it) {
    for (int i = tid; i < L; i += T) ge[i] = __fdiv_rn(gv[i], eps);
    __syncthreads();
    // ---- rows: the partial maxima, exchanged; every CTA takes the max ----
    for (int g = warp; g < G; g += nw) {
      const float* zg = z + (size_t)g * chunk;
      float m = -INFINITY;
      for (int i = lane; i < L; i += 32) m = fmaxf(m, __fsub_rn(zg[i], ge[i]));
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      publish(0, xmax, (size_t)rank * G + g, m, lane);
    }
    xchg_wait(xc, 0);
    // ---- rows: each row thread's four accumulators (one thread each; the
    // row's max from the slots), its partial and the CTA's levels of the x
    // tree (one warp a (group, y)); exchanged; every CTA finishes the trees
    for (int j = tid; j < G * own * 4; j += T) {
      const int g = j / (own * 4), r = (j >> 2) % own, q = j & 3;
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < SK_MAX_CS; ++c)
        if (c < cs) m = fmaxf(m, slot_at(&xmax[(size_t)c * G + g], xsmem));
      m = isfinite(m) ? m : 0.0f;
      if (j % (own * 4) == 0) mx[g] = m;
      const float* zg = z + (size_t)g * chunk;
      float acc = 0.0f;
      for (int i = base[r] + q; i < base[r + 1]; i += 4)
        acc = __fadd_rn(acc, expf(__fsub_rn(__fsub_rn(zg[i], ge[i]), m)));
      part[j] = acc;
    }
    __syncthreads();
    xchg_rearm(xc, 0);  // the max slots' last read is behind us
    for (int j = warp; j < G * by; j += nw) {  // x offsets bw/2 .. cx: in the CTA
      const int g = j / by, y = j % by;
      const float* pq = part + ((size_t)g * own + y * mxn) * 4;
      auto p_of = [&](int m) {
        const float4 v = *(const float4*)(pq + 4 * m);
        return __fadd_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), v.w);
      };
      float v = lane < mxn ? p_of(lane) : 0.0f;
      if (mxn > 32) v = __fadd_rn(v, p_of(lane + 32));  // offset 32 (mxn is 64)
      for (int o = min(mxn, 32) >> 1; o > 0; o >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
      v = __shfl_sync(0xffffffffu, v, 0);
      publish(1, xsum, (size_t)rank * G * by + j, v, lane);
    }
    xchg_wait(xc, 1);
    // f of group g: x offsets cx/2 .. 1 over the CTAs (0 pads to 16), then y
    auto f_of = [&](int g) {
      float sum;
      if (by == 1) {
        float r[SK_MAX_CS];
#pragma unroll
        for (int c = 0; c < SK_MAX_CS; ++c) r[c] = c < cx ? slot_at(&xsum[(size_t)c * G + g], xsmem) : 0.0f;
        sum = halving16(r);
      } else {
        float q[SK_MAX_Y];
        for (int y = 0; y < by; ++y) {
          float r[SK_MAX_CS];
#pragma unroll
          for (int c = 0; c < SK_MAX_CS; ++c)
            r[c] = c < cx ? slot_at(&xsum[(size_t)c * G * by + (size_t)g * by + y], xsmem) : 0.0f;
          q[y] = halving16(r);
        }
        sum = halving_tree(q, by);
      }
      const float lse = __fadd_rn(logf(fabsf(sum)), mx[g]);
      return fmaxf(0.0f, __fmul_rn(eps, __fsub_rn(lse, logs[g])));
    };
    // f / eps where the columns read it: up to 32 groups every warp computes
    // them (lane g) into its own row of fe_w, so the columns need no CTA
    // barrier; beyond, the CTA computes them once into fe
    const float* fer = fe;
    if (G <= 32) {
      if (lane < G) {
        const float fv = f_of(lane);
        fe_w[warp][lane] = __fdiv_rn(fv, eps);
        if (warp == 0) f[lane] = fv;
      }
      __syncwarp();
      fer = fe_w[warp];
    } else {
      for (int g = tid; g < G; g += T) {
        const float fv = f_of(g);
        f[g] = fv;
        fe[g] = __fdiv_rn(fv, eps);
      }
      __syncthreads();
    }
    // ---- columns: each node over its groups, in torch's order ----
    for (int i = tid; i < L; i += T) {
      float m = -INFINITY;
      for (int g = 0; g < G; ++g) m = fmaxf(m, __fsub_rn(z[(size_t)g * chunk + i], fer[g]));
      if (!isfinite(m)) m = 0.0f;
      auto term = [&](int g) {
        return expf(__fsub_rn(__fsub_rn(z[(size_t)g * chunk + i], fer[g]), m));
      };
      float sum;
      if (cy == 1) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int g = 0;
        for (; g + 3 < G; g += 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = __fadd_rn(acc[q], term(g + q));
        }
#pragma unroll
        for (int q = 0; q < 3; ++q)
          if (g + q < G) acc[q] = __fadd_rn(acc[q], term(g + q));
        sum = combine4(acc);
      } else {
        float q[SK_MAX_Y];
        for (int y = 0; y < cy; ++y) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          int g = y;
          for (; g + 3 * cy < G; g += 4 * cy) {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], term(g + k * cy));
          }
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (g + k * cy < G) acc[k] = __fadd_rn(acc[k], term(g + k * cy));
          q[y] = combine4(acc);
        }
        sum = halving_tree(q, cy);
      }
      const float lse = __fadd_rn(logf(fabsf(sum)), m);
      gv[i] = fmaxf(0.0f, __fmul_rn(eps, __fsub_rn(lse, logc[i])));
    }
    __syncthreads();
    xchg_rearm(xc, 1);  // every warp has read the partial slots
  }

  // ---- f, this CTA's g and plan entries ----
  if (rank == 0)
    for (int j = tid; j < G; j += T) a.f[j] = f[j];
  for (int i = tid; i < L; i += T) a.g[node[i]] = gv[i];
  for (size_t j = tid; j < (size_t)G * L; j += T) {
    const int g = (int)(j / L), i = (int)(j % L);
    const size_t s = (size_t)g * N + node[i];
    const float mask = a.feasible[s] ? 0.0f : NEG_INF;
    const float t = __fsub_rn(__fsub_rn(__fadd_rn(a.utility[s], mask), f[g]), gv[i]);
    const float v = expf(__fdiv_rn(t, eps));
    a.plan[s] = v < FLT_MIN ? 0.0f : v;  // XLA flushes subnormal results to zero
  }
  cluster.sync();  // no CTA leaves while another may still use its slots
}

// ---------------------------------------------------------------------------
// host side: the cluster size (once per process), the launch
// ---------------------------------------------------------------------------

static int g_cluster_size = 0;
static int g_cluster_error = 0;

// 16 or 8, or minus the CUDA error that refused both
extern "C" int sinkhorn_cluster_size() {
  if (!g_cluster_size && !g_cluster_error)
    g_cluster_size = choose_cluster_size(sinkhorn_kernel, SK_MAX_THREADS, SK_SMEM_BUDGET,
                                         &g_cluster_error);
  return g_cluster_size ? g_cluster_size : -g_cluster_error;
}

// `iters` iterations and the plan on `stream` as one cluster, with the
// layout the wrapper planned (ops/kernels.py sinkhorn_plan). *launched counts
// the kernels launched. Returns the CUDA error of the launch (a refused
// cluster launch never runs; nothing retries it).
extern "C" int sinkhorn_launch(const SinkhornArgs* args, void* stream, int* launched) {
  *launched = 0;
  const int cs = sinkhorn_cluster_size();
  if (cs <= 0) return -cs;
  const SinkhornArgs& a = *args;
  const bool pow2 = a.bw > 0 && !(a.bw & (a.bw - 1)) && a.by > 0 && !(a.by & (a.by - 1)) &&
                    a.cy > 0 && !(a.cy & (a.cy - 1));
  if (a.cs != cs || a.threads < 32 || a.threads > SK_MAX_THREADS || a.threads % 32 ||
      a.smem_bytes > SK_SMEM_BUDGET || !pow2 || a.by > SK_MAX_Y || a.cy > SK_MAX_Y)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(cs, a.threads, a.smem_bytes, (cudaStream_t)stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, sinkhorn_kernel, a);
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int sinkhorn_args_size() { return (int)sizeof(SinkhornArgs); }
