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
// What bounds it: bytes, by far (~40 integer operations a cell). Per row it
// reads the node state (alloc, used, used_nz [N, R], counts), the row's
// class rows and writes a bool and an int32 per node: ~0.17 us of HBM at
// 8 rows x 5,000 nodes. What held the earlier design (one block a row)
// back was its width: a 1-row call (every Transport_50k batch) ran on one
// SM of 132, each thread walking ~20 nodes in series.
//
// Design: one thread-block cluster a row, its nodes tiled over the
// cluster's CTAs, one node a thread, one launch. The plan (ops/kernels.py
// feasibility_plan) splits the N nodes over the cluster's CS CTAs (16 where
// the card schedules such a cluster, else 8; chosen once per process): CTA
// c owns nodes [c * chunk, (c + 1) * chunk), thread t the nodes c * chunk +
// t + j * threads. A launch is `clusters` clusters (at most as many as the
// card runs at once); cluster q takes the rows q, q + clusters, ... (Rw 8 is
// eight clusters, Rw 1 one, Rw 512 a loop of rows in each cluster).
//   * a thread loads its first node's state once (free = alloc - used, the
//     cpu and memory alloc and used_nz, the pod-headroom bit) into registers
//     and keeps it across the cluster's rows, FR_REG_R resource columns of
//     it; columns beyond those, and a thread's further nodes (more than one
//     a thread only past 16 x 512 nodes, or 8 x 512 on 8-CTA clusters), are
//     read from global memory per row, and such a node's partial total goes
//     through the output;
//   * per row it computes each node's feasibility and partial total (least
//     + balanced + image) and the two normalizer maxima over feasible nodes;
//     the CTA reduces them (redux.sync, then one warp), warp 0 pushes the
//     pair into every CTA's slot by st.async (csrc/cluster_exchange.cuh), so
//     a CTA waits on its own mbarrier and reads its own shared memory (where
//     every warp pulls the CS CTAs' pairs over DSMEM, the loads contend at
//     the owning SMs), and each thread adds 2 napref + 3 taint and writes
//     feas and total once;
//   * the next row's request, class and the class's first 32 port columns
//     are read while this row reduces; each warp votes whether the class
//     sets any port column once the row's class data is in flight;
//   * the host-port test over every port column runs only for a row whose
//     class sets one, so a class without ports (every row on the transport
//     path: it declines batches with host ports) costs nothing a node.
// A maximum does not depend on the order of the reduction, so the split
// reduction is exact; a CTA with no feasible node sends maxima of 0, as
// where(feas, raw, 0).max() does.
//
// Parity with XLA: int32 sums wrap (done in uint32); Python/JAX floor
// division via floordiv(); Balanced in float32 with explicit _rn
// intrinsics (the file is built with --fmad=false), truncation to int32 as
// astype does; the class id is clamped at 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

#define FR_MAX_THREADS 512
#define FR_MAX_WARPS (FR_MAX_THREADS / 32)
#define FR_REG_R 4        // resource columns a node keeps in registers
#define FR_MAX_CS 16

struct FeasRowsArgs {
  int Rw, N, R, C, Pt;
  int cs, clusters, threads, chunk, npt;  // the plan (ops/kernels.py)
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

// what a node keeps across rows
struct NodeState {
  int fr[FR_REG_R];  // alloc - used (wrapping), columns < min(R, FR_REG_R)
  int a0, a1;        // cpu and memory alloc
  int unz0, unz1;    // cpu and memory used_nz
  bool pod_ok;       // pod_count + 1 <= max_pods
};

// what a row needs of its request and class
struct RowParams {
  int req[FR_REG_R];
  int rnz0, rnz1;
  int cls;
  bool bal, has_nap;
  bool port0;        // this lane's port column (lane < 32) set by the class
  bool ports;        // the class sets a port column (the row's warp vote)
  const int* req_g;  // the whole request row, for columns >= FR_REG_R
};

__device__ __forceinline__ void load_node(const FeasRowsArgs& a, int n, NodeState& s) {
  const int R = a.R;
  const int* al = a.alloc + (size_t)n * R;
  const int* us = a.used + (size_t)n * R;
#pragma unroll
  for (int r = 0; r < FR_REG_R; ++r) s.fr[r] = r < R ? wsub(al[r], us[r]) : 0;
  s.a0 = al[0];
  s.a1 = al[1];
  s.unz0 = a.used_nz[(size_t)n * R];
  s.unz1 = a.used_nz[(size_t)n * R + 1];
  s.pod_ok = wadd(a.pod_count[n], 1) <= a.max_pods[n];
}

// node n's feasibility for the row and its partial total (least + balanced
// + image), given its filter bit and image score for the row's class
__device__ __forceinline__ bool node_row(const FeasRowsArgs& a, const RowParams& p, int n,
                                         const NodeState& s, bool fok, int img, int& part) {
  const int R = a.R;
  bool f = s.pod_ok && fok;
#pragma unroll
  for (int r = 0; r < FR_REG_R; ++r)
    if (r < R && !(p.req[r] == 0 || p.req[r] <= s.fr[r])) f = false;
  for (int r = FR_REG_R; r < R; ++r) {
    const int q = p.req_g[r];
    if (!(q == 0 || q <= wsub(a.alloc[(size_t)n * R + r], a.used[(size_t)n * R + r]))) f = false;
  }
  if (p.ports) {
    const unsigned char* np_row = a.node_ports + (size_t)n * a.Pt;
    const unsigned char* cp = a.class_ports + (size_t)p.cls * a.Pt;
    for (int q = 0; q < a.Pt; ++q)
      if (np_row[q] && cp[q]) f = false;
  }
  // LeastAllocated over cpu + memory (int32)
  int per_sum = 0, npos = 0;
  {
    const int A = s.a0, u = wadd(s.unz0, p.rnz0);
    if (A > 0) {
      npos += 1;
      if (u <= A) per_sum = wadd(per_sum, floordiv(wmul(wsub(A, u), 100), max(A, 1)));
    }
  }
  {
    const int A = s.a1, u = wadd(s.unz1, p.rnz1);
    if (A > 0) {
      npos += 1;
      if (u <= A) per_sum = wadd(per_sum, floordiv(wmul(wsub(A, u), 100), max(A, 1)));
    }
  }
  const int least = floordiv(per_sum, max(npos, 1));
  // BalancedAllocation, float32 without FMA (kernel A's formula); used is
  // alloc - free, exact in wrapping arithmetic
  int bal = 0;
  if (p.bal) {
    const float af0 = (float)s.a0, af1 = (float)s.a1;
    const float u0 = (float)wadd(wsub(s.a0, s.fr[0]), p.req[0]);
    const float u1 = (float)wadd(wsub(s.a1, s.fr[1]), p.req[1]);
    const float fr0 = af0 > 0.0f ? fminf(__fdiv_rn(u0, fmaxf(af0, 1.0f)), 1.0f) : 0.0f;
    const float fr1 = af1 > 0.0f ? fminf(__fdiv_rn(u1, fmaxf(af1, 1.0f)), 1.0f) : 0.0f;
    const int nf = (af0 > 0.0f) + (af1 > 0.0f);
    const float sd = nf == 2 ? __fdiv_rn(fabsf(__fsub_rn(fr0, fr1)), 2.0f) : 0.0f;
    bal = (int)__fmul_rn(__fsub_rn(1.0f, sd), 100.0f);
  }
  part = wadd(wadd(least, bal), img);
  return f;
}

// + 2 napref + 3 taint, from the row's merged maxima
__device__ __forceinline__ int finish(int part, int nap, int taint, bool has_nap, int mxn,
                                      int mxt) {
  int napref = 0;
  if (has_nap) napref = mxn > 0 ? floordiv(wmul(100, nap), max(mxn, 1)) : 0;
  const int tscaled = mxt > 0 ? floordiv(wmul(100, taint), max(mxt, 1)) : 0;
  const int tnorm = mxt > 0 ? wsub(100, tscaled) : 100;
  return wadd(part, wadd(wmul(2, napref), wmul(3, tnorm)));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void load_row(const FeasRowsArgs& a, int i, RowParams& p) {
  const int R = a.R;
  p.cls = max(a.clss[i], 0);
  p.req_g = a.reqs + (size_t)i * R;
#pragma unroll
  for (int r = 0; r < FR_REG_R; ++r) p.req[r] = r < R ? p.req_g[r] : 0;
  p.rnz0 = a.req_nzs[(size_t)i * R];
  p.rnz1 = a.req_nzs[(size_t)i * R + 1];
  p.bal = a.bals[i] != 0;
  p.has_nap = a.has_napref[p.cls] != 0;
  // the class's first 32 port columns, a byte a lane, in flight until the
  // row's vote
  const int lane = threadIdx.x & 31;
  p.port0 = lane < a.Pt && a.class_ports[(size_t)p.cls * a.Pt + lane] != 0;
}

// whether the row's class sets any port column: the warp's vote (every
// lane of the warp calls this)
__device__ __forceinline__ void vote_ports(const FeasRowsArgs& a, RowParams& p, int lane) {
  const unsigned char* cp = a.class_ports + (size_t)p.cls * a.Pt;
  bool any = __any_sync(0xffffffffu, p.port0);
  for (int b = 32; b < a.Pt && !any; b += 32)
    any = __any_sync(0xffffffffu, b + lane < a.Pt && cp[b + lane] != 0);
  p.ports = any;
}

__global__ void __launch_bounds__(FR_MAX_THREADS) feasibility_rows_kernel(const FeasRowsArgs a) {
  __shared__ int red_s[2][FR_MAX_WARPS];
  __shared__ __align__(8) int2 xs_s[2][FR_MAX_CS];  // every CTA's maxima, by pass parity
  __shared__ __align__(8) unsigned long long bar_s[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.threads, n_warps = T >> 5;
  const int cs = a.cs, rank = (int)cluster.block_rank();
  const int q = blockIdx.x / cs;  // this cluster's index
  const int N = a.N;
  const int base = rank * a.chunk, end = min(base + a.chunk, N);
  const int n0 = base + tid;  // the thread's node in registers
  const bool own = n0 < end;

  // the exchange's mbarriers, published to the cluster by the barrier
  // whose wait comes before the first push
  Xchg xc;
  xchg_init(xc, smem_addr(bar_s), cs * 8u, cs * 8u, 1);
  cluster_arrive();

  RowParams p;
  if (q < a.Rw) load_row(a, q, p);
  NodeState st;
  if (own) load_node(a, n0, st);

  bool waited = false;
  int par = 0;
  for (int i = q; i < a.Rw; i += a.clusters, par ^= 1) {
    const int cls = p.cls;
    // this row's class data of the thread's node
    bool fok = false;
    int img = 0, nap = 0, taint = 0;
    if (own) {
      const size_t at = (size_t)cls * N + n0;
      fok = a.filter_ok[at] != 0;
      img = a.img_score[at];
      nap = a.napref_raw[at];
      taint = a.taint_cnt[at];
    }
    vote_ports(a, p, lane);
    unsigned char* feas_out = a.feas + (size_t)i * N;
    int* total_out = a.total + (size_t)i * N;

    int mx_nap = 0, mx_taint = 0;  // max(where(feas, raw, 0)) starts at 0
    bool f = false;
    int part = 0;
    if (own) {
      f = node_row(a, p, n0, st, fok, img, part);
      if (f) {
        mx_nap = nap;
        mx_taint = taint;
      }
    }
    // the thread's further nodes: state from global memory, the partial
    // total parked in the output
    for (int j = 1; j < a.npt; ++j) {
      const int n = n0 + j * T;
      if (n >= end) break;
      NodeState s;
      load_node(a, n, s);
      const size_t at = (size_t)cls * N + n;
      int pt;
      const bool fj = node_row(a, p, n, s, a.filter_ok[at] != 0, a.img_score[at], pt);
      feas_out[n] = fj ? 1 : 0;
      total_out[n] = pt;
      if (fj) {
        mx_nap = max(mx_nap, a.napref_raw[at]);
        mx_taint = max(mx_taint, a.taint_cnt[at]);
      }
    }
    const bool has_nap = p.has_nap;
    const bool last = i + a.clusters >= a.Rw;
    if (!last) load_row(a, i + a.clusters, p);  // the next row's, in flight

    // the CTA's maxima, pushed into every CTA's slot of this parity
    mx_nap = __reduce_max_sync(0xffffffffu, mx_nap);
    mx_taint = __reduce_max_sync(0xffffffffu, mx_taint);
    if (lane == 0) {
      red_s[0][warp] = mx_nap;
      red_s[1][warp] = mx_taint;
    }
    __syncthreads();
    // every thread is past the last pass's reads of the other parity's slots
    if (i != q) xchg_rearm(xc, par ^ 1);
    if (!waited) {  // the mbarriers are initialised cluster-wide
      cluster_wait();
      waited = true;
    }
    if (warp == 0) {
      const int m0 = __reduce_max_sync(0xffffffffu, lane < n_warps ? red_s[0][lane] : 0);
      const int m1 = __reduce_max_sync(0xffffffffu, lane < n_warps ? red_s[1][lane] : 0);
      if (lane < cs) {
        const unsigned long long v =
            (unsigned long long)(unsigned)m0 | ((unsigned long long)(unsigned)m1 << 32);
        st_async_b64(remote_addr(smem_addr(&xs_s[par][rank]), lane), v,
                     remote_addr(xc.bar + 8u * par, lane));
      }
    }
    xchg_wait(xc, par);
    if (last) cluster_arrive();  // the exit barrier's arrival
    int mxn = 0, mxt = 0;
    for (int c = 0; c < cs; ++c) {
      const int2 m = xs_s[par][c];
      mxn = max(mxn, m.x);
      mxt = max(mxt, m.y);
    }

    // feas and the finished totals, written once
    if (own) {
      feas_out[n0] = f ? 1 : 0;
      total_out[n0] = finish(part, nap, taint, has_nap, mxn, mxt);
    }
    for (int j = 1; j < a.npt; ++j) {
      const int n = n0 + j * T;
      if (n >= end) break;
      const size_t at = (size_t)cls * N + n;
      total_out[n] = finish(total_out[n], a.napref_raw[at], a.taint_cnt[at], has_nap, mxn, mxt);
    }
  }
  if (!waited) {  // a cluster without rows
    cluster_wait();
    cluster_arrive();
  }
  // no CTA leaves while another may still push into it
  cluster_wait();
}

// ---------------------------------------------------------------------------
// host side: the cluster size (once per process), the clusters the card
// holds at once, the launch
// ---------------------------------------------------------------------------

static int g_cluster_size = 0;
static int g_cluster_error = 0;

// 16 or 8 (set at the largest block), or minus the CUDA error that refused
// both
extern "C" int feasibility_rows_cluster_size() {
  if (!g_cluster_size && !g_cluster_error)
    g_cluster_size = choose_cluster_size(feasibility_rows_kernel, FR_MAX_THREADS, 0,
                                         &g_cluster_error);
  return g_cluster_size ? g_cluster_size : -g_cluster_error;
}

// clusters of the chosen size that the card runs at once with `threads`
// threads a CTA (at least 1), or minus a CUDA error
extern "C" int feasibility_rows_max_clusters(int threads) {
  const int cs = feasibility_rows_cluster_size();
  if (cs <= 0) return cs;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(cs, threads, 0, 0, attr);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, (const void*)feasibility_rows_kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n > 0 ? n : 1;
}

// One launch of args->clusters clusters on `stream`. *launched counts the
// kernels launched. Returns the CUDA error of the launch (a refused cluster
// launch never runs; nothing retries it). The wrapper checks shapes, types
// and contiguity and plans the layout.
extern "C" int feasibility_rows_launch(const FeasRowsArgs* args, void* stream, int* launched) {
  *launched = 0;
  const int cs = feasibility_rows_cluster_size();
  if (cs <= 0) return -cs;
  if (args->cs != cs || args->threads < 32 || args->threads > FR_MAX_THREADS ||
      args->threads % 32 || args->clusters < 1 || args->R < 2 || args->cs > FR_MAX_CS ||
      (long long)args->chunk * cs < args->N || args->npt * args->threads < args->chunk)
    return (int)cudaErrorInvalidValue;
  if (args->Rw <= 0 || args->N <= 0) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(cs, args->threads, 0, (cudaStream_t)stream, attr);
  cfg.gridDim = dim3(cs * args->clusters, 1, 1);
  void* params[1] = {(void*)args};
  cudaError_t e = cudaLaunchKernelExC(&cfg, (const void*)feasibility_rows_kernel, params);
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int feasibility_rows_args_size() { return (int)sizeof(FeasRowsArgs); }
