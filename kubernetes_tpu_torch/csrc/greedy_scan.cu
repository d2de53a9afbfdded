// Kernel A: the greedy-scan batch solver, hand-written for Hopper (sm_90a).
//
// Replaces: kubernetes_tpu/ops/solver.py greedy_scan_solve (jax.jit + lax.scan,
// :263-489). Same function: for each pod in priority order, filter (fit,
// host ports, inter-pod affinity rules 1-3, PTS DoNotSchedule), score
// (LeastAllocated, Balanced, NodeAffinity x2, TaintToleration x3, PTS
// ScheduleAnyway x2, InterPodAffinity x2, ImageLocality, gang bonus), argmax
// with the lowest index winning ties, then commit the pod into the carried
// node state. The plain PyTorch version is ops/solver.py
// greedy_scan_solve_plain; the two must agree exactly.
//
// What bounds it: not bytes and not operations but dependency. Pod p's
// choice depends on the commits of every pod before it, so the P steps run
// one after another, and each step is a chain of block-wide reductions
// (normalizer max/min, domain segment sums, the argmax) separated by
// barriers. At N = 5,000 nodes a step touches ~100 KB of node state; the
// step's latency (barriers, shared-memory reductions, L2 round trips) is the
// cost, not bandwidth.
//
// What the design does about it: one launch per batch, one thread block of
// 1024 threads that walks the pods in order; each thread owns a strided set
// of nodes, so every per-node value stays with one thread between barriers
// and needs no synchronization. Reductions go warp shuffle -> shared memory
// -> warp 0 (two barriers each), and independent ones are fused into one
// pass (seven normalizer extrema in one reduction). Topology-domain segment
// sums live in dynamic shared memory (global scratch when the domain count
// is too large) and are filled with shared atomics. Constraint families the
// batch does not use are skipped by runtime gates (has_ipa/has_ct/has_st/
// has_gang), and per-class terms that are inactive are skipped uniformly, so
// a constrained batch never leaves the kernel. Spreading one pod's node axis
// over a thread-block cluster with DSMEM reductions is later work.
//
// State: the carried state (used, used_nz, pod_count, dyn_selcls, dyn_grp,
// port_used) is device scratch that the wrapper allocates and copies from
// the inputs; this kernel updates it in place (the JAX version is pure).
//
// Parity: int32 arithmetic wraps as in XLA (done in uint32: signed overflow
// is undefined in C++); Python/JAX floor division via floordiv(); float32
// terms use explicit _rn intrinsics and the file is built with --fmad=false
// (no contraction of a*b+c into an FMA); jnp.round is rintf (half to even).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define THREADS 1024
#define NWARPS (THREADS / 32)

struct GreedyScanArgs {
  // dims
  int P, N, R, C, Pt, SC, G, Ct, St, RAm, RNm, PPm, Em, Sm, d_max;
  int has_ipa, has_ct, has_st, has_gang;
  // carried node state (scratch, updated in place)
  int* used;
  int* used_nz;
  int* pod_count;
  int* dyn_selcls;
  int* dyn_grp;
  uint8_t* port_used;
  // static node state and class tables
  const int* alloc;
  const int* max_pods;
  const uint8_t* filter_ok;
  const uint8_t* aff_ok;
  const int* napref_raw;
  const uint8_t* has_napref;
  const int* taint_cnt;
  const int* img_score;
  const uint8_t* class_ports;
  const int* topo_id;
  const int* class_matches_selcls;
  const int* ct_class;
  const int* ct_key;
  const int* ct_sel;
  const int* ct_max_skew;
  const int* ct_min_domains;
  const int* ct_self_match;
  const int* st_class;
  const int* st_key;
  const int* st_sel;
  const int* st_max_skew;
  const int* ra_key;
  const int* ra_sel;
  const int* rn_key;
  const int* rn_sel;
  const int* pp_key;
  const int* pp_sel;
  const int* pp_weight;
  const int* grp_key;
  const int* class_holds_grp;
  const int* ea_grp;
  const int* sym_grp;
  const int* sym_weight;
  const uint8_t* class_self_ok;
  const uint8_t* class_has_ra;
  // pods
  const int* req;
  const int* req_nz;
  const int* class_of_pod;
  const uint8_t* balanced_active;
  const int* gang_bonus;
  // output
  int* assignment;
  // per-node scratch [N] and optional global domain scratch [2 * (d_max+1)]
  int* feas;
  int* ignored;
  float* st_sum;
  int* ipa_raw;
  int* ra_pos;
  int* ra_keys;
  int* dom_global;
};

enum { OP_SUM = 0, OP_MAX = 1, OP_MIN = 2 };

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

__device__ __forceinline__ int op_apply(int op, int a, int b) {
  return op == OP_SUM ? wadd(a, b) : (op == OP_MAX ? max(a, b) : min(a, b));
}

__device__ __forceinline__ int op_ident(int op) {
  return op == OP_SUM ? 0 : (op == OP_MAX ? INT_MIN : INT_MAX);
}

// Block-wide reduction of K ints at once; every thread gets the results.
// Two barriers. `red` holds NWARPS*K ints, `out` K ints (shared memory).
template <int K>
__device__ __forceinline__ void block_reduce(int (&v)[K], const int (&op)[K], int* red, int* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = op_apply(op[k], v[k], __shfl_down_sync(0xffffffffu, v[k], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int x = lane < NWARPS ? red[lane * K + k] : op_ident(op[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = op_apply(op[k], x, __shfl_down_sync(0xffffffffu, x, off));
      if (lane == 0) out[k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = out[k];
}

// dom[d] = sum of vals[n] over nodes with topo[n] == d (d in [0, d_max)).
// Starts with a barrier so callers may still be reading dom from the
// previous term; ends with a barrier so dom is complete.
__device__ __forceinline__ void seg_sum(const int* __restrict__ vals, const int* __restrict__ topo,
                                        int N, int* dom, int dlen) {
  __syncthreads();
  for (int d = threadIdx.x; d < dlen; d += THREADS) dom[d] = 0;
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const int t = topo[n];
    if (t >= 0) {
      const int v = vals[n];
      if (v != 0) atomicAdd(&dom[t], v);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) greedy_scan_kernel(const GreedyScanArgs a) {
  extern __shared__ int smem[];
  __shared__ int red[NWARPS * 8];
  __shared__ int red_out[8];
  __shared__ unsigned long long redl[NWARPS];
  __shared__ unsigned long long redl_out;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = a.N, R = a.R, Pt = a.Pt, d_max = a.d_max, dlen = a.d_max + 1;
  int* dom = a.dom_global ? a.dom_global : smem;
  int* dom2 = dom + dlen;
  const int BIG = 1 << 30;
  const int SCORE_MIN = INT_MIN + 1;  // ops/solver.py INT_MIN

  for (int p = 0; p < a.P; ++p) {
    int cls = a.class_of_pod[p];
    if (cls < 0) cls = 0;
    const int* req = a.req + (size_t)p * R;
    const int* req_nz = a.req_nz + (size_t)p * R;
    const uint8_t* frow = a.filter_ok + (size_t)cls * N;
    const uint8_t* arow = a.aff_ok + (size_t)cls * N;
    const uint8_t* cports = a.class_ports + (size_t)cls * Pt;

    // ---- static filter row, NodeResourcesFit, NodePorts ----
    for (int n = tid; n < N; n += THREADS) {
      int ok = frow[n] != 0;
      const int* al = a.alloc + (size_t)n * R;
      const int* us = a.used + (size_t)n * R;
      for (int r = 0; r < R && ok; ++r) {
        const int q = req[r];
        if (!(q == 0 || q <= al[r] - us[r])) ok = 0;
      }
      if (!(a.pod_count[n] + 1 <= a.max_pods[n])) ok = 0;
      const uint8_t* pu = a.port_used + (size_t)n * Pt;
      for (int k = 0; k < Pt && ok; ++k)
        if (pu[k] && cports[k]) ok = 0;
      a.feas[n] = ok;
    }

    if (a.has_ipa) {
      // rule 1: existing/placed holders' required anti-affinity
      for (int e = 0; e < a.Em; ++e) {
        const int g = a.ea_grp[cls * a.Em + e];
        if (g < 0) continue;
        const int* topo = a.topo_id + (size_t)a.grp_key[g] * N;
        seg_sum(a.dyn_grp + (size_t)g * N, topo, N, dom, dlen);
        for (int n = tid; n < N; n += THREADS) {
          const int t = topo[n];
          if (t >= 0 && dom[t] != 0) a.feas[n] = 0;
        }
      }
      // rule 2: incoming required affinity with the first-pod exception
      if (a.class_has_ra[cls]) {
        for (int n = tid; n < N; n += THREADS) {
          a.ra_pos[n] = 1;
          a.ra_keys[n] = 1;
        }
        int glob0_all = 1;
        for (int j = 0; j < a.RAm; ++j) {
          const int k = a.ra_key[cls * a.RAm + j];
          if (k < 0) continue;
          const int s = max(a.ra_sel[cls * a.RAm + j], 0);
          const int* topo = a.topo_id + (size_t)k * N;
          const int* vals = a.dyn_selcls + (size_t)s * N;
          seg_sum(vals, topo, N, dom, dlen);
          int v[1] = {0};
          const int ops[1] = {OP_SUM};
          for (int n = tid; n < N; n += THREADS) {
            const int t = topo[n];
            const int has = t >= 0;
            const int cnt = has ? dom[t] : 0;
            if (has) v[0] = wadd(v[0], vals[n]);
            if (!(has && cnt > 0)) a.ra_pos[n] = 0;
            if (!has) a.ra_keys[n] = 0;
          }
          block_reduce<1>(v, ops, red, red_out);
          if (v[0] != 0) glob0_all = 0;
        }
        const int self_ok = a.class_self_ok[cls] != 0;
        for (int n = tid; n < N; n += THREADS) {
          if (!(a.ra_keys[n] && (a.ra_pos[n] || (glob0_all && self_ok)))) a.feas[n] = 0;
        }
      }
      // rule 3: incoming required anti-affinity
      for (int j = 0; j < a.RNm; ++j) {
        const int k = a.rn_key[cls * a.RNm + j];
        if (k < 0) continue;
        const int s = max(a.rn_sel[cls * a.RNm + j], 0);
        const int* topo = a.topo_id + (size_t)k * N;
        seg_sum(a.dyn_selcls + (size_t)s * N, topo, N, dom, dlen);
        for (int n = tid; n < N; n += THREADS) {
          const int t = topo[n];
          if (t >= 0 && dom[t] != 0) a.feas[n] = 0;
        }
      }
    }

    if (a.has_ct) {
      // PodTopologySpread DoNotSchedule: counts over the class's node
      // affinity (aff row), skew against the min over valid domains
      for (int c = 0; c < a.Ct; ++c) {
        if (a.ct_class[c] != cls) continue;
        const int* topo = a.topo_id + (size_t)a.ct_key[c] * N;
        const int* vals = a.dyn_selcls + (size_t)a.ct_sel[c] * N;
        __syncthreads();
        for (int d = tid; d < dlen; d += THREADS) {
          dom[d] = 0;
          dom2[d] = 0;
        }
        __syncthreads();
        for (int n = tid; n < N; n += THREADS) {
          const int t = topo[n];
          if (t >= 0 && arow[n]) {
            const int v = vals[n];
            if (v != 0) atomicAdd(&dom[t], v);
            dom2[t] = 1;
          }
        }
        __syncthreads();
        int v[2] = {0, BIG};
        const int ops[2] = {OP_SUM, OP_MIN};
        for (int d = tid; d < d_max; d += THREADS) {
          if (dom2[d]) {
            v[0] += 1;
            v[1] = min(v[1], dom[d]);
          }
        }
        block_reduce<2>(v, ops, red, red_out);
        const int n_valid = v[0];
        int mmn = v[1];
        const int mind = a.ct_min_domains[c];
        if (mind > 0 && mind > n_valid) mmn = 0;
        if (n_valid == 0) mmn = 0;
        const int self = a.ct_self_match[c], max_skew = a.ct_max_skew[c];
        for (int n = tid; n < N; n += THREADS) {
          const int t = topo[n];
          const int node_dc = t >= 0 ? dom[t] : 0;
          const int skew = node_dc + self - mmn;
          if (!(t >= 0 && skew <= max_skew)) a.feas[n] = 0;
        }
      }
    }

    // ---- PTS ScheduleAnyway raw score ----
    int any_st = 0;
    if (a.has_st) {
      for (int n = tid; n < N; n += THREADS) {
        a.st_sum[n] = 0.0f;
        a.ignored[n] = 0;
      }
      for (int c = 0; c < a.St; ++c) {
        if (a.st_class[c] != cls) continue;
        any_st = 1;
        const int* topo = a.topo_id + (size_t)a.st_key[c] * N;
        const int* vals = a.dyn_selcls + (size_t)a.st_sel[c] * N;
        __syncthreads();
        for (int d = tid; d < dlen; d += THREADS) {
          dom[d] = 0;
          dom2[d] = 0;
        }
        __syncthreads();
        for (int n = tid; n < N; n += THREADS) {
          const int t = topo[n];
          if (t >= 0) {
            if (arow[n]) {
              const int v = vals[n];
              if (v != 0) atomicAdd(&dom[t], v);
            }
            if (a.feas[n]) dom2[t] = 1;  // domain size from the feasible set
          }
        }
        __syncthreads();
        int v[1] = {0};
        const int ops[1] = {OP_SUM};
        for (int d = tid; d < d_max; d += THREADS)
          if (dom2[d]) v[0] += 1;
        block_reduce<1>(v, ops, red, red_out);
        const float w = logf(__fadd_rn((float)v[0], 2.0f));
        const float skew_m1 = (float)(a.st_max_skew[c] - 1);
        for (int n = tid; n < N; n += THREADS) {
          const int t = topo[n];
          const int node_dc = t >= 0 ? dom[t] : 0;
          const float contrib = __fadd_rn(__fmul_rn((float)node_dc, w), skew_m1);
          a.st_sum[n] = __fadd_rn(a.st_sum[n], contrib);
          if (t < 0) a.ignored[n] = 1;
        }
      }
    }

    // ---- InterPodAffinity raw score ----
    if (a.has_ipa) {
      for (int n = tid; n < N; n += THREADS) a.ipa_raw[n] = 0;
      for (int j = 0; j < a.PPm; ++j) {
        const int k = a.pp_key[cls * a.PPm + j];
        if (k < 0) continue;
        const int s = max(a.pp_sel[cls * a.PPm + j], 0);
        const int w = a.pp_weight[cls * a.PPm + j];
        const int* topo = a.topo_id + (size_t)k * N;
        seg_sum(a.dyn_selcls + (size_t)s * N, topo, N, dom, dlen);
        for (int n = tid; n < N; n += THREADS) {
          const int t = topo[n];
          const int cnt = t >= 0 ? dom[t] : 0;
          a.ipa_raw[n] = wadd(a.ipa_raw[n], wmul(w, cnt));
        }
      }
      for (int j = 0; j < a.Sm; ++j) {
        const int g = a.sym_grp[cls * a.Sm + j];
        if (g < 0) continue;
        const int w = a.sym_weight[cls * a.Sm + j];
        const int* topo = a.topo_id + (size_t)a.grp_key[g] * N;
        seg_sum(a.dyn_grp + (size_t)g * N, topo, N, dom, dlen);
        for (int n = tid; n < N; n += THREADS) {
          const int t = topo[n];
          const int cnt = t >= 0 ? dom[t] : 0;
          a.ipa_raw[n] = wadd(a.ipa_raw[n], wmul(w, cnt));
        }
      }
    }

    // ---- the normalizers' extrema over the feasible set, one reduction ----
    // 0 napref max, 1 taint max, 2 pts max, 3 pts min, 4 any norm node,
    // 5 ipa max, 6 ipa min
    const int has_napref = a.has_napref[cls] != 0;
    const int* naprow = a.napref_raw + (size_t)cls * N;
    const int* taintrow = a.taint_cnt + (size_t)cls * N;
    int ext[7] = {INT_MIN, INT_MIN, INT_MIN, INT_MAX, 0, INT_MIN, INT_MAX};
    {
      const int ops[7] = {OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MAX, OP_MAX, OP_MIN};
      int* v = ext;
      for (int n = tid; n < N; n += THREADS) {
        const int f = a.feas[n];
        v[0] = max(v[0], f ? naprow[n] : 0);
        v[1] = max(v[1], f ? taintrow[n] : 0);
        if (any_st) {
          const int pr = (int)rintf(a.st_sum[n]);
          const int nm = f && !a.ignored[n];
          v[2] = max(v[2], nm ? pr : -BIG);
          v[3] = min(v[3], nm ? pr : BIG);
          v[4] = max(v[4], nm);
        }
        if (a.has_ipa) {
          const int raw = a.ipa_raw[n];
          v[5] = max(v[5], f ? raw : -BIG);
          v[6] = min(v[6], f ? raw : BIG);
        }
      }
      block_reduce<7>(ext, ops, red, red_out);
    }
    const int mx_napref = ext[0], mx_taint = ext[1];
    const int pmx = ext[2], pmn = ext[3], any_norm = ext[4];
    const int imx = ext[5], imn = ext[6];
    const int idiff = wsub(imx, imn);
    const int bal_active = a.balanced_active[p] != 0;
    const int* imgrow = a.img_score + (size_t)cls * N;
    const int* gangrow = a.has_gang ? a.gang_bonus + (size_t)cls * N : nullptr;

    // ---- total score and argmax (value desc, index asc) ----
    // key = (score biased to unsigned order) << 32 | ~index: the largest key
    // is the highest score at the lowest index; 0 is below every key
    unsigned long long best = 0ull;
    for (int n = tid; n < N; n += THREADS) {
      const int f = a.feas[n];
      const int* al = a.alloc + (size_t)n * R;
      const int* us = a.used + (size_t)n * R;
      const int* unz = a.used_nz + (size_t)n * R;
      // LeastAllocated over cpu + memory
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
      // BalancedAllocation (float32)
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
      int napref = 0;
      if (has_napref) napref = mx_napref > 0 ? floordiv(wmul(100, naprow[n]), max(mx_napref, 1)) : 0;
      const int tscaled = mx_taint > 0 ? floordiv(wmul(100, taintrow[n]), max(mx_taint, 1)) : 0;
      const int taint = mx_taint > 0 ? 100 - tscaled : 100;
      int pts = 0;
      if (any_st) {
        const int pr = (int)rintf(a.st_sum[n]);
        const int val = pmx > 0 ? floordiv(wmul(100, wsub(wadd(pmx, pmn), pr)), max(pmx, 1)) : 100;
        pts = (!a.ignored[n] && any_norm) ? val : 0;
      }
      int ipa = 0;
      if (a.has_ipa && f && idiff > 0) ipa = floordiv(wmul(100, wsub(a.ipa_raw[n], imn)), max(idiff, 1));
      unsigned total = (unsigned)least + (unsigned)bal + 2u * (unsigned)napref + 3u * (unsigned)taint +
                       2u * (unsigned)pts + 2u * (unsigned)ipa + (unsigned)imgrow[n];
      if (gangrow) total += (unsigned)gangrow[n];
      const int masked = f ? (int)total : SCORE_MIN;
      const unsigned long long key =
          ((unsigned long long)((unsigned)masked ^ 0x80000000u) << 32) |
          (unsigned long long)(0xffffffffu - (unsigned)n);
      if (key > best) best = key;
    }
    // block argmax over the packed (score, -index) keys
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
      if (o > best) best = o;
    }
    if (lane == 0) redl[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long x = lane < NWARPS ? redl[lane] : 0ull;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_down_sync(0xffffffffu, x, off);
        if (o > x) x = o;
      }
      if (lane == 0) redl_out = x;
    }
    __syncthreads();
    const int bi = (int)(0xffffffffu - (unsigned)(redl_out & 0xffffffffull));
    const int ok = a.feas[bi];

    // ---- commit ----
    if (ok) {
      for (int r = tid; r < R; r += THREADS) {
        a.used[(size_t)bi * R + r] = wadd(a.used[(size_t)bi * R + r], req[r]);
        a.used_nz[(size_t)bi * R + r] = wadd(a.used_nz[(size_t)bi * R + r], req_nz[r]);
      }
      for (int s = tid; s < a.SC; s += THREADS)
        a.dyn_selcls[(size_t)s * N + bi] =
            wadd(a.dyn_selcls[(size_t)s * N + bi], a.class_matches_selcls[(size_t)cls * a.SC + s]);
      for (int g = tid; g < a.G; g += THREADS)
        a.dyn_grp[(size_t)g * N + bi] =
            wadd(a.dyn_grp[(size_t)g * N + bi], a.class_holds_grp[(size_t)cls * a.G + g]);
      for (int k = tid; k < Pt; k += THREADS)
        if (cports[k]) a.port_used[(size_t)bi * Pt + k] = 1;
      if (tid == 0) a.pod_count[bi] += 1;
    }
    if (tid == 0) a.assignment[p] = ok ? bi : -1;
    __syncthreads();
  }
}

// Launch one batch on `stream`. Returns cudaGetLastError() after the launch
// (a launch refused for its configuration never runs).
extern "C" int greedy_scan_launch(const GreedyScanArgs* args, int dyn_smem_bytes, void* stream) {
  if (dyn_smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(greedy_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dyn_smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_scan_kernel<<<1, THREADS, dyn_smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int greedy_scan_args_size() { return (int)sizeof(GreedyScanArgs); }
