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
// one after another; a step's latency is the cost. The first design walked
// the 5,000 nodes with one 1,024-thread block: every step re-read ~100 KB
// of node state from L2 through one SM and made three passes over N with
// five or more block barriers (15.7 us a step on an H100). Now a step is
// bounded by the cross-SM exchange and a few short dependent chains: one
// round of the argmax exchange costs ~0.5 us (tools/cluster_exchange_bench.cu),
// then the refresh of one node's cached scores (two integer and two IEEE
// float divisions) and the step's own loads and barriers.
//
// What this design does about it: one thread-block cluster of CS CTAs
// (16 where the card schedules it, else the portable 8; chosen once per
// process with cudaOccupancyMaxActiveClusters). CTA c owns the contiguous
// node range [c*chunk, (c+1)*chunk), chunk = ceil(N/CS), one node a thread
// up to MAX_THREADS (320 threads at N = 5,000, CS = 16; past that a thread
// strides over several nodes).
//  - The node state (used, used_nz, pod_count, alloc, max_pods, the port
//    rows) lives in the owning CTA's shared memory for the whole batch and
//    is written back to the wrapper's outputs at the end; only the thread
//    that owns node bi commits into it, so a commit needs no barrier.
//  - Each pod's request row is staged in shared memory one step ahead
//    (three slots), and whether it equals the previous pod's is decided
//    then. A node's fit and LeastAllocated + Balanced score depend only on
//    its state and that row, so they are cached per node and reused while
//    the row repeats; the owner refreshes node bi at its commit, with
//    values computed while the argmax keys were in flight (the global
//    best is some CTA's best: its owner speculates on the base score, a
//    helper thread in another warp on the fit, side by side).
//  - The class rows (filter, preferred node affinity, taint counts, image
//    score plus gang bonus, packed [C, N, 4] by the wrapper) are staged in
//    shared memory per class: a class is loaded when the pod's class
//    changes, and the next pod's class is prefetched with cp.async into a
//    second buffer.
//  - Topology-domain counts are carried, not recomputed: every CTA keeps a
//    replica of each (key, selector-class), holder-group, DoNotSchedule and
//    ScheduleAnyway domain table, built once at launch and updated at each
//    commit (the same wrapping int32 sums as a per-step segment sum, since
//    the counts change only at the committed node). Picked over per-step
//    CTA-local segment sums combined over DSMEM because it removes every
//    per-step reduction of the IPA rules and of the spread counts (a
//    per-step sum costs a pass over N and a cluster round trip per term;
//    the carried update costs O(tables) at commit); rule 2's global total
//    is the table's last slot. Only the DoNotSchedule minimum over a key's
//    domains (a CTA-local scan of the replica) and the ScheduleAnyway domain
//    size (which depends on the step's feasible set: per-CTA domain
//    bitmasks, OR-ed over DSMEM after a barrier.cluster) remain.
//  - Reductions across the cluster: a CTA reduces locally (redux.sync, then
//    shared memory) to one 64-bit (score, ~index, feasible) key for the
//    argmax or 7 ints for the normalizer extrema, and pushes it into every
//    CTA's slot with st.async, which completes bytes on the receiver's
//    mbarrier; each CTA waits on its own mbarrier and reduces its CS slots
//    locally. Slots and mbarriers are double-buffered by parity and re-armed
//    once every thread of the CTA is past the wait. Measured on the H100
//    (tools/cluster_exchange_bench.cu, 16 CTAs x 320 threads): a bare
//    barrier.cluster round costs 0.88-0.92 us, publish + barrier.cluster +
//    read 1.49-1.67 us, this exchange 0.50 us; so no step of the common
//    path has a cluster-wide barrier.
//  - Fewer reductions per step, where that is exact: a class whose taint
//    row has no positive entry has mx_taint = 0 whatever the feasible set,
//    likewise the preferred node affinity row, and a class with no
//    preferred or symmetric IPA term has an IPA score of 0 (the wrapper
//    computes these flags once per launch, ops/solver.py scan_class_rows).
//    When no normalizer needs the feasible set, filter and score fuse into
//    one pass and the step has one cluster reduction, the argmax.
// Where a CTA's share does not fit in shared memory (large N, wide Pt, SC,
// G or d_max), that part stays in global memory (the wrapper's state
// arrays, or a per-CTA slice of one global scratch buffer). Same kernel.
//
// Parity: int32 arithmetic wraps as in XLA (done in uint32: signed overflow
// is undefined in C++); Python/JAX floor division via floordiv(); float32
// terms use explicit _rn intrinsics and the file is built with --fmad=false
// (no contraction of a*b+c into an FMA); jnp.round is rintf (half to even).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

// at most 512 threads a CTA, so a thread may hold 128 registers (a wider
// CTA walks its nodes strided)
#define MAX_THREADS 512
#define MAX_WARPS (MAX_THREADS / 32)
#define MAX_CS 16
// dynamic shared memory a CTA may take (the card allows 227 KB per block,
// the static reduction slots take the rest)
#define SMEM_BUDGET (220 * 1024)

struct GreedyScanArgs {
  // dims
  int P, N, R, C, Pt, SC, G, Kk, Ct, St, RAm, RNm, PPm, Em, Sm, d_max;
  int has_ipa, has_ct, has_st;
  // carried node state: the wrapper's copies of the inputs (used and
  // pod_count are outputs); updated in place
  int* used;
  int* used_nz;
  int* pod_count;
  uint8_t* port_used;
  // static node state and class tables
  const int* alloc;
  const int* max_pods;
  const int4* class_rows;  // [C, N] x {filter_ok, napref_raw, taint_cnt, img (+ gang)}
  const int* class_flags;  // [C]: 1 napref extrema, 2 taint extrema, 4 IPA score terms
  const int* key_domains;  // [Kk]: 1 + the largest domain id of each topology key
  const uint8_t* aff_ok;
  const uint8_t* class_ports;
  const int* topo_id;
  const int* selcls_count;
  const int* grp_count;
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
  const int* balanced_active;  // [P] int32 (the wrapper's copy of the bool row)
  // output
  int* assignment;
  // global scratch: cs slices of plan.gbytes (the regions that do not fit
  // in shared memory)
  char* gscratch;
};

// what the host chose for one launch (greedy_scan_plan)
struct GreedyScanPlan {
  int cs, threads, chunk, smem_bytes, in_smem, n_tables;
  long long gbytes;
};

// shared-memory regions of a CTA, in the order they claim shared memory
enum { RG_POD, RG_NODE, RG_USED, RG_USED_NZ, RG_PODS, RG_ALLOC, RG_MAXP, RG_STFLAGS, RG_ROWS,
       RG_PORTS, RG_TABLES, NRG };

struct ScanLayout {
  int cs, threads, chunk;
  int ts;         // domain table stride: d_max + 2 (slot d_max: total, d_max + 1: scalar)
  int st_words;   // ceil(d_max / 32)
  int t_pair, t_grp, t_ct, t_st, n_tables;  // first table of each family
  int off[NRG];   // byte offset in dynamic shared memory, -1 = global
  long long goff[NRG];  // byte offset in the CTA's global slice (the scratch regions)
  long long gbytes;     // bytes of one CTA's global slice
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

__device__ __forceinline__ int op_ident(int op) {
  return op == OP_SUM ? 0 : (op == OP_MAX ? INT_MIN : INT_MAX);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gsrc) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one warp-wide reduction (redux.sync); int32 sums wrap
__device__ __forceinline__ int warp_op(int op, int v) {
  return op == OP_SUM ? __reduce_add_sync(0xffffffffu, v)
                      : (op == OP_MAX ? __reduce_max_sync(0xffffffffu, v)
                                      : __reduce_min_sync(0xffffffffu, v));
}

// warp-level reduction of K ints; every lane gets the results
template <int K>
__device__ __forceinline__ void warp_reduce(int (&v)[K], const int (&op)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_op(op[k], v[k]);
}

// CTA-wide reduction of K ints; every thread gets the results. Two
// barriers. `red` holds MAX_WARPS*K ints, `out` K ints (shared memory).
template <int K>
__device__ __forceinline__ void block_reduce(int (&v)[K], const int (&op)[K], int* red, int* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_reduce<K>(v, op);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = warp_op(op[k], lane < nw ? red[lane * K + k] : op_ident(op[k]));
      if (lane == 0) out[k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = out[k];
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// warp max of 64-bit keys: the high words' max, then the low words' max
// among the lanes holding it (two redux.sync)
__device__ __forceinline__ unsigned long long warp_max64(unsigned long long x) {
  const unsigned hi = (unsigned)(x >> 32), lo = (unsigned)x;
  const unsigned mhi = __reduce_max_sync(0xffffffffu, hi);
  const unsigned mlo = __reduce_max_sync(0xffffffffu, hi == mhi ? lo : 0u);
  return ((unsigned long long)mhi << 32) | mlo;
}

// argmax key: (score biased to unsigned order) << 32 | (0x7fffffff - n) << 1
// | feasible. The largest key is the highest score at the lowest index; the
// feasible bit rides along (it never decides between two nodes). 0 is below
// every key, so a CTA without nodes publishes 0.
__device__ __forceinline__ unsigned long long argmax_key(int masked, int n, int f) {
  return ((unsigned long long)((unsigned)masked ^ 0x80000000u) << 32) |
         ((unsigned long long)(0x7fffffffu - (unsigned)n) << 1) | (unsigned long long)(f != 0);
}

// Reduction slots, written by every CTA of the cluster into every CTA's
// copy (st.async) and read locally once the CTA's mbarrier of that parity
// completes: key[parity][rank] holds one CTA's argmax key, ext[parity][rank]
// its extrema. bar: argmax 0/1, extrema 2/3.
struct __align__(16) SlotSet {
  unsigned long long key[2][MAX_CS];
  int ext[2][MAX_CS][8];
  unsigned long long bar[4];
};

__global__ void __launch_bounds__(MAX_THREADS, 1)
    greedy_scan_kernel(const GreedyScanArgs a, const ScanLayout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[MAX_WARPS * 8];
  __shared__ int red_out[8];
  __shared__ int same_next[3];  // pod q's request row equals pod q-1's (slot q % 3)
  __shared__ int spec_fit;      // the helper's fit for this step's speculated node
  __shared__ unsigned long long redk[MAX_WARPS];  // the warps' argmax keys
  __shared__ SlotSet slots;  // written by every CTA of the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int cs = L.cs;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int N = a.N, R = a.R, Pt = a.Pt, SC = a.SC, d_max = a.d_max, TS = L.ts;
  const int chunk = L.chunk;
  const int lo = min(crank * chunk, N);
  const int cnt = max(0, min(lo + chunk, N) - lo);
  const int BIG = 1 << 30;
  const int SCORE_MIN = INT_MIN + 1;  // ops/solver.py INT_MIN
  char* gslice = a.gscratch ? a.gscratch + (size_t)crank * (size_t)L.gbytes : nullptr;

  // ---- region pointers: shared memory, or global where it did not fit ----
#define REGION(r) (L.off[r] >= 0 ? (void*)(smem + L.off[r]) : (void*)(gslice + L.goff[r]))
  const bool state_smem = L.off[RG_USED] >= 0;
  int* used = state_smem ? (int*)(smem + L.off[RG_USED]) : a.used + (size_t)lo * R;
  int* used_nz = L.off[RG_USED_NZ] >= 0 ? (int*)(smem + L.off[RG_USED_NZ]) : a.used_nz + (size_t)lo * R;
  int* pods = L.off[RG_PODS] >= 0 ? (int*)(smem + L.off[RG_PODS]) : a.pod_count + lo;
  const int* alloc = L.off[RG_ALLOC] >= 0 ? (const int*)(smem + L.off[RG_ALLOC]) : a.alloc + (size_t)lo * R;
  const int* maxp = L.off[RG_MAXP] >= 0 ? (const int*)(smem + L.off[RG_MAXP]) : a.max_pods + lo;
  uint8_t* ports = L.off[RG_PORTS] >= 0 ? (uint8_t*)(smem + L.off[RG_PORTS]) : a.port_used + (size_t)lo * Pt;
  const bool rows_smem = L.off[RG_ROWS] >= 0;
  int4* rowbuf = rows_smem ? (int4*)(smem + L.off[RG_ROWS]) : nullptr;
  // per-node step scratch: ipa_raw [chunk] int, st_sum [chunk] float, the
  // request-keyed cache cbase [chunk] int (LeastAllocated + Balanced) and
  // cfit [chunk] byte (resources and pod count fit), feas [chunk] and
  // ignored [chunk] bytes (16-byte aligned sub-arrays)
  const int c16 = (chunk + 15) & ~15;
  unsigned char* nodebuf = (unsigned char*)REGION(RG_NODE);
  int* ipa_raw = (int*)nodebuf;
  float* st_sum = (float*)(nodebuf + (size_t)c16 * 4);
  unsigned* cbase = (unsigned*)(nodebuf + (size_t)c16 * 8);
  uint8_t* feas = (uint8_t*)(nodebuf + (size_t)c16 * 12);
  uint8_t* ignored = feas + c16;
  uint8_t* cfit = ignored + c16;
  int* tables = (int*)REGION(RG_TABLES);
  unsigned* stflags = (unsigned*)REGION(RG_STFLAGS);
  // the pod rows, staged one step ahead in three slots of PW words
  // (req[R], req_nz[R], balanced_active), then the class flags [C]
  const int PW = 2 * R + 1;
  int* pbuf = (int*)REGION(RG_POD);
  int* cflags_s = pbuf + ((3 * PW + 3) & ~3);
  const bool stflags_smem = L.off[RG_STFLAGS] >= 0;
  const int W = L.st_words;

  // ---- prologue: node state into shared memory ----
  if (L.off[RG_USED] >= 0 || L.off[RG_ALLOC] >= 0) {
    for (int i = tid; i < cnt; i += T) {
      const size_t g = (size_t)(lo + i) * R;
      for (int r = 0; r < R; ++r) {
        if (L.off[RG_USED] >= 0) used[i * R + r] = a.used[g + r];
        if (L.off[RG_USED_NZ] >= 0) used_nz[i * R + r] = a.used_nz[g + r];
        if (L.off[RG_ALLOC] >= 0) ((int*)alloc)[i * R + r] = a.alloc[g + r];
      }
    }
  }
  for (int i = tid; i < cnt; i += T) {
    if (L.off[RG_PODS] >= 0) pods[i] = a.pod_count[lo + i];
    if (L.off[RG_MAXP] >= 0) ((int*)maxp)[i] = a.max_pods[lo + i];
    if (L.off[RG_PORTS] >= 0)
      for (int k = 0; k < Pt; ++k) ports[i * Pt + k] = a.port_used[(size_t)(lo + i) * Pt + k];
  }

  // word j of pod q's row: one int32 load from req, req_nz or balanced_active
  auto word_src = [&](int j) -> const int* {
    return j < R ? a.req + j : (j < 2 * R ? a.req_nz + (j - R) : a.balanced_active);
  };
  auto pod_word = [&](int q, int j) -> int {
    return word_src(j)[(size_t)q * (j < 2 * R ? R : 1)];
  };
  // the last warp stages the next pod's row (warp 0 often holds the
  // speculating thread): lane j < PW loads word j
  const bool row_lane = warp == nw - 1 && lane < PW;
  const int* my_src = word_src(lane);
  const int my_stride = lane < 2 * R ? R : 1;
  for (int j = tid; j < PW; j += T) pbuf[j] = pod_word(0, j);
  if (tid < 3) same_next[tid] = 0;
  // the exchange barriers: one arrival (the local re-arm) and the bytes
  // every CTA sends, for the first two uses of each
  const unsigned bar_arg = smem_addr(&slots.bar[0]), bar_ext = smem_addr(&slots.bar[2]);
  const unsigned arg_bytes = (unsigned)(cs * 8), ext_bytes = (unsigned)(cs * 32);
  if (tid == 0) {
    for (int b = 0; b < 4; ++b) mbar_init(smem_addr(&slots.bar[b]));
    mbar_init_fence();
    for (int b = 0; b < 2; ++b) {
      mbar_expect(bar_arg + 8 * b, arg_bytes);
      mbar_expect(bar_ext + 8 * b, ext_bytes);
    }
  }
  for (int c = tid; c < a.C; c += T) cflags_s[c] = a.class_flags[c];

  // ---- prologue: the carried domain tables (a full replica per CTA) ----
  const int n_tab = L.n_tables;
  if (n_tab > 0) {
    for (int j = tid; j < n_tab * TS; j += T) tables[j] = 0;
    __syncthreads();
    for (int n = tid; n < N; n += T) {
      if (L.t_pair >= 0) {
        for (int k = 0; k < a.Kk; ++k) {
          const int t = a.topo_id[(size_t)k * N + n];
          if (t < 0) continue;
          for (int s = 0; s < SC; ++s) {
            const int v = a.selcls_count[(size_t)s * N + n];
            if (v == 0) continue;
            int* tab = tables + (size_t)(L.t_pair + k * SC + s) * TS;
            atomicAdd(&tab[t], v);
            atomicAdd(&tab[d_max], v);
          }
        }
        for (int g = 0; g < a.G; ++g) {
          const int t = a.topo_id[(size_t)a.grp_key[g] * N + n];
          const int v = a.grp_count[(size_t)g * N + n];
          if (t < 0 || v == 0) continue;
          int* tab = tables + (size_t)(L.t_grp + g) * TS;
          atomicAdd(&tab[t], v);
          atomicAdd(&tab[d_max], v);
        }
      }
      if (L.t_ct >= 0) {
        for (int c = 0; c < a.Ct; ++c) {
          const int cc = a.ct_class[c];
          if (cc < 0) continue;
          const int t = a.topo_id[(size_t)a.ct_key[c] * N + n];
          if (t < 0 || !a.aff_ok[(size_t)cc * N + n]) continue;
          int* tab = tables + (size_t)(L.t_ct + 2 * c) * TS;
          const int v = a.selcls_count[(size_t)a.ct_sel[c] * N + n];
          if (v != 0) atomicAdd(&tab[t], v);
          int* valid = tab + TS;
          if (atomicExch(&valid[t], 1) == 0) atomicAdd(&valid[d_max], 1);  // n_valid
        }
      }
      if (L.t_st >= 0) {
        for (int c = 0; c < a.St; ++c) {
          const int cc = a.st_class[c];
          if (cc < 0) continue;
          const int t = a.topo_id[(size_t)a.st_key[c] * N + n];
          if (t < 0 || !a.aff_ok[(size_t)cc * N + n]) continue;
          const int v = a.selcls_count[(size_t)a.st_sel[c] * N + n];
          if (v != 0) atomicAdd(&tables[(size_t)(L.t_st + c) * TS + t], v);
        }
      }
    }
  }
  // every CTA of the cluster has started (its slots exist) and the
  // prologue's writes are complete
  cluster.sync();

  // parities (use counts mod 2) of the three exchanges: argmax, extrema, and
  // the ScheduleAnyway bitmasks (barrier.cluster); and the mbarriers' phases
  int pa = 0, pe = 0, ps = 0;
  unsigned phase_bits = 0u;
  int cls_cur = -1, cls_other = -1;  // the classes in the row buffers
  int cur = 0;
  int cls = max(a.class_of_pod[0], 0);

  for (int p = 0; p < a.P; ++p) {
    const int* prow = pbuf + (p % 3) * PW;
    const int* req = prow;
    const int* req_nz = prow + R;
    const uint8_t* cports = a.class_ports + (size_t)cls * Pt;
    // the next pod: its class and (one word a thread) its row, loaded now
    // and stored into its slot after the pass, off this step's path
    // the request row (req, req_nz, balanced_active) equal to the previous
    // pod's (decided during the previous step): every node's cached fit and
    // base score still hold
    const bool same_req = p > 0 && same_next[p % 3];
    const bool more = p + 1 < a.P;
    int nxt_raw = cls, nxt_word = 0;
    if (more) {
      nxt_raw = a.class_of_pod[p + 1];
      if (row_lane) nxt_word = my_src[(size_t)(p + 1) * my_stride];
    }

    // ---- class rows: staged per class, the next class prefetched ----
    const int4* crow;
    if (rows_smem) {
      if (cls_cur != cls) {
        if (cls_other == cls) {  // prefetched during the previous step
          cur ^= 1;
          cls_other = cls_cur;
          cls_cur = cls;
        } else {
          int4* dst = rowbuf + (size_t)cur * chunk;
          const int4* src = a.class_rows + (size_t)cls * N + lo;
          for (int i = tid; i < cnt; i += T) cp_async16(dst + i, src + i);
          cls_cur = cls;
        }
      }
      // each thread copies, and later reads, only its own nodes' rows
      cp_async_wait_all();
      crow = rowbuf + (size_t)cur * chunk;
    } else {
      crow = a.class_rows + (size_t)cls * N + lo;
    }

    // ---- what this pod's class needs (uniform over the cluster) ----
    const int cflags = cflags_s[cls];
    const int nap_ext = cflags & 1, taint_ext = cflags & 2;
    const int ipa_score = a.has_ipa && (cflags & 4);
    int any_ct = 0, any_st = 0;
    if (a.has_ct)
      for (int c = 0; c < a.Ct; ++c) any_ct |= a.ct_class[c] == cls;
    if (a.has_st)
      for (int c = 0; c < a.St; ++c) any_st |= a.st_class[c] == cls;
    const int fused = !(nap_ext || taint_ext || any_st || ipa_score);

    // DoNotSchedule: min count over the valid domains, from the replica
    if (any_ct) {
      for (int c = 0; c < a.Ct; ++c) {
        if (a.ct_class[c] != cls) continue;
        int* tab = tables + (size_t)(L.t_ct + 2 * c) * TS;
        const int* valid = tab + TS;
        const int nd = a.key_domains[a.ct_key[c]];
        int v[1] = {BIG};
        const int ops[1] = {OP_MIN};
        for (int d = tid; d < nd; d += T)
          if (valid[d]) v[0] = min(v[0], tab[d]);
        block_reduce<1>(v, ops, red, red_out);
        const int n_valid = valid[d_max];
        int mmn = v[0];
        const int mind = a.ct_min_domains[c];
        if (mind > 0 && mind > n_valid) mmn = 0;
        if (n_valid == 0) mmn = 0;
        if (tid == 0) tab[d_max + 1] = mmn;
      }
    }
    // ScheduleAnyway: this step's feasible-domain bitmasks start empty
    unsigned* stf = stflags + (size_t)ps * a.St * W;
    if (any_st) {
      for (int c = 0; c < a.St; ++c) {
        if (a.st_class[c] != cls) continue;
        const int wc = (a.key_domains[a.st_key[c]] + 31) >> 5;
        for (int w = tid; w < wc; w += T) stf[(size_t)c * W + w] = 0u;
      }
    }
    if (any_ct || any_st) __syncthreads();

    // ---- filter: static row, fit, ports, IPA rules 1-3, DoNotSchedule ----
    // `after`: as it will be once this pod is committed to node i
    auto fit_ok = [&](int i, int after) -> int {
      const int* al = alloc + (size_t)i * R;
      const int* us = used + (size_t)i * R;
      int ok = 1;
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        const int q = req[r];
        const int u = after ? wadd(us[r], q) : us[r];
        if (!(q == 0 || q <= wsub(al[r], u))) ok = 0;
      }
      return ok && wadd(wadd(pods[i], after), 1) <= maxp[i];
    };
    auto feasible = [&](int i, int n, int frow, int fit) -> int {
      int ok = frow != 0 && fit;
      const uint8_t* pu = ports + (size_t)i * Pt;
      for (int k = 0; k < Pt && ok; ++k)
        if (pu[k] && cports[k]) ok = 0;
      if (!ok) return 0;
      if (a.has_ipa) {
        // rule 1: existing/placed holders' required anti-affinity
        for (int e = 0; e < a.Em; ++e) {
          const int g = a.ea_grp[cls * a.Em + e];
          if (g < 0) continue;
          const int t = a.topo_id[(size_t)a.grp_key[g] * N + n];
          if (t >= 0 && tables[(size_t)(L.t_grp + g) * TS + t] != 0) return 0;
        }
        // rule 2: incoming required affinity with the first-pod exception
        if (a.class_has_ra[cls]) {
          int pos = 1, keys = 1, glob0_all = 1;
          for (int j = 0; j < a.RAm; ++j) {
            const int k = a.ra_key[cls * a.RAm + j];
            if (k < 0) continue;
            const int s = max(a.ra_sel[cls * a.RAm + j], 0);
            const int* tab = tables + (size_t)(L.t_pair + k * SC + s) * TS;
            const int t = a.topo_id[(size_t)k * N + n];
            const int has = t >= 0;
            const int cnt_d = has ? tab[t] : 0;
            if (!(has && cnt_d > 0)) pos = 0;
            if (!has) keys = 0;
            if (tab[d_max] != 0) glob0_all = 0;
          }
          if (!(keys && (pos || (glob0_all && a.class_self_ok[cls])))) return 0;
        }
        // rule 3: incoming required anti-affinity
        for (int j = 0; j < a.RNm; ++j) {
          const int k = a.rn_key[cls * a.RNm + j];
          if (k < 0) continue;
          const int s = max(a.rn_sel[cls * a.RNm + j], 0);
          const int t = a.topo_id[(size_t)k * N + n];
          if (t >= 0 && tables[(size_t)(L.t_pair + k * SC + s) * TS + t] != 0) return 0;
        }
      }
      if (any_ct) {
        for (int c = 0; c < a.Ct; ++c) {
          if (a.ct_class[c] != cls) continue;
          const int* tab = tables + (size_t)(L.t_ct + 2 * c) * TS;
          const int t = a.topo_id[(size_t)a.ct_key[c] * N + n];
          const int node_dc = t >= 0 ? tab[t] : 0;
          const int skew = wsub(wadd(node_dc, a.ct_self_match[c]), tab[d_max + 1]);
          if (!(t >= 0 && skew <= a.ct_max_skew[c])) return 0;
        }
      }
      return 1;
    };

    // ---- score (everything but the normalizers' extrema is per node) ----
    const int bal_active = prow[2 * R] != 0;
    auto base_score = [&](int i, int after) -> unsigned {
      const int* al = alloc + (size_t)i * R;
      const int* us = used + (size_t)i * R;
      const int* unz = used_nz + (size_t)i * R;
      // LeastAllocated over cpu + memory
      int per_sum = 0, npos = 0;
      for (int r = 0; r < 2; ++r) {
        const int A = al[r];
        const int u = wadd(after ? wadd(unz[r], req_nz[r]) : unz[r], req_nz[r]);
        if (A > 0) {
          npos += 1;
          if (u <= A) per_sum = wadd(per_sum, floordiv(wmul(wsub(A, u), 100), max(A, 1)));
        }
      }
      const int least = npos == 2 ? per_sum >> 1 : per_sum;  // floor division by npos
      // BalancedAllocation (float32)
      int bal = 0;
      if (bal_active) {
        float frac[2];
        int nf = 0;
        for (int r = 0; r < 2; ++r) {
          const float af = (float)al[r];
          const float u = (float)wadd(after ? wadd(us[r], req[r]) : us[r], req[r]);
          frac[r] = af > 0.0f ? fminf(__fdiv_rn(u, fmaxf(af, 1.0f)), 1.0f) : 0.0f;
          if (af > 0.0f) nf += 1;
        }
        // x * 0.5f is x / 2 exactly rounded, as the division is
        const float sd = nf == 2 ? __fmul_rn(fabsf(__fsub_rn(frac[0], frac[1])), 0.5f) : 0.0f;
        bal = (int)__fmul_rn(__fsub_rn(1.0f, sd), 100.0f);
      }
      return (unsigned)least + (unsigned)bal;
    };
    // a node's fit and base score from the cache while the request is
    // unchanged (the owner refreshes a committed node), else computed
    auto fit_base = [&](int i, unsigned& base) -> int {
      if (same_req) {
        base = cbase[i];
        return cfit[i];
      }
      const int f = fit_ok(i, 0);
      base = base_score(i, 0);
      cbase[i] = base;
      cfit[i] = (uint8_t)f;
      return f;
    };

    unsigned long long best = 0ull;
    if (fused) {
      // one pass: napref 0, taint 100, no PTS or IPA score
      for (int i = tid; i < cnt; i += T) {
        const int n = lo + i;
        const int4 row = crow[i];
        unsigned base;
        const int f = feasible(i, n, row.x, fit_base(i, base));
        const unsigned total = base + 3u * 100u + (unsigned)row.w;
        const int masked = f ? (int)total : SCORE_MIN;
        best = umax64(best, argmax_key(masked, n, f));
      }
    } else {
      // pass 1: the feasible set, the IPA raw score, the ScheduleAnyway
      // feasible-domain bits, and (without ScheduleAnyway) the extrema
      int ext[7] = {INT_MIN, INT_MIN, INT_MIN, INT_MAX, 0, INT_MIN, INT_MAX};
      for (int i = tid; i < cnt; i += T) {
        const int n = lo + i;
        const int4 row = crow[i];
        unsigned base;
        const int f = feasible(i, n, row.x, fit_base(i, base));
        feas[i] = (uint8_t)f;
        int raw = 0;
        if (ipa_score) {
          for (int j = 0; j < a.PPm; ++j) {
            const int k = a.pp_key[cls * a.PPm + j];
            if (k < 0) continue;
            const int s = max(a.pp_sel[cls * a.PPm + j], 0);
            const int w = a.pp_weight[cls * a.PPm + j];
            const int t = a.topo_id[(size_t)k * N + n];
            const int c_ = t >= 0 ? tables[(size_t)(L.t_pair + k * SC + s) * TS + t] : 0;
            raw = wadd(raw, wmul(w, c_));
          }
          for (int j = 0; j < a.Sm; ++j) {
            const int g = a.sym_grp[cls * a.Sm + j];
            if (g < 0) continue;
            const int w = a.sym_weight[cls * a.Sm + j];
            const int t = a.topo_id[(size_t)a.grp_key[g] * N + n];
            const int c_ = t >= 0 ? tables[(size_t)(L.t_grp + g) * TS + t] : 0;
            raw = wadd(raw, wmul(w, c_));
          }
          ipa_raw[i] = raw;
        }
        if (any_st) {
          if (f) {
            for (int c = 0; c < a.St; ++c) {
              if (a.st_class[c] != cls) continue;
              const int t = a.topo_id[(size_t)a.st_key[c] * N + n];
              if (t >= 0) atomicOr(&stf[(size_t)c * W + (t >> 5)], 1u << (t & 31));
            }
          }
        } else {
          ext[0] = max(ext[0], f ? row.y : 0);
          ext[1] = max(ext[1], f ? row.z : 0);
          ext[5] = max(ext[5], f ? raw : -BIG);
          ext[6] = min(ext[6], f ? raw : BIG);
        }
      }
      if (any_st) {
        // the domain size counts domains holding a feasible node anywhere
        // in the cluster: OR the CS bitmasks over DSMEM
        cluster.sync();
        for (int c = 0; c < a.St; ++c) {
          if (a.st_class[c] != cls) continue;
          int v[1] = {0};
          const int ops[1] = {OP_SUM};
          const int wc = (a.key_domains[a.st_key[c]] + 31) >> 5;
          for (int w = tid; w < wc; w += T) {
            unsigned x = 0u;
            for (int r = 0; r < cs; ++r) {
              const size_t at = (size_t)ps * a.St * W + (size_t)c * W + w;
              if (stflags_smem) {
                x |= cluster.map_shared_rank(stflags, r)[at];
              } else {
                x |= __ldcg((const unsigned*)(a.gscratch + (size_t)r * L.gbytes +
                                              L.goff[RG_STFLAGS]) + at);
              }
            }
            v[0] += __popc(x);
          }
          block_reduce<1>(v, ops, red, red_out);
          if (tid == 0)
            tables[(size_t)(L.t_st + c) * TS + d_max + 1] =
                __float_as_int(logf(__fadd_rn((float)v[0], 2.0f)));
        }
        ps ^= 1;
        __syncthreads();
        // pass 1b: the ScheduleAnyway raw score and the extrema
        for (int i = tid; i < cnt; i += T) {
          const int n = lo + i;
          const int4 row = crow[i];
          const int f = feas[i];
          float ss = 0.0f;
          int ign = 0;
          for (int c = 0; c < a.St; ++c) {
            if (a.st_class[c] != cls) continue;
            const int* tab = tables + (size_t)(L.t_st + c) * TS;
            const float w = __int_as_float(tab[d_max + 1]);
            const float skew_m1 = (float)(a.st_max_skew[c] - 1);
            const int t = a.topo_id[(size_t)a.st_key[c] * N + n];
            const int node_dc = t >= 0 ? tab[t] : 0;
            const float contrib = __fadd_rn(__fmul_rn((float)node_dc, w), skew_m1);
            ss = __fadd_rn(ss, contrib);
            if (t < 0) ign = 1;
          }
          st_sum[i] = ss;
          ignored[i] = (uint8_t)ign;
          const int raw = ipa_score ? ipa_raw[i] : 0;
          ext[0] = max(ext[0], f ? row.y : 0);
          ext[1] = max(ext[1], f ? row.z : 0);
          const int pr = (int)rintf(ss);
          const int nm = f && !ign;
          ext[2] = max(ext[2], nm ? pr : -BIG);
          ext[3] = min(ext[3], nm ? pr : BIG);
          ext[4] = max(ext[4], nm);
          ext[5] = max(ext[5], f ? raw : -BIG);
          ext[6] = min(ext[6], f ? raw : BIG);
        }
      }
      // ---- the normalizers' extrema over the cluster's feasible set ----
      // 0 napref max, 1 taint max, 2 pts max, 3 pts min, 4 any norm node,
      // 5 ipa max, 6 ipa min
      {
        const int ops[7] = {OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MAX, OP_MAX, OP_MIN};
        block_reduce<7>(ext, ops, red, red_out);
        const unsigned bar = bar_ext + 8 * pe;
        if (tid < cs) {  // this CTA's extrema into CTA tid
          const unsigned dst = remote_addr(smem_addr(&slots.ext[pe][crank][0]), tid);
          const unsigned rbar = remote_addr(bar, tid);
          st_async_v4(dst, make_int4(red_out[0], red_out[1], red_out[2], red_out[3]), rbar);
          st_async_v4(dst + 16, make_int4(red_out[4], red_out[5], red_out[6], 0), rbar);
        }
        mbar_wait(bar, (phase_bits >> (2 + pe)) & 1u);
        phase_bits ^= 1u << (2 + pe);
#pragma unroll
        for (int k = 0; k < 7; ++k)
          ext[k] = warp_op(ops[k], lane < cs ? slots.ext[pe][lane][k] : op_ident(ops[k]));
        __syncthreads();  // every thread is past the wait: re-arm for use + 2
        if (tid == 0) mbar_expect(bar, ext_bytes);
        pe ^= 1;
      }
      const int mx_napref = ext[0], mx_taint = ext[1];
      const int pmx = ext[2], pmn = ext[3], any_norm = ext[4];
      const int imn = ext[6];
      const int idiff = wsub(ext[5], imn);

      // pass 2: total score and the CTA's argmax
      for (int i = tid; i < cnt; i += T) {
        const int n = lo + i;
        const int4 row = crow[i];
        const int f = feas[i];
        int napref = 0;
        if (nap_ext) napref = mx_napref > 0 ? floordiv(wmul(100, row.y), max(mx_napref, 1)) : 0;
        int taint = 100;
        if (taint_ext && mx_taint > 0) taint = 100 - floordiv(wmul(100, row.z), max(mx_taint, 1));
        int pts = 0;
        if (any_st) {
          const int pr = (int)rintf(st_sum[i]);
          const int val = pmx > 0 ? floordiv(wmul(100, wsub(wadd(pmx, pmn), pr)), max(pmx, 1)) : 100;
          pts = (!ignored[i] && any_norm) ? val : 0;
        }
        int ipa = 0;
        if (ipa_score && f && idiff > 0) ipa = floordiv(wmul(100, wsub(ipa_raw[i], imn)), max(idiff, 1));
        const unsigned total = cbase[i] + 2u * (unsigned)napref + 3u * (unsigned)taint +
                               2u * (unsigned)pts + 2u * (unsigned)ipa + (unsigned)row.w;
        const int masked = f ? (int)total : SCORE_MIN;
        best = umax64(best, argmax_key(masked, n, f));
      }
    }

    // ---- argmax over the cluster (value desc, index asc) ----
    // the CTA's key (warp max, then over the warps) into every CTA's slot,
    // a wait on this CTA's mbarrier, a local read. While the keys travel,
    // the CTA's best node's cache entry is computed as it will be if the
    // pod lands there (the global best is some CTA's best, so its owner
    // always has it ready for the commit)
    best = warp_max64(best);
    if (lane == 0) redk[warp] = best;
    __syncthreads();
    best = warp_max64(lane < nw ? redk[lane] : 0ull);  // every warp: the CTA's best
    const unsigned bar = bar_arg + 8 * pa;
    if (warp == 0 && lane < cs)
      st_async_b64(remote_addr(smem_addr(&slots.key[pa][crank]), lane), best,
                   remote_addr(bar, lane));
    // (the fit by a helper thread in another warp, so the two chains run
    // side by side)
    const int wi = (int)(0x7fffffffu - ((unsigned)best >> 1)) - lo;
    const bool mine = (best & 1ull) && wi >= 0 && wi < cnt;
    const int otid = mine ? (wi < T ? wi : wi % T) : -1;
    const bool spec = otid == tid;
    unsigned spec_base = 0u;
    if (spec) spec_base = base_score(wi, 1);
    if (mine && (T >= 64 ? (otid + 32) % T : otid) == tid) spec_fit = fit_ok(wi, 1);

    // ---- meanwhile: the next pod's row into its slot, the next class's
    // rows ahead ----
    const int nxt_cls = max(nxt_raw, 0);
    if (more) {
      if (warp == nw - 1) {  // and is the next pod's request row this one's?
        if (row_lane) pbuf[((p + 1) % 3) * PW + lane] = nxt_word;
        int eq = row_lane ? nxt_word == prow[lane] : 1;
        for (int j = 32 + lane; j < PW; j += 32) {
          const int w = pod_word(p + 1, j);
          pbuf[((p + 1) % 3) * PW + j] = w;
          eq &= w == prow[j];
        }
        eq = __all_sync(0xffffffffu, eq);
        if (lane == 0) same_next[(p + 1) % 3] = eq;
      }
      if (rows_smem && nxt_cls != cls && cls_other != nxt_cls) {
        int4* dst = rowbuf + (size_t)(cur ^ 1) * chunk;
        const int4* src = a.class_rows + (size_t)nxt_cls * N + lo;
        for (int i = tid; i < cnt; i += T) cp_async16(dst + i, src + i);
        cls_other = nxt_cls;
        cp_async_commit();
      }
    }

    mbar_wait(bar, phase_bits >> pa & 1u);
    phase_bits ^= 1u << pa;
    best = warp_max64(lane < cs ? slots.key[pa][lane] : 0ull);
    __syncthreads();  // every thread is past the wait: re-arm for use + 2
    if (tid == 0) mbar_expect(bar, arg_bytes);
    pa ^= 1;
    const unsigned low = (unsigned)(best & 0xffffffffull);
    const int bi = (int)(0x7fffffffu - (low >> 1));
    const int ok = (int)(low & 1u);

    // ---- commit: the owning thread updates its node, every CTA its replica ----
    if (ok) {
      const int i = bi - lo;
      if (i >= 0 && i < cnt) {  // this CTA owns bi
        if (i < T ? i == tid : i % T == tid) {
          for (int r = 0; r < R; ++r) {
            used[i * R + r] = wadd(used[i * R + r], req[r]);
            used_nz[i * R + r] = wadd(used_nz[i * R + r], req_nz[r]);
          }
          pods[i] = wadd(pods[i], 1);
          for (int k = 0; k < Pt; ++k)
            if (cports[k]) ports[(size_t)i * Pt + k] = 1;
          // this request's cache entry for the new state
          const bool ready = spec && wi == i;
          cfit[i] = (uint8_t)(ready ? spec_fit : fit_ok(i, 0));  // spec_fit: after the barrier
          cbase[i] = ready ? spec_base : base_score(i, 0);
        }
      }
      if (n_tab > 0) {
        const int n_pair = L.t_pair >= 0 ? a.Kk * SC : 0;
        const int n_grp = L.t_pair >= 0 ? a.G : 0;
        const int n_ct = L.t_ct >= 0 ? a.Ct : 0;
        const int n_st = L.t_st >= 0 ? a.St : 0;
        for (int j = tid; j < n_pair + n_grp + n_ct + n_st; j += T) {
          int* tab;
          int key, m;
          if (j < n_pair) {
            const int k = j / SC, s = j % SC;
            tab = tables + (size_t)(L.t_pair + j) * TS;
            key = k;
            m = a.class_matches_selcls[(size_t)cls * SC + s];
          } else if (j < n_pair + n_grp) {
            const int g = j - n_pair;
            tab = tables + (size_t)(L.t_grp + g) * TS;
            key = a.grp_key[g];
            m = a.class_holds_grp[(size_t)cls * a.G + g];
          } else if (j < n_pair + n_grp + n_ct) {
            const int c = j - n_pair - n_grp;
            const int cc = a.ct_class[c];
            if (cc < 0 || !a.aff_ok[(size_t)cc * N + bi]) continue;
            tab = tables + (size_t)(L.t_ct + 2 * c) * TS;
            key = a.ct_key[c];
            m = a.class_matches_selcls[(size_t)cls * SC + a.ct_sel[c]];
          } else {
            const int c = j - n_pair - n_grp - n_ct;
            const int cc = a.st_class[c];
            if (cc < 0 || !a.aff_ok[(size_t)cc * N + bi]) continue;
            tab = tables + (size_t)(L.t_st + c) * TS;
            key = a.st_key[c];
            m = a.class_matches_selcls[(size_t)cls * SC + a.st_sel[c]];
          }
          const int t = a.topo_id[(size_t)key * N + bi];
          if (t < 0 || m == 0) continue;
          tab[t] = wadd(tab[t], m);
          if (j < n_pair + n_grp) tab[d_max] = wadd(tab[d_max], m);
        }
      }
    }
    if (crank == 0 && tid == 0) a.assignment[p] = ok ? bi : -1;
    if (n_tab > 0) __syncthreads();  // the replica's update before the next step reads it
    cls = nxt_cls;
  }

  // ---- epilogue: the carried state back to the wrapper's outputs ----
  for (int i = tid; i < cnt; i += T) {
    const size_t g = (size_t)(lo + i) * R;
    if (L.off[RG_USED] >= 0)
      for (int r = 0; r < R; ++r) a.used[g + r] = used[i * R + r];
    if (L.off[RG_PODS] >= 0) a.pod_count[lo + i] = pods[i];
  }
  // no CTA leaves while another may still read its slots
  cluster.sync();
#undef REGION
}

// ---------------------------------------------------------------------------
// host side: the cluster size (once per process), the layout, the launch
// ---------------------------------------------------------------------------

static int g_cluster_size = 0;
static int g_cluster_error = 0;

// 16 CTAs where the card can hold such a cluster at the largest launch this
// file makes (MAX_THREADS threads, SMEM_BUDGET bytes each), else the portable 8.
// Returns the size, or 0 with the CUDA error kept for greedy_scan_plan.
extern "C" int greedy_scan_cluster_size() {
  if (g_cluster_size || g_cluster_error) return g_cluster_size;
  g_cluster_size = choose_cluster_size(greedy_scan_kernel, MAX_THREADS, SMEM_BUDGET,
                                       &g_cluster_error);
  return g_cluster_size;
}

static long long align16(long long x) { return (x + 15) & ~15ll; }

// The layout of one launch: region sizes per CTA, placed in shared memory
// in RG_* order while they fit, the rest in a per-CTA global slice.
static int make_layout(const GreedyScanArgs* a, ScanLayout* L, GreedyScanPlan* plan) {
  const int cs = greedy_scan_cluster_size();
  if (!cs) return g_cluster_error;
  const int chunk = (a->N + cs - 1) / cs;
  int threads = (chunk + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  L->cs = cs;
  L->threads = threads;
  L->chunk = chunk;
  L->ts = a->d_max + 2;
  L->st_words = (a->d_max + 31) / 32;
  int nt = 0;
  L->t_pair = L->t_grp = L->t_ct = L->t_st = -1;
  if (a->has_ipa) {
    L->t_pair = nt;
    nt += a->Kk * a->SC;
    L->t_grp = nt;
    nt += a->G;
  }
  if (a->has_ct) {
    L->t_ct = nt;
    nt += 2 * a->Ct;  // counts, then the valid-domain flags
  }
  if (a->has_st) {
    L->t_st = nt;
    nt += a->St;
  }
  L->n_tables = nt;
  const long long c16 = (chunk + 15) & ~15;
  const long long rbytes = align16((long long)chunk * a->R * 4);
  long long size[NRG];
  size[RG_POD] = align16((((3ll * (2 * a->R + 1)) + 3) & ~3ll) * 4 + (long long)a->C * 4);
  size[RG_NODE] = c16 * 15;
  size[RG_USED] = rbytes;
  size[RG_USED_NZ] = rbytes;
  size[RG_PODS] = align16((long long)chunk * 4);
  size[RG_ALLOC] = rbytes;
  size[RG_MAXP] = align16((long long)chunk * 4);
  size[RG_STFLAGS] = a->has_st ? align16(2ll * a->St * L->st_words * 4) : 0;
  size[RG_ROWS] = 2ll * chunk * 16;
  size[RG_PORTS] = align16((long long)chunk * a->Pt);
  size[RG_TABLES] = align16((long long)nt * L->ts * 4);
  long long smem = 0, gbytes = 0;
  int in_smem = 0;
  for (int r = 0; r < NRG; ++r) {
    L->goff[r] = 0;
    if (smem + size[r] <= SMEM_BUDGET) {
      L->off[r] = (int)smem;
      smem += size[r];
      in_smem |= 1 << r;
    } else {
      L->off[r] = -1;
      if (r == RG_POD || r == RG_NODE || r == RG_STFLAGS || r == RG_TABLES) {
        L->goff[r] = gbytes;
        gbytes += size[r];
      }
    }
  }
  L->gbytes = gbytes;
  plan->cs = cs;
  plan->threads = threads;
  plan->chunk = chunk;
  plan->smem_bytes = (int)smem;
  plan->in_smem = in_smem;
  plan->n_tables = nt;
  plan->gbytes = gbytes;
  return 0;
}

// What a launch with these args would do: the wrapper sizes the global
// scratch (plan.cs * plan.gbytes bytes) from it. Returns a CUDA error or 0.
extern "C" int greedy_scan_plan(const GreedyScanArgs* args, GreedyScanPlan* plan) {
  ScanLayout L;
  return make_layout(args, &L, plan);
}

// Launch one batch on `stream` as one cluster. Returns the CUDA error of
// the launch (a refused cluster launch never runs; nothing retries it).
extern "C" int greedy_scan_launch(const GreedyScanArgs* args, void* stream) {
  ScanLayout L;
  GreedyScanPlan plan;
  int err = make_layout(args, &L, &plan);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(L.cs, L.threads, plan.smem_bytes, (cudaStream_t)stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, greedy_scan_kernel, *args, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int greedy_scan_args_size() { return (int)sizeof(GreedyScanArgs); }
extern "C" int greedy_scan_plan_size() { return (int)sizeof(GreedyScanPlan); }
