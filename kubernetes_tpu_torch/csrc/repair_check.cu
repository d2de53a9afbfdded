// Kernel D: the final-state violation check of one placed batch (sm_90a).
//
// Replaces: kubernetes_tpu/models/repair.py repair_check (jax.jit,
// :120-228). Same function: for every placed pod of a pow2-padded batch,
// (1) required anti-affinity: another matching pod in its topology domain
// (the pod's own class_matches contribution subtracted), (2) holders'
// required anti-affinity against it (own class_holds subtracted),
// (3) required affinity: the key is missing or the domain count is <= 0,
// (4) DoNotSchedule spread: the node's domain count minus the minimum over
// valid domains (minDomains rule) exceeds maxSkew, or the key is missing.
// Four bool masks, one [4, Pb] output; padding and unplaced pods
// (node_of < 0) never violate. The plain PyTorch version is
// models/repair.py repair_check_plain; the two must agree exactly.
//
// What bounds it: bytes, barely. The count rows ([SC + G, N] int32) and
// topology rows are read once per key; at 5,000 nodes and 100 count rows
// that is 2 MB, under a microsecond at the card's rate. What held the
// earlier design back was its shape: up to three dependent launches joined
// through global memory (a [Kk, SC + G, d_max] domain table, a [Ct, N]
// spread row), and one block a spread row, so a TopologySpreading check ran
// its 5,000 nodes on one SM.
//
// Design: one launch of one thread-block cluster (16 CTAs, else 8; chosen
// once per process). The table rows are the (key, count row) pairs (when
// has_affinity) and, per spread row, its counts over aff_ok & key present
// and its eligible-node counts (when has_ct); a domain is valid where the
// latter is > 0. CTA r owns the nodes [r * node_chunk, ...) (whole quads of
// four nodes) and the padded pods [r * pod_chunk, ...). The plan
// (ops/kernels.py repair_plan) picks where the domain totals live:
//   mode 0 (replicate, rows x d_max small: zones): each CTA sums its nodes
//     into a local table with shared-memory atomics, pushes it into a slot
//     of every CTA by st.async (csrc/cluster_exchange.cuh), waits on its
//     own mbarrier and adds the CS slots: every CTA holds every total, and
//     reduces the spread rows' n_valid and minimum itself;
//   mode 1 (owner, the table fits the cluster's shared memory): CTA q owns
//     the domains [q * slice, (q + 1) * slice) of every row; each CTA adds
//     its nodes' values straight into the owner's table (a distributed
//     shared-memory atomic), then, after one barrier.cluster, reduces its
//     slice of each spread row and pushes (n_valid, min) to every CTA by
//     st.async; the pods read their totals from the owner over DSMEM;
//   mode 2 (global, beyond the cluster's shared memory): mode 1 with the
//     owners' tables in a global scratch, zeroed by their owners inside
//     the same launch.
// The pod pass runs the class's anti-affinity, holder and affinity term
// loops against the totals and the spread test against the row's minimum.
// No per-node spread row and no table of another launch goes through
// global memory; the masks are written once.
//
// Parity: int32 sums wrap as in XLA (integer atomics wrap, order does not
// matter; wrapping subtraction in uint32); a node whose domain id is >= d_max
// adds nothing and reads domain d_max - 1, as the JAX version's segment sum
// and clip do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

// threads a CTA (measured on an NVIDIA H100 80GB HBM3 against 1,024: faster at the
// TopologySpreading check, slower at the PodAntiAffinity one; the main path
// runs six of the former to one of the latter)
#define RC_THREADS 512
#define RC_WARPS (RC_THREADS / 32)
#define RC_SMEM_BUDGET (220 * 1024)
#define RC_BATCH 8  // count-row quads a thread has in flight

struct RepairCheckArgs {
  int Pb, N, Kk, SC, G, RNm, EAm, RAm, Ct, d_max, has_affinity, has_ct;
  // the plan (ops/kernels.py repair_plan)
  int cs, mode, rows, slice, node_chunk, pod_chunk, smem_bytes;
  const int* node_of;
  const int* cls_of;
  const int* dyn_selcls;
  const int* dyn_grp;
  const int* topo_id;
  const int* rn_key;
  const int* rn_sel;
  const int* ea_grp;
  const int* ra_key;
  const int* ra_sel;
  const int* class_matches;
  const int* class_holds;
  const int* grp_key;
  const uint8_t* aff_ok;
  const int* ct_class;
  const int* ct_key;
  const int* ct_sel;
  const int* ct_max_skew;
  const int* ct_min_domains;
  uint8_t* out;  // [4, Pb]: anti-affinity, holders' anti-affinity, affinity, spread
  int* gtab;     // mode 2: [cs][rows][slice] domain totals
};

__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// row[n, n + 4) of an int row of `len` entries (0 past its end): one 16-byte
// load where the quad is whole and 16-byte aligned (N a multiple of 4 and a
// fresh tensor), else entry by entry
__device__ __forceinline__ int4 quad_at(const int* row, int n, int len) {
  if (n + 4 <= len && ((uintptr_t)(row + n) & 15) == 0) return *(const int4*)(row + n);
  int w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = n + q < len ? row[n + q] : 0;
  return make_int4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the dynamic shared memory's regions (16-byte aligned), in this order
struct RcLayout {
  long long ctmin;  // [Ct] each spread row's minimum after the minDomains rule
  long long xct;    // [cs][Ct] int2 (n_valid, min) partials, modes 1-2
  long long tab;    // mode 0: [rows][d_max]; mode 1: [rows][slice]
  long long slots;  // mode 0: [cs][rows][d_max]
  long long end;
};

__host__ __device__ __forceinline__ long long rc_align16(long long x) { return (x + 15) & ~15ll; }

__host__ __device__ __forceinline__ RcLayout rc_layout(int mode, int cs, int Ct, int rows,
                                                       int d_max, int slice) {
  RcLayout L;
  L.ctmin = 0;
  L.xct = rc_align16(4ll * Ct);
  L.tab = L.xct + (mode ? rc_align16(8ll * cs * Ct) : 0);
  long long tab_words = mode == 0 ? (long long)rows * d_max : mode == 1 ? (long long)rows * slice : 0;
  L.slots = L.tab + rc_align16(4ll * tab_words);
  L.end = L.slots + (mode == 0 ? rc_align16(4ll * cs * rows * d_max) : 0);
  return L;
}

// the domain totals of one CTA's view: (row, clipped domain) -> total
struct Totals {
  int mode, rank, rows, d_max, slice;
  int* tab;   // this CTA's table (modes 0-1)
  int* gtab;  // mode 2
  __device__ __forceinline__ int get(int row, int t) const {
    if (mode == 0) return tab[(size_t)row * d_max + t];
    const int q = t / slice, o = t - q * slice;
    if (mode == 1) {
      const int* p = q == rank ? tab : cg::this_cluster().map_shared_rank(tab, q);
      return p[(size_t)row * slice + o];
    }
    return gtab[((size_t)q * rows + row) * slice + o];
  }
  // add v at (row, t) into the owner's table (modes 1-2)
  __device__ __forceinline__ void add_owner(int row, int t, int v) const {
    const int q = t / slice, o = t - q * slice;
    const size_t at = (size_t)row * slice + o;
    if (mode == 2)
      atomicAdd(gtab + (size_t)q * rows * slice + at, v);
    else if (q == rank)  // this CTA's own slice: a shared-memory atomic
      atomicAdd(tab + at, v);
    else
      atomicAdd(cg::this_cluster().map_shared_rank(tab, q) + at, v);
  }
};

__global__ void __launch_bounds__(RC_THREADS) repair_check_kernel(const RepairCheckArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar_s[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = a.cs, rank = (int)cluster.block_rank();
  const int N = a.N, d_max = a.d_max, M = a.SC + a.G;
  const int mode = a.mode, rows = a.rows;
  const int r_aff = a.has_affinity ? a.Kk * M : 0;
  const RcLayout L = rc_layout(mode, cs, a.Ct, rows, d_max, a.slice);
  int* ctmin = (int*)(smem + L.ctmin);
  int2* xct = (int2*)(smem + L.xct);
  int* tab = (int*)(smem + L.tab);
  int* slots = (int*)(smem + L.slots);
  const Totals tot{mode, rank, rows, d_max, a.slice, tab,
                   mode == 2 ? a.gtab : nullptr};

  // one exchange: mode 0 the tables (every CTA's into every CTA), modes 1-2
  // the spread rows' (n_valid, min) partials
  const long long words = (long long)rows * d_max;
  const unsigned xbytes = mode == 0 ? (unsigned)(4ll * cs * words)
                                    : (a.has_ct ? (unsigned)(8 * cs * a.Ct) : 0u);
  Xchg xc;
  xchg_init(xc, smem_addr(bar_s), xbytes, 0u, 1);

  // this thread's first pod's node and class, in flight through steps 0-2
  const int p0 = rank * a.pod_chunk, p1 = min(a.Pb, p0 + a.pod_chunk);
  int nd0 = -1, cl0 = 0;
  if (p0 + tid < p1) {
    nd0 = a.node_of[p0 + tid];
    cl0 = a.cls_of[p0 + tid];
  }

  // ---- 0. zero this CTA's table (the owners' slices in mode 2) ----------
  if (mode == 0) {
    for (long long w = tid; w < words; w += RC_THREADS) tab[w] = 0;
  } else {
    int* own = mode == 1 ? tab : a.gtab + (size_t)rank * rows * a.slice;
    const long long ow = (long long)rows * a.slice;
    for (long long w = tid; w < ow; w += RC_THREADS) own[w] = 0;
  }
  __syncthreads();
  // publishes the mbarriers and the zeroed tables to the cluster
  cluster_arrive();
  if (mode != 0) cluster_wait();  // the owners' tables take remote adds next

  // ---- 1. this CTA's nodes into the domain sums ----------------------------
  const int n0 = rank * a.node_chunk;  // a multiple of 4
  const int len = max(0, min(N, n0 + a.node_chunk) - n0);
  auto add = [&](int row, int t, int v) {
    if (t < 0 || t >= d_max || v == 0) return;
    if (mode == 0)
      atomicAdd(&tab[(size_t)row * d_max + t], v);
    else
      tot.add_owner(row, t, v);
  };
  // (a) the (key, count row) pairs: a thread a quad of nodes (quad_at) and
  // a share of the rows, groups of threads over the slice's quads, group g
  // taking the rows g, g + groups, ...; a key's domain ids are read once,
  // the rows' quads RC_BATCH at a time (their loads in flight together,
  // then their adds)
  const int quads = (len + 3) >> 2;
  int groups = quads ? max(1, RC_THREADS / quads) : 0;
  int grp = quads && quads < RC_THREADS ? tid / quads : 0;
  const int qstep = quads < RC_THREADS ? quads : RC_THREADS;
  for (int qd = tid - grp * quads; a.has_affinity && grp < groups && qd < quads; qd += qstep) {
    const int n = n0 + 4 * qd;
    for (int k = 0; k < a.Kk; ++k) {
      const int4 t4 = quad_at(a.topo_id + (size_t)k * N, n, N);
      for (int m0 = grp; m0 < M; m0 += RC_BATCH * groups) {
        int4 v[RC_BATCH];
#pragma unroll
        for (int u = 0; u < RC_BATCH; ++u) {
          const int m = m0 + u * groups;
          v[u] = m < M ? quad_at(m < a.SC ? a.dyn_selcls + (size_t)m * N
                                          : a.dyn_grp + (size_t)(m - a.SC) * N, n, N)
                       : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < RC_BATCH; ++u) {
          if ((v[u].x | v[u].y | v[u].z | v[u].w) == 0) continue;
          const int row = k * M + m0 + u * groups;
          add(row, t4.x, v[u].x);
          add(row, t4.y, v[u].y);
          add(row, t4.z, v[u].z);
          add(row, t4.w, v[u].w);
        }
      }
    }
  }
  // (b) each spread row: its count over aff_ok & key present, its eligible
  // nodes; a thread a node (a slice wider than the block, several), the
  // rows shared by groups of threads over the slice as in (a)
  groups = len ? max(1, RC_THREADS / len) : 0;
  grp = len < RC_THREADS && len ? tid / len : 0;
  const int cstep = len < RC_THREADS ? len : RC_THREADS;
  for (int col = tid - grp * len; a.has_ct && grp < groups && col < len; col += cstep) {
    const int n = n0 + col;
    for (int c = grp; c < a.Ct; c += groups) {
      // the three loads issued together, then tested
      const int c0 = max(a.ct_class[c], 0);
      const bool ok = a.aff_ok[(size_t)c0 * N + n];
      const int t = a.topo_id[(size_t)a.ct_key[c] * N + n];
      const int v = a.dyn_selcls[(size_t)a.ct_sel[c] * N + n];
      if (!ok) continue;
      add(r_aff + 2 * c, t, v);
      add(r_aff + 2 * c + 1, t, 1);
    }
  }

  // ---- 2. the cluster's totals, the spread rows' minima ------------------
  if (mode == 0) {
    __syncthreads();  // the CTA's partial table is complete
    cluster_wait();   // every CTA runs and its mbarrier is initialised
    const long long pushes = words * cs;
    for (long long w = tid; w < pushes; w += RC_THREADS) {
      const int q = (int)(w / words);
      const long long x = w - (long long)q * words;
      st_async_b32(remote_addr(smem_addr(slots + (size_t)rank * words + x), q), (unsigned)tab[x],
                   remote_addr(xc.bar, q));
    }
    __syncthreads();  // every push has read its word of tab
    xchg_wait(xc, 0);
    for (long long x = tid; x < words; x += RC_THREADS) {
      unsigned s = 0u;
      for (int q = 0; q < cs; ++q) s += (unsigned)slots[(size_t)q * words + x];
      tab[x] = (int)s;
    }
    __syncthreads();
    // each spread row over every domain: one warp a row
    if (a.has_ct) {
      for (int c = warp; c < a.Ct; c += RC_WARPS) {
        const int* cnt = tab + (size_t)(r_aff + 2 * c) * d_max;
        const int* elig = cnt + d_max;
        int nv = 0, mn = 1 << 30;
        for (int d = lane; d < d_max; d += 32)
          if (elig[d] > 0) {
            nv += 1;
            mn = min(mn, cnt[d]);
          }
        nv = __reduce_add_sync(0xffffffffu, nv);
        mn = __reduce_min_sync(0xffffffffu, mn);
        if (lane == 0) {
          const int mind = a.ct_min_domains[c];
          if ((mind > 0 && mind > nv) || nv == 0) mn = 0;
          ctmin[c] = mn;
        }
      }
    }
    __syncthreads();
  } else {
    cluster_arrive();  // this CTA's adds are done
    cluster_wait();    // and every CTA's
    if (a.has_ct) {
      // this CTA's slice of each spread row, pushed to every CTA
      const int d0 = rank * a.slice, d1 = min(d_max, d0 + a.slice);
      for (int c = warp; c < a.Ct; c += RC_WARPS) {
        const int rc = r_aff + 2 * c;
        int nv = 0, mn = 1 << 30;
        for (int d = d0 + lane; d < d1; d += 32)
          if (tot.get(rc + 1, d) > 0) {
            nv += 1;
            mn = min(mn, tot.get(rc, d));
          }
        nv = __reduce_add_sync(0xffffffffu, nv);
        mn = __reduce_min_sync(0xffffffffu, mn);
        if (lane < cs) {
          const unsigned long long v =
              (unsigned long long)(unsigned)nv | ((unsigned long long)(unsigned)mn << 32);
          st_async_b64(remote_addr(smem_addr(&xct[(size_t)rank * a.Ct + c]), lane), v,
                       remote_addr(xc.bar, lane));
        }
      }
      xchg_wait(xc, 0);
      for (int c = tid; c < a.Ct; c += RC_THREADS) {
        int nv = 0, mn = 1 << 30;
        for (int q = 0; q < cs; ++q) {
          const int2 p = xct[(size_t)q * a.Ct + c];
          nv += p.x;
          mn = min(mn, p.y);
        }
        const int mind = a.ct_min_domains[c];
        if ((mind > 0 && mind > nv) || nv == 0) mn = 0;
        ctmin[c] = mn;
      }
    }
    __syncthreads();
  }

  // ---- 3. this CTA's pods ------------------------------------------------
  for (int i = p0 + tid; i < p1; i += RC_THREADS) {
    const int nd = i == p0 + tid ? nd0 : a.node_of[i];
    const int cl = i == p0 + tid ? cl0 : a.cls_of[i];
    const int placed = nd >= 0;
    const int n = nd > 0 ? nd : 0;
    const int c = cl > 0 ? cl : 0;
    int rn = 0, ea = 0, ra = 0, ct = 0;
    if (placed && a.has_affinity) {
      for (int j = 0; j < a.RNm; ++j) {
        const int k = a.rn_key[c * a.RNm + j];
        if (k < 0) continue;
        const int s0 = max(a.rn_sel[c * a.RNm + j], 0);
        const int t = a.topo_id[(size_t)k * N + n];
        if (t < 0) continue;
        const int other = wsub(tot.get(k * M + s0, min(t, d_max - 1)),
                               a.class_matches[c * a.SC + s0]);
        if (other > 0) rn = 1;
      }
      for (int j = 0; j < a.EAm; ++j) {
        const int g = a.ea_grp[c * a.EAm + j];
        if (g < 0) continue;
        const int k = a.grp_key[g];
        const int t = a.topo_id[(size_t)k * N + n];
        if (t < 0) continue;
        const int other = wsub(tot.get(k * M + a.SC + g, min(t, d_max - 1)),
                               a.class_holds[c * a.G + g]);
        if (other > 0) ea = 1;
      }
      for (int j = 0; j < a.RAm; ++j) {
        // final-state affinity counts include the pod itself
        const int k = a.ra_key[c * a.RAm + j];
        if (k < 0) continue;
        const int s0 = max(a.ra_sel[c * a.RAm + j], 0);
        const int t = a.topo_id[(size_t)k * N + n];
        if (t < 0 || tot.get(k * M + s0, min(t, d_max - 1)) <= 0) ra = 1;
      }
    }
    if (placed && a.has_ct) {
      for (int j = 0; j < a.Ct; ++j) {
        if (a.ct_class[j] < 0 || a.ct_class[j] != c) continue;
        const int t = a.topo_id[(size_t)a.ct_key[j] * N + n];
        const int node_dc = t >= 0 ? tot.get(r_aff + 2 * j, min(t, d_max - 1)) : 0;
        if (t < 0 || wsub(node_dc, ctmin[j]) > a.ct_max_skew[j]) ct = 1;
      }
    }
    a.out[i] = (uint8_t)rn;
    a.out[(size_t)a.Pb + i] = (uint8_t)ea;
    a.out[2 * (size_t)a.Pb + i] = (uint8_t)ra;
    a.out[3 * (size_t)a.Pb + i] = (uint8_t)ct;
  }
  // mode 1: no CTA leaves while another may still read its table
  if (mode == 1) {
    cluster_arrive();
    cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// host side: the cluster size (once per process), the launch
// ---------------------------------------------------------------------------

static int g_cluster_size = 0;
static int g_cluster_error = 0;

// 16 or 8, or minus the CUDA error that refused both
extern "C" int repair_check_cluster_size() {
  if (!g_cluster_size && !g_cluster_error)
    g_cluster_size = choose_cluster_size(repair_check_kernel, RC_THREADS, RC_SMEM_BUDGET,
                                         &g_cluster_error);
  return g_cluster_size ? g_cluster_size : -g_cluster_error;
}

extern "C" int repair_check_smem_budget() { return RC_SMEM_BUDGET; }
extern "C" int repair_check_threads() { return RC_THREADS; }

// the plan's dynamic shared memory (what ops/kernels.py repair_plan computes)
extern "C" long long repair_check_smem_bytes(int mode, int cs, int Ct, int rows, int d_max,
                                             int slice) {
  return rc_layout(mode, cs, Ct, rows, d_max, slice).end;
}

// One launch of one cluster on `stream`. *launched counts the kernels
// launched. Returns the CUDA error of the launch (a refused cluster launch
// never runs; nothing retries it). The wrapper checks shapes, types and
// contiguity and plans the layout.
extern "C" int repair_check_launch(const RepairCheckArgs* args, void* stream, int* launched) {
  *launched = 0;
  const RepairCheckArgs& a = *args;
  const int cs = repair_check_cluster_size();
  if (cs <= 0) return -cs;
  const int r_aff = a.has_affinity ? a.Kk * (a.SC + a.G) : 0;
  if (a.cs != cs || a.mode < 0 || a.mode > 2 || a.d_max < 1 || a.Pb < 1 || a.N < 1 ||
      a.rows != r_aff + (a.has_ct ? 2 * a.Ct : 0) || (a.has_ct && a.Ct < 1) ||
      (long long)a.slice * cs < a.d_max || (long long)a.node_chunk * cs < a.N ||
      (long long)a.pod_chunk * cs < a.Pb || (a.mode == 2 && !a.gtab) ||
      a.smem_bytes != rc_layout(a.mode, cs, a.Ct, a.rows, a.d_max, a.slice).end ||
      a.smem_bytes > RC_SMEM_BUDGET || !a.out || a.node_chunk % 4)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(cs, RC_THREADS, a.smem_bytes, (cudaStream_t)stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, repair_check_kernel, a);
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int repair_check_args_size() { return (int)sizeof(RepairCheckArgs); }
