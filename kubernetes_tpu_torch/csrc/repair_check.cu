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
// Four bool masks [Pb]; padding and unplaced pods (node_of < 0) never
// violate. The plain PyTorch version is models/repair.py
// repair_check_plain; the two must agree exactly.
//
// What bounds it: bytes, barely. The count rows ([SC + G, N] int32) and
// topology rows are read once per key; at 5,000 nodes that is a few hundred
// KB, microseconds at the card's rate. The launches dominate.
//
// Design, one wrapper call = up to three launches:
//   1. (has_affinity) one block per (topology key, count row): segment sums
//      of the row over the key's domains with shared-memory atomics, into a
//      [Kk, SC + G, d_max] table (no [Kk, M, N] per-node view).
//   2. (has_ct) one block per spread row: domain counts over
//      aff_ok & key present, valid domains, n_valid, the minimum (sentinel
//      2^30, minDomains rule), then that row's bad[N] flags.
//   3. one thread per padded pod: the class's anti-affinity, holder and
//      affinity term loops against the table, and the class's spread rows.
// Domain scratch lives in shared memory up to 6,000 domains, else in a
// global scratch slice per block.
//
// Parity: int32 sums wrap as in XLA (atomicAdd on int, wrapping subtraction
// in uint32); domain ids are clipped to d_max - 1 on the gather, as in the
// JAX version.

#include <cuda_runtime.h>
#include <stdint.h>

#define RC_THREADS 256

struct RepairCheckArgs {
  int Pb, N, Kk, SC, G, RNm, EAm, RAm, Ct, d_max, has_affinity, has_ct, dom_in_smem;
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
  // outputs [Pb]
  uint8_t* v_rn;
  uint8_t* v_ea;
  uint8_t* v_ra;
  uint8_t* v_ct;
  // scratch: domain table [Kk * (SC + G) * d_max], spread flags [Ct * N],
  // and (when the domains do not fit shared memory) [blocks * 2 * d_max]
  int* dom_tab;
  uint8_t* bad;
  int* dom_scratch;
};

__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// ---- 1. domain sums of every count row under every key -------------------

__global__ void rc_dom_sums(const RepairCheckArgs a) {
  extern __shared__ int smem[];
  const int M = a.SC + a.G, d_max = a.d_max, N = a.N;
  const int k = blockIdx.x / M, m = blockIdx.x % M;
  int* dom = a.dom_in_smem ? smem : a.dom_scratch + (size_t)blockIdx.x * 2 * d_max;
  const int* row = m < a.SC ? a.dyn_selcls + (size_t)m * N : a.dyn_grp + (size_t)(m - a.SC) * N;
  const int* topo = a.topo_id + (size_t)k * N;
  for (int d = threadIdx.x; d < d_max; d += blockDim.x) dom[d] = 0;
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int t = topo[n];
    if (t >= 0 && t < d_max) {
      const int v = row[n];
      if (v != 0) atomicAdd(&dom[t], v);
    }
  }
  __syncthreads();
  int* out = a.dom_tab + ((size_t)k * M + m) * d_max;
  for (int d = threadIdx.x; d < d_max; d += blockDim.x) out[d] = dom[d];
}

// ---- 2. one block per spread row -----------------------------------------

__global__ void rc_ct_rows(const RepairCheckArgs a) {
  extern __shared__ int smem[];
  __shared__ int red[2][RC_THREADS / 32];
  const int t = blockIdx.x, d_max = a.d_max, N = a.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* dc = a.dom_in_smem ? smem : a.dom_scratch + (size_t)blockIdx.x * 2 * d_max;
  int* valid = dc + d_max;
  const int tc = a.ct_class[t];
  const int act = tc >= 0;
  const int c0 = tc > 0 ? tc : 0;
  const int* trow = a.topo_id + (size_t)a.ct_key[t] * N;
  const uint8_t* arow = a.aff_ok + (size_t)c0 * N;
  const int* sel = a.dyn_selcls + (size_t)a.ct_sel[t] * N;
  for (int d = threadIdx.x; d < d_max; d += blockDim.x) {
    dc[d] = 0;
    valid[d] = 0;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int tt = trow[n];
    if (tt >= 0 && tt < d_max && arow[n]) {
      const int v = sel[n];
      if (v != 0) atomicAdd(&dc[tt], v);
      valid[tt] = 1;
    }
  }
  __syncthreads();
  int n_valid = 0, mmn = 1 << 30;
  for (int d = threadIdx.x; d < d_max; d += blockDim.x) {
    if (valid[d]) {
      n_valid += 1;
      mmn = min(mmn, dc[d]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n_valid += __shfl_down_sync(0xffffffffu, n_valid, off);
    mmn = min(mmn, __shfl_down_sync(0xffffffffu, mmn, off));
  }
  if (lane == 0) {
    red[0][warp] = n_valid;
    red[1][warp] = mmn;
  }
  __syncthreads();
  n_valid = 0;
  mmn = 1 << 30;
  for (int w = 0; w < RC_THREADS / 32; ++w) {
    n_valid += red[0][w];
    mmn = min(mmn, red[1][w]);
  }
  const int mind = a.ct_min_domains[t];
  if (mind > 0 && mind > n_valid) mmn = 0;
  if (n_valid == 0) mmn = 0;
  const int skew = a.ct_max_skew[t];
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int tt = trow[n];
    const int node_dc = tt >= 0 ? dc[min(tt, d_max - 1)] : 0;
    const int bad = tt < 0 || wsub(node_dc, mmn) > skew;
    a.bad[(size_t)t * N + n] = (uint8_t)(act && bad);
  }
}

// ---- 3. one thread per padded pod ----------------------------------------

__device__ __forceinline__ int dom_total(const RepairCheckArgs& a, int k, int m, int n) {
  const int t = a.topo_id[(size_t)k * a.N + n];
  if (t < 0) return 0;
  return a.dom_tab[((size_t)k * (a.SC + a.G) + m) * a.d_max + min(t, a.d_max - 1)];
}

__global__ void rc_pods(const RepairCheckArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.Pb) return;
  const int nd = a.node_of[i];
  const int placed = nd >= 0;
  const int n = nd > 0 ? nd : 0;
  const int c = a.cls_of[i] > 0 ? a.cls_of[i] : 0;
  const int N = a.N;
  int rn = 0, ea = 0, ra = 0, ct = 0;
  if (placed && a.has_affinity) {
    for (int j = 0; j < a.RNm; ++j) {
      const int k = a.rn_key[c * a.RNm + j];
      if (k < 0) continue;
      const int s0 = max(a.rn_sel[c * a.RNm + j], 0);
      const int other = wsub(dom_total(a, k, s0, n), a.class_matches[c * a.SC + s0]);
      if (a.topo_id[(size_t)k * N + n] >= 0 && other > 0) rn = 1;
    }
    for (int j = 0; j < a.EAm; ++j) {
      const int g = a.ea_grp[c * a.EAm + j];
      if (g < 0) continue;
      const int k = a.grp_key[g];
      const int other = wsub(dom_total(a, k, a.SC + g, n), a.class_holds[c * a.G + g]);
      if (a.topo_id[(size_t)k * N + n] >= 0 && other > 0) ea = 1;
    }
    for (int j = 0; j < a.RAm; ++j) {
      // final-state affinity counts include the pod itself
      const int k = a.ra_key[c * a.RAm + j];
      if (k < 0) continue;
      const int s0 = max(a.ra_sel[c * a.RAm + j], 0);
      if (a.topo_id[(size_t)k * N + n] < 0 || dom_total(a, k, s0, n) <= 0) ra = 1;
    }
  }
  if (placed && a.has_ct) {
    for (int t = 0; t < a.Ct; ++t)
      if (a.ct_class[t] >= 0 && a.ct_class[t] == c && a.bad[(size_t)t * N + n]) ct = 1;
  }
  a.v_rn[i] = (uint8_t)rn;
  a.v_ea[i] = (uint8_t)ea;
  a.v_ra[i] = (uint8_t)ra;
  a.v_ct[i] = (uint8_t)ct;
}

// Launch one check on `stream`; returns the first CUDA error (0 if none).
extern "C" int repair_check_launch(const RepairCheckArgs* args, void* stream_ptr) {
  const RepairCheckArgs& a = *args;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t e;
  const size_t smem = a.dom_in_smem ? (size_t)2 * a.d_max * sizeof(int) : 0;
  if (a.has_affinity) {
    rc_dom_sums<<<a.Kk * (a.SC + a.G), RC_THREADS, smem, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (a.has_ct) {
    rc_ct_rows<<<a.Ct, RC_THREADS, smem, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  rc_pods<<<(a.Pb + 127) / 128, 128, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return 0;
}

extern "C" int repair_check_args_size() { return (int)sizeof(RepairCheckArgs); }
