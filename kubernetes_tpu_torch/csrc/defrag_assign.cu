// Kernel I: the defrag assignment, a sequential best-fit (sm_90a).
//
// Replaces: kubernetes_tpu/models/defrag.py:99 defrag_assign. The plain
// PyTorch version is models/defrag.py defrag_assign_plain.
//
//   for each victim k in drain order, with (free, headroom) carried:
//     fits[n] = all_r(free[n,r] >= v_req[k,r]) && headroom[n] > 0 && target_ok[n]
//     key[n]  = fits[n] ? sum_r(free[n,r] - v_req[k,r]) : 2^30   (int32, wrapping)
//     tgt     = argmin_n key[n], the lowest index on ties
//     if key[tgt] < 2^30 && v_valid[k]: out[k] = tgt, free[tgt] -= v_req[k],
//                                       headroom[tgt] -= 1
//     else out[k] = -1 (nothing changes, not even at the argmin's index 0)
//
// What bounds it: neither bytes nor operations. The victims form one
// dependency chain (each sees what its predecessors consumed), while the
// bytes (~130 KB at the main path's 8,192 slots x R 3) and the operations
// take about a microsecond of the card's rates. The earlier design ran a
// block-wide argmin over every slot for every victim (~2.4 us each). Yet
// between two victims only one slot changes, the target of the last
// placement, and the main path's victims mostly share one request.
//
// Design: ONE persistent block of 1,024 threads walks all victims in one
// launch, over a tournament tree of packed keys (ord(key) << 32 | n: ord
// flips the sign bit so the unsigned order is the signed one, and the
// smallest packed key is the argmin with the lowest index on ties).
//   * The carried state lives in dynamic shared memory, column-major with
//     each column padded to a multiple of 4 slots (free_s[r * stride + n],
//     then head_s[n]), when it fits beside the victim stage; else in a
//     global scratch copy with the same layout. target_ok folds into the
//     carried headroom (0 where the node is not a target): such a node never
//     fits and is never placed on. A lane reads 4 consecutive slots of a
//     column with one 16-byte load.
//   * The tree: at most DA_L0 = 128 leaves, each the minimum over a group of
//     128 x q slots (one quad of 4 slots a lane of a warp, q quads; q = 1 up
//     to 16,384 slots), and their minimum, the root. Warp 0 holds the leaves
//     in registers (lane l the leaves l, l + 32, l + 64, l + 96), so the
//     root is two redux.sync over them. A key is a pure function of (slot
//     state, request), so the tree is exact for the request it was built for
//     as long as the state changes only where a leaf is recomputed.
//   * A valid victim whose request differs from the tree's rebuilds it: the
//     whole block computes the leaves (a lane's minimum over its quads, then
//     the warp's by two __reduce_min_sync), one block barrier, warp 0 loads
//     them.
//   * A valid victim with the tree's request takes the root. If it places,
//     warp 0 updates the target's state; the target's leaf is recomputed by
//     warp 0 when the next valid victim has the same request (a rebuild
//     makes that moot), in the same pass as that victim's root (the minimum
//     over the other leaves and the stale leaf's slots: two independent
//     warp minima), with no block barrier. If it does not place, nothing
//     changed, and every following victim with the same request reads -1
//     from the same root.
//   * A pad victim (v_valid false) gets -1 and changes nothing.
//   * Thread 0 counts the rebuilds and the leaf updates and writes them to
//     a.counts at the end (the schedule, read by chip_smoke.py).
//   * Victims are staged in shared memory DA_VCHUNK at a time. Every thread
//     walks every victim and takes the same rebuild decisions; warps 1-31 run
//     ahead to the next rebuild's barrier while warp 0 places.
//
// Parity with XLA: the waste sum is done in uint32 and read as int32 (XLA
// wraps, and the sentinel test then reads the wrapped value); nodes that do
// not fit take part in the argmin with the 2^30 sentinel, as in JAX; the
// comparisons are signed, so negative free compares as JAX's does; pad
// slots (target_ok false) and pad victims (v_valid false) change nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define DA_THREADS 1024
#define DA_WARPS (DA_THREADS / 32)
#define DA_MAX_R 32
#define DA_BIG (1 << 30)
#define DA_EPL 4                   // leaves a lane of warp 0 holds
#define DA_L0 (32 * DA_EPL)        // leaves at most
#define DA_VCHUNK 256              // victims staged in shared memory at a time
// dynamic shared memory a block may take: the H100's 227 KiB, less the
// static arrays below and a margin
#define DA_SMEM_MAX (227 * 1024 - 4096)

struct DefragArgs {
  int n_slots, v_max, R, use_smem, smem_bytes;
  const int* free;                 // [n_slots, R]
  const int* headroom;             // [n_slots]
  const unsigned char* target_ok;  // [n_slots] (torch.bool)
  const int* v_req;                // [v_max, R]
  const unsigned char* v_valid;    // [v_max] (torch.bool)
  int* out;                        // [v_max]
  int* scratch;                    // [(R + 1) * stride] when !use_smem
  int* counts;                     // [2] out: tree rebuilds, leaf updates
};

// a column's slots, padded to a multiple of 4
__host__ __device__ inline int da_stride(int n_slots) { return (n_slots + 3) & ~3; }
// quads (4 slots) a lane takes in a leaf's group: enough for at most DA_L0
// leaves
__host__ __device__ inline int da_quads(int n_slots) {
  const int q = (n_slots + 128 * DA_L0 - 1) / (128 * DA_L0);
  return q < 1 ? 1 : q;
}
__host__ __device__ inline int da_group(int n_slots) { return 128 * da_quads(n_slots); }

// dynamic shared memory of the layout [victim stage][state if in smem]
__host__ __device__ inline long long stage_bytes(int R) {
  return ((long long)DA_VCHUNK * R * 4 + DA_VCHUNK + 15) / 16 * 16;
}
__host__ __device__ inline long long smem_need(int n_slots, int R, int use_smem) {
  return stage_bytes(R) + (use_smem ? (long long)da_stride(n_slots) * (R + 1) * 4 : 0);
}

// a victim's request: in registers when R is known at compile time
template <int RT>
struct Req {
  int v[RT > 0 ? RT : 1];
  const int* p;  // RT == 0: the request in shared memory
  __device__ __forceinline__ void load(const int* src) {
    p = src;
#pragma unroll
    for (int r = 0; r < (RT > 0 ? RT : 0); ++r) v[r] = src[r];
  }
  __device__ __forceinline__ int operator[](int r) const {
    if constexpr (RT > 0) return v[r];
    else return p[r];
  }
};

// slots n0 .. n0 + 3 against request vr: this lane's packed minimum folded
// into (best, bn) (strict: the lowest index keeps a tie; a slot past ns
// never counts)
template <int RT>
__device__ __forceinline__ void quad_min(const int* state, int stride, int ns, int R,
                                         const Req<RT>& vr, int n0, unsigned& best, int& bn) {
  const int* head = state + (size_t)R * stride;
  const int4 h = *(const int4*)(head + n0);
  bool fit[4] = {h.x > 0, h.y > 0, h.z > 0, h.w > 0};
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < (RT > 0 ? RT : DA_MAX_R); ++r) {
    if (RT == 0 && r >= R) break;
    const int4 f = *(const int4*)(state + (size_t)r * stride + n0);
    const int q = vr[r];
    fit[0] = fit[0] && f.x >= q;
    fit[1] = fit[1] && f.y >= q;
    fit[2] = fit[2] && f.z >= q;
    fit[3] = fit[3] && f.w >= q;
    w[0] += (unsigned)f.x - (unsigned)q;
    w[1] += (unsigned)f.y - (unsigned)q;
    w[2] += (unsigned)f.z - (unsigned)q;
    w[3] += (unsigned)f.w - (unsigned)q;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const unsigned o = (unsigned)(fit[s] ? (int)w[s] : DA_BIG) ^ 0x80000000u;
    if (n0 + s < ns && (bn < 0 || o < best)) {
      best = o;
      bn = n0 + s;
    }
  }
}

__device__ __forceinline__ unsigned long long pack(unsigned best, int bn) {
  return bn < 0 ? ~0ull : ((unsigned long long)best << 32) | (unsigned)bn;
}

// this lane's minimum packed key over its slots of leaf g: g * group + j *
// 128 + 4 * lane + s, j < quads, s < 4 (~0 for a lane with none: a real
// key, even 0xffffffff << 32 | n, is below it)
template <int RT>
__device__ __forceinline__ unsigned long long lane_min(const int* state, int stride, int ns, int R,
                                                       const Req<RT>& vr, int g, int quads,
                                                       int lane) {
  unsigned best = 0xffffffffu;
  int bn = -1;
  if (quads == 1) {  // one quad: straight-line code, its loads in flight with a neighbour's
    const int n0 = g * 128 + 4 * lane;
    if (n0 < ns) quad_min<RT>(state, stride, ns, R, vr, n0, best, bn);
    return pack(best, bn);
  }
  const int g0 = g * 128 * quads;
#pragma unroll 1
  for (int j = 0; j < quads; ++j) {
    const int n0 = g0 + j * 128 + 4 * lane;
    if (n0 >= ns) break;
    quad_min<RT>(state, stride, ns, R, vr, n0, best, bn);
  }
  return pack(best, bn);
}

// the warp's minimum of a 64-bit value (all lanes; two redux.sync)
__device__ __forceinline__ unsigned long long warp_min64(unsigned long long v) {
  const unsigned hi = __reduce_min_sync(0xffffffffu, (unsigned)(v >> 32));
  const unsigned lo = __reduce_min_sync(0xffffffffu, (unsigned)(v >> 32) == hi ? (unsigned)v : ~0u);
  return ((unsigned long long)hi << 32) | lo;
}

// RT > 0: R known at compile time (unrolled); RT == 0: R at run time
template <int RT>
__global__ void __launch_bounds__(DA_THREADS, 1) defrag_assign_kernel(const DefragArgs a) {
  extern __shared__ __align__(16) unsigned char dyn_s[];
  __shared__ unsigned long long leaf_s[DA_L0];  // a rebuild's leaves, for warp 0
  __shared__ int treq_s[DA_MAX_R];             // RT == 0: the tree's request
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ns = a.n_slots, stride = da_stride(ns), quads = da_quads(ns);
  const int n_leaves = (ns + 128 * quads - 1) / (128 * quads);
  const int R = RT > 0 ? RT : a.R;
  int* vreq_s = (int*)dyn_s;
  unsigned char* vval_s = (unsigned char*)(vreq_s + DA_VCHUNK * R);
  int* state = a.use_smem ? (int*)(dyn_s + stage_bytes(R)) : a.scratch;
  int* head_s = state + (size_t)R * stride;

  for (int n = tid; n < stride; n += DA_THREADS) {
    const bool real = n < ns;
    for (int r = 0; r < R; ++r) state[(size_t)r * stride + n] = real ? a.free[(size_t)n * R + r] : 0;
    head_s[n] = real && a.target_ok[n] ? a.headroom[n] : 0;
  }

  bool have_tree = false;  // every thread takes the same decisions
  Req<RT> treq;            // the tree's request, in every thread's registers
  treq.p = treq_s;         // (RT == 0: in shared memory)
  unsigned long long leaf[DA_EPL];  // warp 0: leaves lane + 32 e
  int pending = -1;                 // warp 0: a placed target whose leaf is stale
  int rebuilds = 0, leaf_updates = 0;  // thread 0's count of the schedule

  for (int k = 0; k < a.v_max; ++k) {
    const int kc = k % DA_VCHUNK;
    if (kc == 0) {  // stage the next victims (warp 0 is done with these)
      __syncthreads();
      const int cnt = min(DA_VCHUNK, a.v_max - k);
      for (int i = tid; i < cnt * R; i += DA_THREADS) vreq_s[i] = a.v_req[(size_t)k * R + i];
      for (int i = tid; i < cnt; i += DA_THREADS) vval_s[i] = a.v_valid[k + i];
      __syncthreads();
    }
    if (!vval_s[kc]) {  // a pad: -1, nothing changes
      if (tid == 0) a.out[k] = -1;
      continue;
    }
    const int* vsrc = vreq_s + kc * R;
    Req<RT> vr;  // (indexed by constants only: a register array)
    vr.load(vsrc);
    unsigned diff = have_tree ? 0u : 1u;
#pragma unroll
    for (int r = 0; r < (RT > 0 ? RT : DA_MAX_R); ++r) {
      if (RT == 0 && r >= R) break;
      diff |= (unsigned)(vr[r] ^ treq[r]);
    }

    if (diff) {
      // rebuild for this request: warp 0's state updates are visible past
      // this barrier, and nobody reads treq_s or leaf_s until the next
      __syncthreads();
      if (RT == 0 && tid < R) treq_s[tid] = vsrc[tid];
      treq = vr;
      treq.p = treq_s;
      // two leaves a warp at a time (their loads in flight together)
      for (int g = warp; g < n_leaves; g += 2 * DA_WARPS) {
        const int g2 = g + DA_WARPS;
        const unsigned long long m1 = lane_min<RT>(state, stride, ns, R, vr, g, quads, lane);
        const unsigned long long m2 =
            g2 < n_leaves ? lane_min<RT>(state, stride, ns, R, vr, g2, quads, lane) : ~0ull;
        const unsigned long long v1 = warp_min64(m1), v2 = warp_min64(m2);
        if (lane == 0) {
          leaf_s[g] = v1;
          if (g2 < n_leaves) leaf_s[g2] = v2;
        }
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int e = 0; e < DA_EPL; ++e) {
          const int g = e * 32 + lane;
          leaf[e] = g < n_leaves ? leaf_s[g] : ~0ull;
        }
      }
      have_tree = true;
      pending = -1;
      rebuilds += 1;
    }
    if (warp != 0) continue;

    // ---- warp 0: the stale leaf and the root in one pass, then place ----
    // (the root is the minimum over the other leaves and the stale leaf's
    // slots, so the two reductions run side by side)
    const int g = pending < 0 ? -1 : (quads == 1 ? pending >> 7 : pending / (128 * quads));
    unsigned long long cand = ~0ull;
#pragma unroll
    for (int e = 0; e < DA_EPL; ++e)
      if (!(e == (g >> 5) && lane == (g & 31))) cand = leaf[e] < cand ? leaf[e] : cand;
    unsigned long long root;
    if (g >= 0) {
      const unsigned long long mine = lane_min<RT>(state, stride, ns, R, vr, g, quads, lane);
      cand = mine < cand ? mine : cand;
      const unsigned long long gv = warp_min64(mine);
      root = warp_min64(cand);
#pragma unroll
      for (int e = 0; e < DA_EPL; ++e)
        if (e == (g >> 5) && lane == (g & 31)) leaf[e] = gv;
      pending = -1;
      leaf_updates += 1;
    } else {
      root = warp_min64(cand);
    }
    const unsigned hi = (unsigned)(root >> 32), lo = (unsigned)root;
    const int key = (int)(hi ^ 0x80000000u);
    const int tgt = (int)lo;
    if (key < DA_BIG) {
      if (lane < R) {
        int* f = &state[(size_t)lane * stride + tgt];
        *f = (int)((unsigned)*f - (unsigned)vsrc[lane]);
      }
      if (lane == 0) {
        head_s[tgt] -= 1;
        a.out[k] = tgt;
      }
      pending = tgt;
      __syncwarp();
    } else if (lane == 0) {
      a.out[k] = -1;
    }
  }
  if (tid == 0) {
    a.counts[0] = rebuilds;
    a.counts[1] = leaf_updates;
  }
}

// the shared-memory attribute is set once per instantiation, at the most
// any layout takes (DA_SMEM_MAX), not before every launch
template <int RT>
static int launch_r(const DefragArgs* args, cudaStream_t stream) {
  static int attr_err = -1;
  if (attr_err < 0)
    attr_err = (int)cudaFuncSetAttribute(defrag_assign_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DA_SMEM_MAX);
  if (attr_err) return attr_err;
  const size_t smem = (size_t)args->smem_bytes;
  if (smem > DA_SMEM_MAX) return (int)cudaErrorInvalidValue;
  defrag_assign_kernel<RT><<<1, DA_THREADS, smem, stream>>>(*args);
  return (int)cudaGetLastError();
}

// 1 when the carried state of n_slots x R fits the block's shared memory
// beside the victim stage, 0 when it goes to the global scratch (the
// wrapper allocates (R + 1) * defrag_assign_stride(n_slots) int32)
extern "C" int defrag_assign_uses_smem(int n_slots, int R) {
  return smem_need(n_slots, R, 1) <= DA_SMEM_MAX ? 1 : 0;
}

extern "C" int defrag_assign_stride(int n_slots) { return da_stride(n_slots); }

// the dynamic shared memory of that layout
extern "C" long long defrag_assign_smem_bytes(int n_slots, int R, int use_smem) {
  return smem_need(n_slots, R, use_smem);
}

// Launch on `stream`; *launched counts the kernels launched. Returns the
// first CUDA error of the attribute call or the launch. The wrapper checks
// shapes, 1 <= R <= DA_MAX_R, v_max >= 1 and the layout.
extern "C" int defrag_assign_launch(const DefragArgs* args, void* stream, int* launched) {
  *launched = 0;
  if (args->n_slots < 1 || args->R < 1 || args->R > DA_MAX_R || args->v_max < 1 ||
      defrag_assign_uses_smem(args->n_slots, args->R) < args->use_smem ||
      args->smem_bytes != smem_need(args->n_slots, args->R, args->use_smem) ||
      (!args->use_smem && !args->scratch) || !args->counts)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (args->R) {
    case 1: err = launch_r<1>(args, s); break;
    case 2: err = launch_r<2>(args, s); break;
    case 3: err = launch_r<3>(args, s); break;
    case 4: err = launch_r<4>(args, s); break;
    default: err = launch_r<0>(args, s); break;
  }
  if (err == 0) *launched = 1;
  return err;
}

extern "C" int defrag_assign_args_size() { return (int)sizeof(DefragArgs); }
extern "C" int defrag_assign_max_r() { return DA_MAX_R; }
// slots under one leaf of the tree at n_slots
extern "C" int defrag_assign_group(int n_slots) { return da_group(n_slots); }
