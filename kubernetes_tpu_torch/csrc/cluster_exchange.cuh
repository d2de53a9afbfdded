// The thread-block-cluster machinery shared by kernels A (greedy_scan.cu),
// E (auction_phase.cu) and F (sinkhorn.cu), sm_90a.
//
// One launch is one cluster of CS CTAs (16 where the card schedules such a
// cluster at the kernel's largest launch, else the portable 8; chosen once
// per process with cudaOccupancyMaxActiveClusters). CTAs exchange small
// partial results by st.async: a CTA stores its words straight into a slot
// of every CTA's shared memory, and each store completes its bytes on the
// receiver's mbarrier, so a receiver waits on its own mbarrier and nothing
// waits on a cluster-wide barrier (measured on an H100 by
// tools/cluster_exchange_bench.cu: ~0.5 us a round against ~0.9 us for a
// bare barrier.cluster). Slots and mbarriers are double-buffered by parity
// and re-armed (xchg_rearm) once every thread of the CTA is past the wait.
// Where the slots do not fit in shared memory, an exchange writes them to a
// global array of the cluster and the CTAs meet at barrier.cluster (release
// on arrival, acquire on wait, so the global stores are visible after it).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// the same shared-memory address in CTA `rank` of the cluster
__device__ __forceinline__ unsigned remote_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async_b32(unsigned raddr, unsigned v, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(raddr), "r"(v), "r"(rbar) : "memory");
}
__device__ __forceinline__ void st_async_b64(unsigned raddr, unsigned long long v, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
               ::"r"(raddr), "l"(v), "r"(rbar) : "memory");
}
__device__ __forceinline__ void st_async_v4(unsigned raddr, int4 v, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
               ::"r"(raddr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar) : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
// makes the initialised mbarriers visible to the other CTAs' st.async
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival plus `bytes` expected: arms the barrier's current phase
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p; }\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// Two alternating exchanges: `bar` is the shared-memory address of two
// consecutive mbarriers (use p in {0, 1} waits on bar + 8p), bytes[p] what
// one use of p delivers to each CTA (the sum over senders), `smem` whether
// the slots are in every CTA's shared memory (st.async) or in a global array
// (barrier.cluster).
struct Xchg {
  unsigned bar;
  unsigned bytes[2];
  unsigned phase;  // bit p: the phase parity the next wait on barrier p expects
  int smem;
};

// every thread, before the cluster's first barrier.cluster (thread 0 arms
// both barriers for their first use)
__device__ __forceinline__ void xchg_init(Xchg& x, unsigned bar, unsigned bytes0, unsigned bytes1,
                                          int smem) {
  x.bar = bar;
  x.bytes[0] = bytes0;
  x.bytes[1] = bytes1;
  x.phase = 0u;
  x.smem = smem;
  if (threadIdx.x == 0 && smem) {
    mbar_init(bar);
    mbar_init(bar + 8);
    mbar_init_fence();
    mbar_expect(bar, bytes0);
    mbar_expect(bar + 8, bytes1);
  }
}

// every thread of the CTA: use p's words are in this CTA's slots (or, for
// global slots, every CTA's stores before this call are visible)
__device__ __forceinline__ void xchg_wait(Xchg& x, int p) {
  if (x.smem) {
    mbar_wait(x.bar + 8 * p, (x.phase >> p) & 1u);
    x.phase ^= 1u << p;
  } else {
    cg::this_cluster().sync();
  }
}

// after a __syncthreads that every thread reaches past xchg_wait(x, p) and
// its last read of the use's slots: arm barrier p for its next use
__device__ __forceinline__ void xchg_rearm(const Xchg& x, int p) {
  if (x.smem && threadIdx.x == 0) mbar_expect(x.bar + 8 * p, x.bytes[p]);
}

static inline cudaLaunchConfig_t cluster_config(int cs, int threads, int smem, cudaStream_t stream,
                                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// 16 CTAs where the card can hold such a cluster of `kernel` at its largest
// launch (`threads` threads and `smem` bytes of dynamic shared memory each),
// else the portable 8. Sets the kernel's shared-memory and non-portable
// cluster attributes. Returns the size, or 0 with the CUDA error in *err.
template <typename Kernel>
static int choose_cluster_size(Kernel kernel, int threads, int smem, int* err) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) {
    *err = (int)e;
    return 0;
  }
  const int sizes[2] = {16, 8};
  for (int k = 0; k < 2; ++k) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(sizes[k], threads, smem, 0, attr);
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, (const void*)kernel, &cfg);
    if (e == cudaSuccess && n_clusters >= 1) return sizes[k];
    cudaGetLastError();  // a refused query leaves no sticky error
  }
  *err = e != cudaSuccess ? (int)e : (int)cudaErrorUnsupportedLimit;
  return 0;
}
