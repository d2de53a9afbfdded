// Cluster exchange microbenchmark for kernel A's argmax reduction
// (kubernetes_tpu_torch/csrc/greedy_scan.cu): one thread-block cluster of 16
// CTAs x T threads (320 and 160) runs 4,096 rounds of one 64-bit max over
// every warp of the cluster, in five ways:
//   0  a bare barrier.cluster (cluster.sync) per round, no data moved
//   1  every warp pushes its key into every CTA's slot (DSMEM stores),
//      barrier.cluster, each CTA reduces its slots locally
//   2  CTA max (one __syncthreads), barrier.cluster, every warp pulls the
//      16 CTA maxima over DSMEM
//   3  every warp pushes its key with st.async, which completes bytes on the
//      receiver's mbarrier; each CTA waits on its own mbarrier
//   4  CTA max first, then one st.async per receiving CTA (kernel A's choice)
// Prints us and SM cycles per round for each (every mode must print the same
// acc for one T: the reductions agree).
//
//   mkdir -p build/tools && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/tools/cluster_exchange_bench tools/cluster_exchange_bench.cu \
//       && build/tools/cluster_exchange_bench
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdio.h>
namespace cg = cooperative_groups;
#define MAXW 16
#define CS 16
__device__ __forceinline__ unsigned long long wmax(unsigned long long x) {
  unsigned hi = (unsigned)(x >> 32), lo = (unsigned)x;
  unsigned mhi = __reduce_max_sync(0xffffffffu, hi);
  unsigned mlo = __reduce_max_sync(0xffffffffu, hi == mhi ? lo : 0u);
  return ((unsigned long long)mhi << 32) | mlo;
}
__global__ void xk(int mode, int rounds, unsigned long long* out) {
  __shared__ unsigned long long key[2][MAXW * CS];
  __shared__ unsigned long long cta[2];
  __shared__ __align__(8) unsigned long long bar[2];
  cg::cluster_group cl = cg::this_cluster();
  const int crank = cl.block_rank(), tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  for (int j = tid; j < 2 * MAXW * CS; j += blockDim.x) (&key[0][0])[j] = 0;
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(&bar[0]);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar0 + 8 * b), "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  const unsigned tx = (unsigned)(CS * nw * 8);
  if (mode == 3 && tid == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar0), "r"(tx) : "memory");
  if (mode == 4 && tid == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar0), "r"((unsigned)(CS * 8)) : "memory");
  unsigned long long acc = 0;
  int par = 0;
  unsigned ph[2] = {0, 0};
  long long t0 = clock64();
  for (int it = 0; it < rounds; ++it) {
    unsigned long long v = ((unsigned long long)(it * 7 + crank * 131 + tid) << 20) | (unsigned)(crank * 1000 + tid);
    v = wmax(v);
    if (mode == 0) {
      cl.sync();
      acc += v;
    } else if (mode == 1) {  // push every warp's key, barrier, local read
      if (lane < CS) cl.map_shared_rank(&key[par][warp * CS + crank], lane)[0] = v;
      cl.sync();
      unsigned long long x = 0;
      for (int j = lane; j < nw * CS; j += 32) x = x > key[par][j] ? x : key[par][j];
      acc += wmax(x);
    } else if (mode == 2) {  // CTA max, barrier, pull CS values
      if (lane == 0) key[par][warp] = v;
      __syncthreads();
      if (warp == 0) { unsigned long long x = lane < nw ? key[par][lane] : 0; x = wmax(x); if (lane == 0) cta[par] = x; }
      cl.sync();
      unsigned long long x = lane < CS ? cl.map_shared_rank(&cta[par], lane)[0] : 0;
      acc += wmax(x);
    } else if (mode == 3) {  // st.async with complete_tx on the receiver's mbarrier
      if (lane < CS) {
        unsigned la = (unsigned)__cvta_generic_to_shared(&key[par][warp * CS + crank]), ra, rb;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(la), "r"(lane));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(bar0 + 8 * par), "r"(lane));
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
                     ::"r"(ra), "l"(v), "r"(rb) : "memory");
      }
      unsigned done = 0;
      while (!done)
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(bar0 + 8 * par), "r"(ph[par]) : "memory");
      ph[par] ^= 1;
      unsigned long long x = 0;
      for (int j = lane; j < nw * CS; j += 32) x = x > key[par][j] ? x : key[par][j];
      acc += wmax(x);
      __syncthreads();  // every warp has read this parity before its next expect
      if (tid == 0 && it + 2 < rounds + 2)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar0 + 8 * (par ^ 1)), "r"(tx) : "memory");
    } else if (mode == 4) {  // CTA max first (one __syncthreads), one st.async per receiver
      if (lane == 0) key[par][64 + warp] = v;
      __syncthreads();
      if (warp == 0) {
        unsigned long long x = wmax(lane < nw ? key[par][64 + lane] : 0);
        if (lane < CS) {
          unsigned la = (unsigned)__cvta_generic_to_shared(&key[par][crank]), ra, rb;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(la), "r"(lane));
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rb) : "r"(bar0 + 8 * par), "r"(lane));
          asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
                       ::"r"(ra), "l"(x), "r"(rb) : "memory");
        }
      }
      unsigned done = 0;
      while (!done)
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(bar0 + 8 * par), "r"(ph[par]) : "memory");
      ph[par] ^= 1;
      acc += wmax(lane < CS ? key[par][lane] : 0);
      __syncthreads();
      if (tid == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar0 + 8 * (par ^ 1)), "r"((unsigned)(CS * 8)) : "memory");
    }
    par ^= 1;
  }
  long long t1 = clock64();
  cl.sync();
  if (tid == 0 && crank == 0) { out[0] = acc; out[1] = t1 - t0; }
}
int main() {
  unsigned long long* d; cudaMalloc(&d, 16);
  cudaFuncSetAttribute(xk, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  const int rounds = 4096;
  for (int T : {320, 160}) for (int mode = 0; mode < 5; ++mode) for (int rep = 0; rep < 2; ++rep) {
    cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(CS); cfg.blockDim = dim3(T);
    cudaLaunchAttribute at[1]; at[0].id = cudaLaunchAttributeClusterDimension; at[0].val.clusterDim.x = CS; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
    cfg.attrs = at; cfg.numAttrs = 1;
    cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
    cudaEventRecord(e0);
    cudaError_t err = cudaLaunchKernelEx(&cfg, xk, mode, rounds, d);
    cudaEventRecord(e1); cudaError_t e2 = cudaDeviceSynchronize();
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    unsigned long long h[2]; cudaMemcpy(h, d, 16, cudaMemcpyDeviceToHost);
    printf("T %d mode %d err %d/%d  us/round %.3f  cycles/round %.0f  acc %llu\n", T, mode, (int)err, (int)e2, ms * 1e3 / rounds, (double)h[1] / rounds, h[0]);
  }
  return 0;
}
