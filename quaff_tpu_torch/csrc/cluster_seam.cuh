// The seam exchange and the cross-tile scan of the "cluster routes" of K1
// (band_fill_cluster.cuh) and K4 (ov_fill_cluster.cuh), for NVIDIA Hopper
// (sm_90a).
//
// A cluster route tiles one pair's band over the warps of a thread-block
// cluster: warp g of CTA r (of nct) is tile r * warps + g, and its 32
// threads own 32 * LPT consecutive lanes, the band row in registers, as in
// the warp routes.  Once a row the tiles meet at one cluster barrier
// (barrier.cluster.arrive.release / wait.acquire; a plain block barrier
// where the cluster is one CTA), after one cluster barrier before the first
// row, so that no CTA's shared memory is written before that CTA has
// started:
//
//   - before it, each tile posts a slot: its delete-chain map without its
//     first lane, that lane's own step and cells, and its last lane's
//     cells.  The slot is written to every CTA of the cluster (distributed
//     shared memory), so every read after the barrier is local.  The slots
//     are double buffered by row parity: a row's slot is written only after
//     every tile has passed the previous barrier, by which time every tile
//     has read the slot of two rows ago;
//   - after it, every tile folds the slots of all tiles in a fixed order
//     (fold lane h of each warp takes tile h, then one warp scan), so each
//     score depends only on the pair and the tiling, never on timing.
//
// The cluster-specific operations (rank, remote slot address, barrier)
// are the few small functions below.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// tiles a pair: the fold gives each tile one lane of a warp
constexpr int kMaxTiles = 32;

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_ctas() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}

// the shared-memory address of `p` (a __shared__ object of this CTA) in
// CTA `rank` of the cluster
__device__ __forceinline__ uint32_t remote_addr(const void* p, int rank) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void remote_store4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void remote_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

// the row's meeting, split so that work between the two halves overlaps
// the other tiles' arrival; with one CTA a block barrier at the wait
__device__ __forceinline__ void seam_arrive(int nct) {
  if (nct > 1) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void seam_wait(int nct) {
  if (nct > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  else
    __syncthreads();
}

__device__ __forceinline__ void cluster_sync(int nct) {
  seam_arrive(nct);
  seam_wait(nct);
}

// A tile's slot: NF floats in float4 words.
template <int NF>
struct SeamSlot {
  static constexpr int kWords = (NF + 3) / 4;
  float4 w[kWords];
};

// Post `v` (NF floats, every thread of the warp holding all of them) as
// tile g's slot of this row's buffer `buf` in every CTA of the cluster:
// thread r writes CTA r's copy (a plain store where the cluster is one
// CTA).
template <int NF>
__device__ __forceinline__ void seam_post(SeamSlot<NF> (*slots)[kMaxTiles],
                                          int buf, int g, const float (&v)[NF],
                                          int t, int nct) {
  if (t < nct) {
    const uint32_t a = nct > 1 ? remote_addr(&slots[buf][g], t) : 0u;
#pragma unroll
    for (int q = 0; q < SeamSlot<NF>::kWords; ++q) {
      const float4 x = make_float4(v[4 * q], 4 * q + 1 < NF ? v[4 * q + 1] : 0.f,
                                   4 * q + 2 < NF ? v[4 * q + 2] : 0.f,
                                   4 * q + 3 < NF ? v[4 * q + 3] : 0.f);
      if (nct > 1)
        remote_store4(a + 16u * q, x);
      else
        slots[buf][g].w[q] = x;
    }
  }
}

// tile h's slot of buffer `buf`, read from this CTA's copy
template <int NF>
__device__ __forceinline__ void seam_read(const SeamSlot<NF> (*slots)[kMaxTiles],
                                          int buf, int h, float (&v)[NF]) {
#pragma unroll
  for (int q = 0; q < SeamSlot<NF>::kWords; ++q) {
    const float4 x = slots[buf][h].w[q];
    v[4 * q] = x.x;
    if (4 * q + 1 < NF) v[4 * q + 1] = x.y;
    if (4 * q + 2 < NF) v[4 * q + 2] = x.z;
    if (4 * q + 3 < NF) v[4 * q + 3] = x.w;
  }
}

// The end of a pair: each tile's NR end values (maxima, or a Forward
// fill's partial sums) go to CTA 0, which reads them in tile order after
// the cluster barrier.  Every CTA passes the barrier, so none exits while
// a peer may still write its shared memory.
template <int NR>
__device__ __forceinline__ void seam_gather(float (*red)[NR], int g,
                                            const float (&v)[NR], int t,
                                            int nct) {
  if (t == 0) {
    const uint32_t a = nct > 1 ? remote_addr(&red[g][0], 0) : 0u;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (nct > 1)
        remote_store(a + 4u * q, v[q]);
      else
        red[g][q] = v[q];
    }
  }
  cluster_sync(nct);
}

// a warp's minimum and maximum of an int
__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the lanes of a pair's band that lie inside its strips (the lanes past
// them hold no envelope lane): max over strips of start + width, capped
// at W
__device__ __forceinline__ int pair_extent(const int* seg_start,
                                           const int* seg_width, int pb,
                                           int S, int W) {
  int wb = 0;
  for (int q = 0; q < S; ++q)
    wb = max(wb, seg_start[pb * S + q] + seg_width[pb * S + q]);
  return min(wb, W);
}

// The launch of `kernel` with a cluster of `nct` CTAs a pair (B pairs,
// `warps` warps a CTA, its shared memory static): `attr` holds the
// cluster's dimension.
inline cudaLaunchConfig_t cluster_config(int B, int nct, int warps,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * nct), 1, 1);
  cfg.blockDim = dim3((unsigned)(32 * warps), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nct;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches `kernel` on B pairs, a cluster of `nct` CTAs each.  A shape the
// card holds no cluster of (too many registers or too much shared memory
// for a cluster of this size) returns its error, or
// cudaErrorLaunchOutOfResources; a refused launch returns its error.
// Either is also taken off the runtime's last error, so that the next
// launch's check does not report it again.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int B, int nct,
                           int warps, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(B, nct, warps, stream, attr);
  // clusters of this shape the card holds at once (they must fit inside a
  // GPC): none means the launch could never run
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e == cudaSuccess && n < 1) e = cudaErrorLaunchOutOfResources;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace
