// What the shared-memory cluster routes ("smem routes") of K1
// (band_fill_smem.cuh) and K2 (estep_smem.cu) share, for NVIDIA Hopper
// (sm_90a): the row slots of the two-level fold, the fold itself, the
// global tier's slab check and the launch.
//
// A smem route tiles one pair's band over the warps of a thread-block
// cluster of up to kMaxClusterCtas CTAs of up to kSmemMaxWarps warps: warp
// wi of CTA `rank` is tile g = rank * nw + wi, and its 32 threads each own
// a run of `lpt` consecutive lanes in the CTA's dynamic shared memory.
// Once a row the tiles meet (smem_meet):
//   - each tile posts its slot (RowSlot: its delete-chain map without its
//     first lane (c, b), that lane's c (NEG where it is invalid), match
//     and insert cells, its last lane's match cell and its largest cell
//     of the row) to its own CTA; after a block barrier every warp folds
//     its CTA's tiles (fold_cta: lane h takes tile h, one warp scan), and
//     warp 0 posts the CTA's slot, the composite of its tiles with its
//     first tile's first lane apart, to every CTA of the cluster
//     (distributed shared memory);
//   - after the row's one cluster barrier every warp folds the CTAs'
//     slots (fold_ctas: lane q takes CTA q) and each tile takes the delete
//     cell entering its first lane, the next tile's first match and
//     insert cells (NEG past the last tile) and the row's largest cell.
// The slots are double buffered by row parity: a row's slot is written
// only after every warp of the cluster has passed the previous row's
// barriers, by which time each has read the slots of two rows ago.
//
// T is the cells' type: float (K1) or double (K2's float64 cells); VIT the
// Viterbi max, else the log-add-exp (comb).  Each composition's order
// depends only on the tiling, so reruns are bit-identical.

#pragma once

#include "band_fill.cuh"
#include "cluster_seam.cuh"

namespace {

// warps a CTA of the smem routes (128 registers a thread)
constexpr int kSmemMaxWarps = 16;

// a tile's (or, at level 2, a CTA's) slot: its delete-chain map without
// its first lane (c, b), the first lane's c, match and insert cells, the
// last lane's match cell, its largest cell of the row; 8 words, 16-byte
// stores
enum { kRC, kRB, kRC0, kRM0, kRI0, kRML, kRTop, kRWords = 8 };

template <typename T>
struct __align__(16) RowSlot {
  T v[kRWords];
};

// a CTA's slots: its own tiles', and every CTA's (a copy in each CTA)
template <typename T>
struct RowSlots {
  RowSlot<T> tiles[2][kSmemMaxWarps];
  RowSlot<T> ctas[2][kMaxClusterCtas];
};

template <typename T>
__device__ __forceinline__ T warp_max_t(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = vmax2(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ void remote_store2d(uint32_t addr, double x,
                                               double y) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};" ::"r"(addr),
               "d"(x), "d"(y)
               : "memory");
}

// a slot's words to the shared memory of another CTA at `addr`
__device__ __forceinline__ void remote_store_slot(uint32_t addr,
                                                  const float (&v)[kRWords]) {
  remote_store4(addr, make_float4(v[0], v[1], v[2], v[3]));
  remote_store4(addr + 16u, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void remote_store_slot(
    uint32_t addr, const double (&v)[kRWords]) {
#pragma unroll
  for (int q = 0; q < kRWords / 2; ++q)
    remote_store2d(addr + 16u * q, v[2 * q], v[2 * q + 1]);
}

// `v` as slot `h` of buffer `buf` in every CTA of the cluster: thread r
// writes CTA r's copy (a plain store where the cluster is one CTA)
template <typename T>
__device__ __forceinline__ void post_cta_slot(
    RowSlot<T> (*slots)[kMaxClusterCtas], int buf, int h,
    const T (&v)[kRWords], int t, int nct) {
  if (t < nct) {
    if (nct > 1) {
      remote_store_slot(remote_addr(&slots[buf][h], t), v);
    } else {
#pragma unroll
      for (int q = 0; q < kRWords; ++q) slots[buf][h].v[q] = v[q];
    }
  }
}

template <typename T>
__device__ __forceinline__ void read_slot(const RowSlot<T>& s,
                                          T (&v)[kRWords]) {
#pragma unroll
  for (int q = 0; q < kRWords; ++q) v[q] = s.v[q];
}

// level 1, after the block barrier: lane h takes the CTA's tile h (of nw)
// and builds its step, tile 0's without its first lane (which joins at
// level 2); one warp scan leaves in (fc, fb) the composite from tile 0's
// second lane through tile h, in (c0, b0) tile h's first lane's step and
// in v tile h's slot; cpost is the CTA's slot.
template <bool VIT, typename T>
__device__ __forceinline__ void fold_cta(const RowSlot<T>* lslots, int nw,
                                         T m2d, int t, T (&v)[kRWords],
                                         T& fc, T& fb, T& c0, T& b0,
                                         T (&cpost)[kRWords]) {
  const T NEG = (T)neg_big();
  if (t < nw) {
    read_slot(lslots[t], v);
  } else {
#pragma unroll
    for (int q = 0; q < kRWords; ++q) v[q] = NEG;
  }
  const T mprev = __shfl_up_sync(kFull, v[kRML], 1);
  c0 = v[kRC0];
  b0 = c0 > NEG / 2 ? mprev + m2d : NEG;
  fc = T(0);
  fb = (T)neg_inf();
  if (t == 0) {
    fc = v[kRC];
    fb = v[kRB];
  } else if (t < nw) {
    fc = c0 + v[kRC];
    fb = comb<VIT>(b0 + v[kRC], v[kRB]);
  }
  warp_scan<VIT>(fc, fb, t);
  cpost[kRC] = __shfl_sync(kFull, fc, nw - 1);
  cpost[kRB] = __shfl_sync(kFull, fb, nw - 1);
  cpost[kRC0] = __shfl_sync(kFull, v[kRC0], 0);
  cpost[kRM0] = __shfl_sync(kFull, v[kRM0], 0);
  cpost[kRI0] = __shfl_sync(kFull, v[kRI0], 0);
  cpost[kRML] = __shfl_sync(kFull, v[kRML], nw - 1);
  cpost[kRTop] = warp_max_t(t < nw ? v[kRTop] : NEG);
  cpost[kRWords - 1] = T(0);
}

// level 2, after the cluster barrier: lane q takes CTA q's slot (of nct),
// builds its whole step, its first lane's from CTA q-1's last lane, one
// warp scan composes them; lane q returns CTA q's first lane's delete
// cell, v CTA q's slot
template <bool VIT, typename T>
__device__ __forceinline__ T fold_ctas(const RowSlot<T>* slots, int nct,
                                       T m2d, int t, T (&v)[kRWords]) {
  const T NEG = (T)neg_big();
  if (t < nct) {
    read_slot(slots[t], v);
  } else {
#pragma unroll
    for (int q = 0; q < kRWords; ++q) v[q] = NEG;
  }
  T mprev = __shfl_up_sync(kFull, v[kRML], 1);
  if (t == 0) mprev = NEG;
  const T c0 = v[kRC0];
  const T b0 = c0 > NEG / 2 ? mprev + m2d : NEG;
  T fc = T(0), fb = (T)neg_inf();
  if (t < nct) {
    fc = c0 + v[kRC];
    fb = comb<VIT>(b0 + v[kRC], v[kRB]);
  }
  warp_scan<VIT>(fc, fb, t);
  const T xe = __shfl_up_sync(kFull, fb, 1);
  const T xin = t == 0 ? (T)neg_inf() : xe;
  return comb<VIT>(xin + c0, b0);
}

// what a tile takes from a row's meeting
template <typename T>
struct RowMeet {
  T d0;      // the delete cell of the tile's first lane
  T nm, ni;  // the next tile's first lane's match and insert cells
  T top;     // the largest of the tiles' kRTop (NEG where none is valid)
};

// Row j's meeting of every tile of the cluster (the header above): `post`
// is the tile's slot (every thread holds it), buf the row's parity, m2d
// the row's match-to-delete; `between` runs between the cluster barrier's
// arrival and its wait (the next row's loads).
template <bool VIT, typename T, typename Between>
__device__ __forceinline__ RowMeet<T> smem_meet(RowSlots<T>& s, int buf,
                                                const T (&post)[kRWords],
                                                T m2d, int t, int wi, int nw,
                                                int rank, int nct,
                                                Between&& between) {
  const T NEG = (T)neg_big();
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < kRWords; ++q) s.tiles[buf][wi].v[q] = post[q];
  }
  __syncthreads();
  // level 1: every warp folds its CTA's tiles; warp 0 posts the CTA's slot
  // to every CTA
  T v1[kRWords], cpost[kRWords], fc, fb, tc0, tb0;
  fold_cta<VIT>(s.tiles[buf], nw, m2d, t, v1, fc, fb, tc0, tb0, cpost);
  if (wi == 0) post_cta_slot(s.ctas, buf, rank, cpost, t, nct);
  const T pfc = __shfl_sync(kFull, fc, max(wi - 1, 0));
  const T pfb = __shfl_sync(kFull, fb, max(wi - 1, 0));
  const T c0w = __shfl_sync(kFull, tc0, wi);
  const T b0w = __shfl_sync(kFull, tb0, wi);
  const T nm_l = __shfl_sync(kFull, v1[kRM0], min(wi + 1, 31));
  const T ni_l = __shfl_sync(kFull, v1[kRI0], min(wi + 1, 31));
  seam_arrive(nct);
  between();
  seam_wait(nct);

  // level 2: the CTAs' slots; the delete cell entering the CTA's first
  // lane, then the tile's through the CTA's tiles before it
  T v2[kRWords];
  const T del0 = fold_ctas<VIT>(s.ctas[buf], nct, m2d, t, v2);
  RowMeet<T> m;
  m.top = warp_max_t(t < nct ? v2[kRTop] : NEG);
  const T dc = __shfl_sync(kFull, del0, rank);
  m.d0 = wi == 0 ? dc : comb<VIT>(comb<VIT>(dc + pfc, pfb) + c0w, b0w);
  const int n = min(rank + 1, 31);
  const T cm = __shfl_sync(kFull, v2[kRM0], n);
  const T cn = __shfl_sync(kFull, v2[kRI0], n);
  const bool last = rank + 1 >= nct;
  m.nm = wi + 1 < nw ? nm_l : (last ? NEG : cm);
  m.ni = wi + 1 < nw ? ni_l : (last ? NEG : cn);
  return m;
}

// a tiling's run, bytes a CTA: its lanes times the kernel's bytes a lane
inline size_t run_bytes(int lpt, int warps, size_t lane_bytes) {
  return (size_t)lpt * warps * 32 * lane_bytes;
}

// the global tier's slab (null: the shared tier) must hold every CTA's run
// of every pair
inline bool slab_ok(const void* slab, long long slab_bytes, int B, int nct,
                    int lpt, int warps, size_t lane_bytes) {
  return slab == nullptr ||
         (slab_bytes >= 0 &&
          (size_t)slab_bytes >=
              (size_t)B * nct * run_bytes(lpt, warps, lane_bytes));
}

// The launch of a smem kernel: the tiling's checks, the opt-in to its
// dynamic shared memory and to clusters past 8 CTAs (launch_cluster), the
// card's refusal of the cluster shape returned as an error.
template <typename... KArgs, typename... Args>
cudaError_t launch_smem(void (*kernel)(KArgs...), int B, int nct, int warps,
                        size_t smem, cudaStream_t stream, Args... args) {
  if (nct < 1 || nct > kMaxClusterCtas || warps < 1 || warps > kSmemMaxWarps)
    return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess && smem > (size_t)optin) e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  return launch_cluster(kernel, B, nct, warps, smem, stream, true, args...);
}

}  // namespace
