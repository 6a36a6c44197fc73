// What K3's cluster routes share (estep_cluster.cu, the register-lane
// route, and estep_smem.cu, the shared-memory-lane route): the tile slot
// of the reverse delete chain, the row statistics posted to CTA 0 and
// tile 0's table update from them, and the posterior-mode pick.

#pragma once

#include "band_fill_cluster.cuh"
#include "estep_warp.cuh"

namespace {

// warps a CTA of K3's cluster route at every LPT (up to 255 registers a
// thread: the warp route's row state and weights)
constexpr int kBwdClusterWarps = 8;

// a tile's slot, to every CTA: its reverse delete-chain map (c, b) over its
// lanes, its last lane's backward insert cell of this row (unshifted, NEG
// where invalid), its largest backward cell of the previous row; WIDE adds
// the previous row's posterior-mode candidate, the largest forward +
// backward match cell of its lanes (key) and the backward cell there (val)
enum { kBC, kBB, kBBiL, kBTop, kBSlot, kBKey = kBSlot, kBVal, kBSlotW };

// the 16 values of each tile's row statistics (15 and a 0), CTA 0's copy
using BwdStats = float[2][kMaxTiles][16];

// Post the tile's statistics (lane 2s holds statistic s) to CTA 0's copy
// of this row's buffer: st[buf][g] of stats of `ntiles` tiles a buffer.
__device__ __forceinline__ void post_stats(float* st, int ntiles, int buf,
                                           int g, float stat, int t,
                                           int nct) {
  if ((t & 1) == 0) {
    float* p = st + ((size_t)buf * ntiles + g) * 16 + (t >> 1);
    if (nct > 1)
      remote_store(remote_addr(p, 0), stat);
    else
      *p = stat;
  }
}

__device__ __forceinline__ void load_stats(const float* p, float (&v)[16]) {
  const auto* q4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 x = q4[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// Tile 0: one row's table update from the T tiles' statistics in buffer
// `buf` of st (stats of `ntiles` tiles a buffer): lane h takes tile h's
// (and, past 32 tiles, adds tiles h + 32, h + 64, .. in order), one
// reduce-scatter butterfly sums the lanes, and lane 2s adds statistic s
// (1 <= s <= 9) times the row's factor to its table entry and statistics
// 10-14 to sc (as the warp route's bwd_row).  key and ctxp are the row's
// key and its previous row's indel context.
__device__ __forceinline__ void bwd_table_add(const float* st, int ntiles,
                                              int buf, int T, int t,
                                              int4 key, int ctxp,
                                              const FillTables& tb,
                                              float w_pair, float* tab,
                                              float& sc) {
  float v[16];
  const float* base = st + (size_t)buf * ntiles * 16;
  if (t < T) {
    load_stats(base + (size_t)t * 16, v);
    for (int h = t + 32; h < T; h += 32) {
      float u[16];
      load_stats(base + (size_t)h * 16, u);
#pragma unroll
      for (int q = 0; q < 16; ++q) v[q] += u[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = 0.f;
  }
  const float stat = reduce_scatter16(v, t);
  const float mass = __shfl_sync(kFull, stat, 0);
  const float factor = mass > 1e-30f ? w_pair / mass : 0.f;
  const int q = t >> 1;  // the statistic this lane holds
  const int KmQ = tb.Km * tb.Q, Q = tb.Q;
  const int e_match = (q - 1) * KmQ + key.x * Q + key.y;
  const int e_ins = 4 * KmQ + key.z * Q + key.y;
  // m2m, m2i (previous context), m2d, m2e
  const int e_ik = 4 * KmQ + 4 * Q + (q < 8 ? ctxp : key.w) * 4 + (q - 6);
  const int e = q <= 4 ? e_match : (q == 5 ? e_ins : e_ik);
  const float add = stat * factor;
  if ((t & 1) == 0 && q >= 1 && q <= 9) tab[e] += add;
  sc += q < 14 ? add : stat;  // read on lanes 20, 22, .., 28 alone
}

// WIDE: of the n (key, val) candidates in the slots' lanes, the val of
// the largest key (the largest val among equal keys), every lane; NEG
// where no key is finite
template <int NS>
__device__ __forceinline__ float mode_of(const float (&v)[NS], int n, int t) {
  const float NEG = neg_big();
  const float key = t < n ? v[kBKey] : NEG;
  const float km = warp_max(key);
  if (km <= NEG / 2) return NEG;
  return warp_max(t < n && key == km ? v[kBVal] : NEG);
}

// dynamic shared memory of K3's cluster route: its count table (CTA 0,
// when smem_table) and, with kTwoFold, the tile slots of each CTA, double
// buffered, and the statistics of each of the T tiles at CTA 0
__host__ __device__ constexpr size_t bwd_table_floats(size_t E) {
  return (E + 3) / 4 * 4;  // the slots after it 16-byte aligned
}
constexpr size_t bwd_two_smem(int T) {
  return sizeof(SeamSlot<kBSlotW>) * 2 * kMaxTiles2 +
         sizeof(float) * 2 * T * 16;
}

}  // namespace
