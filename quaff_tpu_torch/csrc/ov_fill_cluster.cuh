// K4's cluster route: the banded read-vs-read overlap Viterbi score fill
// with one pair's band tiled over the warps of a thread-block cluster, for
// NVIDIA Hopper (sm_90a).
//
// It computes what the warp route (ov_fill_warp.cuh) computes, on the same
// inputs and into the same [B + B*S] output, for bands too wide for one
// warp: up to 32 tiles of 32 * LPT lanes, so 8192 lanes at LPT 8.
// ov_fill.cu launches it and dp/ov_fill.ov_route picks the tiling (CTAs a
// pair, warps a CTA, LPT) from the band's width alone.  The recurrence is
// the one at the top of ov_fill.cu.
//
// Why.  One block a pair, the band row in shared memory, left most of the
// card idle on a wide chunk (18 pairs of 8063 lanes: 18 blocks on 132
// SMs), and each SM issue-bound on dead work: every lane-row ran three
// log-add-exps of its delete chain, live or not, around four block
// barriers.  Here:
//   - each warp runs the warp route's row code (ov_row_cells and
//     ov_row_apply) on its own tile, the row in registers, the row's
//     inputs loaded a row ahead;
//   - a tile's lanes are live in rows [tlo, thi] (the union of its lanes'
//     windows, computed once); in a row outside it the warp skips its
//     loads, its emission, its cells, its composes and its replay, and
//     posts the constant map (every lane NEG).  A tile past the pair's own
//     lane extent is dead in every row;
//   - the tiles meet once a row (cluster_seam.cuh).  A tile posts its
//     delete-chain map without its first lane (the warp's triple scan),
//     its first lane's step (c, and m2d at gap order 1) and cells, and its
//     last lane's cells.  After the barrier, fold lane h of every warp
//     builds tile h's whole map from its slot and tile h-1's last lane,
//     and one warp_scan3 over the tiles gives every tile the delete value
//     entering it; the thread then applies the within-tile scan to it.
//     The same fold gives each tile the next tile's first lane (its
//     previous-row mat, ins and del: lane w+1 of the tile's last lane), in
//     the same arithmetic order as that tile's own, so the two agree bit
//     for bit;
//   - the pair's end and strip maxima are warp maxima gathered to CTA 0.
// The association order of every sum depends only on the pair and the
// tiling, which depends only on W: reruns are bit-identical.
//
// What bounds it: per row, the longest live tile's dependent chain (its
// cells, LPT - 1 composes, a 5-round triple scan), then the barrier and
// the fold's scan over the tiles (log2 of their number in rounds); the
// dead tiles cost the barrier alone.

#pragma once

#include "cluster_seam.cuh"
#include "ov_fill_warp.cuh"

namespace {

// warps a CTA of the cluster route at LPT lanes a thread: 8 at LPT 8 (up
// to 255 registers a thread), 16 below it (up to 128)
template <int LPT>
constexpr int ov_cluster_max_warps() {
  return LPT >= 8 ? 8 : 16;
}

// a tile's slot: its map without its first lane (c, k, b), the first
// lane's c (NEG where it is dead) and m2d, its match and insert cells, and
// the last lane's match and insert cells
enum { kOvC, kOvK, kOvB, kOvC0, kOvM2d0, kOvMat0, kOvIns0, kOvMatL, kOvInsL,
       kOvSlot };

template <bool IK, int LPT>
__global__ void __launch_bounds__(ov_cluster_max_warps<LPT>() * 32, 1)
    ov_fill_cluster_kernel(const float* __restrict__ bank, int L,
                           const int4* __restrict__ meta,
                           const int* __restrict__ doff, int W,
                           const int* __restrict__ seg_start,
                           const int* __restrict__ seg_width, int S,
                           const float2* __restrict__ ins_xy,
                           const float* __restrict__ trans, int B,
                           float* __restrict__ out) {
  constexpr int C = IK ? 7 : 5;
  constexpr int NR = 1 + kMaxSegs;  // the end maximum, the strips'
  __shared__ SeamSlot<kOvSlot> slots[2][kMaxTiles];
  __shared__ float red[kMaxTiles][NR];

  const int nct = cluster_ctas();
  const int rank = cluster_rank();
  const int nw = blockDim.x >> 5;
  const int t = threadIdx.x & 31;
  const int T = nct * nw;                       // tiles
  const int g = rank * nw + (threadIdx.x >> 5);  // this warp's tile
  const int pb = blockIdx.x / nct;
  const float NEG = neg_big();
  const int4 m0 = meta[2 * pb], m1 = meta[2 * pb + 1];
  const int xlen = m0.z, ylen = m0.w;
  // uniform over the warp for the compiler (see ov_fill_warp_kernel)
  const int joff = __shfl_sync(kFull, m1.x, 0);
  const int nrows = __shfl_sync(kFull, m1.y, 0);
  const float* xb = bank + (size_t)m0.x * C * L;
  const float* yb = bank + (size_t)m0.y * C * L;
  const OvTrans tr{trans[0], trans[1], trans[2], trans[3], trans[4],
                   trans[6], trans[7], trans[8]};
  const int wb = pair_extent(seg_start, seg_width, pb, S, W);

  // the tile's lanes, and its live rows: the union of its lanes' windows
  OvLanes<LPT> s;
  int lo = 1 << 30, hi = -(1 << 30);
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = (g * 32 + t) * LPT + k;
    s.dm1[k] = (w < wb ? doff[(size_t)pb * W + w] : kSentinel) - 1;
    s.mat[k] = NEG;
    s.ins[k] = NEG;
    s.del[k] = NEG;
    s.endw[k] = NEG;
    const int l = max(joff + 1, -s.dm1[k]);
    const int h = min(min(joff + nrows, ylen), xlen - 1 - s.dm1[k]);
    if (l <= h) {
      lo = min(lo, l);
      hi = max(hi, h);
    }
  }
  const int tlo = warp_min_i(lo), thi = warp_max_i(hi);
  // every CTA of the cluster has started before a peer's first seam_post
  // stores into its shared memory
  cluster_sync(nct);

  // thread 31's lane w+1 of the previous row: the next tile's first lane
  float seam_m = NEG, seam_i = NEG, seam_d = NEG;
  OvRowIn<IK, LPT> r;
  if (tlo <= joff + 1 && joff + 1 <= thi)
    ov_row_in<IK, LPT>(r, ov_row_loads<IK, LPT>(s, xb, yb, L, joff + 1), s,
                       joff + 1);
  for (int jj = 1; jj <= nrows; ++jj) {
    const int j = joff + jj;  // true row
    const bool live = tlo <= j && j <= thi;
    const bool live_next = tlo <= j + 1 && j + 1 <= thi && jj < nrows;
    OvRowLoads<IK, LPT> ld;
    if (live_next) ld = ov_row_loads<IK, LPT>(s, xb, yb, L, j + 1);

    OvRowWork<LPT> w;
    float post[kOvSlot];
    float ce = 0.f, ke = neg_inf(), be = neg_inf();  // the lanes before t's
    if (live) {
      ov_row_cells<IK, LPT, true>(w, s, r, tr, j, xlen, ylen, t, seam_m,
                                  seam_i, seam_d);
      float c = w.pc[LPT - 1], k = w.pk[LPT - 1], b = w.pb[LPT - 1];
      warp_scan3(c, k, b, t);
      ce = __shfl_up_sync(kFull, c, 1);
      ke = __shfl_up_sync(kFull, k, 1);
      be = __shfl_up_sync(kFull, b, 1);
      post[kOvC] = __shfl_sync(kFull, c, 31);
      post[kOvK] = __shfl_sync(kFull, k, 31);
      post[kOvB] = __shfl_sync(kFull, b, 31);
      const float m2d0 = IK ? r.sx[0] + r.yo : tr.m2d;
      post[kOvC0] = __shfl_sync(kFull, w.v[0] ? tr.d2d : NEG, 0);
      post[kOvM2d0] = __shfl_sync(kFull, m2d0, 0);
      post[kOvMat0] = __shfl_sync(kFull, w.mc[0], 0);
      post[kOvIns0] = __shfl_sync(kFull, w.ic[0], 0);
      post[kOvMatL] = __shfl_sync(kFull, w.mc[LPT - 1], 31);
      post[kOvInsL] = __shfl_sync(kFull, w.ic[LPT - 1], 31);
    } else {
      // every lane NEG: the map sends any value to NEG
#pragma unroll
      for (int q = 0; q < kOvSlot; ++q) post[q] = NEG;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        s.mat[k] = NEG;
        s.ins[k] = NEG;
        s.del[k] = NEG;
      }
    }
    const int buf = jj & 1;
    seam_post<kOvSlot>(slots, buf, g, post, t, nct);
    seam_arrive(nct);
    // row j+1's emission while the other tiles arrive (r is not read
    // again in row j)
    if (live_next) ov_row_in<IK, LPT>(r, ld, s, j + 1);
    seam_wait(nct);

    if (live || live_next) {
      // the fold: lane h builds tile h's map, first its first lane's step
      // from tile h-1's last lane, then the rest of its lanes
      const int h = t;
      float v[kOvSlot];
      if (h < T) {
        seam_read<kOvSlot>(slots, buf, h, v);
      } else {
#pragma unroll
        for (int q = 0; q < kOvSlot; ++q) v[q] = NEG;
      }
      float mprev = __shfl_up_sync(kFull, v[kOvMatL], 1);
      float iprev = __shfl_up_sync(kFull, v[kOvInsL], 1);
      if (h == 0) {
        mprev = NEG;
        iprev = NEG;
      }
      const bool v0 = v[kOvC0] > NEG / 2;
      const float c0 = v[kOvC0];
      const float k0 = v0 ? iprev + tr.d2i : NEG;
      const float b0 = v0 ? mprev + v[kOvM2d0] : NEG;
      float fc = 0.f, fk = neg_inf(), fb = neg_inf();
      if (h < T) {
        fc = c0;
        fk = k0;
        fb = b0;
        compose(fc, fk, fb, v[kOvC], v[kOvK], v[kOvB]);
      }
      warp_scan3(fc, fk, fb, t, T);
      const float xk = __shfl_up_sync(kFull, fk, 1);
      const float xbv = __shfl_up_sync(kFull, fb, 1);
      const float xin = h == 0 ? neg_inf() : fmaxf(xk, xbv);
      // tile h's first lane's delete cell
      const float del0 = fmaxf(lse(xin + c0, k0), b0);

      if (live) {
        const float d0 = __shfl_sync(kFull, del0, g);
        const float x = t == 0 ? d0 : fmaxf(lse(d0 + ce, ke), be);
        ov_row_apply<LPT>(s, w, x, j, xlen, ylen);
      }
      const int n = min(g + 1, 31);
      const float nm = __shfl_sync(kFull, v[kOvMat0], n);
      const float ni = __shfl_sync(kFull, v[kOvIns0], n);
      const float nd = __shfl_sync(kFull, del0, n);
      const bool last = g + 1 >= T;
      seam_m = last ? NEG : nm;
      seam_i = last ? NEG : ni;
      seam_d = last ? NEG : nd;
    }
  }

  // the pair's end score and the per-strip end maxima: each tile's
  // maxima to CTA 0, which reduces them in tile order
  float e[NR];
  float vmax = NEG;
#pragma unroll
  for (int k = 0; k < LPT; ++k) vmax = fmaxf(vmax, s.endw[k]);
  e[0] = ov_warp_max(vmax);
#pragma unroll
  for (int q = 0; q < kMaxSegs; ++q) {
    float sk = NEG;
    if (q < S) {
      const int s0 = seg_start[pb * S + q], sw = seg_width[pb * S + q];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int w = (g * 32 + t) * LPT + k;
        if (w >= s0 && w < s0 + sw) sk = fmaxf(sk, s.endw[k]);
      }
    }
    e[1 + q] = ov_warp_max(sk);
  }
  seam_gather<NR>(red, g, e, t, nct);
  if (rank == 0 && threadIdx.x < 32) {
    float f[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) f[q] = ov_warp_max(t < T ? red[t][q] : NEG);
    if (t == 0) {
      const float2 iv = ins_xy[pb];
      out[pb] = f[0] <= NEG / 2 ? neg_inf() : (f[0] + iv.x) + iv.y;
      for (int q = 0; q < S; ++q)
        out[(size_t)B + (size_t)pb * S + q] =
            f[1 + q] <= NEG / 2 ? neg_inf() : f[1 + q];
    }
  }
}

// the cluster route's instantiations: LPT 2, 4 and 8 lanes a thread
template <bool IK>
cudaError_t launch_ov_cluster(int lpt, int nct, int warps, const float* bank,
                              int L, const int4* meta, const int* doff, int W,
                              const int* seg_start, const int* seg_width,
                              int S, const float2* ins_xy, const float* trans,
                              int B, float* out, cudaStream_t stream) {
#define QUAFF_OV_CLUSTER_CASE(N)                                             \
  case N:                                                                    \
    if (warps > ov_cluster_max_warps<N>()) return cudaErrorInvalidValue;     \
    return launch_cluster(ov_fill_cluster_kernel<IK, N>, B, nct, warps,      \
                          stream, bank, L, meta, doff, W, seg_start,         \
                          seg_width, S, ins_xy, trans, B, out);
  switch (lpt) {
    QUAFF_OV_CLUSTER_CASE(2)
    QUAFF_OV_CLUSTER_CASE(4)
    QUAFF_OV_CLUSTER_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef QUAFF_OV_CLUSTER_CASE
}

}  // namespace
