// K1's cluster route: the banded pair-HMM score fill with one pair's band
// tiled over the warps of a thread-block cluster, for NVIDIA Hopper
// (sm_90a).
//
// It computes what the warp route (band_fill_warp.cuh) computes, on the
// same inputs and into the same [B + B*S] output, for bands too wide for
// one warp: up to 32 tiles of 32 * LPT lanes, so 16384 lanes at LPT 16.
// band_fill.cu launches it and dp/fill_v2.fill_route picks the tiling
// (CTAs a pair, warps a CTA, LPT) from the band's width alone.
//
// Why.  The block route gives a pair one block with the band row in
// shared memory, splits all W lanes of the chunk over its threads whatever
// the pair's own extent, and passes three block barriers a row: at phase
// 4's W=4038 chunk (71 pairs; NVIDIA H100 80GB HBM3, 700 W) it filled
// 1.1e9 in-envelope cells/s, a few percent of its lane-rows being in the
// envelope.  Here:
//   - each warp runs the warp route's row code (fill_cells and fill_apply)
//     on its own tile, the row in registers, the row's inputs a row ahead;
//   - lanes past the pair's own extent (its last strip) are sentinel
//     lanes, and a tile's live rows [tlo, thi] are the union of its lanes'
//     [jlo, jhi]: in a row outside it the warp skips its token loads, its
//     cells, its steps and its replay, and posts the constant step (every
//     lane NEG);
//   - the tiles meet once a row (cluster_seam.cuh).  A tile posts its
//     delete-chain step without its first lane (warp_scan<VIT> of the
//     threads' steps), its first lane's c and cells, and its last lane's
//     match cell; after the barrier fold lane h of every warp builds tile
//     h's whole step from its slot and tile h-1's last lane, one
//     warp_scan<VIT> over the tiles gives every tile the delete value
//     entering it, and each thread replays its lanes from there.  The fold
//     also gives each tile the next tile's first lane of the row (mat and
//     ins: lane w+1 of its last lane in the next row);
//   - the pair's score and strip maxima are reduced warp by warp and then
//     over the tiles in tile order at CTA 0 (a Forward fill's end as
//     per-tile maxima and sums of exponentials).
// Every sum's association order depends only on the pair and the tiling,
// which depends only on W: reruns are bit-identical.
//
// What bounds it: per row, the longest live tile's chain (its cells, LPT
// steps, the 5-round scan) plus the barrier and the fold's 5-round scan
// over the tiles; the dead tiles cost the barrier alone.

#pragma once

#include "band_fill_warp.cuh"
#include "cluster_seam.cuh"

namespace {

// warps a CTA of K1's cluster route at LPT lanes a thread: 8 at LPT 16
// (up to 255 registers a thread), 16 below it (up to 128)
template <int LPT>
constexpr int fill_cluster_max_warps() {
  return LPT >= 16 ? 8 : 16;
}

// a tile's slot: its step without its first lane (c, b), the first lane's
// c (NEG where it is dead), match and insert cells, the last lane's match
// cell
enum { kFC, kFB, kFC0, kFMat0, kFIns0, kFMatL, kFSlot };

template <bool VIT, int LPT, bool FIRST>
__device__ __forceinline__ void fill_cluster_cells(
    RowWork<LPT>& w, const Lanes<LPT>& s, const RowIn& r, const Trans& tr,
    int j, int t, bool local, float seam_m, float seam_i, float (&post)[kFSlot],
    float& ce, float& be) {
  fill_cells<VIT, LPT, FIRST, true>(w, s, r, tr, j, t, local, seam_m, seam_i);
  float c = w.c_acc, b = w.b_acc;
  warp_scan<VIT>(c, b, t);
  ce = __shfl_up_sync(kFull, c, 1);
  be = __shfl_up_sync(kFull, b, 1);
  post[kFC] = __shfl_sync(kFull, c, 31);
  post[kFB] = __shfl_sync(kFull, b, 31);
  post[kFC0] = __shfl_sync(kFull, w.cc[0], 0);
  post[kFMat0] = __shfl_sync(kFull, w.mc[0], 0);
  post[kFIns0] = __shfl_sync(kFull, w.ic[0], 0);
  post[kFMatL] = __shfl_sync(kFull, w.mc[LPT - 1], 31);
}

template <bool VIT, int LPT>
__global__ void __launch_bounds__(fill_cluster_max_warps<LPT>() * 32, 1)
    band_fill_cluster_kernel(const int8_t* __restrict__ x_tok, int Lx,
                             const int4* __restrict__ keys, int Ly,
                             const int4* __restrict__ meta,
                             const int* __restrict__ doff, int W,
                             const int* __restrict__ seg_start,
                             const int* __restrict__ seg_width, int S,
                             FillTables tb, const float* __restrict__ trans,
                             int B, int local, float* __restrict__ out) {
  constexpr int NR = 2 + kMaxSegs;  // end maximum, Forward sum, strips
  __shared__ SeamSlot<kFSlot> slots[2][kMaxTiles];
  __shared__ float red[kMaxTiles][NR];

  const int nct = cluster_ctas();
  const int rank = cluster_rank();
  const int nw = blockDim.x >> 5;
  const int t = threadIdx.x & 31;
  const int T = nct * nw;
  const int g = rank * nw + (threadIdx.x >> 5);
  const int b = blockIdx.x / nct;
  const float NEG = neg_big();
  const int4 pm = meta[b];
  const int xlen = pm.x, ylen = __shfl_sync(kFull, min(pm.y, Ly), 0);
  const bool hq = pm.z != 0;
  const Trans tr{trans[0], trans[1], trans[2], trans[3]};
  const auto* xb = reinterpret_cast<const uint8_t*>(x_tok) + (size_t)b * Lx;
  const int xmax = Lx - 1;
  const int4* kb = keys + (size_t)b * Ly;
  const int wb = pair_extent(seg_start, seg_width, b, S, W);

  Lanes<LPT> s;
  int lo = 1 << 30, hi = -(1 << 30);
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = (g * 32 + t) * LPT + k;
    const int d = w < wb ? doff[(size_t)b * W + w] : kSentinel;
    int l = max(1, 1 - d);
    const int h = min(ylen, xlen - d);
    int span = h - l;
    if (d == kSentinel || span < 0) {  // never valid
      l = 1 << 30;
      span = 0;
    } else {
      lo = min(lo, l);
      hi = max(hi, h);
    }
    s.dg[k] = d - 1;
    s.jlo[k] = l;
    s.span[k] = span;
    s.mat[k] = NEG;
    s.ins[k] = NEG;
    s.del[k] = NEG;
    s.tok[k] = token(xb, d, xmax);
  }
  const int tlo = warp_min_i(lo), thi = warp_max_i(hi);
  // every CTA of the cluster has started before a peer's first seam_post
  // stores into its shared memory
  cluster_sync(nct);

  float seam_m = NEG, seam_i = NEG;
  RowIn r{};
  if (ylen >= 1) {
    int4 kn = kb[0];
    r = load_row(tb, hq, kn, 0);
    int ctx = indel_ctx(tb, kn);
    kn = kb[min(1, ylen - 1)];
    for (int j = 1; j <= ylen; ++j) {
      const bool lv = tlo <= j && j <= thi;
      const bool lv_next = tlo <= j + 1 && j + 1 <= thi;
      // row j+1's inputs (unconditional, as in the warp route: past the
      // read's last row they stay on its last key, whose m2e the end row
      // reads) and, where the tile is live in it, its lanes' ref tokens
      const RowIn rn = load_row(tb, hq, kn, ctx);
      const int4 kn2 = kb[min(j + 1, ylen - 1)];
      int tn[LPT];
      if (lv_next) {
#pragma unroll
        for (int k = 0; k < LPT; ++k) tn[k] = token(xb, s.dg[k] + j + 1, xmax);
      }
      RowWork<LPT> w;
      float post[kFSlot];
      float ce = 0.f, be = neg_inf();
      if (lv) {
        if (j == 1)
          fill_cluster_cells<VIT, LPT, true>(w, s, r, tr, j, t, local, seam_m,
                                             seam_i, post, ce, be);
        else
          fill_cluster_cells<VIT, LPT, false>(w, s, r, tr, j, t, local,
                                              seam_m, seam_i, post, ce, be);
      } else {
#pragma unroll
        for (int q = 0; q < kFSlot; ++q) post[q] = NEG;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          s.mat[k] = NEG;
          s.ins[k] = NEG;
          s.del[k] = NEG;
        }
      }
      const float m2d = r.m2d;
      const int buf = j & 1;
      seam_post<kFSlot>(slots, buf, g, post, t, nct);
      seam_arrive(nct);
      ctx = indel_ctx(tb, kn);
      kn = kn2;
      r = rn;
      if (lv_next) {
#pragma unroll
        for (int k = 0; k < LPT; ++k) s.tok[k] = tn[k];
      }
      seam_wait(nct);

      if (lv || lv_next) {
        // the fold: lane h builds tile h's step, its first lane's from
        // tile h-1's last lane, then the rest of its lanes'
        const int h = t;
        float v[kFSlot];
        if (h < T) {
          seam_read<kFSlot>(slots, buf, h, v);
        } else {
#pragma unroll
          for (int q = 0; q < kFSlot; ++q) v[q] = NEG;
        }
        float mprev = __shfl_up_sync(kFull, v[kFMatL], 1);
        if (h == 0) mprev = NEG;
        const float c0 = v[kFC0];
        const float b0 = c0 > NEG / 2 ? mprev + m2d : NEG;
        float fc = 0.f, fb = neg_inf();
        if (h < T) {
          fc = c0 + v[kFC];
          fb = comb<VIT>(b0 + v[kFC], v[kFB]);
        }
        warp_scan<VIT>(fc, fb, t);
        const float xe = __shfl_up_sync(kFull, fb, 1);
        const float xin = h == 0 ? neg_inf() : xe;
        const float del0 = comb<VIT>(xin + c0, b0);
        if (lv) {
          const float d0 = __shfl_sync(kFull, del0, g);
          const float x = t == 0 ? d0 : comb<VIT>(d0 + ce, be);
          fill_apply<VIT, LPT, true>(s, w, x, t);
        }
        const int n = min(g + 1, 31);
        const float nm = __shfl_sync(kFull, v[kFMat0], n);
        const float ni = __shfl_sync(kFull, v[kFIns0], n);
        seam_m = g + 1 >= T ? NEG : nm;
        seam_i = g + 1 >= T ? NEG : ni;
      }
    }
  }
  // s.mat holds row ylen's match cells, and r.m2e is row ylen's

  // end row: each tile's maximum, its Forward sum, its strip maxima, to
  // CTA 0, which reduces them in tile order
  bool at_end[LPT];
  float vmax = NEG;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    at_end[k] = ylen >= 1 && live(ylen, s.jlo[k], s.span[k]) &&
                (local || s.dg[k] + ylen == xlen - 1);
    if (at_end[k]) vmax = fmaxf(vmax, s.mat[k] + r.m2e);
  }
  float e[NR];
  e[0] = warp_max(vmax);
  e[1] = 0.f;
  if (!VIT && e[0] > NEG / 2) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (at_end[k]) sum += expf(s.mat[k] + r.m2e - e[0]);
    e[1] = warp_sum(sum);
  }
#pragma unroll
  for (int q = 0; q < kMaxSegs; ++q) {
    float sk = NEG;
    if (q < S) {
      const int s0 = seg_start[b * S + q], sw = seg_width[b * S + q];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int w = (g * 32 + t) * LPT + k;
        if (at_end[k] && w >= s0 && w < s0 + sw)
          sk = fmaxf(sk, s.mat[k] + r.m2e);
      }
    }
    e[2 + q] = warp_max(sk);
  }
  seam_gather<NR>(red, g, e, t, nct);
  if (rank == 0 && threadIdx.x < 32) {
    const float mt = t < T ? red[t][0] : NEG;
    const float m = warp_max(mt);
    float score = m;
    if (!VIT && m > NEG / 2) {
      const float part = t < T && mt > NEG / 2 ? red[t][1] * expf(mt - m) : 0.f;
      score = m + logf(warp_sum(part));
    }
    float f[kMaxSegs];
#pragma unroll
    for (int q = 0; q < kMaxSegs; ++q) f[q] = warp_max(t < T ? red[t][2 + q] : NEG);
    if (t == 0) {
      out[b] = score;
      for (int q = 0; q < S; ++q) out[(size_t)B + (size_t)b * S + q] = f[q];
    }
  }
}

// the cluster route's instantiations: LPT 4, 8 and 16 lanes a thread
template <bool VIT>
cudaError_t launch_fill_cluster(int lpt, int nct, int warps,
                                const int8_t* x_tok, int Lx, const int4* keys,
                                int Ly, const int4* meta, const int* doff,
                                int W, const int* seg_start,
                                const int* seg_width, int S,
                                const FillTables& tb, const float* trans,
                                int B, int local, float* out,
                                cudaStream_t stream) {
#define QUAFF_FILL_CLUSTER_CASE(N)                                          \
  case N:                                                                   \
    if (warps > fill_cluster_max_warps<N>()) return cudaErrorInvalidValue;  \
    return launch_cluster(band_fill_cluster_kernel<VIT, N>, B, nct, warps,  \
                          stream, x_tok, Lx, keys, Ly, meta, doff, W,       \
                          seg_start, seg_width, S, tb, trans, B, local, out);
  switch (lpt) {
    QUAFF_FILL_CLUSTER_CASE(4)
    QUAFF_FILL_CLUSTER_CASE(8)
    QUAFF_FILL_CLUSTER_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef QUAFF_FILL_CLUSTER_CASE
}

}  // namespace
