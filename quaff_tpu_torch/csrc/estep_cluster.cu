// K2's and K3's cluster routes: the training E-step's forward fill with
// stored rows and its backward sweep with posterior counts, for bands too
// wide for one warp, one pair's band tiled over the warps of a
// thread-block cluster, for NVIDIA Hopper (sm_90a).
//
// With estep.cu, replaces the TPU kernels
// quaff_tpu/dp/pallas_counts.py::_fwd_store (kernel _fwd_kernel) and
// ::_bwd_counts (kernel _bwd_kernel); the plain PyTorch versions are
// quaff_tpu_torch/dp/estep.py::fwd_store_reference and
// ::bwd_counts_reference.  dp/estep.estep_route sends a band here past each
// kernel's warp route (ESTEP_WARP_MAX_LANES) up to its
// ESTEP_CLUSTER_MAX_LANES (K2: ESTEP_WIDE_LANES; its wider bands take the
// smem route, estep_smem.cu), with the tiling (CTAs a pair, warps a CTA,
// LPT) of its ESTEP_CLUSTER_TABLE row and the mode dp/estep.cluster_mode
// picks (K2 one fold alone); the same inputs and outputs as the warp and
// smem routes, so any route's K2 store feeds any route's K3.
//
// Why.  One block a pair (the former block routes) kept the row in shared
// memory or global scratch and passed 7 (K2) and 9 (K3) block barriers a
// row over all W lanes of the chunk whatever the pair's own extent; one
// warp a pair holds at most 512 lanes.  A training chunk holding one read
// whose band is a few thousand lanes wide put every pair of the chunk
// past the warp routes.
//
// K2's cluster route is K1's cluster fill with STORE set
// (band_fill_cluster_kernel<false, true, LPT>, band_fill_cluster.cuh): the
// row scale rides on the next row's seam exchange, the header there says
// how.
//
// K3's cluster route, bwd_counts_cluster_kernel<LPT> below, runs the warp
// route's row (estep_warp.cuh) on each tile: warp g of CTA r (of nct) is
// tile r * warps + g, its 32 threads own 32 * LPT consecutive lanes, the
// carried backward state and the diagonals in registers, row j-1's stored
// cells read as row j starts.  The tiles meet once a row at one cluster
// barrier (cluster_seam.cuh), and every cross-tile value rides on it:
//   - the reverse delete chain bd[w] = lse(bd[w+1] + d2d, d2m + me'[w] +
//     bm'[w]) needs nothing of another lane but the chain itself, so each
//     tile composes its lanes' maps from its high end (one warp scan) and
//     posts the total; after the barrier fold lane h takes tile h's map and
//     one scan over the tiles from the last down gives every tile the value
//     entering it from the right (its last lane's bd[w+1] too);
//   - the tile's first lane reads the previous tile's last backward insert
//     cell of the row before (posted with that row), and the stored
//     forward cells of the neighbouring tiles' edge lanes straight from
//     memory;
//   - the row scale: the row's largest backward cell is known only after
//     the fold, so each tile's maximum rides on the next row's exchange,
//     and row j is filled from row j+1's unshifted cells, then less row
//     j+1's shift once the barrier brings it (the carried cells stay within
//     one row's shift of 0; the posterior weights use row j's cells with
//     the backward offset that includes that shift, as the warp route's);
//   - the 15 row statistics: each tile reduces its lanes' by the warp
//     route's reduce-scatter butterfly and posts them, with the next row, to
//     CTA 0 alone; there tile 0's lane h takes tile h's vector and one more
//     butterfly sums the tiles, after which tile 0 adds the row's 4 + 1 + 4
//     table entries and its 5 per-pair sums, each entry always by the same
//     lane, in row order, a row late.  One more exchange after row 1 brings
//     its statistics.
// MODE (cluster_seam.cuh) as K2's: kOneFold up to ESTEP_WIDE_LANES and
// 32 tiles; past either kTwoFold, the reverse chain's maps relative to
// each thread's largest opening term and the row shifted at its posterior
// mode (each tile's largest forward + backward match cell and its
// backward cell there ride on the slot with its maximum, estep.cu's
// mode_shift over the tiles), and the two-level fold: each CTA folds its
// tiles' maps from its
// last tile down after a block barrier, warp 0 posts the CTA's map, its
// last tile's insert cell, maximum and mode to every CTA, the CTAs fold
// from the last down at the barrier, and each tile enters from its CTA's
// value through the CTA's tiles after it; the statistics of up to 128
// tiles go to CTA 0, tile 0's lane h summing tiles h, h + 32, .. in order
// before the butterfly.  Past 8 CTAs (up to 16) the launch opts in to a
// non-portable cluster size.
// No float atomics: every sum's association order depends only on the
// pair and the tiling (a function of W), so reruns are bit-identical.  The
// count table lives in CTA 0's shared memory while kWarpsPerBlock of them
// would fit the warp route's kTableSmemBytes (the same choice the warp
// route makes), else in the pair's row of partial.  A tile dead in a row
// (no lane of it valid there: outside its tlo/thi, as in K1's) skips its
// loads, its cells and its weights and posts the chain's reset.
//
// What bounds it: as K1's cluster route, per row the longest live tile's
// chain (its cells, the scan, ~7 exps a lane for the weights, the
// butterfly) plus the barrier and the fold's scans; the bytes (the 12 a
// cell K2 stores and K3 reads) are an order of magnitude below.

#include "estep_cluster.cuh"

namespace {

template <int LPT, int MODE = kOneFold>
__global__ void __launch_bounds__(kBwdClusterWarps * 32, 1)
    bwd_counts_cluster_kernel(
        const int8_t* __restrict__ x_tok, int Lx,
        const int4* __restrict__ keys, int Ly,
        const int4* __restrict__ meta,
        const int* __restrict__ doff, int W, FillTables tb,
        const float* __restrict__ trans,
        const float* __restrict__ wrow,   // [2][B]: pair weight, fwd normaliser
        const float* __restrict__ rows,   // K2's [3][B][Ly][W], relative
        const double* __restrict__ offs,  // K2's row offsets [B][Ly]
        int B, int local, int smem_table,
        float* __restrict__ partial,  // [B][E]
        float* __restrict__ d_sc) {   // [5][B]
  constexpr bool TWO = MODE == kTwoFold;
  constexpr bool WIDE = TWO;  // the wide arithmetic comes with the two levels
  constexpr int NS = WIDE ? kBSlotW : kBSlot;  // a slot's floats
  extern __shared__ float tab_smem[];
  __shared__ SeamSlot<NS> slots[2][kMaxTiles];
  __shared__ __align__(16) BwdStats stats;

  const int nct = cluster_ctas();
  const int rank = cluster_rank();
  const int nw = blockDim.x >> 5;
  const int t = threadIdx.x & 31;
  const int T = nct * nw;
  const int wi = threadIdx.x >> 5;  // the tile's warp in its CTA
  const int g = rank * nw + wi;
  const int b = blockIdx.x / nct;
  const float NEG = neg_big();
  const int4 pm = meta[b];
  const int E = 4 * tb.Km * tb.Q + 4 * tb.Q + 4 * tb.n_ik;
  // kTwoFold: this CTA's tile slots (indexed by tile) and CTA 0's tile
  // statistics, after the count table
  float* two = tab_smem + (smem_table ? bwd_table_floats(E) : 0);
  auto* lslots = reinterpret_cast<SeamSlot<NS>(*)[kMaxTiles2]>(two);
  float* stats2 = two + 2 * kMaxTiles2 * 4 * SeamSlot<NS>::kWords;
  float* st = TWO ? stats2 : &stats[0][0][0];
  const int ntiles = TWO ? T : kMaxTiles;
  const int nslots = TWO ? nct : T;  // the slots the fold reads
  const size_t plane = (size_t)B * Ly * W;
  BwdPair P;
  P.tb = tb;
  P.tr = Trans{trans[0], trans[1], trans[2], trans[3]};
  P.fm = rows + (size_t)b * Ly * W;
  P.fi = P.fm + plane;
  P.fd = P.fm + 2 * plane;
  P.ob = offs + (size_t)b * Ly;
  P.kb = keys + (size_t)b * Ly;
  P.xb = reinterpret_cast<const uint8_t*>(x_tok) + (size_t)b * Lx;
  P.fnorm = wrow[B + b];
  P.w_pair = wrow[b];
  P.xlen = pm.x;
  // the read length from lane 0 (a trip count uniform over the warp)
  P.ylen = __shfl_sync(kFull, min(pm.y, Ly), 0);
  P.xmax = Lx - 1;
  P.W = W;
  P.t = t;
  P.hq = pm.z != 0;
  P.local = local != 0;
  const int ylen = P.ylen;
  const int base = g * 32 * LPT;  // the tile's first lane
  const int wl = W - base;        // lanes of the band from it on
  float* tab = smem_table ? tab_smem : partial + (size_t)b * E;  // tile 0's

  if (g == 0) {
    for (int e = t; e < E; e += 32) tab[e] = 0.f;
    __syncwarp();
  }
  BwdLanes<LPT> s;
  int lo = 1 << 30, hi = -(1 << 30);
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = base + t * LPT + k;
    const int d = w < W ? doff[(size_t)b * W + w] : kSentinel;
    const int l = max(1, 1 - d), h = min(ylen, P.xlen - d);
    if (d != kSentinel && h >= l) {
      lo = min(lo, l);
      hi = max(hi, h);
    }
    s.dg[k] = d - 1;
    s.fmx[k] = NEG;  // row ylen+1: no backward match cell, emission 0
    s.bi[k] = NEG;
    s.fm_c[k] = NEG;
    s.fd_c[k] = NEG;
  }
  // the tile's live rows: a row outside them has no valid lane of it
  const int tlo = warp_min_i(lo), thi = warp_max_i(hi);
  // every CTA of the cluster has started before a peer's first post
  // stores into its shared memory
  cluster_sync(nct);

  BwdCarry c;
  c.sc = 0.f;
  if (ylen >= 1) {
    // row ylen's stored forward match and delete cells (the previous
    // tile's last lane's for thread 0)
    float fm_cl = NEG, fd_cl = NEG;
    if (tlo <= ylen && ylen <= thi) {
      const size_t row = (size_t)(ylen - 1) * W;
      load_row_cells<LPT>(s.fm_c, P.fm + row + base, t, wl);
      load_row_cells<LPT>(s.fd_c, P.fd + row + base, t, wl);
      if (t == 0 && base >= 1) {
        fm_cl = __ldg(P.fm + row + base - 1);
        fd_cl = __ldg(P.fd + row + base - 1);
      }
    }
    c.kc = P.kb[ylen - 1];
    c.kn = P.kb[max(ylen - 2, 0)];
    c.o_c = P.ob[ylen - 1];
    c.offb = 0.0;
    c.ie_n = 0.f;
    float bi_in = NEG;  // thread 0: row j+1's insert cell of lane base - 1
    float top = NEG;    // the tile's largest cell of row j+1
    float mkey = NEG;   // WIDE: the tile's posterior-mode candidate of
    float mval = NEG;   // row j+1
    float stat = 0.f;   // lane 2s: the tile's statistic s of row j+1
    int4 key_p = {};    // row j+1's key and previous context (tile 0)
    int ctxp_p = 0;
    for (int j = ylen; j >= 1; --j) {
      const bool lv = tlo <= j && j <= thi;
      const bool end = j == ylen;
      // loads: row j's inputs (its key came a row ago), the key of row j-2,
      // where the tile is live the tokens of row j, and where it is live in
      // row j or j-1 row j-1's stored cells (the edge lanes of the
      // neighbouring tiles too) and its offset (row 0: none, offset 0)
      const BwdRowIn r = load_bwd_row(P.tb, P.hq, c.kc, j >= 2 ? c.kn.w : 0);
      const int4 kq = P.kb[max(j - 3, 0)];
      int tok[LPT];
      float fm_p[LPT], fi_p[LPT], fd_p[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        tok[k] = lv ? token(P.xb, s.dg[k] + j, P.xmax) : 0;
        fm_p[k] = fi_p[k] = fd_p[k] = NEG;
      }
      float fm_ph = NEG, fi_ph = NEG, fm_pl = NEG, fd_pl = NEG;
      const double o_p = j >= 2 ? P.ob[j - 2] : 0.0;
      if (j >= 2 && tlo <= j && j <= thi + 1) {
        const size_t row = (size_t)(j - 2) * W;
        load_row_cells<LPT>(fm_p, P.fm + row + base, t, wl);
        load_row_cells<LPT>(fi_p, P.fi + row + base, t, wl);
        load_row_cells<LPT>(fd_p, P.fd + row + base, t, wl);
        const int wh = base + 32 * LPT;  // the next tile's first lane
        if (t == 31 && wh < W) {
          fm_ph = __ldg(P.fm + row + wh);
          fi_ph = __ldg(P.fi + row + wh);
        }
        if (t == 0 && base >= 1) {
          fm_pl = __ldg(P.fm + row + base - 1);
          fd_pl = __ldg(P.fd + row + base - 1);
        }
      }

      // before the barrier: the backward insert cells (no delete term)
      // and the tile's reverse delete-chain map, from row j+1's unshifted
      // cells (WIDE: relative to the thread's largest opening term r)
      bool v[LPT];
#pragma unroll
      for (int k = 0; k < LPT; ++k) v[k] = lv && in_ref(s.dg[k], j, P.xlen);
      float bik[LPT], pc[LPT], pb[LPT];
      float c_acc = 0.f, b_acc = neg_inf(), bi_l = NEG, r0 = 0.f;
      float post[NS];
      if (lv) {
        bi_l = __shfl_up_sync(kFull, s.bi[LPT - 1], 1);
        if (t == 0) bi_l = bi_in;
#pragma unroll
        for (int k = 0; k < LPT; ++k)
          bik[k] = lse2(P.tr.i2m + s.fmx[k],
                        P.tr.i2i + c.ie_n + lane_lo(s.bi, k, bi_l));
        if constexpr (WIDE) {
          float bmax = NEG;
#pragma unroll
          for (int k = 0; k < LPT; ++k)
            if (v[k]) bmax = fmaxf(bmax, P.tr.d2m + s.fmx[k]);
          r0 = wide_chain_ref(bmax);
        }
#pragma unroll
        for (int q = 0; q < LPT; ++q) {
          const int k = LPT - 1 - q;
          const float cv = v[k] ? P.tr.d2d : NEG;
          const float bv = v[k] ? P.tr.d2m + s.fmx[k] - r0 : NEG;
          if (q == 0) {
            pc[k] = cv;
            pb[k] = bv;
          } else {
            const int n = k + 1 < LPT ? k + 1 : k;
            pb[k] = lse2(pb[n] + cv, bv);
            pc[k] = pc[n] + cv;
          }
        }
        c_acc = pc[0];
        b_acc = WIDE ? r0 + pb[0] : pb[0];
        scan_maps<false>(c_acc, b_acc, t, 32);
        post[kBC] = __shfl_sync(kFull, c_acc, 0);
        post[kBB] = __shfl_sync(kFull, b_acc, 0);
        post[kBBiL] =
            __shfl_sync(kFull, v[LPT - 1] ? bik[LPT - 1] : NEG, 31);
      } else {
        post[kBC] = NEG;
        post[kBB] = NEG;
        post[kBBiL] = NEG;
      }
      post[kBTop] = top;
      if constexpr (WIDE) {
        post[kBKey] = mkey;
        post[kBVal] = mval;
      }
      const int buf = j & 1;
      // kTwoFold: the composite of the tiles after this one in its CTA
      float sfc = 0.f, sfb = neg_inf();
      if constexpr (TWO) {
        seam_post_local<NS>(lslots, buf, g, post, t);
        if (!end) post_stats(st, ntiles, buf, g, stat, t, nct);
        __syncthreads();
        if (wi == 0 || lv) {
          // lane h takes the CTA's tile h; composed from its last tile
          // down, lane h holds tiles h .. nw - 1
          float lv_[NS], cpost[NS];
          if (t < nw) {
            seam_read<NS>(lslots, buf, rank * nw + t, lv_);
          } else {
#pragma unroll
            for (int q = 0; q < NS; ++q) lv_[q] = NEG;
          }
          float lc = 0.f, lb = neg_inf();
          if (t < nw) {
            lc = lv_[kBC];
            lb = lv_[kBB];
          }
          scan_maps<false>(lc, lb, t, 32);
          sfc = __shfl_sync(kFull, lc, min(wi + 1, 31));
          sfb = __shfl_sync(kFull, lb, min(wi + 1, 31));
          if (wi == 0) {
            cpost[kBC] = __shfl_sync(kFull, lc, 0);
            cpost[kBB] = __shfl_sync(kFull, lb, 0);
            cpost[kBBiL] = __shfl_sync(kFull, lv_[kBBiL], nw - 1);
            cpost[kBTop] = warp_max(t < nw ? lv_[kBTop] : NEG);
            if constexpr (WIDE) {
              const float key = t < nw ? lv_[kBKey] : NEG;
              const float km = warp_max(key);
              cpost[kBKey] = km;
              cpost[kBVal] = warp_max(t < nw && key == km ? lv_[kBVal] : NEG);
            }
            seam_post<NS>(slots, buf, rank, cpost, t, nct);
          }
        }
      } else {
        seam_post<NS>(slots, buf, g, post, t, nct);
        if (!end) post_stats(st, ntiles, buf, g, stat, t, nct);
      }
      seam_arrive(nct);
      seam_wait(nct);

      // row j+1's shift (the largest of the tiles' maxima; WIDE: the
      // backward cell at the row's posterior mode), row j's backward
      // offset, and the previous tile's last insert cell of row j (less
      // the shift) for row j-1
      float sv[NS];
      float tm = NEG;
      if (t < nslots) {
        seam_read<NS>(slots, buf, t, sv);
        tm = sv[kBTop];
      } else {
#pragma unroll
        for (int q = 0; q < NS; ++q) sv[q] = NEG;
      }
      tm = warp_max(tm);
      float shift = tm > NEG / 2 ? tm : 0.f;
      if constexpr (WIDE) {
        const float mv = mode_of<NS>(sv, nslots, t);
        if (mv > NEG / 2) shift = mv;
      }
      const double offb = c.offb + shift;
      float bi_next = NEG;
      if (TWO ? (wi > 0 || rank > 0) : g > 0) {
        float pv[NS];
        if (!TWO)
          seam_read<NS>(slots, buf, g - 1, pv);
        else if (wi > 0)
          seam_read<NS>(lslots, buf, g - 1, pv);
        else
          seam_read<NS>(slots, buf, rank - 1, pv);
        bi_next = pv[kBBiL] - shift;
      }

      float top_j = NEG, stat_j = 0.f, key_j = NEG, val_j = NEG;
      if (lv) {
        // the fold: lane h holds slot h's map; composed from the last slot
        // down, lane h+1's value is the one entering slot h from the right
        // (kTwoFold: CTA h's; then the tiles after this one in its CTA)
        float fc = 0.f, fb = neg_inf();
        if (t < nslots) {
          fc = sv[kBC];
          fb = sv[kBB];
        }
        scan_maps<false>(fc, fb, t, 32);
        float xt = __shfl_down_sync(kFull, fb, 1);
        if (t == 31) xt = neg_inf();
        float x_in = __shfl_sync(kFull, xt, TWO ? rank : g);
        if (TWO && wi + 1 < nw) x_in = lse2(x_in + sfc, sfb);
        // the value entering the thread, then each lane's delete cell
        const float cn = __shfl_down_sync(kFull, c_acc, 1);
        const float bn = __shfl_down_sync(kFull, b_acc, 1);
        const float x = t == 31 ? x_in : lse2(x_in + cn, bn);
        float bd[LPT];
        const float xr = x - r0;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const float d = WIDE ? r0 + lse2(xr + pc[k], pb[k])
                               : lse2(x + pc[k], pb[k]);
          bd[k] = v[k] ? d : NEG;
        }
        float bd_r = __shfl_down_sync(kFull, bd[0], 1);
        if (t == 31) bd_r = x_in;

        // the backward match cells; row j's cells less row j+1's shift;
        // the tile's largest (WIDE: and its posterior-mode candidate)
        float bm[LPT], me[LPT], tmx = NEG, kx = NEG, vx = NEG;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const bool end_ok = end && (P.local || s.dg[k] + j == P.xlen - 1);
          const float m = lse2(lse2(end_ok ? r.m2e_c : NEG, r.m2m_c + s.fmx[k]),
                               lse2(r.m2i_c + c.ie_n + lane_lo(s.bi, k, bi_l),
                                    r.m2d_c + lane_hi(bd, k, bd_r)));
          bm[k] = m - shift;
          bik[k] -= shift;
          bd[k] = v[k] ? bd[k] - shift : NEG;
          tmx = fmaxf(tmx, v[k] ? fmaxf(bm[k], bik[k]) : NEG);
          me[k] = pick(r.e, tok[k]);
          if constexpr (WIDE) {
            const float key = v[k] && s.fm_c[k] > NEG / 2 ? s.fm_c[k] + bm[k]
                                                          : NEG;
            if (key > kx || (key == kx && bm[k] > vx)) {
              kx = key;
              vx = bm[k];
            }
          }
        }
        top_j = warp_max(tmx);
        if constexpr (WIDE) {
          key_j = warp_max(kx);
          val_j = warp_max(kx == key_j ? vx : NEG);
        }
        // row constants: forward offset of rows j and j-1 plus the
        // backward offset, minus fwd_total, in float64 once a row
        const float cc = (float)(c.o_c + offb - P.fnorm);
        const float cp = (float)(o_p + offb - P.fnorm);
        const float c0 = (float)(offb - P.fnorm);
        // row j-1's lane w+1 (the next tile's first lane from memory) and
        // row j's lane w-1 (the previous tile's last)
        float fm_pr = __shfl_down_sync(kFull, fm_p[0], 1);
        float fi_pr = __shfl_down_sync(kFull, fi_p[0], 1);
        float fm_l = __shfl_up_sync(kFull, s.fm_c[LPT - 1], 1);
        float fd_l = __shfl_up_sync(kFull, s.fd_c[LPT - 1], 1);
        if (t == 31) {
          fm_pr = fm_ph;
          fi_pr = fi_ph;
        }
        if (t == 0) {
          fm_l = fm_cl;
          fd_l = fd_cl;
        }

        // the posterior weights of the row's cells (the warp route's): an
        // invalid lane's base and insert cell are NEG, so each of its
        // weights is exp(-inf) = 0 exactly
        float acc[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[q] = 0.f;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const float base_k = v[k] ? me[k] + bm[k] : NEG;
          const float bi_v = v[k] ? bik[k] : NEG;
          const float w_m2m = post_fast(fm_p[k] + r.m2m_p + base_k, cp);
          const float w_d2m = post_fast(fd_p[k] + P.tr.d2m + base_k, cp);
          const float w_i2m = post_fast(fi_p[k] + P.tr.i2m + base_k, cp);
          float w_s2m = 0.f;
          if (j == 1) {
            const float w = post_fast(base_k, c0);
            w_s2m = P.local || s.dg[k] + j == 0 ? w : 0.f;
          }
          const float mc = w_m2m + w_d2m + w_i2m + w_s2m;
          const float w_m2i = post_fast(
              lane_hi(fm_p, k, fm_pr) + r.m2i_p + r.ins + bi_v, cp);
          const float w_i2i = post_fast(
              lane_hi(fi_p, k, fi_pr) + P.tr.i2i + r.ins + bi_v, cp);
          const float w_m2d =
              post_fast(lane_lo(s.fm_c, k, fm_l) + r.m2d_c + bd[k], cc);
          const float w_d2d =
              post_fast(lane_lo(s.fd_c, k, fd_l) + P.tr.d2d + bd[k], cc);
          acc[0] += mc + w_m2i + w_i2i;
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[1 + a] += tok[k] == a ? mc : 0.f;
          acc[5] += w_m2i + w_i2i;
          acc[6] += w_m2m;
          acc[7] += w_m2i;
          acc[8] += w_m2d;
          acc[10] += w_i2i;
          acc[11] += w_i2m;
          acc[12] += w_d2d;
          acc[13] += w_d2m;
          acc[14] += w_s2m;
        }
        if (end) {  // the end row (uniform over the cluster): m2e weights
#pragma unroll
          for (int k = 0; k < LPT; ++k) {
            const bool end_ok = P.local || s.dg[k] + j == P.xlen - 1;
            const float w = post_fast(s.fm_c[k] + r.m2e_c, cc);
            acc[9] += v[k] && end_ok ? w : 0.f;
          }
        }
        stat_j = reduce_scatter16(acc, t);
        // carry row j's cells to row j-1 (its shift comes with it)
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          s.fmx[k] = v[k] ? me[k] + bm[k] : NEG;
          s.bi[k] = v[k] ? bik[k] : NEG;
        }
      } else {
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          s.fmx[k] = NEG;
          s.bi[k] = NEG;
        }
      }
      // tile 0: row j+1's table update, from the statistics the tiles
      // posted with this row
      if (g == 0 && !end)
        bwd_table_add(st, ntiles, buf, T, t, key_p, ctxp_p, P.tb, P.w_pair,
                      tab, c.sc);
      key_p = make_int4(r.kx, r.ky, r.kz, r.ctx);
      ctxp_p = r.ctxp;
      top = top_j;
      mkey = key_j;
      mval = val_j;
      stat = stat_j;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        s.fm_c[k] = fm_p[k];
        s.fd_c[k] = fd_p[k];
      }
      fm_cl = fm_pl;
      fd_cl = fd_pl;
      bi_in = bi_next;
      c.offb = offb;
      c.ie_n = r.ins;
      c.o_c = o_p;
      c.kc = c.kn;
      c.kn = kq;
    }
    // row 1's statistics by one more exchange
    post_stats(st, ntiles, 0, g, stat, t, nct);
    cluster_sync(nct);
    if (g == 0)
      bwd_table_add(st, ntiles, 0, T, t, key_p, ctxp_p, P.tb, P.w_pair, tab,
                    c.sc);
  } else {
    cluster_sync(nct);
  }
  if (g == 0) {
    if ((t & 1) == 0 && t >= 20 && t <= 28)
      d_sc[(size_t)(t / 2 - 10) * B + b] = c.sc;
    if (smem_table) {
      __syncwarp();
      float* part = partial + (size_t)b * E;
      for (int e = t; e < E; e += 32) part[e] = tab[e];
    }
  }
}

}  // namespace

extern "C" {

// Launches K2's cluster route on `stream`: each pair's band tiled over nct
// CTAs (a thread-block cluster) of `warps` warps, lpt lanes a thread (one
// of 4, 8, 16), which must cover the band, in `mode` kOneFold
// (cluster_seam.cuh; any other mode is refused) with at most kMaxTiles
// tiles.  The same outputs as quaff_fwd_store_warp; returns the
// cudaError_t of the launch, or of the card's refusal of the cluster
// shape.
int quaff_fwd_store_cluster(const void* x_tok, int Lx, const void* keys,
                            int Ly, const void* meta, const void* doff, int W,
                            const void* seg_start, const void* seg_width,
                            int S, const void* match, const void* match_noq,
                            const void* insert, const void* insert_noq,
                            int Km, int Q, const void* ik, int n_ik,
                            const void* trans, int B, int local, int lpt,
                            int nct, int warps, int mode, void* out,
                            void* rows, void* offs, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || nct < 1 || warps < 1 || W > nct * warps * 32 * lpt ||
      S < 1 || S > kMaxSegs || n_ik < 1 || Lx < 1)
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  return (int)launch_fill_cluster<false, true>(
      lpt, nct, warps, static_cast<const int8_t*>(x_tok), Lx,
      static_cast<const int4*>(keys), Ly, static_cast<const int4*>(meta),
      static_cast<const int*>(doff), W, static_cast<const int*>(seg_start),
      static_cast<const int*>(seg_width), S, tb,
      static_cast<const float*>(trans), B, local, static_cast<float*>(out),
      static_cast<cudaStream_t>(stream), static_cast<float*>(rows),
      static_cast<double*>(offs), mode);
}

// Launches K3's cluster route on `stream` (the tiling and mode as
// quaff_fwd_store_cluster's, at most kBwdClusterWarps warps a CTA): the
// same outputs as quaff_bwd_counts_warp, no scratch.
int quaff_bwd_counts_cluster(const void* x_tok, int Lx, const void* keys,
                             int Ly, const void* meta, const void* doff,
                             int W, const void* match, const void* match_noq,
                             const void* insert, const void* insert_noq,
                             int Km, int Q, const void* ik, int n_ik,
                             const void* trans, const void* wrow,
                             const void* rows, const void* offs, int B,
                             int local, int lpt, int nct, int warps, int mode,
                             void* partial, void* d_sc, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || nct < 1 || warps < 1 || warps > kBwdClusterWarps ||
      nct * warps > (mode == kTwoFold ? kMaxTiles2 : kMaxTiles) ||
      (mode == kTwoFold && nct > kMaxClusterCtas) ||
      W > nct * warps * 32 * lpt || n_ik < 1 || Lx < 1 ||
      (mode != kOneFold && mode != kTwoFold))
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  const size_t E = (size_t)4 * Km * Q + 4 * Q + 4 * n_ik;
  // the warp route's choice of the table's home; with kTwoFold only while
  // it fits beside the tile slots and statistics under 40 KB (the static
  // arrays take the rest of the 48 KB a block has without opting in)
  const int smem_table =
      kWarpsPerBlock * E * sizeof(float) <= (size_t)kTableSmemBytes &&
      (mode != kTwoFold || bwd_table_floats(E) * sizeof(float) +
                                   bwd_two_smem(nct * warps) <= 40 * 1024);
  const size_t table = smem_table ? E * sizeof(float) : 0;
  const size_t smem =
      mode == kTwoFold
          ? (smem_table ? bwd_table_floats(E) * sizeof(float) : 0) +
                bwd_two_smem(nct * warps)
          : table;
#define QUAFF_BWD_CLUSTER_LAUNCH(N, M)                                     \
  launch_cluster(                                                          \
      bwd_counts_cluster_kernel<N, (M)>, B, nct, warps, smem,              \
      static_cast<cudaStream_t>(stream), (M) == kTwoFold,                  \
      static_cast<const int8_t*>(x_tok), Lx,                               \
      static_cast<const int4*>(keys), Ly, static_cast<const int4*>(meta),  \
      static_cast<const int*>(doff), W, tb,                                \
      static_cast<const float*>(trans), static_cast<const float*>(wrow),   \
      static_cast<const float*>(rows), static_cast<const double*>(offs),   \
      B, local, smem_table, static_cast<float*>(partial),                  \
      static_cast<float*>(d_sc))
#define QUAFF_BWD_CLUSTER_CASE(N)                                          \
  case N:                                                                  \
    if (mode == kTwoFold)                                                  \
      return (int)QUAFF_BWD_CLUSTER_LAUNCH(N, kTwoFold);                   \
    return (int)QUAFF_BWD_CLUSTER_LAUNCH(N, kOneFold);
  switch (lpt) {
    QUAFF_BWD_CLUSTER_CASE(4)
    QUAFF_BWD_CLUSTER_CASE(8)
    QUAFF_BWD_CLUSTER_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QUAFF_BWD_CLUSTER_CASE
#undef QUAFF_BWD_CLUSTER_LAUNCH
}

}  // extern "C"
