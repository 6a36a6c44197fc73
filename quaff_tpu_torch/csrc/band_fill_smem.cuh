// K1's shared-memory cluster route ("smem route"): the banded pair-HMM
// score fill with one pair's band spread over the CTAs of a thread-block
// cluster, every lane's row state in a run that lives in the CTA's shared
// memory (the shared tier) or, for bands past what 16 CTAs hold, in a
// per-pair slab of global memory (the global tier), for NVIDIA Hopper
// (sm_90a).
//
// band_fill_smem_kernel<GLOBAL, VIT> computes what the other routes of K1
// compute (Viterbi or Forward, local or global), on the same inputs and
// into the same [B + B*S] output: the pair scores, then the per-strip end
// maxima floored at NEG_INF.  band_fill.cu launches it
// (quaff_band_fill_smem) and dp/fill_v2.fill_route sends it every band
// past the register cluster route's widest (FILL_CLUSTER_MAX_LANES): up to
// FILL_SMEM_MAX_LANES the shared tier ("smem", the tiling of the band's
// FILL_SMEM_TABLE row), past it the global tier ("global",
// fill_v2.global_tiling: 16 CTAs of 16 warps, lanes a thread growing with
// the band), so this route takes a band of any width.
//
// Why.  The register cluster route (band_fill_cluster.cuh) holds a
// thread's lanes in registers and folds at most 32 tiles a row: 16384
// lanes at 16 lanes a thread.  Past it the former block route (deleted)
// gave a pair one SM with its row state in a global scratch row
// set, three block barriers a row and a dependent chain of global loads:
// 295.041 ms at phase 4b's `align -kmatchoff` chunk (B=8, W=22882, reads
// of 2-3 kb; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6), 8 of the card's
// 132 SMs busy, and 395.284 ms at its 132 kb chunk (B=2, W=132396).  Here:
//   - a tile is a warp of 32 threads, each owning a run of `lpt`
//     consecutive lanes (a runtime count, so no register array grows with
//     it) laid out [lane of the run][thread], so that a warp's accesses
//     fall on 32 banks of shared memory, or on consecutive words of global
//     memory (coalesced): the match, insert and delete cells of the
//     previous row and the lane's diagonal, 16 bytes a lane.  16 CTAs of
//     16 warps at 27 lanes a thread, the most a CTA's 227 KB holds, cover
//     221184 lanes.  Past that each CTA's run lives in its own part of a
//     slab the wrapper allocates, B * nct * warps * 32 * lpt lanes; a
//     thread reads and writes only its own lanes, so the slab needs no
//     fence, and one pair's slab (4.2 MB at 264400 lanes) stays in the
//     card's 50 MB L2;
//   - the tiles meet once a row through the two-level fold of
//     cluster_smem.cuh, which K2's smem route shares: the CTA's tiles
//     after one block barrier, then the CTAs after the row's one cluster
//     barrier, the slots double buffered by row parity;
//   - the row's inputs are read a row ahead (the key of row j+2 and the
//     emissions and transitions of row j+1 while row j fills), and a
//     tile outside its live rows [tlo, thi] (the union of its lanes'
//     valid rows) skips its lanes and posts the constant step;
//   - at the end each tile reduces its lanes to its end maximum, its
//     Forward sum of exponentials and its strip maxima, which go to CTA 0
//     and are reduced there in tile order.
// Cells are float32 and unscaled, as in every other route of K1 and in the
// TPU kernel.  Past kFillAbsLpt lanes a thread each thread composes and
// replays its delete chain past its first lane relative to r0, its largest
// match cell of the previous row plus m2d (near enough, and known before
// the row's lanes are filled, so the row stays one pass over them): the
// steps then add at the run's own magnitude, where at the cells' (~1e5
// nats on global bands past 131072 lanes) float32 rounds each one; that
// left a Forward fill at 27 lanes a thread 1.23 nats (1.16 of K1's
// tolerance) off the plain version on a global band of 221184 lanes
// (NVIDIA H100 80GB HBM3, 700 W).  Up to kFillAbsLpt lanes a thread (every
// band of up to 131072 lanes at its table tiling) the chain adds at the
// cells' magnitude, r0 = 0, so those bands keep their bits.  No float
// atomics: every sum's association order depends
// only on the pair and the tiling, which depends only on W, so reruns are
// bit-identical, and the two tiers give the same bits at one tiling.
//
// What bounds it: per row, the longest live tile's run (lpt lanes of
// shared- or global-memory reads and writes and ~15 operations a lane,
// the Forward fill's log-add-exps ~20 add_max steps each) plus the block
// barrier, the cluster barrier and the folds' two 5-round scans; its
// bytes and operations bound is two orders of magnitude below.

#pragma once

#include "band_fill_warp.cuh"
#include "cluster_smem.cuh"

namespace {

// each tile's end values: its maximum, its Forward sum, its strip maxima
constexpr int kFillEnds = 2 + kMaxSegs;

// bytes a lane of the run: the match, insert and delete cells of the
// previous row and the diagonal - 1
constexpr size_t kFillLaneBytes = 3 * sizeof(float) + sizeof(int);

// lanes a thread up to which the delete chain adds at the cells' magnitude
constexpr int kFillAbsLpt = 16;

// The run of each thread's lpt lanes: GLOBAL this CTA's part of `slab`,
// else the CTA's dynamic shared memory.
template <bool GLOBAL, bool VIT>
__global__ void __launch_bounds__(kSmemMaxWarps * 32, 1)
    band_fill_smem_kernel(const int8_t* __restrict__ x_tok, int Lx,
                          const int4* __restrict__ keys, int Ly,
                          const int4* __restrict__ meta,
                          const int* __restrict__ doff, int W,
                          const int* __restrict__ seg_start,
                          const int* __restrict__ seg_width, int S,
                          FillTables tb, const float* __restrict__ trans,
                          int B, int local, int lpt,
                          unsigned char* __restrict__ slab,
                          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char fill_smem[];
  __shared__ RowSlots<float> slots;
  __shared__ float ends[kMaxClusterCtas * kSmemMaxWarps][kFillEnds];

  const int NT = blockDim.x, tid = threadIdx.x;
  const int nct = cluster_ctas(), rank = cluster_rank();
  const int nw = NT >> 5, t = tid & 31, wi = tid >> 5;
  const int T = nct * nw, g = rank * nw + wi;
  const int b = blockIdx.x / nct;
  const float NEG = neg_big();
  const size_t run = (size_t)lpt * NT;
  unsigned char* lanes =
      GLOBAL ? slab + (size_t)blockIdx.x * run * kFillLaneBytes : fill_smem;
  float* Mc = reinterpret_cast<float*>(lanes);
  float* Ic = Mc + run;
  float* Dc = Ic + run;
  int* dgs = reinterpret_cast<int*>(Dc + run);
  const int4 pm = meta[b];
  const int xlen = pm.x, ylen = __shfl_sync(kFull, min(pm.y, Ly), 0);
  const bool hq = pm.z != 0;
  const Trans tr{trans[0], trans[1], trans[2], trans[3]};
  const auto* xb = reinterpret_cast<const uint8_t*>(x_tok) + (size_t)b * Lx;
  const int xmax = Lx - 1;
  const int4* kb = keys + (size_t)b * Ly;
  const int wb = pair_extent(seg_start, seg_width, b, S, W);
  const int w0 = (g * 32 + t) * lpt;  // the thread's first lane

  int lo = 1 << 30, hi = -(1 << 30);
  for (int k = 0; k < lpt; ++k) {
    const int w = w0 + k, a = k * NT + tid;
    const int d = w < wb ? doff[(size_t)b * W + w] : kSentinel;
    const int l = max(1, 1 - d), h = min(ylen, xlen - d);
    if (d != kSentinel && h >= l) {
      lo = min(lo, l);
      hi = max(hi, h);
    }
    dgs[a] = d - 1;
    Mc[a] = NEG;
    Ic[a] = NEG;
    Dc[a] = NEG;
  }
  // the tile's live rows: a row outside them has no valid lane of it
  const int tlo = warp_min_i(lo), thi = warp_max_i(hi);
  // every CTA of the cluster has started before a peer's first post
  // stores into its shared memory
  cluster_sync(nct);

  float M0 = NEG, I0 = NEG;          // the thread's first lane, last row
  float seam_m = NEG, seam_i = NEG;  // thread 31: the next tile's
  float top = NEG;  // the thread's largest match cell of its last live row
  const bool rel = lpt > kFillAbsLpt;
  RowIn r{};
  if (ylen >= 1) {
    int4 kn = kb[0];
    r = load_row(tb, hq, kn, 0);
    int ctx = indel_ctx(tb, kn);
    kn = kb[min(1, ylen - 1)];
    for (int j = 1; j <= ylen; ++j) {
      const bool lv = tlo <= j && j <= thi;
      // row j+1's inputs, a row ahead (past the last row they stay on its
      // key, whose m2e the end row reads)
      const RowIn rn = load_row(tb, hq, kn, ctx);
      const int4 kn2 = kb[min(j + 1, ylen - 1)];
      const float m2d = r.m2d;
      float post[kRWords];
#pragma unroll
      for (int q = 0; q < kRWords; ++q) post[q] = NEG;
      float ce = 0.f, be = neg_inf(), ml = NEG;
      // the reference the thread's lanes past its first compose relative to
      const float r0 = rel ? wide_chain_ref(top + m2d) : 0.f;
      if (lv) {
        // A: the match and insert cells in place of the previous row's
        // (lane w+1's of the previous row read first), the thread's delete
        // chain over its lanes but the first, whose opening term needs the
        // previous thread's last match cell
        float mr = __shfl_down_sync(kFull, M0, 1);
        float ir = __shfl_down_sync(kFull, I0, 1);
        if (t == 31) {
          mr = seam_m;
          ir = seam_i;
        }
        float m_nx = Mc[tid], i_nx = Ic[tid];
        float mprev = NEG, C = 0.f, Bc = neg_inf(), mtop = NEG;
        float c0 = NEG, mc0 = NEG, ic0 = NEG;
        bool v0 = false;
        for (int k = 0; k < lpt; ++k) {
          const int a = k * NT + tid;
          const float m_o = m_nx, i_o = i_nx, d_o = Dc[a];
          if (k + 1 < lpt) {
            m_nx = Mc[a + NT];
            i_nx = Ic[a + NT];
          } else {
            m_nx = mr;
            i_nx = ir;
          }
          const int dg = dgs[a];
          const bool v = in_ref(dg, j, xlen);
          float s = comb<VIT>(comb<VIT>(m_o + r.m2m, d_o + tr.d2m),
                              i_o + tr.i2m);
          if (j == 1 && (local || dg == -1)) s = comb<VIT>(s, 0.f);
          const float mc = v ? s + pick(r.e, token(xb, dg + j, xmax)) : NEG;
          const float ic =
              v ? r.ins + comb<VIT>(i_nx + tr.i2i, m_nx + r.m2i) : NEG;
          Mc[a] = mc;
          Ic[a] = ic;
          if (k == 0) {
            v0 = v;
            c0 = v ? tr.d2d : NEG;
            mc0 = mc;
            ic0 = ic;
          } else {
            const float c = v ? tr.d2d : NEG;
            const float bb = v ? mprev - r0 + m2d : NEG;
            Bc = comb<VIT>(Bc + c, bb);
            C += c;
          }
          mprev = mc;
          mtop = fmaxf(mtop, mc);
        }
        top = mtop;
        ml = __shfl_up_sync(kFull, mprev, 1);
        // the thread's step: its first lane's, then the rest (thread 0's
        // first lane is the tile's, which joins at the fold)
        float cc = C, bc = Bc + r0;
        if (t > 0) {
          const float b0 = v0 ? ml + m2d : NEG;
          bc = comb<VIT>(b0 + C, Bc + r0);
          cc = c0 + C;
        }
        warp_scan<VIT>(cc, bc, t);
        ce = __shfl_up_sync(kFull, cc, 1);
        be = __shfl_up_sync(kFull, bc, 1);
        post[kRC] = __shfl_sync(kFull, cc, 31);
        post[kRB] = __shfl_sync(kFull, bc, 31);
        post[kRC0] = __shfl_sync(kFull, c0, 0);
        post[kRM0] = __shfl_sync(kFull, mc0, 0);
        post[kRI0] = __shfl_sync(kFull, ic0, 0);
        post[kRML] = __shfl_sync(kFull, mprev, 31);
      }
      // the row's meeting (cluster_smem.cuh): the delete cell entering the
      // tile, the next tile's first cells of the row
      const RowMeet<float> meet = smem_meet<VIT>(
          slots, j & 1, post, m2d, t, wi, nw, rank, nct, [&] {
            ctx = indel_ctx(tb, kn);
            kn = kn2;
          });
      seam_m = meet.nm;
      seam_i = meet.ni;

      // C: the delete cells from the value entering the thread, its first
      // lane's at the cells' magnitude, the rest relative to r0
      if (lv) {
        float x = t == 0 ? meet.d0 : comb<VIT>(meet.d0 + ce, be);
        float mprev = ml, ref = 0.f;
        for (int k = 0; k < lpt; ++k) {
          const int a = k * NT + tid;
          const float mc = Mc[a];
          const bool v = in_ref(dgs[a], j, xlen);
          if (k > 0 || t > 0)
            x = comb<VIT>(x + (v ? tr.d2d : NEG),
                          v ? mprev - ref + m2d : NEG);
          mprev = mc;
          Dc[a] = v ? x + ref : NEG;
          if (k == 0) {
            M0 = mc;
            I0 = Ic[a];
            x -= r0;
            ref = r0;
          }
        }
      }
      r = rn;
    }
  }
  // Mc holds row ylen's match cells, and r.m2e is row ylen's

  // end row: each tile's maximum, its Forward sum and its strip maxima to
  // CTA 0, which reduces them in tile order (lane h: tiles h, h + 32, ..)
  float vmax = NEG;
  for (int k = 0; k < lpt; ++k) {
    const int a = k * NT + tid, dg = dgs[a];
    if (ylen >= 1 && in_ref(dg, ylen, xlen) && (local || dg + ylen == xlen - 1))
      vmax = fmaxf(vmax, Mc[a] + r.m2e);
  }
  float e[kFillEnds];
  e[0] = warp_max(vmax);
  float sum = 0.f;
  float sk[kMaxSegs];
#pragma unroll
  for (int q = 0; q < kMaxSegs; ++q) sk[q] = NEG;
  int s0[kMaxSegs], s1[kMaxSegs];
#pragma unroll
  for (int q = 0; q < kMaxSegs; ++q) {
    s0[q] = q < S ? seg_start[b * S + q] : 0;
    s1[q] = q < S ? s0[q] + seg_width[b * S + q] : 0;
  }
  for (int k = 0; k < lpt; ++k) {
    const int a = k * NT + tid, dg = dgs[a], w = w0 + k;
    if (!(ylen >= 1 && in_ref(dg, ylen, xlen) &&
          (local || dg + ylen == xlen - 1)))
      continue;
    const float v = Mc[a] + r.m2e;
    if (!VIT && e[0] > NEG / 2) sum += expf(v - e[0]);
#pragma unroll
    for (int q = 0; q < kMaxSegs; ++q)
      if (w >= s0[q] && w < s1[q]) sk[q] = fmaxf(sk[q], v);
  }
  e[1] = VIT ? 0.f : warp_sum(sum);
#pragma unroll
  for (int q = 0; q < kMaxSegs; ++q) e[2 + q] = warp_max(sk[q]);
  seam_gather<kFillEnds>(ends, g, e, t, nct);
  if (rank == 0 && tid < 32) {
    float mt = NEG;
    for (int h = t; h < T; h += 32) mt = fmaxf(mt, ends[h][0]);
    const float m = warp_max(mt);
    float score = m;
    if (!VIT && m > NEG / 2) {
      float part = 0.f;
      for (int h = t; h < T; h += 32)
        if (ends[h][0] > NEG / 2) part += ends[h][1] * expf(ends[h][0] - m);
      score = m + logf(warp_sum(part));
    }
    float f[kMaxSegs];
#pragma unroll
    for (int q = 0; q < kMaxSegs; ++q) {
      float fq = NEG;
      for (int h = t; h < T; h += 32) fq = fmaxf(fq, ends[h][2 + q]);
      f[q] = warp_max(fq);
    }
    if (t == 0) {
      out[b] = score;
      for (int q = 0; q < S; ++q) out[(size_t)B + (size_t)b * S + q] = f[q];
    }
  }
}

// K1's smem route on B pairs: nct CTAs (a cluster, at most 16) of `warps`
// warps (at most 16) a pair, lpt lanes a thread, each thread's run in
// shared memory (slab null: the shared tier) or in `slab` (the global tier)
template <bool VIT>
cudaError_t launch_fill_smem(int lpt, int nct, int warps, const int8_t* x_tok,
                             int Lx, const int4* keys, int Ly,
                             const int4* meta, const int* doff, int W,
                             const int* seg_start, const int* seg_width,
                             int S, const FillTables& tb, const float* trans,
                             int B, int local, unsigned char* slab,
                             float* out, cudaStream_t stream) {
  const bool global = slab != nullptr;
  return launch_smem(global ? band_fill_smem_kernel<true, VIT>
                            : band_fill_smem_kernel<false, VIT>,
                     B, nct, warps,
                     global ? 0 : run_bytes(lpt, warps, kFillLaneBytes),
                     stream, x_tok, Lx, keys, Ly, meta, doff, W, seg_start,
                     seg_width, S, tb, trans, B, local, lpt, slab, out);
}

}  // namespace
