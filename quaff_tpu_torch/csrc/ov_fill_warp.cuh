// K4's warp route: the banded read-vs-read overlap Viterbi score fill with
// one warp per pair and the band row in registers, for NVIDIA Hopper
// (sm_90a).  Also the delete chain's triple algebra and the row code that
// the cluster route (ov_fill_cluster.cuh) runs on each of its tiles.
//
// It computes K4's [B + B*S] output (ov_fill.cu) for bands of at most 32
// * LPT lanes; ov_fill.cu launches it and dp/ov_fill.ov_fill picks the
// route and LPT from the band's width (ov_route).  The recurrence is the
// one at the top of ov_fill.cu.
//
// Why.  A block a pair with the M/I/D row in shared memory (K4's first
// design, since removed) passed four block barriers a row.  At phase 6 of
// chip_smoke.py (128 pairs of W=126 on 132 SMs, one block an SM) a row
// cost ~4 us: every row started with 7 (gap order 1: 9) dependent loads
// of each lane's x values from L2, then the emission's three
// log-add-exps, then shared-memory round trips around the scans, all on
// the row's critical path.
//
// Design (band_fill_warp.cuh's, with three log-add-exp states).
//   - One warp fills one pair; a block holds kOvWarpsPerBlock independent
//     warps.  The row loop has no barrier: each warp stops at its own live
//     rows joff+1 .. joff+nrows, a count broadcast from lane 0 so that the
//     compiler sees it uniform over the warp (a per-thread trip count
//     makes ptxas check convergence before every shuffle, and spill).
//   - Thread t owns lanes [t*LPT, (t+1)*LPT).  Their match, insert and
//     delete cells, diagonals (as i - 1 at row 0) and end maxima live in
//     unrolled register arrays.  A lane's validity in row j is one
//     unsigned compare of its x index i - 1 against the x read's length
//     (a sentinel diagonal is past any read), and the row's own bound.
//   - The previous row's mat/ins/del[w+1] come from the thread's own
//     registers, or for its last lane by __shfl_down_sync from the next
//     thread's first lane (NEG beyond the warp, where lanes >= W hold NEG
//     anyway).  The delete chain's mat/ins[w-1] come by __shfl_up_sync.
//   - The delete chain del[w] = max(lse(del[w-1] + d2d, ins[w-1] + d2i),
//     mat[w-1] + m2d) is a chain of affine-max maps x -> max(lse(x + c,
//     k), b): each thread composes its LPT triples in lane order, keeping
//     each lane's inclusive map; one warp_scan3 over the threads that hold
//     a lane of the band gives each thread the map of all lanes before it;
//     each lane's delete cell is then its own inclusive map applied to that
//     map's value at -inf, all lanes at once (no replay chain).  The
//     composition is not commutative; its identity is (0, -inf, -inf).
//     Invalid lanes carry (NEG, NEG, NEG), which resets the chain, so no
//     path crosses a strip seam.
//   - The row's inputs a row ahead: while it fills row j, each thread
//     loads row j+1's y values (broadcast loads) and its lanes' x values
//     at i (the bank is channel-major: neighbouring lanes read
//     neighbouring addresses), then computes row j+1's emission
//     lse_r(x_r + y_r) - insX - insY and, at gap order 1, its per-lane
//     stay_x(i-1) and open_x(i).  No load and no emission log-add-exp sits
//     on a row's dependent chain: only the match/insert update, the
//     thread's composes, the triple scan and one log-add-exp do.
//   - The log-add-exp is the TPU kernel's own form (pallas_v2._lse2_fast,
//     lse below): the hardware exp and log of 1 + exp(-|a - b|).
//     log1pf's software polynomial made a row's chain ~6x longer, and
//     with one warp a pair the chain is what a row costs.
//   - The pair score (end + x and y insert sums) and the per-strip end
//     maxima are warp shuffles: no shared memory, no block reduction.
//   - Transitions are run-time data (trans[9]); the gap order is a
//     template argument because it is the bank's layout (5 or 7 channels),
//     not a parameter value.
//
// What bounds it: with few pairs an SM (K4's chunks hold 6-1024 pairs),
// the row's dependent chain: the shuffles, LPT - 1 composes of two
// log-add-exps each, up to 5 rounds of the triple scan, the last
// log-add-exp; with many, instruction throughput.  A lane costs seven
// log-add-exps a row (three in the emission, one in the insert cell, two
// in its compose, one for its delete cell), every lane of the 32*LPT pays
// them, valid or not.

#pragma once

#include "band_fill.cuh"

namespace {

constexpr int kChIns = 4, kChOpen = 5, kChStay = 6;
constexpr int kOvWarpsPerBlock = 4;

// log-add-exp in the TPU kernel's own form (pallas_v2._lse2_fast): the
// hardware exp and log of 1 + exp(-|a - b|), within ~2e-7 of log1p (far
// below float32's step at the cells' magnitudes) in about a sixth of
// log1pf's dependent instructions, with the same guard for two operands
// near -inf
__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  const float r = m + __logf(1.f + __expf(-fabsf(a - b)));
  return m < -1e38f ? m : r;
}

// (c, k, b) := (c, k, b) then (c2, k2, b2)
__device__ __forceinline__ void compose(float& c, float& k, float& b, float c2,
                                        float k2, float b2) {
  b = fmaxf(lse(b + c2, k2), b2);
  k = lse(k + c2, k2);
  c = c + c2;
}

// inclusive scan of triples over the first `span` lanes of a warp (a
// warp-uniform count; the lanes past it get partial scans), in lane order
__device__ __forceinline__ void warp_scan3(float& c, float& k, float& b,
                                           int lane, int span = 32) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= span) break;
    float co = __shfl_up_sync(kFull, c, off);
    float ko = __shfl_up_sync(kFull, k, off);
    float bo = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      compose(co, ko, bo, c, k, b);  // the earlier lanes' map, then ours
      c = co;
      k = ko;
      b = bo;
    }
  }
}

// the thread's lanes: the previous row's cells, i - 1 at row 0 (the x
// index of row j is dm1 + j), the end maxima
template <int LPT>
struct OvLanes {
  float mat[LPT], ins[LPT], del[LPT], endw[LPT];
  int dm1[LPT];
};

// one row's inputs: per lane the emission and, at gap order 1,
// stay_x(i-1) and open_x(i); for the row, stay_y(j-1) and open_y(j)
template <bool IK, int LPT>
struct OvRowIn {
  float emit[LPT];
  float sx[IK ? LPT : 1], ox[IK ? LPT : 1];
  float ys, yo;
};

// the raw loads of one row's inputs (see ov_row_in)
template <bool IK, int LPT>
struct OvRowLoads {
  float x[IK ? 7 : 5][LPT];
  float y[IK ? 7 : 5];
};

// start row j's loads: its y values at j - 1 (one address for the whole
// warp) and each lane's x values at i - 1 = dm1 + j, read unconditionally
// at indices clamped into the bank row (a lane outside [0, xlen) is masked
// when the row is filled)
template <bool IK, int LPT>
__device__ __forceinline__ OvRowLoads<IK, LPT> ov_row_loads(
    const OvLanes<LPT>& s, const float* xb, const float* yb, int L, int j) {
  constexpr int C = IK ? 7 : 5;
  OvRowLoads<IK, LPT> ld;
  const int yi = min(max(j - 1, 0), L - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) ld.y[c] = __ldg(yb + (size_t)c * L + yi);
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int ti = s.dm1[k] + j;
    const int xi = min(max(ti, 0), L - 1);
#pragma unroll
    for (int c = 0; c < (IK ? 6 : 5); ++c)
      ld.x[c][k] = __ldg(xb + (size_t)c * L + xi);
    if (IK) ld.x[kChStay][k] = __ldg(xb + (size_t)kChStay * L + min(max(ti - 1, 0), L - 1));
  }
  return ld;
}

// row j's inputs from its loads: the emission in ov_fill_kernel's order,
// stay_x(i-1) (0 at i = 1) and open_x(i)
template <bool IK, int LPT>
__device__ __forceinline__ void ov_row_in(OvRowIn<IK, LPT>& r,
                                          const OvRowLoads<IK, LPT>& ld,
                                          const OvLanes<LPT>& s, int j) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    float acc = ld.x[0][k] + ld.y[0];
#pragma unroll
    for (int c = 1; c < 4; ++c) acc = lse(acc, ld.x[c][k] + ld.y[c]);
    r.emit[k] = acc - ld.x[kChIns][k] - ld.y[kChIns];
    if (IK) {
      r.sx[IK ? k : 0] = s.dm1[k] + j >= 1 ? ld.x[IK ? kChStay : 0][k] : 0.f;
      r.ox[IK ? k : 0] = ld.x[IK ? kChOpen : 0][k];
    }
  }
  if (IK) {
    r.ys = ld.y[IK ? kChStay : 0];
    r.yo = ld.y[IK ? kChOpen : 0];
  }
}

struct OvTrans {
  float m2m, m2i, m2d, i2m, i2i, d2m, d2i, d2d;
};

// one row's work on a thread's lanes between its two halves: validity,
// the match and insert cells, and the inclusive delete-chain maps
template <int LPT>
struct OvRowWork {
  bool v[LPT];
  float mc[LPT], ic[LPT];
  float pc[LPT], pk[LPT], pb[LPT];
};

// The first half of row j from row j-1's cells in s: A, the match and
// insert cells; B, the inclusive maps of the thread's lanes (its
// delete-chain triples composed in lane order).  Thread 31's lane w+1 of
// the previous row is (seam_m, seam_i, seam_d): NEG past the warp route's
// band, the next tile's first lane in a cluster route.  TILE: the first
// lane of thread 0 keeps the identity map; its step reads the tile
// before's last lane and joins at the cross-tile fold.
template <bool IK, int LPT, bool TILE>
__device__ __forceinline__ void ov_row_cells(OvRowWork<LPT>& w,
                                             const OvLanes<LPT>& s,
                                             const OvRowIn<IK, LPT>& r,
                                             const OvTrans& tr, int j,
                                             int xlen, int ylen, int t,
                                             float seam_m, float seam_i,
                                             float seam_d) {
  const float NEG = neg_big();
  const bool row_ok = j <= ylen;
  float mat_r = __shfl_down_sync(kFull, s.mat[0], 1);
  float ins_r = __shfl_down_sync(kFull, s.ins[0], 1);
  float del_r = __shfl_down_sync(kFull, s.del[0], 1);
  if (t == 31) {
    mat_r = seam_m;
    ins_r = seam_i;
    del_r = seam_d;
  }
  // A: match and insert cells from the previous row
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int ti = s.dm1[k] + j;  // i - 1
    w.v[k] = row_ok && (unsigned)ti < (unsigned)xlen;
    const float m2m = IK ? r.sx[IK ? k : 0] + r.ys : tr.m2m;
    const float m2i = IK ? r.ox[IK ? k : 0] : tr.m2i;
    float a = fmaxf(fmaxf(s.mat[k] + m2m, s.del[k] + tr.d2m), s.ins[k] + tr.i2m);
    if (j == 1 || ti == 0) a = fmaxf(a, 0.f);
    const float mh = k + 1 < LPT ? s.mat[k + 1 < LPT ? k + 1 : k] : mat_r;
    const float ih = k + 1 < LPT ? s.ins[k + 1 < LPT ? k + 1 : k] : ins_r;
    const float dh = k + 1 < LPT ? s.del[k + 1 < LPT ? k + 1 : k] : del_r;
    w.mc[k] = w.v[k] ? a + r.emit[k] : NEG;
    w.ic[k] = w.v[k] ? fmaxf(lse(ih + tr.i2i, dh + tr.d2i), mh + m2i) : NEG;
  }
  // B: the inclusive maps of the thread's lanes
  float ml = __shfl_up_sync(kFull, w.mc[LPT - 1], 1);
  float il = __shfl_up_sync(kFull, w.ic[LPT - 1], 1);
  if (t == 0) {
    ml = NEG;
    il = NEG;
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const float mprev = k > 0 ? w.mc[k > 0 ? k - 1 : 0] : ml;
    const float iprev = k > 0 ? w.ic[k > 0 ? k - 1 : 0] : il;
    const float m2d = IK ? r.sx[IK ? k : 0] + r.yo : tr.m2d;
    const float cc = w.v[k] ? tr.d2d : NEG;
    const float kk = w.v[k] ? iprev + tr.d2i : NEG;
    const float bb = w.v[k] ? mprev + m2d : NEG;
    if (k == 0) {
      const bool first = TILE && t == 0;
      w.pc[0] = first ? 0.f : cc;
      w.pk[0] = first ? neg_inf() : kk;
      w.pb[0] = first ? neg_inf() : bb;
    } else {
      w.pc[k] = w.pc[k > 0 ? k - 1 : 0];
      w.pk[k] = w.pk[k > 0 ? k - 1 : 0];
      w.pb[k] = w.pb[k > 0 ? k - 1 : 0];
      compose(w.pc[k], w.pk[k], w.pb[k], cc, kk, bb);
    }
  }
}

// The second half of row j: C, each lane's delete cell is its inclusive
// map applied to x, the value entering the thread (no chain across the
// thread's lanes), then the end maxima and the row's cells into s.
template <int LPT>
__device__ __forceinline__ void ov_row_apply(OvLanes<LPT>& s,
                                             const OvRowWork<LPT>& w, float x,
                                             int j, int xlen, int ylen) {
  const float NEG = neg_big();
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    s.del[k] = w.v[k] ? fmaxf(lse(x + w.pc[k], w.pk[k]), w.pb[k]) : NEG;
    const int ti = s.dm1[k] + j;
    if (w.v[k] && (j == ylen || ti == xlen - 1))
      s.endw[k] = fmaxf(s.endw[k], w.mc[k]);
    s.mat[k] = w.mc[k];
    s.ins[k] = w.ic[k];
  }
}

// row j of the pair from row j-1's cells in s; `span`: the threads that
// hold a lane of the band (ceil(W / LPT))
template <bool IK, int LPT>
__device__ __forceinline__ void ov_fill_row(OvLanes<LPT>& s,
                                            const OvRowIn<IK, LPT>& r,
                                            const OvTrans& tr, int j,
                                            int xlen, int ylen, int t,
                                            int span) {
  const float NEG = neg_big();
  OvRowWork<LPT> w;
  ov_row_cells<IK, LPT, false>(w, s, r, tr, j, xlen, ylen, t, NEG, NEG, NEG);
  // the scan of the threads' totals
  float c_acc = w.pc[LPT - 1], k_acc = w.pk[LPT - 1], b_acc = w.pb[LPT - 1];
  warp_scan3(c_acc, k_acc, b_acc, t, span);
  // the map of the lanes before this thread's, applied to -inf
  float ke = __shfl_up_sync(kFull, k_acc, 1);
  float be = __shfl_up_sync(kFull, b_acc, 1);
  const float x = t == 0 ? neg_inf() : fmaxf(ke, be);
  ov_row_apply<LPT>(s, w, x, j, xlen, ylen);
}

__device__ __forceinline__ float ov_warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <bool IK, int LPT>
__global__ void __launch_bounds__(kOvWarpsPerBlock * 32) ov_fill_warp_kernel(
    const float* __restrict__ bank, int L, const int4* __restrict__ meta,
    const int* __restrict__ doff, int W, const int* __restrict__ seg_start,
    const int* __restrict__ seg_width, int S,
    const float2* __restrict__ ins_xy, const float* __restrict__ trans,
    int B, float* __restrict__ out) {
  constexpr int C = IK ? 7 : 5;
  const int t = threadIdx.x & 31;
  const int pb = blockIdx.x * kOvWarpsPerBlock + (threadIdx.x >> 5);
  if (pb >= B) return;  // the whole warp: no barrier follows
  const float NEG = neg_big();
  const int4 m0 = meta[2 * pb], m1 = meta[2 * pb + 1];
  const int xlen = m0.z, ylen = m0.w;
  // the live rows from lane 0: every lane holds them already, but so the
  // row loop's trip count is uniform over the warp for the compiler
  const int joff = __shfl_sync(kFull, m1.x, 0);
  const int nrows = __shfl_sync(kFull, m1.y, 0);
  const float* xb = bank + (size_t)m0.x * C * L;
  const float* yb = bank + (size_t)m0.y * C * L;
  const OvTrans tr{trans[0], trans[1], trans[2], trans[3], trans[4],
                   trans[6], trans[7], trans[8]};
  const int span = (W + LPT - 1) / LPT;

  OvLanes<LPT> s;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = t * LPT + k;
    s.dm1[k] = (w < W ? doff[(size_t)pb * W + w] : kSentinel) - 1;
    s.mat[k] = NEG;
    s.ins[k] = NEG;
    s.del[k] = NEG;
    s.endw[k] = NEG;
  }

  OvRowIn<IK, LPT> r;
  ov_row_in<IK, LPT>(r, ov_row_loads<IK, LPT>(s, xb, yb, L, joff + 1), s,
                     joff + 1);
  for (int jj = 1; jj <= nrows; ++jj) {
    const int j = joff + jj;  // true row
    // row j+1's loads (unconditional: past the pair's rows they are
    // in-bounds and unused), then row j, then row j+1's inputs
    const OvRowLoads<IK, LPT> ld = ov_row_loads<IK, LPT>(s, xb, yb, L, j + 1);
    ov_fill_row<IK, LPT>(s, r, tr, j, xlen, ylen, t, span);
    ov_row_in<IK, LPT>(r, ld, s, j + 1);
  }

  // the pair's end score and the per-strip end maxima
  float vmax = NEG;
#pragma unroll
  for (int k = 0; k < LPT; ++k) vmax = fmaxf(vmax, s.endw[k]);
  const float end = ov_warp_max(vmax);
  if (t == 0) {
    const float2 iv = ins_xy[pb];
    out[pb] = end <= NEG / 2 ? neg_inf() : (end + iv.x) + iv.y;
  }
  for (int q = 0; q < S; ++q) {
    const int s0 = seg_start[pb * S + q], sw = seg_width[pb * S + q];
    float sk = NEG;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int w = t * LPT + k;
      if (w >= s0 && w < s0 + sw) sk = fmaxf(sk, s.endw[k]);
    }
    sk = ov_warp_max(sk);
    if (t == 0) out[(size_t)B + (size_t)pb * S + q] = sk <= NEG / 2 ? neg_inf() : sk;
  }
}

template <bool IK, int LPT>
cudaError_t launch_ov_warp(const float* bank, int L, const int4* meta,
                           const int* doff, int W, const int* seg_start,
                           const int* seg_width, int S, const float2* ins_xy,
                           const float* trans, int B, float* out,
                           cudaStream_t stream) {
  const int blocks = (B + kOvWarpsPerBlock - 1) / kOvWarpsPerBlock;
  ov_fill_warp_kernel<IK, LPT><<<blocks, kOvWarpsPerBlock * 32, 0, stream>>>(
      bank, L, meta, doff, W, seg_start, seg_width, S, ins_xy, trans, B, out);
  return cudaGetLastError();
}

// the warp route's instantiations: LPT 1, 2, 4, 8 and 16 lanes a thread
template <bool IK>
cudaError_t launch_ov_warp_lpt(int lpt, const float* bank, int L,
                               const int4* meta, const int* doff, int W,
                               const int* seg_start, const int* seg_width,
                               int S, const float2* ins_xy,
                               const float* trans, int B, float* out,
                               cudaStream_t stream) {
#define QUAFF_OV_WARP_CASE(N)                                               \
  case N:                                                                   \
    return launch_ov_warp<IK, N>(bank, L, meta, doff, W, seg_start,         \
                                 seg_width, S, ins_xy, trans, B, out,       \
                                 stream);
  switch (lpt) {
    QUAFF_OV_WARP_CASE(1)
    QUAFF_OV_WARP_CASE(2)
    QUAFF_OV_WARP_CASE(4)
    QUAFF_OV_WARP_CASE(8)
    QUAFF_OV_WARP_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef QUAFF_OV_WARP_CASE
}

}  // namespace
