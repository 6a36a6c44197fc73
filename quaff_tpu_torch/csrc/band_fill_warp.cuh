// K1's warp route: the banded pair-HMM score fill with one warp per pair
// and the band row in registers, for NVIDIA Hopper (sm_90a).
//
// It computes what band_fill_kernel<VIT, false> (band_fill.cuh, the "block
// route") computes, on the same inputs and into the same [B + B*S] output,
// for bands of at most 32 * LPT lanes; band_fill.cu launches it and
// dp/fill_v2.band_fill picks the route and LPT from the band's width.
//
// Why.  The block route gives each pair a block, one thread a lane, with
// the band row in shared memory: every lane makes about ten shared-memory
// accesses a row and the block passes three barriers a row, between two of
// which one warp scans the warp totals alone.  At the align configuration
// (W=203) a row costs about 4 SM-cycles an in-envelope cell, and the
// kernel runs two orders of magnitude above its operation bound.
//
// Design.
//   - One warp fills one pair; a block holds kWarpsPerBlock independent
//     warps.  The row loop has no barrier: each warp stops at its own read
//     length.
//   - Thread t owns lanes [t*LPT, (t+1)*LPT).  Their match, insert and
//     delete cells, diagonals and first and last valid rows
//     (jlo = max(1, 1-d), jhi = min(ylen, xlen-d)) live in unrolled register
//     arrays, so a lane's validity in row j is one unsigned compare,
//     (unsigned)(j - jlo) <= jhi - jlo, computed once a row.
//   - The previous row's mat[w+1] and ins[w+1] come from the thread's own
//     registers, or for its last lane from __shfl_down_sync of the next
//     thread's first lane (NEG beyond the warp: lanes >= W hold NEG).  The
//     delete chain's mat[w-1] comes by __shfl_up_sync the same way.
//   - The delete chain del[w] = comb(del[w-1] + d2d, mat[w-1] + m2d): each
//     thread composes its LPT (c, b) steps, one warp_scan<VIT> gives every
//     thread the chain's value entering its run (the chain is -inf before
//     lane 0, so that value is the exclusive prefix's b), and the thread
//     replays its lanes.  Invalid lanes carry c = -FLT_MAX and stop the
//     chain at strip seams and sentinel lanes, as in the block route.
//   - Row inputs one row ahead: while it fills row j the warp loads row
//     j+1's four match scores (by ref token), insert score and transitions,
//     whose addresses come from row j+1's key, loaded a row earlier still;
//     and each lane's ref token x[d + j] of row j+1.  A lane then picks its
//     emission from four registers by its token: no load on a row's
//     critical path depends on a load of the same row.
//   - The end row's pair score and strip maxima are warp shuffles.
//
// What bounds it: instruction issue.  A Viterbi lane costs ~50 instructions
// a row (the match and insert updates, the token's load and select, the
// validity selects, the two passes of the delete chain) and every lane of
// the 32*LPT pays them, valid or not; a row adds the 5-round shuffle scan
// and a handful of broadcast loads.  The Forward fill adds the
// log-add-exp's expf and log1pf (~20 add_max steps each on this card).
// With few pairs in flight, the row's dependent chain (shuffles, the two
// delete-chain passes) sets the time instead.

#pragma once

#include "band_fill.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// the tables a row's inputs come from
struct FillTables {
  const float* match;       // [4][Km][Q]
  const float* match_noq;   // [4][Km]
  const float* insert;      // [4][Q]
  const float* insert_noq;  // [4]
  const float* ik;          // [n_ik][4]: m2m, m2i, m2d, m2e
  int Km, Q, n_ik;
};

// one read row's inputs: the match score of each ref token, the insert
// score of the read token, and the row's transitions
struct RowIn {
  float e[4];
  float ins, m2m, m2i, m2d, m2e;
};

__device__ __forceinline__ int indel_ctx(const FillTables& tb, int4 kk) {
  return tb.n_ik == 1 ? 0 : kk.w;
}

// row inputs of key kk; m2m/m2i follow the previous row's indel context,
// m2d/m2e this row's (as in band_fill_kernel)
__device__ __forceinline__ RowIn load_row(const FillTables& tb, bool hq,
                                          int4 kk, int ctx_prev) {
  RowIn r;
  const float* mrow = hq ? tb.match + (size_t)kk.x * tb.Q + kk.y
                         : tb.match_noq + kk.x;
  const size_t sym = hq ? (size_t)tb.Km * tb.Q : (size_t)tb.Km;
#pragma unroll
  for (int s = 0; s < 4; ++s) r.e[s] = __ldg(mrow + s * sym);
  r.ins = __ldg(hq ? tb.insert + kk.z * tb.Q + kk.y : tb.insert_noq + kk.z);
  const int ctx = indel_ctx(tb, kk);
  r.m2m = __ldg(tb.ik + ctx_prev * 4 + 0);
  r.m2i = __ldg(tb.ik + ctx_prev * 4 + 1);
  r.m2d = __ldg(tb.ik + ctx * 4 + 2);
  r.m2e = __ldg(tb.ik + ctx * 4 + 3);
  return r;
}

// the thread's lanes: previous row's cells, diagonal - 1, valid rows
// [jlo, jlo + span], the ref token of the row being filled
template <int LPT>
struct Lanes {
  float mat[LPT], ins[LPT], del[LPT];
  int dg[LPT], jlo[LPT], span[LPT], tok[LPT];
};

__device__ __forceinline__ bool live(int j, int jlo, int span) {
  return (unsigned)(j - jlo) <= (unsigned)span;
}

// ref token at index i, read unconditionally: the index is clamped into
// the pair's row of x_tok (a lane outside [0, xlen) gets some token and is
// masked), which costs less than a predicated, sign-extended load
__device__ __forceinline__ int token(const uint8_t* xb, int i, int xmax) {
  return xb[min(max(i, 0), xmax)];
}

struct Trans {
  float d2d, d2m, i2i, i2m;
};

// one row's work on a thread's lanes between its two halves: validity,
// the match and insert cells, the delete-chain steps and the thread's
// composed step
template <int LPT>
struct RowWork {
  bool v[LPT];
  float mc[LPT], ic[LPT], cc[LPT], bb[LPT];
  float c_acc, b_acc;
};

// The first half of row j from row j-1's cells in s (FIRST: j == 1, where
// a path may start): A, the match and insert cells; B, the delete-chain
// steps and their composition over the thread's lanes.  Thread 31's lane
// w+1 of the previous row is (seam_m, seam_i): NEG past the warp route's
// band, the next tile's first lane in a cluster route.  TILE: the first
// lane of thread 0 stays out of the thread's step; it reads the tile
// before's last lane and joins at the cross-tile fold.
template <bool VIT, int LPT, bool FIRST, bool TILE>
__device__ __forceinline__ void fill_cells(RowWork<LPT>& w,
                                           const Lanes<LPT>& s,
                                           const RowIn& r, const Trans& tr,
                                           int j, int t, bool local,
                                           float seam_m, float seam_i) {
  const float NEG = neg_big();
  float mat_r = __shfl_down_sync(kFull, s.mat[0], 1);
  float ins_r = __shfl_down_sync(kFull, s.ins[0], 1);
  if (t == 31) {
    mat_r = seam_m;
    ins_r = seam_i;
  }
  // A: match and insert cells
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    w.v[k] = live(j, s.jlo[k], s.span[k]);
    const float mh = k + 1 < LPT ? s.mat[k + 1 < LPT ? k + 1 : k] : mat_r;
    const float ih = k + 1 < LPT ? s.ins[k + 1 < LPT ? k + 1 : k] : ins_r;
    float a = comb<VIT>(comb<VIT>(s.mat[k] + r.m2m, s.del[k] + tr.d2m),
                        s.ins[k] + tr.i2m);
    if (FIRST && (local || s.dg[k] == -1)) a = comb<VIT>(a, 0.f);
    const int tk = s.tok[k];
    const float e = tk < 2 ? (tk == 0 ? r.e[0] : r.e[1])
                           : (tk == 2 ? r.e[2] : r.e[3]);
    w.mc[k] = w.v[k] ? a + e : NEG;
    w.ic[k] = w.v[k] ? r.ins + comb<VIT>(ih + tr.i2i, mh + r.m2i) : NEG;
  }
  // B: compose the thread's delete-chain steps
  float ml = __shfl_up_sync(kFull, w.mc[LPT - 1], 1);
  if (t == 0) ml = NEG;
  w.c_acc = 0.f;
  w.b_acc = neg_inf();  // the identity step
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const float mprev = k > 0 ? w.mc[k > 0 ? k - 1 : 0] : ml;
    w.cc[k] = w.v[k] ? tr.d2d : NEG;
    w.bb[k] = w.v[k] ? mprev + r.m2d : NEG;
    const bool skip = TILE && k == 0 && t == 0;
    w.b_acc = skip ? w.b_acc : comb<VIT>(w.b_acc + w.cc[k], w.bb[k]);
    w.c_acc = skip ? w.c_acc : w.c_acc + w.cc[k];
  }
}

// The second half of row j: C, replay the thread's lanes from x, the
// chain's value entering them (an invalid lane's step (NEG, NEG) leaves
// exactly NEG there); TILE: thread 0's x is already its first lane's
// delete cell.
template <bool VIT, int LPT, bool TILE>
__device__ __forceinline__ void fill_apply(Lanes<LPT>& s, const RowWork<LPT>& w,
                                           float x, int t) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const bool keep = TILE && k == 0 && t == 0;
    x = keep ? x : comb<VIT>(x + w.cc[k], w.bb[k]);
    s.del[k] = x;
    s.mat[k] = w.mc[k];
    s.ins[k] = w.ic[k];
  }
}

// row j of the fill from row j-1's cells in s (FIRST: j == 1, where a
// path may start)
template <bool VIT, int LPT, bool FIRST>
__device__ __forceinline__ void fill_row(Lanes<LPT>& s, const RowIn& r,
                                         const Trans& tr, int j, int t,
                                         bool local) {
  const float NEG = neg_big();
  RowWork<LPT> w;
  fill_cells<VIT, LPT, FIRST, false>(w, s, r, tr, j, t, local, NEG, NEG);
  float c_acc = w.c_acc, b_acc = w.b_acc;
  warp_scan<VIT>(c_acc, b_acc, t);
  float x = __shfl_up_sync(kFull, b_acc, 1);
  if (t == 0) x = neg_inf();
  fill_apply<VIT, LPT, false>(s, w, x, t);
}

// one row step: issue row j+1's loads (its inputs from the key loaded a
// row ago, the key of row j+2, the lanes' ref tokens), then fill row j
template <bool VIT, int LPT, bool FIRST>
__device__ __forceinline__ void step(Lanes<LPT>& s, RowIn& r, int4& kn,
                                     int& ctx, const FillTables& tb, bool hq,
                                     const int4* kb, const uint8_t* xb,
                                     int xmax, const Trans& tr, int j,
                                     int ylen, int t, bool local) {
  // unconditional: past the read's last row the indices stay on its last
  // key (valid table entries), whose inputs the end row reads again
  const RowIn rn = load_row(tb, hq, kn, ctx);
  const int4 kn2 = kb[min(j + 1, ylen - 1)];
  int tn[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) tn[k] = token(xb, s.dg[k] + j + 1, xmax);
  fill_row<VIT, LPT, FIRST>(s, r, tr, j, t, local);
  ctx = indel_ctx(tb, kn);
  kn = kn2;
  r = rn;
#pragma unroll
  for (int k = 0; k < LPT; ++k) s.tok[k] = tn[k];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <bool VIT, int LPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) band_fill_warp_kernel(
    const int8_t* __restrict__ x_tok, int Lx,
    const int4* __restrict__ keys, int Ly,
    const int4* __restrict__ meta,
    const int* __restrict__ doff, int W,
    const int* __restrict__ seg_start, const int* __restrict__ seg_width,
    int S, FillTables tb, const float* __restrict__ trans, int B, int local,
    float* __restrict__ out) {
  const int t = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: no barrier follows
  const float NEG = neg_big();
  const int4 pm = meta[b];
  // the read length from lane 0: every lane holds it already, but so the
  // compiler sees the row loop's trip count uniform over the warp and
  // drops its divergence checks (and their spills) at every shuffle
  const int xlen = pm.x, ylen = __shfl_sync(kFull, min(pm.y, Ly), 0);
  const bool hq = pm.z != 0;
  const Trans tr{trans[0], trans[1], trans[2], trans[3]};
  const auto* xb = reinterpret_cast<const uint8_t*>(x_tok) + (size_t)b * Lx;
  const int xmax = Lx - 1;
  const int4* kb = keys + (size_t)b * Ly;

  Lanes<LPT> s;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = t * LPT + k;
    const int d = w < W ? doff[(size_t)b * W + w] : kSentinel;
    int lo = max(1, 1 - d);
    const int hi = min(ylen, xlen - d);
    int span = hi - lo;
    if (d == kSentinel || span < 0) {  // never valid
      lo = 1 << 30;
      span = 0;
    }
    s.dg[k] = d - 1;  // ref index i - 1 = dg + j
    s.jlo[k] = lo;
    s.span[k] = span;
    s.mat[k] = NEG;
    s.ins[k] = NEG;
    s.del[k] = NEG;
    s.tok[k] = token(xb, d, xmax);
  }

  RowIn r{};
  if (ylen >= 1) {
    int4 kn = kb[0];
    r = load_row(tb, hq, kn, 0);
    int ctx = indel_ctx(tb, kn);
    kn = kb[min(1, ylen - 1)];
    step<VIT, LPT, true>(s, r, kn, ctx, tb, hq, kb, xb, xmax, tr, 1, ylen, t,
                         local);
    for (int j = 2; j <= ylen; ++j)
      step<VIT, LPT, false>(s, r, kn, ctx, tb, hq, kb, xb, xmax, tr, j, ylen,
                            t, local);
  }
  // s.mat holds row ylen's match cells, and r.m2e is row ylen's (the last
  // step loaded r again from row ylen's key)

  // end row: pair score and per-strip maxima
  bool at_end[LPT];
  float vmax = NEG;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    at_end[k] = ylen >= 1 && live(ylen, s.jlo[k], s.span[k]) &&
             (local || s.dg[k] + ylen == xlen - 1);
    if (at_end[k]) vmax = fmaxf(vmax, s.mat[k] + r.m2e);
  }
  const float m = warp_max(vmax);
  float score = m;
  if (!VIT && m > NEG / 2) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (at_end[k]) sum += expf(s.mat[k] + r.m2e - m);
    score = m + logf(warp_sum(sum));
  }
  if (t == 0) out[b] = score;
  for (int q = 0; q < S; ++q) {
    const int s0 = seg_start[b * S + q], sw = seg_width[b * S + q];
    float sk = NEG;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int w = t * LPT + k;
      if (at_end[k] && w >= s0 && w < s0 + sw) sk = fmaxf(sk, s.mat[k] + r.m2e);
    }
    sk = warp_max(sk);
    if (t == 0) out[(size_t)B + (size_t)b * S + q] = sk;
  }
}

template <bool VIT, int LPT>
cudaError_t launch_warp_fill(const int8_t* x_tok, int Lx, const int4* keys,
                             int Ly, const int4* meta, const int* doff, int W,
                             const int* seg_start, const int* seg_width,
                             int S, const FillTables& tb, const float* trans,
                             int B, int local, float* out,
                             cudaStream_t stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  band_fill_warp_kernel<VIT, LPT><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      x_tok, Lx, keys, Ly, meta, doff, W, seg_start, seg_width, S, tb, trans,
      B, local, out);
  return cudaGetLastError();
}

// the warp route's instantiations: LPT 1, 2, 4, 8 and 16 lanes a thread
template <bool VIT>
cudaError_t launch_warp_lpt(int lpt, const int8_t* x_tok, int Lx,
                            const int4* keys, int Ly, const int4* meta,
                            const int* doff, int W, const int* seg_start,
                            const int* seg_width, int S, const FillTables& tb,
                            const float* trans, int B, int local, float* out,
                            cudaStream_t stream) {
#define QUAFF_WARP_CASE(L)                                                  \
  case L:                                                                   \
    return launch_warp_fill<VIT, L>(x_tok, Lx, keys, Ly, meta, doff, W,     \
                                    seg_start, seg_width, S, tb, trans, B,  \
                                    local, out, stream);
  switch (lpt) {
    QUAFF_WARP_CASE(1)
    QUAFF_WARP_CASE(2)
    QUAFF_WARP_CASE(4)
    QUAFF_WARP_CASE(8)
    QUAFF_WARP_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef QUAFF_WARP_CASE
}

}  // namespace
