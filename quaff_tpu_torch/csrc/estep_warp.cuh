// K2's and K3's warp routes: the training E-step's forward fill with
// stored rows (fwd_store_warp_kernel) and its backward sweep with
// posterior counts (bwd_counts_warp_kernel), one warp per pair with the
// band row in registers, for NVIDIA Hopper (sm_90a).
//
// They compute what the other routes compute (estep.cu's header), on the
// same inputs and into the same outputs (rows[3][B][Ly][W], offs[B][Ly],
// partial[B][E], d_sc[5][B]), for bands of at most 32 * LPT lanes;
// estep.cu launches them and dp/estep.estep_route picks the route and LPT
// from the band's width.  Any route's K2 store feeds any route's K3; the
// cluster routes (estep_cluster.cu) run this file's K3 row on each tile.
// The recurrences are those at the top of band_fill.cuh and estep.cu.
//
// Why.  One block a pair (the former block routes), one thread a lane, the
// row in shared memory, passed 7 (K2) and 9 (K3) block barriers a row,
// with one warp alone scanning the warp totals between two of them; at
// the training chunk (B=256, W=168) they ran 120x and 180x over their
// bounds.
//
// Design (band_fill_warp.cuh's and ov_fill_warp.cuh's).
//   - One warp per pair; a block holds kWarpsPerBlock independent warps.
//     No barrier in the row loop: each warp stops at its own read length,
//     a count broadcast from lane 0 so the compiler sees it uniform.
//   - Thread t owns lanes [t*LPT, (t+1)*LPT) in unrolled register arrays:
//     K2 a lane's M/I/D cells, diagonal and token; K3 its carried backward
//     state and diagonal.  A lane is valid in row j when its ref index
//     lies in the ref, one unsigned compare.  Neighbouring lanes of the
//     next or previous thread come by __shfl_down_sync / __shfl_up_sync
//     (NEG beyond the warp).
//   - Branch-free lanes: every value is computed, then selected.  An
//     expression under a lane's condition becomes a divergent branch in
//     SASS, and ptxas does not interleave the lanes' work across branches;
//     with one warp on a scheduler that interleaving is what a row costs.
//   - The log-add-exp is the TPU kernels' own (_fwd_kernel and _bwd_kernel
//     both take pallas_v2._lse2_fast), lse2 below: the operations of
//     ov_fill_warp.cuh's lse without its predicates.  K3's posterior
//     weights take the hardware exp (post_fast).
//   - The delete chains, K2's del[w] = lse(del[w-1] + d2d, mat[w-1] + m2d)
//     and K3's reverse bd[w] = lse(bd[w+1] + d2d, d2m + me'[w] + bm'[w]),
//     are chains of maps x -> lse(x + c, b).  Each thread composes its
//     lanes' maps in chain order, keeping each lane's inclusive map; one
//     warp scan over the threads that hold a lane of the band (K3's from
//     the high lanes down) gives the value entering the thread, and each
//     lane's cell is its inclusive map applied to it, all lanes at once
//     (no replay chain).  Invalid lanes carry (NEG, NEG), which resets the
//     chain, so no path crosses a strip seam.
//   - K2's row inputs a row ahead, as in K1's warp route: row j+1's
//     emission and transition values (its key loaded a row earlier still)
//     and each lane's ref token issue during row j, after its match and
//     insert cells.  K3 reads each stored row once: row j's inputs, its
//     lanes' tokens, row j-1's M, I and D cells and offset issue as row j
//     starts and are first used after its delete chain, which hides their
//     latency (only the keys come a row ahead); row j's own match and
//     delete cells, read as row j+1's previous row, stay in registers; the
//     w+1 and w-1 neighbours come by shuffle.  Loaded a row ahead instead,
//     three more arrays of LPT cells stay live across the row, and at LPT
//     8 ptxas, at its 255-register limit, interleaved fewer lanes.
//   - Per-row float64 scaling: after a row a warp
//     max (5 shuffles) of the thread's cells is subtracted from the row
//     and added to the pair's float64 offset; lane 0 writes K2's offset.
//   - K3's 15 row statistics (estep.cu) reduce by one reduce-scatter
//     butterfly, 16 shuffles in a fixed order, after which lanes 2s and
//     2s+1 hold statistic s; lane 2s then adds statistic s (times the
//     row's factor) to its table entry.  Each table entry is always
//     touched by one lane, in row order, so the tables repeat bit for bit.
//     The pair's table lives in shared memory while a block's kWarpsPerBlock
//     tables fit kTableSmemBytes (an order-1 table, E = 1884, is 7.5 KB a
//     warp), else in partial[b] itself; the adds are the same either way.
//
// What bounds them: with one warp a pair (256 pairs on 528 schedulers) a
// row costs its dependent chain and what one warp can issue around it:
// K2's LPT - 1 composes, the 5-round scan, the apply and the warp max,
// with ~5 log-add-exps a lane; K3's reverse chain, its match cells and
// ~7 exps a lane for the posterior weights (~19 MUFU operations a lane, on
// 4 MUFU lanes a scheduler).  ptxas's schedule leaves ~2 stall cycles an
// instruction (prof/kernel_sass.py).  Bytes (the 12 a cell K2 stores and
// K3 reads) are two orders of magnitude below either.

#pragma once

#include "band_fill_warp.cuh"

namespace {

// shared memory a block may hold for its warps' count tables
constexpr int kTableSmemBytes = 48 * 1024;

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_ftz(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The TPU kernels' log-add-exp (pallas_v2._lse2_fast; ov_fill_warp.cuh's
// lse):
// max(a, b) + ln 2 * lg2(1 + 2^(-|a - b| * log2 e)), the same operations on
// the same values, in 8 instructions without a predicate.  lse's
// __expf and __logf check for denormals (a compare feeding a predicated
// multiply each, ~13 stall cycles on this card) and its guard for two
// operands near -inf is a third; here exp and log flush to zero (exp's
// denormal results add nothing to 1, and log's argument is at least 1),
// and the guard is a clamp of the exponent at -200, which maps the NaN of
// -inf - -inf to 2^-200 = 0 (fmaxf returns its other operand), so the sum
// is the max; where the max is below -1e38 the added <= ln 2 rounds away,
// as the guard returns it.
__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float x = fmaxf(-fabsf(a - b) * 1.44269504f, -200.f);
  return fmaf(lg2_ftz(1.f + ex2_ftz(x)), 0.693147182f, m);
}

// K3's float64 cells (its smem route, estep_smem.cu): the max and the sum
// in float64, the correction ln 2 * lg2(1 + 2^x) in float32 as above (its
// absolute error, ~1e-7 nats, does not grow with the cells' magnitude);
// two operands at -inf give NaN in the difference, which the clamp maps to
// -200 as above
__device__ __forceinline__ double lse2(double a, double b) {
  const double m = fmax(a, b);
  const float x = fmaxf((float)-fabs(a - b) * 1.44269504f, -200.f);
  return m + (double)(lg2_ftz(1.f + ex2_ftz(x)) * 0.693147182f);
}

// K3's warp route's posterior weight: the TPU kernel's exp(min(logw + c,
// 40)) (_bwd_kernel's post, a hardware exp on the TPU) by the card's
// hardware exp, 2 instructions where expf takes 8; its relative error
// (~1e-6 at the clamp) is far inside the counts' tolerance, and each
// row's weights are renormalised by their sum
__device__ __forceinline__ float post_fast(float logw, float c) {
  return ex2_ftz(fminf(logw + c, 40.f) * 1.44269504f);
}

// inclusive scan over the first `span` threads of a warp (a warp-uniform
// count) of maps x -> lse(x + c, b), composed in lane order (UP) or from
// the high lanes down
template <bool UP, typename T>
__device__ __forceinline__ void scan_maps(T& c, T& b, int t, int span) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= span) break;
    const T co = UP ? __shfl_up_sync(kFull, c, off)
                    : __shfl_down_sync(kFull, c, off);
    const T bo = UP ? __shfl_up_sync(kFull, b, off)
                    : __shfl_down_sync(kFull, b, off);
    if (UP ? t >= off : t + off < 32) {
      b = lse2(bo + c, b);  // the earlier maps (co, bo), then ours
      c = co + c;
    }
  }
}

// `v` of the thread's lane k-1 (k > 0) or of the previous thread's last
// lane (NEG before lane 0)
template <int LPT>
__device__ __forceinline__ float lane_lo(const float (&v)[LPT], int k,
                                         float prev_last) {
  return k > 0 ? v[k > 0 ? k - 1 : 0] : prev_last;
}

// `v` of the thread's lane k+1 or of the next thread's first lane
template <int LPT>
__device__ __forceinline__ float lane_hi(const float (&v)[LPT], int k,
                                         float next_first) {
  return k + 1 < LPT ? v[k + 1 < LPT ? k + 1 : k] : next_first;
}

template <int LPT>
__device__ __forceinline__ float from_prev_thread(const float (&v)[LPT],
                                                  int t) {
  const float x = __shfl_up_sync(kFull, v[LPT - 1], 1);
  return t == 0 ? neg_big() : x;
}

template <int LPT>
__device__ __forceinline__ float from_next_thread(const float (&v)[LPT],
                                                  int t) {
  const float x = __shfl_down_sync(kFull, v[0], 1);
  return t == 31 ? neg_big() : x;
}

// the thread's lanes of a stored row, written (those inside W)
template <int LPT>
__device__ __forceinline__ void store_row(float* row, const float (&v)[LPT],
                                          int t, int W) {
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    if (t * LPT + k < W) row[t * LPT + k] = v[k];
}

// the thread's lanes of a stored row (NEG past W)
template <int LPT>
__device__ __forceinline__ void load_row_cells(float (&v)[LPT],
                                               const float* row, int t,
                                               int W) {
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    v[k] = t * LPT + k < W ? __ldg(row + t * LPT + k) : neg_big();
}

// the thread's lanes' diagonal - 1: a lane's ref index i - 1 in row j is
// dg + j (lanes past W take the sentinel diagonal)
template <int LPT>
__device__ __forceinline__ void init_diagonals(int (&dg)[LPT],
                                               const int* doff, int W,
                                               int t) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = t * LPT + k;
    dg[k] = (w < W ? doff[w] : kSentinel) - 1;
  }
}

// ---------------------------------------------------------------- K2

// the thread's lanes of the fill: the previous row's cells, diagonal - 1,
// the ref token of the row being filled
template <int LPT>
struct FwdLanes {
  float mat[LPT], ins[LPT], del[LPT];
  int dg[LPT], tok[LPT];
};

// what a warp's rows share: its pair's inputs and where its rows go
struct FwdPair {
  FillTables tb;
  Trans tr;
  const int4* kb;     // the pair's keys
  const uint8_t* xb;  // its ref tokens
  float* rows;        // its row 0 in the match plane
  double* offs;       // its offsets
  size_t plane;       // floats from one plane to the next
  int xmax, xlen, ylen, W, t, span;
  bool hq, local;
};

// row j of the scaled Forward fill from row j-1's cells in s, stored with
// its offset (FIRST: j == 1, where a path may start).  Row j+1's loads
// (rn from key kn and indel context ctx, the key kn2 of row j+2, the
// tokens tn) issue after the match and insert cells, in the delete
// chain's stall cycles: issued first, their address arithmetic held up
// the row's start.
template <int LPT, bool FIRST>
__device__ __forceinline__ void fwd_store_row(FwdLanes<LPT>& s,
                                              const RowIn& r, double& off,
                                              const FwdPair& P, int j,
                                              int4 kn, int ctx, RowIn& rn,
                                              int4& kn2, int (&tn)[LPT]) {
  const float NEG = neg_big();
  const int t = P.t;
  const float mat_r = from_next_thread(s.mat, t);
  const float ins_r = from_next_thread(s.ins, t);
  bool v[LPT];
  float mc[LPT], ic[LPT];
  // A: match and insert cells
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    v[k] = in_ref(s.dg[k], j, P.xlen);
    float a = lse2(lse2(s.mat[k] + r.m2m, s.del[k] + P.tr.d2m),
                   s.ins[k] + P.tr.i2m);
    if (FIRST && (P.local || s.dg[k] == -1)) a = lse2(a, 0.f);
    const float e = pick(r.e, s.tok[k]);
    const float ih = lse2(lane_hi(s.ins, k, ins_r) + P.tr.i2i,
                          lane_hi(s.mat, k, mat_r) + r.m2i);
    mc[k] = v[k] ? a + e : NEG;
    ic[k] = v[k] ? r.ins + ih : NEG;
  }
  rn = load_row(P.tb, P.hq, kn, ctx);
  kn2 = P.kb[min(j + 1, P.ylen - 1)];
#pragma unroll
  for (int k = 0; k < LPT; ++k) tn[k] = token(P.xb, s.dg[k] + j + 1, P.xmax);
  // B: each lane's inclusive map of the delete chain, the scan of the
  // threads' totals, the value entering the thread (-inf before lane 0)
  const float ml = from_prev_thread(mc, t);
  float pc[LPT], pb[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const float c = v[k] ? P.tr.d2d : NEG;
    const float b = v[k] ? lane_lo(mc, k, ml) + r.m2d : NEG;
    if (k == 0) {
      pc[0] = c;
      pb[0] = b;
    } else {
      const int q = k > 0 ? k - 1 : 0;
      pb[k] = lse2(pb[q] + c, b);
      pc[k] = pc[q] + c;
    }
  }
  float c_acc = pc[LPT - 1], b_acc = pb[LPT - 1];
  scan_maps<true>(c_acc, b_acc, t, P.span);
  float x = __shfl_up_sync(kFull, b_acc, 1);
  if (t == 0) x = neg_inf();
  // C: delete cells, the row's largest cell
  float dc[LPT], top = NEG;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const float d = lse2(x + pc[k], pb[k]);
    dc[k] = v[k] ? d : NEG;
    top = fmaxf(top, fmaxf(fmaxf(mc[k], ic[k]), dc[k]));
  }
  // scale the row, then store it and its offset (off the row's chain)
  top = warp_max(top);
  const float shift = top > NEG / 2 ? top : 0.f;
  off += shift;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    s.mat[k] = v[k] ? mc[k] - shift : NEG;
    s.ins[k] = v[k] ? ic[k] - shift : NEG;
    s.del[k] = v[k] ? dc[k] - shift : NEG;
  }
  float* row = P.rows + (size_t)(j - 1) * P.W;
  store_row<LPT>(row, s.mat, t, P.W);
  store_row<LPT>(row + P.plane, s.ins, t, P.W);
  store_row<LPT>(row + 2 * P.plane, s.del, t, P.W);
  if (t == 0) P.offs[j - 1] = off;
}

// one row step: row j, in which the loads of row j+1 (its inputs from the
// key loaded a row ago, the key of row j+2, the lanes' ref tokens) issue
template <int LPT, bool FIRST>
__device__ __forceinline__ void fwd_store_step(FwdLanes<LPT>& s, RowIn& r,
                                               int4& kn, int& ctx,
                                               double& off, const FwdPair& P,
                                               int j) {
  RowIn rn;
  int4 kn2;
  int tn[LPT];
  fwd_store_row<LPT, FIRST>(s, r, off, P, j, kn, ctx, rn, kn2, tn);
  ctx = indel_ctx(P.tb, kn);
  kn = kn2;
  r = rn;
#pragma unroll
  for (int k = 0; k < LPT; ++k) s.tok[k] = tn[k];
}

template <int LPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) fwd_store_warp_kernel(
    const int8_t* __restrict__ x_tok, int Lx,
    const int4* __restrict__ keys, int Ly,
    const int4* __restrict__ meta,
    const int* __restrict__ doff, int W, FillTables tb,
    const float* __restrict__ trans, int B, int local,
    float* __restrict__ out, float* __restrict__ rows,
    double* __restrict__ offs) {
  const int t = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: no barrier follows
  const float NEG = neg_big();
  const int4 pm = meta[b];
  FwdPair P;
  P.tb = tb;
  P.tr = Trans{trans[0], trans[1], trans[2], trans[3]};
  P.kb = keys + (size_t)b * Ly;
  P.xb = reinterpret_cast<const uint8_t*>(x_tok) + (size_t)b * Lx;
  P.rows = rows + (size_t)b * Ly * W;
  P.offs = offs + (size_t)b * Ly;
  P.plane = (size_t)B * Ly * W;
  P.xmax = Lx - 1;
  P.xlen = pm.x;
  // the read length from lane 0, so the row loop's trip count is uniform
  // over the warp for the compiler (as in K1's warp route)
  P.ylen = __shfl_sync(kFull, min(pm.y, Ly), 0);
  P.W = W;
  P.t = t;
  P.span = (W + LPT - 1) / LPT;
  P.hq = pm.z != 0;
  P.local = local != 0;
  const int ylen = P.ylen;

  FwdLanes<LPT> s;
  init_diagonals(s.dg, doff + (size_t)b * W, W, t);
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    s.mat[k] = NEG;
    s.ins[k] = NEG;
    s.del[k] = NEG;
    s.tok[k] = token(P.xb, s.dg[k] + 1, P.xmax);
  }

  double off = 0.0;
  RowIn r{};
  if (ylen >= 1) {
    int4 kn = P.kb[0];
    r = load_row(tb, P.hq, kn, 0);
    int ctx = indel_ctx(tb, kn);
    kn = P.kb[min(1, ylen - 1)];
    fwd_store_step<LPT, true>(s, r, kn, ctx, off, P, 1);
    for (int j = 2; j <= ylen; ++j)
      fwd_store_step<LPT, false>(s, r, kn, ctx, off, P, j);
  }
  // s.mat holds row ylen's scaled match cells and r.m2e is row ylen's (the
  // last step loaded r again from row ylen's key): the Forward score is
  // the offset plus the end row's log-sum-exp
  bool at_end[LPT];
  float vmax = NEG;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    at_end[k] = ylen >= 1 && in_ref(s.dg[k], ylen, P.xlen) &&
                (local || s.dg[k] + ylen == P.xlen - 1);
    if (at_end[k]) vmax = fmaxf(vmax, s.mat[k] + r.m2e);
  }
  const float m = warp_max(vmax);
  float score = m;
  if (m > NEG / 2) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (at_end[k]) sum += expf(s.mat[k] + r.m2e - m);
    score = m + logf(warp_sum(sum));
  }
  if (t == 0) out[b] = score > NEG / 2 ? (float)(off + (double)score) : score;
}

// ---------------------------------------------------------------- K3

// one read row's inputs for the backward sweep: the match score of each
// ref token, the insert score, the transitions of the row's indel context
// (_c) and of the previous row's (_p), and the count tables' indices
struct BwdRowIn {
  float e[4];
  float ins, m2m_c, m2i_c, m2d_c, m2e_c, m2m_p, m2i_p;
  int kx, ky, kz, ctx, ctxp;
};

// row inputs of key kk whose previous row's indel context is ikp (0 at
// row 1); the tables' indices of estep.cu's header
__device__ __forceinline__ BwdRowIn load_bwd_row(const FillTables& tb,
                                                 bool hq, int4 kk, int ikp) {
  BwdRowIn r;
  const float* mrow = hq ? tb.match + (size_t)kk.x * tb.Q + kk.y
                         : tb.match_noq + kk.x;
  const size_t sym = hq ? (size_t)tb.Km * tb.Q : (size_t)tb.Km;
#pragma unroll
  for (int s = 0; s < 4; ++s) r.e[s] = __ldg(mrow + s * sym);
  r.ins = __ldg(hq ? tb.insert + kk.z * tb.Q + kk.y : tb.insert_noq + kk.z);
  const int c = indel_ctx(tb, kk), cp = tb.n_ik == 1 ? 0 : ikp;
  r.m2m_c = __ldg(tb.ik + c * 4 + 0);
  r.m2i_c = __ldg(tb.ik + c * 4 + 1);
  r.m2d_c = __ldg(tb.ik + c * 4 + 2);
  r.m2e_c = __ldg(tb.ik + c * 4 + 3);
  r.m2m_p = __ldg(tb.ik + cp * 4 + 0);
  r.m2i_p = __ldg(tb.ik + cp * 4 + 1);
  r.kx = kk.x;
  r.ky = kk.y;
  r.kz = kk.z;
  r.ctx = kk.w;
  r.ctxp = ikp;
  return r;
}

// the thread's lanes of the backward sweep, carried from row to row: row
// j+1's from_match (its scaled backward match cell plus its match
// emission) and backward insert cell, row j's stored forward match and
// delete cells (read as row j+1's previous row), the diagonal - 1
template <int LPT>
struct BwdLanes {
  float fmx[LPT], bi[LPT], fm_c[LPT], fd_c[LPT];
  int dg[LPT];
};

// what a warp's rows share: its pair's inputs, stored rows and table
struct BwdPair {
  FillTables tb;
  Trans tr;
  const float *fm, *fi, *fd;  // its stored rows: match, insert, delete
  const double* ob;           // its forward offsets
  const int4* kb;             // its keys
  const uint8_t* xb;          // its ref tokens
  float* tab_s;               // its count table in shared memory, or
  float* tab_g;               // in global memory (one of the two null)
  double fnorm;               // its forward score
  float w_pair;               // its weight
  int xlen, ylen, xmax, W, t, span;
  bool hq, local;
};

// the scalars a warp carries from row to row
struct BwdCarry {
  int4 kc, kn;     // the keys of rows j and j-1
  double o_c;      // the forward offset of row j
  double offb;     // the backward offset
  float ie_n;      // row j+1's insert emission
  float sc;        // lanes 20, 22, .., 28: i2i, i2m, d2d, d2m, back start
};

// one round of the butterfly below: v[0, N) (statistics base .. base+N-1)
// becomes v[0, N/2), the half this lane keeps (the upper where bit N of t
// is set), summed with the partner t ^ N's copy of the same half
template <int N>
__device__ __forceinline__ void halve(float (&v)[16], int t) {
  const bool hi = (t & N) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = hi ? v[i] : v[i + N / 2];
    const float keep = hi ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, N);
  }
}

// the 16 values v (15 row statistics and a 0) summed over the warp by a
// reduce-scatter butterfly in a fixed order (16 shuffles): returns
// statistic t >> 1, the same bits in lanes 2s and 2s + 1
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int t) {
  halve<16>(v, t);
  halve<8>(v, t);
  halve<4>(v, t);
  halve<2>(v, t);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// row j of the backward sweep from row j+1's cells in s (START: j == 1,
// where a path may start).  Leaves row j's cells in s, adds its backward
// shift to offb and its counts to the table (lane 2s: statistic s,
// 1 <= s <= 9) and to sc (10 <= s <= 14).
//
// Row j's inputs (its key came a row ago), its lanes' ref tokens, row
// j-1's stored cells and offset are loaded first and used only after the
// delete chain, which hides their latency (see the top of this file).
// Branch-free a lane: every value is computed, then selected.
template <int LPT, bool START>
__device__ __forceinline__ void bwd_row(BwdLanes<LPT>& s, BwdCarry& g,
                                        const BwdPair& P, int j) {
  const float NEG = neg_big();
  const int t = P.t;
  const bool end = j == P.ylen;
  // loads: row j's inputs, the key of row j-2, the tokens of row j, the
  // stored cells of row j-1 and its offset (row 0: none, offset 0)
  const BwdRowIn r = load_bwd_row(P.tb, P.hq, g.kc, START ? 0 : g.kn.w);
  const int4 kq = P.kb[max(j - 3, 0)];
  int tok[LPT];
  float fm_p[LPT], fi_p[LPT], fd_p[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    tok[k] = token(P.xb, s.dg[k] + j, P.xmax);
    fm_p[k] = fi_p[k] = fd_p[k] = NEG;
  }
  double o_p = 0.0;
  if (!START) {
    const size_t row = (size_t)(j - 2) * P.W;
    load_row_cells<LPT>(fm_p, P.fm + row, t, P.W);
    load_row_cells<LPT>(fi_p, P.fi + row, t, P.W);
    load_row_cells<LPT>(fd_p, P.fd + row, t, P.W);
    o_p = P.ob[j - 2];
  }

  bool v[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) v[k] = in_ref(s.dg[k], j, P.xlen);
  // the backward insert cells (no delete term: ready before the chain)
  const float bi_l = from_prev_thread(s.bi, t);
  float bi_k[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    bi_k[k] = lse2(P.tr.i2m + s.fmx[k],
                   P.tr.i2i + g.ie_n + lane_lo(s.bi, k, bi_l));
  // the reverse delete chain: each lane's inclusive map from the band's
  // high end down to it, the scan of the threads' totals from thread 31
  // down, the value entering the thread (-inf past the last lane)
  float pc[LPT], pb[LPT];
#pragma unroll
  for (int q = 0; q < LPT; ++q) {
    const int k = LPT - 1 - q;
    const float c = v[k] ? P.tr.d2d : NEG;
    const float b = v[k] ? P.tr.d2m + s.fmx[k] : NEG;
    if (q == 0) {
      pc[k] = c;
      pb[k] = b;
    } else {
      const int n = k + 1 < LPT ? k + 1 : k;
      pb[k] = lse2(pb[n] + c, b);
      pc[k] = pc[n] + c;
    }
  }
  float c_acc = pc[0], b_acc = pb[0];
  scan_maps<false>(c_acc, b_acc, t, P.span);
  float x = __shfl_down_sync(kFull, b_acc, 1);
  if (t == 31) x = neg_inf();
  float bd[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const float d = lse2(x + pc[k], pb[k]);
    bd[k] = v[k] ? d : NEG;
  }

  // the backward match cells, the row's largest cell, the scaled cells
  // carried to row j-1
  const float bd_r = from_next_thread(bd, t);
  float bm[LPT], me[LPT], top = NEG;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const bool end_ok = end && (P.local || s.dg[k] + j == P.xlen - 1);
    bm[k] = lse2(lse2(end_ok ? r.m2e_c : NEG, r.m2m_c + s.fmx[k]),
                 lse2(r.m2i_c + g.ie_n + lane_lo(s.bi, k, bi_l),
                      r.m2d_c + lane_hi(bd, k, bd_r)));
    const float hi = fmaxf(bm[k], bi_k[k]);
    top = fmaxf(top, v[k] ? hi : NEG);
    me[k] = pick(r.e, tok[k]);
  }
  top = warp_max(top);
  const float shift = top > NEG / 2 ? top : 0.f;
  // row constants: forward offset of rows j and j-1 plus the backward
  // offset, minus fwd_total, in float64 once a row
  const float cc = (float)(g.o_c + g.offb - P.fnorm);
  const float cp = (float)(o_p + g.offb - P.fnorm);
  const float c0 = (float)(g.offb - P.fnorm);
  g.offb += shift;
  const float fm_pr = from_next_thread(fm_p, t);
  const float fi_pr = from_next_thread(fi_p, t);
  const float fm_cl = from_prev_thread(s.fm_c, t);
  const float fd_cl = from_prev_thread(s.fd_c, t);

  // the posterior weights of the row's cells: an invalid lane's base and
  // insert cell are NEG, so each of its weights is exp(-inf) = 0 exactly
  // (bd is NEG there already) and adds nothing to the sums
  float acc[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) acc[q] = 0.f;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const float b_k = me[k] + bm[k];
    const float base = v[k] ? b_k : NEG;
    const float bi_v = v[k] ? bi_k[k] : NEG;
    const float w_m2m = post_fast(fm_p[k] + r.m2m_p + base, cp);
    const float w_d2m = post_fast(fd_p[k] + P.tr.d2m + base, cp);
    const float w_i2m = post_fast(fi_p[k] + P.tr.i2m + base, cp);
    float w_s2m = 0.f;
    if (START) {
      const float w = post_fast(base, c0);
      w_s2m = P.local || s.dg[k] + j == 0 ? w : 0.f;
    }
    const float mc = w_m2m + w_d2m + w_i2m + w_s2m;
    const float w_m2i =
        post_fast(lane_hi(fm_p, k, fm_pr) + r.m2i_p + r.ins + bi_v, cp);
    const float w_i2i =
        post_fast(lane_hi(fi_p, k, fi_pr) + P.tr.i2i + r.ins + bi_v, cp);
    const float w_m2d =
        post_fast(lane_lo(s.fm_c, k, fm_cl) + r.m2d_c + bd[k], cc);
    const float w_d2d =
        post_fast(lane_lo(s.fd_c, k, fd_cl) + P.tr.d2d + bd[k], cc);
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
    if (START) acc[14] += w_s2m;
  }
  if (end) {  // the end row (uniform over the warp): the m2e weights
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const bool end_ok = P.local || s.dg[k] + j == P.xlen - 1;
      const float w = post_fast(s.fm_c[k] + r.m2e_c, cc);
      acc[9] += v[k] && end_ok ? w : 0.f;
    }
  }

  // the row's contribution, renormalised by its match + insert mass; the
  // table entry of each lane's statistic by selects (no branch a
  // statistic), one add each
  const float stat = reduce_scatter16(acc, t);
  const float mass = __shfl_sync(kFull, stat, 0);
  const float factor = mass > 1e-30f ? P.w_pair / mass : 0.f;
  const int q = t >> 1;  // the statistic this lane holds
  const int KmQ = P.tb.Km * P.tb.Q, Q = P.tb.Q;
  const int e_match = (q - 1) * KmQ + r.kx * Q + r.ky;
  const int e_ins = 4 * KmQ + r.kz * Q + r.ky;
  // m2m, m2i (previous context), m2d, m2e
  const int e_ik = 4 * KmQ + 4 * Q + (q < 8 ? r.ctxp : r.ctx) * 4 + (q - 6);
  const int e = q <= 4 ? e_match : (q == 5 ? e_ins : e_ik);
  const bool to_table = (t & 1) == 0 && q >= 1 && q <= 9;
  const float add = stat * factor;
  if (to_table) {
    if (P.tab_s != nullptr)
      P.tab_s[e] += add;
    else
      P.tab_g[e] += add;
  }
  g.sc += q < 14 ? add : stat;  // read on lanes 20, 22, .., 28 alone

  // carry the scaled cells to row j-1
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const float f = me[k] + (bm[k] - shift), bi = bi_k[k] - shift;
    s.fmx[k] = v[k] ? f : NEG;
    s.bi[k] = v[k] ? bi : NEG;
    s.fm_c[k] = fm_p[k];
    s.fd_c[k] = fd_p[k];
  }
  g.ie_n = r.ins;
  g.o_c = o_p;
  g.kc = g.kn;
  g.kn = kq;
}

template <int LPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) bwd_counts_warp_kernel(
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
  extern __shared__ float tab_smem[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // the whole warp: no barrier follows
  const float NEG = neg_big();
  const int4 pm = meta[b];
  const int E = 4 * tb.Km * tb.Q + 4 * tb.Q + 4 * tb.n_ik;
  float* part = partial + (size_t)b * E;
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
  P.tab_s = smem_table ? tab_smem + (size_t)warp * E : nullptr;
  P.tab_g = smem_table ? nullptr : part;
  P.fnorm = wrow[B + b];
  P.w_pair = wrow[b];
  P.xlen = pm.x;
  // the read length from lane 0 (a trip count uniform over the warp)
  P.ylen = __shfl_sync(kFull, min(pm.y, Ly), 0);
  P.xmax = Lx - 1;
  P.W = W;
  P.t = t;
  P.span = (W + LPT - 1) / LPT;
  P.hq = pm.z != 0;
  P.local = local != 0;
  const int ylen = P.ylen;
  float* tab = smem_table ? P.tab_s : P.tab_g;

  for (int e = t; e < E; e += 32) tab[e] = 0.f;
  __syncwarp();

  BwdLanes<LPT> s;
  init_diagonals(s.dg, doff + (size_t)b * W, W, t);
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    s.fmx[k] = NEG;  // row ylen+1: no backward match cell, emission 0
    s.bi[k] = NEG;
  }
  BwdCarry g;
  g.sc = 0.f;
  if (ylen >= 1) {
    load_row_cells<LPT>(s.fm_c, P.fm + (size_t)(ylen - 1) * W, t, W);
    load_row_cells<LPT>(s.fd_c, P.fd + (size_t)(ylen - 1) * W, t, W);
    g.kc = P.kb[ylen - 1];
    g.kn = P.kb[max(ylen - 2, 0)];
    g.o_c = P.ob[ylen - 1];
    g.offb = 0.0;
    g.ie_n = 0.f;
    for (int j = ylen; j >= 2; --j) bwd_row<LPT, false>(s, g, P, j);
    bwd_row<LPT, true>(s, g, P, 1);
  }
  if ((t & 1) == 0 && t >= 20 && t <= 28)
    d_sc[(size_t)(t / 2 - 10) * B + b] = g.sc;
  if (smem_table) {
    __syncwarp();
    for (int e = t; e < E; e += 32) part[e] = tab[e];
  }
}

// ---------------------------------------------------------------- launch

// the warp routes' instantiations: LPT 1, 2, 4, 8 and 16 lanes a thread,
// CASE(L) for each
#define QUAFF_ESTEP_LPT(CASE) CASE(1) CASE(2) CASE(4) CASE(8) CASE(16)

}  // namespace
