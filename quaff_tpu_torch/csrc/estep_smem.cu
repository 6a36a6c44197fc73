// K2's and K3's shared-memory cluster routes ("smem routes"): the training
// E-step's forward fill with stored rows and its backward sweep with
// posterior counts for the widest bands, each pair's band spread over the
// CTAs of a thread-block cluster, every lane's row state in a run that
// lives in the CTA's shared memory (the shared tier) or, for bands past
// what 16 CTAs hold, in a per-pair slab of global memory (the global
// tier), for NVIDIA Hopper (sm_90a).
//
// With estep.cu and estep_cluster.cu, replaces the TPU kernels
// quaff_tpu/dp/pallas_counts.py::_fwd_store (kernel _fwd_kernel) and
// ::_bwd_counts (kernel _bwd_kernel); the plain PyTorch versions are
// quaff_tpu_torch/dp/estep.py::fwd_store_reference and
// ::bwd_counts_reference.  dp/estep.estep_route sends K2's bands past
// ESTEP_WIDE_LANES and K3's past its two-level cluster route here: up to
// the kernel's ESTEP_SMEM_MAX_LANES the shared tier ("smem", the tiling of
// the kernel's ESTEP_SMEM_TABLE row), past it the global tier ("global",
// estep.global_tiling: 16 CTAs of 16 warps, lanes a thread growing with
// the band), so these routes take a band of any width.  The same inputs
// and outputs as the other routes, so any route's K2 store feeds any
// route's K3.
//
// Why.  The register-lane cluster routes (band_fill_cluster.cuh,
// estep_cluster.cu) hold a thread's lanes in registers: at 16 CTAs a pair
// (the most a cluster takes) of 16 warps (K2) or 8 (K3), 32768 lanes need
// 4 or 8 lanes a thread, and 16 spill.  Past that the former block routes
// gave a pair one SM, its row in global scratch and block reductions every
// row: 424 ms (K2) and 451 ms (K3) at chip_smoke.py phase 4b's 66 kb count
// (B=2, W=66401, 400 rows; PERF.md §6).  Here a tile is still a warp of 32
// threads that own consecutive runs of lanes, and the tiles meet as in the
// two-level fold (cluster_seam.cuh kTwoFold; K2's meeting is
// cluster_smem.cuh's, which K1's smem route shares): each tile posts its
// slot to its CTA, every warp folds its CTA's tiles after a block barrier,
// warp 0 posts the CTA's slot to every CTA, and the CTAs fold after the
// row's one cluster barrier.  What changes is where a thread's lanes live:
// a run of `lpt` lanes (a runtime count, so no register array grows with
// it) laid out [lane of the run][thread], so that a warp's accesses fall
// on 32 banks of shared memory, or on consecutive words of global memory
// (coalesced).  K2 takes 28 bytes a lane, K3 36: 16 CTAs of 16 warps hold
// 15 lanes a thread of K2 (122880 lanes, 210 KB a CTA) and 10 of K3
// (81920 lanes, 180 KB and its tiles' row statistics).  Past that each
// CTA's run lives in its own part of a slab the wrapper allocates, B * nct
// * warps * 32 * lpt lanes; a thread reads and writes only its own lanes,
// so the slab needs no fence, and one pair's slab (7.3 MB at 262144 lanes
// of K2) stays in the card's 50 MB L2.
//
// K2 runs the wide arithmetic of dp/estep.ESTEP_WIDE_LANES in float64
// cells.  On global bands of reads that need thousands of deletions the
// path that ends the read lies hundreds to ~10^4 nats below its row's
// largest cell, where a float32 step rounds at 6e-5 to 5e-4 nats; float32
// cells put the forward score up to 3.7e-2 nats off the float64 fill at
// 32769 lanes (PERF.md §7).  So a lane's match, insert and delete cells
// are doubles, every sum is a double, and a log-add-exp takes its one
// transcendental, log1p(exp(-|a - b|)) of the doubles' difference, in
// float32, whose absolute error (~1e-7 nats) does not grow with the
// cells' magnitude.  The row's shift is its largest match or insert cell
// (known before the fold, so it rides on the row's own exchange and row j
// is stored as soon as its delete cells are: no row of lag, no second
// copy of a row), added to the pair's float64 offset; the stored rows stay
// float32 relative to it, one rounding a cell.
//
// K3 runs float64 cells too (dp/estep.ESTEP_BWD_F64_LANES: every band of
// this route): its backward match, insert and delete cells, the reverse
// chain's maps and its row constants are doubles, each log-add-exp takes
// its correction in float32 (estep_warp.cuh's lse2 on doubles), and each
// posterior weight's argument (stored forward cell + transition +
// backward cell + row constant) is summed in float64 before the float32
// exp.  Its float32 backward total (the cluster route's relative chain
// and posterior-mode shift) left the back-start posterior up to 3.9e-3 off 1
// at 35506-65536 lanes, near the counts' 5e-3, and that drift grows with
// the band's deletions.  In float64 no shift position matters, so the row
// is shifted by its largest cell, as the plain version does.  The row
// statistics stay float32 sums of float32 weights.  Its per-lane loop
// reads the stored forward cells it needs (row j and j-1, lanes w-1, w,
// w+1) straight from global memory; each lane's reverse map c (a sum of
// d2d terms) is recomputed in the second pass in the first pass's order,
// so only its b map is kept in the run.
//
// No float atomics: every sum's association order depends only on the pair
// and the tiling, so reruns are bit-identical, and the two tiers give the
// same bits at the same tiling.
//
// What bounds them: per row the longest live tile's run (lpt lanes of
// shared- or global-memory reads and writes, ~5 log-add-exps a lane in
// float64 sums) plus the block barrier, the cluster barrier and the folds'
// scans; the bytes (12 a cell K2 stores and K3 reads) are an order of
// magnitude below.

#include "cluster_smem.cuh"
#include "estep_cluster.cuh"

namespace {

// bytes a lane of each kernel's run: K2's match, insert and delete cells
// (float64) and the diagonal - 1; K3's from_match, backward insert cells of
// rows j+1 and j, reverse chain b map (float64) and the diagonal - 1
constexpr size_t kFwdLaneBytes = 3 * sizeof(double) + sizeof(int);
constexpr size_t kBwdLaneBytes = 4 * sizeof(double) + sizeof(int);

// ---------------------------------------------------------------- K2

// K2: the scaled Forward fill of K1 with float64 cells, storing every
// row's cells to rows[3][B][Ly][W] relative to the row's offset offs[B][Ly]
// and each pair's Forward score to out[b].  The run (GLOBAL: this CTA's
// part of `slab`, else dynamic shared memory): the previous row's match,
// insert and delete cells (float64) and the diagonal - 1 of each of the
// CTA's lanes, [lane of the run][thread].
template <bool GLOBAL>
__global__ void __launch_bounds__(kSmemMaxWarps * 32, 1) fwd_store_smem_kernel(
    const int8_t* __restrict__ x_tok, int Lx, const int4* __restrict__ keys,
    int Ly, const int4* __restrict__ meta, const int* __restrict__ doff,
    int W, const int* __restrict__ seg_start,
    const int* __restrict__ seg_width, int S, FillTables tb,
    const float* __restrict__ trans, int B, int local, int lpt,
    unsigned char* __restrict__ slab, float* __restrict__ out,
    float* __restrict__ rows, double* __restrict__ offs) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  __shared__ RowSlots<double> slots;
  __shared__ double ends[kMaxClusterCtas * kSmemMaxWarps][2];

  const int NT = blockDim.x, tid = threadIdx.x;
  const int nct = cluster_ctas(), rank = cluster_rank();
  const int nw = NT >> 5, t = tid & 31, wi = tid >> 5;
  const int T = nct * nw, g = rank * nw + wi;
  const int b = blockIdx.x / nct;
  const float NEGF = neg_big();
  const double NEG = (double)NEGF;
  const size_t run = (size_t)lpt * NT;
  unsigned char* lanes =
      GLOBAL ? slab + (size_t)blockIdx.x * run * kFwdLaneBytes : fwd_smem;
  double* Mc = reinterpret_cast<double*>(lanes);
  double* Ic = Mc + run;
  double* Dc = Ic + run;
  int* dgs = reinterpret_cast<int*>(Dc + run);
  const int4 pm = meta[b];
  const int xlen = pm.x, ylen = __shfl_sync(kFull, min(pm.y, Ly), 0);
  const bool hq = pm.z != 0;
  const double d2d = trans[0], d2m = trans[1], i2i = trans[2], i2m = trans[3];
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

  double M0 = NEG, I0 = NEG;          // the thread's first lane, last row
  double seam_m = NEG, seam_i = NEG;  // thread 31: the next tile's
  double off = 0.0;
  const size_t plane = (size_t)B * Ly * W;
  float* prow = rows + (size_t)b * Ly * W;
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
      const double m2d = r.m2d;
      double post[kRWords];
#pragma unroll
      for (int q = 0; q < kRWords; ++q) post[q] = NEG;
      double ce = 0.0, be = -INFINITY, ml = NEG;
      if (lv) {
        // A: the match and insert cells in place of the previous row's
        // (lane w+1's of the previous row read first), the thread's delete
        // chain over its lanes but the first, whose opening term needs the
        // previous thread's last match cell
        double mr = __shfl_down_sync(kFull, M0, 1);
        double ir = __shfl_down_sync(kFull, I0, 1);
        if (t == 31) {
          mr = seam_m;
          ir = seam_i;
        }
        double m_nx = Mc[tid], i_nx = Ic[tid];
        double mprev = NEG, C = 0.0, Bc = -INFINITY, top = NEG;
        double c0 = NEG, mc0 = NEG, ic0 = NEG;
        bool v0 = false;
        for (int k = 0; k < lpt; ++k) {
          const int a = k * NT + tid;
          const double m_o = m_nx, i_o = i_nx, d_o = Dc[a];
          if (k + 1 < lpt) {
            m_nx = Mc[a + NT];
            i_nx = Ic[a + NT];
          } else {
            m_nx = mr;
            i_nx = ir;
          }
          const int dg = dgs[a];
          const bool v = in_ref(dg, j, xlen);
          double s = comb<false>(comb<false>(m_o + (double)r.m2m, d_o + d2m),
                                 i_o + i2m);
          if (j == 1 && (local || dg == -1)) s = comb<false>(s, 0.0);
          const float e = pick(r.e, token(xb, dg + j, xmax));
          const double mc = v ? s + (double)e : NEG;
          const double ic =
              v ? (double)r.ins +
                      comb<false>(i_nx + i2i, m_nx + (double)r.m2i)
                : NEG;
          Mc[a] = mc;
          Ic[a] = ic;
          if (v) top = fmax(top, fmax(mc, ic));
          if (k == 0) {
            v0 = v;
            c0 = v ? d2d : NEG;
            mc0 = mc;
            ic0 = ic;
          } else {
            const double c = v ? d2d : NEG;
            const double bb = v ? mprev + m2d : NEG;
            Bc = comb<false>(Bc + c, bb);
            C += c;
          }
          mprev = mc;
        }
        ml = __shfl_up_sync(kFull, mprev, 1);
        // the thread's step: its first lane's, then the rest (thread 0's
        // first lane is the tile's, which joins at the fold)
        double cc = C, bc = Bc;
        if (t > 0) {
          const double b0 = v0 ? ml + m2d : NEG;
          bc = comb<false>(b0 + C, Bc);
          cc = c0 + C;
        }
        warp_scan<false>(cc, bc, t);
        ce = __shfl_up_sync(kFull, cc, 1);
        be = __shfl_up_sync(kFull, bc, 1);
        post[kRC] = __shfl_sync(kFull, cc, 31);
        post[kRB] = __shfl_sync(kFull, bc, 31);
        post[kRC0] = __shfl_sync(kFull, c0, 0);
        post[kRM0] = __shfl_sync(kFull, mc0, 0);
        post[kRI0] = __shfl_sync(kFull, ic0, 0);
        post[kRML] = __shfl_sync(kFull, mprev, 31);
        post[kRTop] = warp_max_t(top);
      }
      // the row's meeting (cluster_smem.cuh); the row's shift, its largest
      // match or insert cell, from the CTAs' slots
      const RowMeet<double> meet = smem_meet<false>(
          slots, j & 1, post, m2d, t, wi, nw, rank, nct, [&] {
            ctx = indel_ctx(tb, kn);
            kn = kn2;
          });
      const double shift = meet.top > NEG / 2 ? meet.top : 0.0;
      const double d0 = meet.d0;
      seam_m = meet.nm <= NEG / 2 ? NEG : meet.nm - shift;
      seam_i = meet.ni <= NEG / 2 ? NEG : meet.ni - shift;

      // C: the delete cells from the value entering the thread, the row
      // less its shift, kept and stored
      float* row = prow + (size_t)(j - 1) * W;
      if (lv) {
        double x = t == 0 ? d0 : comb<false>(d0 + ce, be);
        double mprev = ml;
        for (int k = 0; k < lpt; ++k) {
          const int a = k * NT + tid, w = w0 + k;
          const double mc = Mc[a], ic = Ic[a];
          const bool v = in_ref(dgs[a], j, xlen);
          if (k > 0 || t > 0)
            x = comb<false>(x + (v ? d2d : NEG), v ? mprev + m2d : NEG);
          mprev = mc;
          const double ms = v ? mc - shift : NEG;
          const double is = v ? ic - shift : NEG;
          const double ds = v ? x - shift : NEG;
          Mc[a] = ms;
          Ic[a] = is;
          Dc[a] = ds;
          if (k == 0) {
            M0 = ms;
            I0 = is;
          }
          if (w < W) {
            row[w] = to_row(ms);
            row[plane + w] = to_row(is);
            row[2 * plane + w] = to_row(ds);
          }
        }
      } else {
        for (int k = 0; k < lpt; ++k) {
          const int w = w0 + k;
          if (w < W) {
            row[w] = NEGF;
            row[plane + w] = NEGF;
            row[2 * plane + w] = NEGF;
          }
        }
      }
      off += shift;
      if (g == 0 && t == 0) offs[(size_t)b * Ly + j - 1] = off;
      r = rn;
    }
  }

  // end row: each tile's largest end cell and its sum of exponentials to
  // CTA 0, which reduces them in tile order (lane h: tiles h, h + 32, ..)
  double vmax = NEG;
  for (int k = 0; k < lpt; ++k) {
    const int a = k * NT + tid, dg = dgs[a];
    const bool at_end = ylen >= 1 && in_ref(dg, ylen, xlen) &&
                        (local || dg + ylen == xlen - 1);
    if (at_end) vmax = fmax(vmax, Mc[a] + (double)r.m2e);
  }
  const double em = warp_max_t(vmax);
  float sum = 0.f;
  if (em > NEG / 2) {
    for (int k = 0; k < lpt; ++k) {
      const int a = k * NT + tid, dg = dgs[a];
      const bool at_end = ylen >= 1 && in_ref(dg, ylen, xlen) &&
                          (local || dg + ylen == xlen - 1);
      if (at_end) sum += expf((float)(Mc[a] + (double)r.m2e - em));
    }
  }
  sum = warp_sum(sum);
  if (t == 0) {
    if (nct > 1)
      remote_store2d(remote_addr(&ends[g][0], 0), em, (double)sum);
    else {
      ends[g][0] = em;
      ends[g][1] = sum;
    }
  }
  cluster_sync(nct);
  if (rank == 0 && tid < 32) {
    double mt = NEG;
    for (int h = t; h < T; h += 32) mt = fmax(mt, ends[h][0]);
    const double m = warp_max_t(mt);
    double score = NEG;
    if (m > NEG / 2) {
      float part = 0.f;
      for (int h = t; h < T; h += 32)
        if (ends[h][0] > NEG / 2)
          part += (float)ends[h][1] * expf((float)(ends[h][0] - m));
      score = m + (double)logf(warp_sum(part));
    }
    if (t == 0) out[b] = score > NEG / 2 ? (float)(off + score) : NEGF;
  }
}

// ---------------------------------------------------------------- K3

// K3's slot words (a RowSlot<double> of cluster_smem.cuh): a tile's (or,
// at level 2, a CTA's) reverse delete-chain map (c, b) over its lanes, its
// last lane's backward insert cell of this row (unshifted, NEG where
// invalid) and its largest backward cell of the previous row
enum { kDC, kDB, kDBiL, kDTop };

// a posterior weight from its log term (stored forward cell + transition
// + backward cell + the row constant) summed in float64: the clamp at 40
// and the hardware exp of post_fast in float32
__device__ __forceinline__ float post_wide(double logw) {
  return ex2_ftz(fminf((float)logw, 40.f) * 1.44269504f);
}

// K3: the backward sweep and posterior counts of bwd_counts_cluster_kernel
// <LPT, kTwoFold> in float64 cells (the header above).  Dynamic shared
// memory: the count table (CTA 0, smem_table), the tiles' row statistics
// (CTA 0), then (the shared tier) the run: [lane of the run][thread]
// arrays of row j+1's from_match (backward match cell plus emission), the
// backward insert cells of rows j+1 and j, the reverse chain's inclusive b
// map from the thread's high end (float64) and the diagonal - 1; GLOBAL
// keeps the run in this CTA's part of `slab`.
template <bool GLOBAL>
__global__ void __launch_bounds__(kSmemMaxWarps * 32, 1)
    bwd_counts_smem_kernel(
        const int8_t* __restrict__ x_tok, int Lx,
        const int4* __restrict__ keys, int Ly,
        const int4* __restrict__ meta, const int* __restrict__ doff, int W,
        FillTables tb, const float* __restrict__ trans,
        const float* __restrict__ wrow,   // [2][B]: pair weight, fwd normaliser
        const float* __restrict__ rows,   // K2's [3][B][Ly][W], relative
        const double* __restrict__ offs,  // K2's row offsets [B][Ly]
        int B, int local, int lpt, int smem_table,
        unsigned char* __restrict__ slab,
        float* __restrict__ partial,  // [B][E]
        float* __restrict__ d_sc) {   // [5][B]
  extern __shared__ __align__(16) float bwd_smem[];
  __shared__ RowSlot<double> lslots[2][kSmemMaxWarps];
  __shared__ RowSlot<double> slots[2][kMaxClusterCtas];

  const int NT = blockDim.x, tid = threadIdx.x;
  const int nct = cluster_ctas(), rank = cluster_rank();
  const int nw = NT >> 5, t = tid & 31, wi = tid >> 5;
  const int T = nct * nw, g = rank * nw + wi;
  const int b = blockIdx.x / nct;
  const float NEGF = neg_big();
  const double NEG = (double)NEGF;
  const int E = 4 * tb.Km * tb.Q + 4 * tb.Q + 4 * tb.n_ik;
  float* st = bwd_smem + (smem_table ? bwd_table_floats(E) : 0);
  const size_t run = (size_t)lpt * NT;
  unsigned char* lanes =
      GLOBAL ? slab + (size_t)blockIdx.x * run * kBwdLaneBytes
             : reinterpret_cast<unsigned char*>(st + (size_t)2 * T * 16);
  double* fmx = reinterpret_cast<double*>(lanes);
  double* bio = fmx + run;  // row j+1's backward insert cells
  double* bin = fmx + 2 * run;  // row j's
  double* pbs = fmx + 3 * run;
  int* dgs = reinterpret_cast<int*>(fmx + 4 * run);
  const int4 pm = meta[b];
  const size_t plane = (size_t)B * Ly * W;
  const float* fm = rows + (size_t)b * Ly * W;
  const float* fi = fm + plane;
  const float* fd = fm + 2 * plane;
  const double* ob = offs + (size_t)b * Ly;
  const int4* kb = keys + (size_t)b * Ly;
  const auto* xb = reinterpret_cast<const uint8_t*>(x_tok) + (size_t)b * Lx;
  const double fnorm = wrow[B + b];
  const float w_pair = wrow[b];
  const int xlen = pm.x, xmax = Lx - 1;
  const int ylen = __shfl_sync(kFull, min(pm.y, Ly), 0);
  const bool hq = pm.z != 0, lcl = local != 0;
  const double d2d = trans[0], d2m = trans[1], i2i = trans[2], i2m = trans[3];
  const int w0 = (g * 32 + t) * lpt;  // the thread's first lane
  float* tab = smem_table ? bwd_smem : partial + (size_t)b * E;  // tile 0's

  if (g == 0) {
    for (int e = t; e < E; e += 32) tab[e] = 0.f;
    __syncwarp();
  }
  int lo = 1 << 30, hi = -(1 << 30);
  for (int k = 0; k < lpt; ++k) {
    const int w = w0 + k, a = k * NT + tid;
    const int d = w < W ? doff[(size_t)b * W + w] : kSentinel;
    const int l = max(1, 1 - d), h = min(ylen, xlen - d);
    if (d != kSentinel && h >= l) {
      lo = min(lo, l);
      hi = max(hi, h);
    }
    dgs[a] = d - 1;
    fmx[a] = NEG;  // row ylen+1: no backward match cell, emission 0
    bio[a] = NEG;
    bin[a] = NEG;
  }
  const int tlo = warp_min_i(lo), thi = warp_max_i(hi);
  cluster_sync(nct);

  float sc = 0.f;  // lanes 20, 22, .., 28: i2i, i2m, d2d, d2m, back start
  if (ylen >= 1) {
    int4 kc = kb[ylen - 1], kn = kb[max(ylen - 2, 0)];
    double o_c = ob[ylen - 1], offb = 0.0;
    double ie_n = 0.0;
    double bi_in = NEG;  // thread 0: row j+1's insert cell of lane w0 - 1
    double top = NEG;    // the tile's largest cell of row j+1
    float stat = 0.f;    // lane 2s: the tile's statistic s of row j+1
    int4 key_p = {};     // row j+1's key and previous context (tile 0)
    int ctxp_p = 0;
    for (int j = ylen; j >= 1; --j) {
      const bool lv = tlo <= j && j <= thi;
      const bool end = j == ylen;
      const BwdRowIn r = load_bwd_row(tb, hq, kc, j >= 2 ? kn.w : 0);
      const int4 kq = kb[max(j - 3, 0)];
      const double o_p = j >= 2 ? ob[j - 2] : 0.0;

      // before the barrier: the backward insert cells (no delete term)
      // and the thread's reverse delete-chain maps from row j+1's
      // unshifted cells
      double c_acc = 0.0, b_acc = -INFINITY, bi_l = NEG;
      double pc0 = 0.0, pb0 = NEG;  // the thread's first lane's maps
      double post[kRWords];
#pragma unroll
      for (int q = 0; q < kRWords; ++q) post[q] = NEG;
      if (lv) {
        bi_l = __shfl_up_sync(kFull, bio[(lpt - 1) * NT + tid], 1);
        if (t == 0) bi_l = bi_in;
        double bprev = bi_l, bik_l = NEG;
        bool v_l = false;
        for (int k = 0; k < lpt; ++k) {
          const int a = k * NT + tid;
          const double bik = lse2(i2m + fmx[a], i2i + ie_n + bprev);
          bprev = bio[a];
          bin[a] = bik;
          v_l = in_ref(dgs[a], j, xlen);
          bik_l = bik;
        }
        double pc = 0.0, pb = -INFINITY;
        for (int k = lpt - 1; k >= 0; --k) {
          const int a = k * NT + tid;
          const bool v = in_ref(dgs[a], j, xlen);
          const double cv = v ? d2d : NEG;
          const double bv = v ? d2m + fmx[a] : NEG;
          if (k == lpt - 1) {
            pc = cv;
            pb = bv;
          } else {
            pb = lse2(pb + cv, bv);
            pc = pc + cv;
          }
          pbs[a] = pb;
        }
        c_acc = pc0 = pc;
        b_acc = pb0 = pb;
        scan_maps<false>(c_acc, b_acc, t, 32);
        post[kDC] = __shfl_sync(kFull, c_acc, 0);
        post[kDB] = __shfl_sync(kFull, b_acc, 0);
        post[kDBiL] = __shfl_sync(kFull, v_l ? bik_l : NEG, 31);
      }
      post[kDTop] = top;
      const int buf = j & 1;
      if (t == 0) {
#pragma unroll
        for (int q = 0; q < kRWords; ++q) lslots[buf][wi].v[q] = post[q];
      }
      if (!end) post_stats(st, T, buf, g, stat, t, nct);
      __syncthreads();
      // level 1: lane h takes the CTA's tile h; composed from its last
      // tile down, lane h holds tiles h .. nw - 1
      double lv_[kRWords];
      if (t < nw) {
        read_slot(lslots[buf][t], lv_);
      } else {
#pragma unroll
        for (int q = 0; q < kRWords; ++q) lv_[q] = NEG;
      }
      double lc = 0.0, lb = -INFINITY;
      if (t < nw) {
        lc = lv_[kDC];
        lb = lv_[kDB];
      }
      scan_maps<false>(lc, lb, t, 32);
      const double sfc = __shfl_sync(kFull, lc, min(wi + 1, 31));
      const double sfb = __shfl_sync(kFull, lb, min(wi + 1, 31));
      if (wi == 0) {
        double cpost[kRWords];
#pragma unroll
        for (int q = 0; q < kRWords; ++q) cpost[q] = 0.0;
        cpost[kDC] = __shfl_sync(kFull, lc, 0);
        cpost[kDB] = __shfl_sync(kFull, lb, 0);
        cpost[kDBiL] = __shfl_sync(kFull, lv_[kDBiL], nw - 1);
        cpost[kDTop] = warp_max_t(t < nw ? lv_[kDTop] : NEG);
        post_cta_slot(slots, buf, rank, cpost, t, nct);
      }
      seam_arrive(nct);
      seam_wait(nct);

      // row j+1's shift (its largest backward cell), row j's backward
      // offset, and the previous tile's last insert cell of row j (less
      // the shift) for row j-1
      double sv[kRWords];
      if (t < nct) {
        read_slot(slots[buf][t], sv);
      } else {
#pragma unroll
        for (int q = 0; q < kRWords; ++q) sv[q] = NEG;
      }
      const double tm = warp_max_t(sv[kDTop]);
      const double shift = tm > NEG / 2 ? tm : 0.0;
      offb += shift;
      double bi_next = NEG;
      if (wi > 0 || rank > 0) {
        double pv[kRWords];
        if (wi > 0)
          read_slot(lslots[buf][wi - 1], pv);
        else
          read_slot(slots[buf][rank - 1], pv);
        bi_next = pv[kDBiL] - shift;
      }

      double top_j = NEG;
      float stat_j = 0.f;
      if (lv) {
        // the value entering the thread from the right: CTA `rank`'s, then
        // the tiles after this one in its CTA, then the threads after it
        double fc = 0.0, fb = -INFINITY;
        if (t < nct) {
          fc = sv[kDC];
          fb = sv[kDB];
        }
        scan_maps<false>(fc, fb, t, 32);
        double xt = __shfl_down_sync(kFull, fb, 1);
        if (t == 31) xt = -INFINITY;
        double x_in = __shfl_sync(kFull, xt, rank);
        if (wi + 1 < nw) x_in = lse2(x_in + sfc, sfb);
        const double cn = __shfl_down_sync(kFull, c_acc, 1);
        const double bn = __shfl_down_sync(kFull, b_acc, 1);
        const double x = t == 31 ? x_in : lse2(x_in + cn, bn);
        // lane w+1's delete cell (unshifted): the next thread's first
        const double bd_first =
            in_ref(dgs[tid], j, xlen) ? lse2(x + pc0, pb0) : NEG;
        double bd_hi = __shfl_down_sync(kFull, bd_first, 1);
        if (t == 31) bd_hi = x_in;
        // row constants: forward offset of rows j and j-1 plus the
        // backward offset, minus fwd_total
        const double cc = o_c + offb - fnorm;
        const double cp = o_p + offb - fnorm;
        const double c0 = offb - fnorm;
        const float* fm_c = fm + (size_t)(j - 1) * W;  // row j
        const float* fd_c = fd + (size_t)(j - 1) * W;
        const float* fm_p = fm + (size_t)(j >= 2 ? j - 2 : 0) * W;  // row j-1
        const float* fi_p = fi + (size_t)(j >= 2 ? j - 2 : 0) * W;
        const float* fd_p = fd + (size_t)(j >= 2 ? j - 2 : 0) * W;
        const int wh = w0 + lpt;  // lane w+1 of the thread's last lane
        float fmp_hi = j >= 2 && wh < W ? __ldg(fm_p + wh) : NEGF;
        float fip_hi = j >= 2 && wh < W ? __ldg(fi_p + wh) : NEGF;
        float fmc_w = wh - 1 < W ? __ldg(fm_c + wh - 1) : NEGF;
        float acc[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[q] = 0.f;
        double tmx = NEG, pc = 0.0;
        // from the thread's last lane down: each lane's delete cell, then
        // its backward match cell, the row's cells less row j+1's shift,
        // its posterior weights (the warp route's), row j's cells carried
        for (int k = lpt - 1; k >= 0; --k) {
          const int a = k * NT + tid, w = w0 + k;
          const int dg = dgs[a];
          const bool v = in_ref(dg, j, xlen);
          const double f = fmx[a];
          const double bo_lo = k > 0 ? bio[a - NT] : bi_l;
          const double cv = v ? d2d : NEG;
          pc = k == lpt - 1 ? cv : pc + cv;  // the first pass's c map
          const double bdu = v ? lse2(x + pc, pbs[a]) : NEG;
          const bool end_ok = end && (lcl || dg + j == xlen - 1);
          const double m =
              lse2(lse2(end_ok ? (double)r.m2e_c : NEG, r.m2m_c + f),
                   lse2(r.m2i_c + ie_n + bo_lo, r.m2d_c + bd_hi));
          const double bm = m - shift;
          const double bik = bin[a] - shift;
          const double bd = v ? bdu - shift : NEG;
          tmx = fmax(tmx, v ? fmax(bm, bik) : NEG);
          const float me = pick(r.e, token(xb, dg + j, xmax));
          const float fmc = fmc_w;  // row j's forward match cell at w
          const bool in = w < W;
          const float fmp = j >= 2 && in ? __ldg(fm_p + w) : NEGF;
          const float fip = j >= 2 && in ? __ldg(fi_p + w) : NEGF;
          const float fdp = j >= 2 && in ? __ldg(fd_p + w) : NEGF;
          const bool lo_in = w >= 1 && w - 1 < W;
          const float fml = lo_in ? __ldg(fm_c + w - 1) : NEGF;
          const float fdl = lo_in ? __ldg(fd_c + w - 1) : NEGF;
          // an invalid lane's base and insert cell are NEG, so each of its
          // weights is exp(-inf) = 0 exactly
          const double base_k = v ? me + bm : NEG;
          const double bi_v = v ? bik : NEG;
          const float w_m2m = post_wide((double)fmp + r.m2m_p + base_k + cp);
          const float w_d2m = post_wide((double)fdp + d2m + base_k + cp);
          const float w_i2m = post_wide((double)fip + i2m + base_k + cp);
          float w_s2m = 0.f;
          if (j == 1) {
            const float ws = post_wide(base_k + c0);
            w_s2m = lcl || dg + j == 0 ? ws : 0.f;
          }
          const float mc = w_m2m + w_d2m + w_i2m + w_s2m;
          const float w_m2i =
              post_wide((double)fmp_hi + r.m2i_p + r.ins + bi_v + cp);
          const float w_i2i =
              post_wide((double)fip_hi + i2i + r.ins + bi_v + cp);
          const float w_m2d = post_wide((double)fml + r.m2d_c + bd + cc);
          const float w_d2d = post_wide((double)fdl + d2d + bd + cc);
          acc[0] += mc + w_m2i + w_i2i;
          const int tk = token(xb, dg + j, xmax);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[1 + q] += tk == q ? mc : 0.f;
          acc[5] += w_m2i + w_i2i;
          acc[6] += w_m2m;
          acc[7] += w_m2i;
          acc[8] += w_m2d;
          acc[10] += w_i2i;
          acc[11] += w_i2m;
          acc[12] += w_d2d;
          acc[13] += w_d2m;
          acc[14] += w_s2m;
          if (end) {  // the end row (uniform over the cluster): m2e weights
            const bool e_ok = lcl || dg + j == xlen - 1;
            const float we = post_wide((double)fmc + r.m2e_c + cc);
            acc[9] += v && e_ok ? we : 0.f;
          }
          // carry row j's cells to row j-1 (its shift comes with it)
          fmx[a] = v ? me + bm : NEG;
          bin[a] = v ? bik : NEG;
          bd_hi = bdu;
          fmp_hi = fmp;
          fip_hi = fip;
          fmc_w = fml;
        }
        top_j = warp_max_t(tmx);
        stat_j = reduce_scatter16(acc, t);
      }
      // tile 0: row j+1's table update, from the statistics the tiles
      // posted with this row
      if (g == 0 && !end)
        bwd_table_add(st, T, buf, T, t, key_p, ctxp_p, tb, w_pair, tab, sc);
      key_p = make_int4(r.kx, r.ky, r.kz, r.ctx);
      ctxp_p = r.ctxp;
      top = top_j;
      stat = stat_j;
      bi_in = bi_next;
      ie_n = r.ins;
      o_c = o_p;
      kc = kn;
      kn = kq;
      double* tmp = bio;
      bio = bin;
      bin = tmp;
    }
    // row 1's statistics by one more exchange
    post_stats(st, T, 0, g, stat, t, nct);
    cluster_sync(nct);
    if (g == 0)
      bwd_table_add(st, T, 0, T, t, key_p, ctxp_p, tb, w_pair, tab, sc);
  } else {
    cluster_sync(nct);
  }
  if (g == 0) {
    if ((t & 1) == 0 && t >= 20 && t <= 28)
      d_sc[(size_t)(t / 2 - 10) * B + b] = sc;
    if (smem_table) {
      __syncwarp();
      float* part = partial + (size_t)b * E;
      for (int e = t; e < E; e += 32) part[e] = tab[e];
    }
  }
}

// K3's dynamic shared memory: the count table, the tiles' statistics and,
// on the shared tier, the run
inline size_t bwd_smem_bytes(int lpt, int nct, int warps, size_t table,
                             bool global) {
  return table * sizeof(float) + sizeof(float) * 2 * (size_t)nct * warps * 16 +
         (global ? 0 : run_bytes(lpt, warps, kBwdLaneBytes));
}

}  // namespace

extern "C" {

// Launches K2's smem route on `stream`: each pair's band over nct CTAs (a
// thread-block cluster, at most 16) of `warps` warps (at most 16), lpt
// lanes a thread, which must cover the band; each thread's run in shared
// memory (slab null: the shared tier) or in `slab`, slab_bytes of global
// memory that must hold B * nct * warps * 32 * lpt lanes of 28 bytes (the
// global tier).  The same outputs as the other routes' entries; returns
// the cudaError_t of the launch, or of the card's refusal of the cluster
// shape or its shared memory.
int quaff_fwd_store_smem(const void* x_tok, int Lx, const void* keys, int Ly,
                         const void* meta, const void* doff, int W,
                         const void* seg_start, const void* seg_width, int S,
                         const void* match, const void* match_noq,
                         const void* insert, const void* insert_noq, int Km,
                         int Q, const void* ik, int n_ik, const void* trans,
                         int B, int local, int lpt, int nct, int warps,
                         void* slab, long long slab_bytes, void* out,
                         void* rows, void* offs, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || lpt < 1 || nct < 1 || warps < 1 ||
      (long long)W > (long long)nct * warps * 32 * lpt || S < 1 ||
      S > kMaxSegs || n_ik < 1 || Lx < 1 ||
      !slab_ok(slab, slab_bytes, B, nct, lpt, warps, kFwdLaneBytes))
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  const bool global = slab != nullptr;
  return (int)launch_smem(
      global ? fwd_store_smem_kernel<true> : fwd_store_smem_kernel<false>, B,
      nct, warps, global ? 0 : run_bytes(lpt, warps, kFwdLaneBytes),
      static_cast<cudaStream_t>(stream), static_cast<const int8_t*>(x_tok),
      Lx, static_cast<const int4*>(keys), Ly, static_cast<const int4*>(meta),
      static_cast<const int*>(doff), W, static_cast<const int*>(seg_start),
      static_cast<const int*>(seg_width), S, tb,
      static_cast<const float*>(trans), B, local, lpt,
      static_cast<unsigned char*>(slab), static_cast<float*>(out),
      static_cast<float*>(rows), static_cast<double*>(offs));
}

// Launches K3's smem route on `stream` (the tiling and the two tiers as
// quaff_fwd_store_smem's, 36 bytes a lane of slab): partial[B][E]
// per-pair count tables and d_sc[5][B] (i2i, i2m, d2d, d2m, back-start
// posterior per pair).  The count table lives in CTA 0's shared memory
// where the warp route would keep it there and it fits beside the rest,
// else in partial.
int quaff_bwd_counts_smem(const void* x_tok, int Lx, const void* keys,
                          int Ly, const void* meta, const void* doff, int W,
                          const void* match, const void* match_noq,
                          const void* insert, const void* insert_noq, int Km,
                          int Q, const void* ik, int n_ik, const void* trans,
                          const void* wrow, const void* rows,
                          const void* offs, int B, int local, int lpt,
                          int nct, int warps, void* slab,
                          long long slab_bytes, void* partial, void* d_sc,
                          void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || lpt < 1 || nct < 1 || warps < 1 ||
      (long long)W > (long long)nct * warps * 32 * lpt || n_ik < 1 ||
      Lx < 1 || !slab_ok(slab, slab_bytes, B, nct, lpt, warps, kBwdLaneBytes))
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  const bool global = slab != nullptr;
  const size_t E = (size_t)4 * Km * Q + 4 * Q + 4 * n_ik;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t fixed = sizeof(RowSlot<double>) * 2 * (kSmemMaxWarps + kMaxClusterCtas);
  const int smem_table =
      kWarpsPerBlock * E * sizeof(float) <= (size_t)kTableSmemBytes &&
      bwd_smem_bytes(lpt, nct, warps, bwd_table_floats(E), global) + fixed <=
          (size_t)optin;
  const size_t smem = bwd_smem_bytes(
      lpt, nct, warps, smem_table ? bwd_table_floats(E) : 0, global);
  return (int)launch_smem(
      global ? bwd_counts_smem_kernel<true> : bwd_counts_smem_kernel<false>,
      B, nct, warps, smem, static_cast<cudaStream_t>(stream),
      static_cast<const int8_t*>(x_tok), Lx, static_cast<const int4*>(keys),
      Ly, static_cast<const int4*>(meta), static_cast<const int*>(doff), W,
      tb, static_cast<const float*>(trans), static_cast<const float*>(wrow),
      static_cast<const float*>(rows), static_cast<const double*>(offs), B,
      local, lpt, smem_table, static_cast<unsigned char*>(slab),
      static_cast<float*>(partial), static_cast<float*>(d_sc));
}

}  // extern "C"
