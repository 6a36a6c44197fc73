// K2 and K3: the training E-step (forward fill with stored rows, then the
// backward sweep with posterior-weighted expected counts) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels quaff_tpu/dp/pallas_counts.py::_fwd_store
// (kernel _fwd_kernel) and ::_bwd_counts (kernel _bwd_kernel).  The plain
// PyTorch versions are quaff_tpu_torch/dp/estep.py::fwd_store_reference
// and ::bwd_counts_reference; the input layout is fill_v2.kernel_inputs.
//
// Two routes each, picked by dp/estep.estep_route from the band's width W
// (and each kernel's measured cutover):
//
//   warp route   fwd_store_warp_kernel<LPT> and
//                bwd_counts_warp_kernel<LPT> (estep_warp.cuh): one
//                warp per pair, the band row in registers, LPT lanes a
//                thread, no block barrier in the row loop;
//   block route  wider bands: K1's block fill with STORE set
//                (band_fill_kernel<false, true>, band_fill.cuh) and
//                bwd_counts_kernel below, one block per pair, the row in
//                shared memory or, past its size, global scratch.
//
// Both routes keep one layout, so either route's K2 store feeds either
// route's K3.  K2 keeps its fill scaled, and every row's M/I/D cells go to
// rows[3][B][Ly][W] relative to the row's float64 offset offs[B][Ly],
// pair-major, so each pair writes its own contiguous runs.
//
// K3's block route, one block per pair, walks rows ylen -> 1 carrying the
// backward match/insert/delete state of the next row in shared memory (or
// a global scratch row set for bands too wide for it), in band
// coordinates:
//
//   bd[w] = lse(bd[w+1] + d2d, d2m + me'[w] + bm'[w])      (in-row, reverse)
//   bm[w] = lse(end term, m2m + me'[w] + bm'[w],
//               m2i + ie' + bi'[w-1], m2d + bd[w+1])
//   bi[w] = lse(i2m + me'[w] + bm'[w], i2i + ie' + bi'[w-1])
//
// (primes: row j+1; the recursion's transitions come from this row's indel
// context).  The reverse delete chain is K1's block scan run over mirrored
// lanes; non-member lanes stop it at strip seams.  Each lane's posterior
// transition weights are exp(fwd_src + trans + back_dst - fwd_total),
// clamped at 40, with the m2m/m2i weights taking the row's previous-
// context transitions.  The backward sweep is kept scaled like K2's fill:
// after each row a block reduction finds its largest backward match or
// insert cell, which is subtracted from the row and added to the pair's
// float64 backward offset (unscaled, float32 backward scores drift over a
// read of thousands of rows, and the back-start posterior exp(back - fwd),
// 1 in exact arithmetic, with them).  A weight takes the relative forward
// and backward cells plus the row constant (forward offset + backward
// offset - fwd_total), formed in float64 once per row.  One block
// reduction per row gives a 15-float vector: the row's match+insert mass
// (for the per-row renormalisation, which cancels float32 forward/backward
// drift), the 4 per-symbol match sums, the insert sum, m2m/m2i/m2d/m2e,
// i2i/i2m/d2d/d2m and the back-start posterior.  All of a row's keys come
// from the read's row j, so its contribution, scaled by w_pair / row mass,
// goes to 4 + 1 + 4 table entries.
//
// Deterministic counts: each pair accumulates into its own slice of a
// [B][E] partial table, each entry always by the same thread, in row
// order (the warp route keeps the slice in shared memory while it fits);
// the reduce kernel then sums the B slices of every entry in one fixed
// order (estep_reduce_kernel below).  No float atomics, so two runs on the
// same inputs give bit-identical tables (an order-3 match table, ~385 KB,
// would not fit shared memory anyway).  E = 4*Km*Q (match, symbol-major) +
// 4*Q (insert) + 4*n_ik (m2m, m2i, m2d, m2e per indel context).
//
// What bounds K3's block route: like K1's, the per-row barriers (the
// reverse scan's two, the reduction's two) and the dependent loads of the
// row keys, table entries and stored rows; it reads the 12 bytes a cell K2
// wrote (the bytes bound), and a row's table update is one global
// read-modify-write per entry, on the critical path of warp 0.  The warp
// routes' bounds are at the top of estep_warp.cuh.

#include "estep_warp.cuh"

namespace {

constexpr int kStats = 15;  // per-row reduced quantities (see header)

// posterior weight of a log term plus its row constant
__device__ __forceinline__ float post(float logw, float c) {
  return expf(fminf(logw + c, 40.f));
}

// 15 sums over the block in a fixed order: per-warp shuffle trees, then
// warp totals in warp order.  res gets the totals; all threads may read
// them after return.
__device__ __forceinline__ void block_sum15(float (&v)[kStats], float* red,
                                            float* res) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) red[warp * 16 + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * 16 + threadIdx.x];
    res[threadIdx.x] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads) bwd_counts_kernel(
    const int8_t* __restrict__ x_tok, int Lx,
    const int4* __restrict__ keys, int Ly,
    const int4* __restrict__ meta,
    const int* __restrict__ doff, int W,
    const float* __restrict__ match, const float* __restrict__ match_noq,
    const float* __restrict__ insert, const float* __restrict__ insert_noq,
    int Km, int Q,
    const float* __restrict__ ik, int n_ik,
    const float* __restrict__ trans,
    const float* __restrict__ wrow,  // [2][B]: pair weight, fwd normaliser
    const float* __restrict__ rows,  // K2's [3][B][Ly][W], relative
    const double* __restrict__ offs,  // K2's row offsets [B][Ly]
    int B, int local, int lanes_per_thread,
    float* __restrict__ scratch,
    float* __restrict__ partial,  // [B][E]
    float* __restrict__ d_sc) {   // [5][B]
  extern __shared__ float smem[];
  __shared__ float warp_c[32], warp_b[32];
  __shared__ float red[32 * 16], res[16];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float NEG = neg_big();

  // per-lane state, 8 words: next/cur backward match and insert (double
  // buffered), next/cur match emission, this row's delete, the diagonal
  float* st = scratch != nullptr ? scratch + (size_t)b * 8 * W : smem;
  float* bm_n = st;
  float* bm_c = st + W;
  float* bi_n = st + 2 * W;
  float* bi_c = st + 3 * W;
  float* me_n = st + 4 * W;
  float* me_c = st + 5 * W;
  float* bd = st + 6 * W;
  int* dof = reinterpret_cast<int*>(st + 7 * W);

  const int w0 = min(t * lanes_per_thread, W);
  const int w1 = min(w0 + lanes_per_thread, W);
  const int4 pm = meta[b];
  const int xlen = pm.x, ylen = min(pm.y, Ly), hq = pm.z;
  const float d2d = trans[0], d2m = trans[1], i2i = trans[2], i2m = trans[3];
  const float w_pair = wrow[b];
  const double fnorm = wrow[B + b];
  const double* ob = offs + (size_t)b * Ly;
  const int8_t* xb = x_tok + (size_t)b * Lx;
  const int4* kb = keys + (size_t)b * Ly;
  const size_t sym_stride = hq ? (size_t)Km * Q : (size_t)Km;
  const size_t plane = (size_t)B * Ly * W;
  const float* fm = rows;
  const float* fi = rows + plane;
  const float* fd = rows + 2 * plane;

  const int E = 4 * Km * Q + 4 * Q + 4 * n_ik;
  float* part = partial + (size_t)b * E;
  for (int e = t; e < E; e += blockDim.x) part[e] = 0.f;
  for (int w = w0; w < w1; ++w) {
    bm_n[w] = NEG;
    bi_n[w] = NEG;
    me_n[w] = 0.f;
    dof[w] = doff[(size_t)b * W + w];
  }
  __syncthreads();

  float ie_n = 0.f;    // row j+1's insert emission
  double offb = 0.0;   // the backward offset (all threads hold it)
  float s_i2i = 0.f, s_i2m = 0.f, s_d2d = 0.f, s_d2m = 0.f, s_sb = 0.f;
  for (int j = ylen; j >= 1; --j) {
    const int4 kk = kb[j - 1];
    const int ikp = j >= 2 ? kb[j - 2].w : 0;
    float m2m_c, m2i_c, m2d_c, m2e_c, m2m_p, m2i_p;
    if (n_ik == 1) {
      m2m_c = m2m_p = ik[0];
      m2i_c = m2i_p = ik[1];
      m2d_c = ik[2];
      m2e_c = ik[3];
    } else {
      m2m_c = ik[kk.w * 4 + 0];
      m2i_c = ik[kk.w * 4 + 1];
      m2d_c = ik[kk.w * 4 + 2];
      m2e_c = ik[kk.w * 4 + 3];
      m2m_p = ik[ikp * 4 + 0];
      m2i_p = ik[ikp * 4 + 1];
    }
    const float ie_c = hq ? insert[kk.z * Q + kk.y] : insert_noq[kk.z];
    // row constants: forward offset of rows j and j-1 (row 0: 0) plus the
    // backward offset, minus fwd_total
    const float cc = (float)(ob[j - 1] + offb - fnorm);
    const float cp = (float)((j >= 2 ? ob[j - 2] : 0.0) + offb - fnorm);
    const float c0 = (float)(offb - fnorm);
    const float* mrow = hq ? match + (size_t)kk.x * Q + kk.y : match_noq + kk.x;

    // B: the reverse delete chain over mirrored lanes v = W-1-w, so that
    // thread order runs from the high lanes down
    float c_acc = 0.f, b_acc = neg_inf();
    for (int v = w0; v < w1; ++v) {
      const int w = W - 1 - v;
      const int idx = dof[w] + j - 1;
      const bool ok = dof[w] != kSentinel && idx >= 0 && idx < xlen;
      const float c = ok ? d2d : NEG;
      const float bb = ok ? d2m + (me_n[w] + bm_n[w]) : NEG;
      b_acc = comb<false>(b_acc + c, bb);
      c_acc = c_acc + c;
    }
    float x = block_scan_in<false>(c_acc, b_acc, warp_c, warp_b);
    for (int v = w0; v < w1; ++v) {
      const int w = W - 1 - v;
      const int idx = dof[w] + j - 1;
      const bool ok = dof[w] != kSentinel && idx >= 0 && idx < xlen;
      const float c = ok ? d2d : NEG;
      const float bb = ok ? d2m + (me_n[w] + bm_n[w]) : NEG;
      x = comb<false>(x + c, bb);
      bd[w] = ok ? x : NEG;
    }
    __syncthreads();

    // C: backward match/insert cells and the posterior weights of the
    // thread's own lanes
    float acc[kStats];
#pragma unroll
    for (int k = 0; k < kStats; ++k) acc[k] = 0.f;
    float top = NEG;
    const size_t cur = ((size_t)b * Ly + (j - 1)) * W;
    const size_t prv = cur - W;  // row j-1, read only when j >= 2
    for (int w = w0; w < w1; ++w) {
      const int idx = dof[w] + j - 1;
      const bool ok = dof[w] != kSentinel && idx >= 0 && idx < xlen;
      float bmv = NEG, biv = NEG, mev = 0.f;
      if (ok) {
        const float from_match = me_n[w] + bm_n[w];
        const float bi_lo = w > 0 ? bi_n[w - 1] : NEG;
        const float bd_hi = w + 1 < W ? bd[w + 1] : NEG;
        const bool end_ok = j == ylen && (local || idx == xlen - 1);
        bmv = comb<false>(
            comb<false>(end_ok ? m2e_c : NEG, m2m_c + from_match),
            comb<false>(m2i_c + ie_n + bi_lo, m2d_c + bd_hi));
        biv = comb<false>(i2m + from_match, i2i + ie_n + bi_lo);
        top = fmaxf(top, fmaxf(bmv, biv));
        const int tok = xb[idx];
        mev = mrow[(size_t)tok * sym_stride];

        float fm_p = NEG, fi_p = NEG, fd_p = NEG, fm_ph = NEG, fi_ph = NEG;
        if (j >= 2) {
          fm_p = __ldg(fm + prv + w);
          fi_p = __ldg(fi + prv + w);
          fd_p = __ldg(fd + prv + w);
          if (w + 1 < W) {
            fm_ph = __ldg(fm + prv + w + 1);
            fi_ph = __ldg(fi + prv + w + 1);
          }
        }
        const float fm_cl = w > 0 ? __ldg(fm + cur + w - 1) : NEG;
        const float fd_cl = w > 0 ? __ldg(fd + cur + w - 1) : NEG;
        const float base = mev + bmv;
        const float w_m2m = post(fm_p + m2m_p + base, cp);
        const float w_d2m = post(fd_p + d2m + base, cp);
        const float w_i2m = post(fi_p + i2m + base, cp);
        const float p_s2m = post(base, c0);  // shared with the back start
        const bool start_ok = j == 1 && (local || idx == 0);
        const float mc = w_m2m + w_d2m + w_i2m + (start_ok ? p_s2m : 0.f);
        const float w_m2i = post(fm_ph + m2i_p + ie_c + biv, cp);
        const float w_i2i = post(fi_ph + i2i + ie_c + biv, cp);
        const float w_m2d = post(fm_cl + m2d_c + bd[w], cc);
        const float w_d2d = post(fd_cl + d2d + bd[w], cc);
        const float w_m2e =
            end_ok ? post(__ldg(fm + cur + w) + m2e_c, cc) : 0.f;
        acc[0] += mc + w_m2i + w_i2i;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[1 + a] += tok == a ? mc : 0.f;
        acc[5] += w_m2i + w_i2i;
        acc[6] += w_m2m;
        acc[7] += w_m2i;
        acc[8] += w_m2d;
        acc[9] += w_m2e;
        acc[10] += w_i2i;
        acc[11] += w_i2m;
        acc[12] += w_d2d;
        acc[13] += w_d2m;
        acc[14] += start_ok ? p_s2m : 0.f;
      }
      bm_c[w] = bmv;
      bi_c[w] = biv;
      me_c[w] = mev;
    }
    block_sum15(acc, red, res);

    // the row's contribution: every entry always by the same thread of
    // warp 0, so each table entry sums in row order
    const float factor = res[0] > 1e-30f ? w_pair / res[0] : 0.f;
    if (t < 4) {
      part[(size_t)t * Km * Q + (size_t)kk.x * Q + kk.y] += res[1 + t] * factor;
    } else if (t == 4) {
      part[(size_t)4 * Km * Q + kk.z * Q + kk.y] += res[5] * factor;
    } else if (t < 9) {
      const int c = t - 5;  // m2m, m2i (previous context), m2d, m2e
      const int ctx = c < 2 ? ikp : kk.w;
      part[(size_t)4 * Km * Q + 4 * Q + ctx * 4 + c] += res[6 + c] * factor;
    }
    if (t == 0) {
      s_i2i += res[10] * factor;
      s_i2m += res[11] * factor;
      s_d2d += res[12] * factor;
      s_d2m += res[13] * factor;
      s_sb += res[14];
    }
    // scale the backward row carried to the next one
    top = block_reduce<true>(top, red);
    const float shift = top > NEG / 2 ? top : 0.f;
    offb += shift;
    for (int w = w0; w < w1; ++w) {
      const int idx = dof[w] + j - 1;
      const bool ok = dof[w] != kSentinel && idx >= 0 && idx < xlen;
      bm_c[w] = ok ? bm_c[w] - shift : NEG;
      bi_c[w] = ok ? bi_c[w] - shift : NEG;
    }
    __syncthreads();  // the next row reads other threads' lanes
    ie_n = ie_c;
    float* tmp = bm_n;
    bm_n = bm_c;
    bm_c = tmp;
    tmp = bi_n;
    bi_n = bi_c;
    bi_c = tmp;
    tmp = me_n;
    me_n = me_c;
    me_c = tmp;
  }
  if (t == 0) {
    d_sc[b] = s_i2i;
    d_sc[B + b] = s_i2m;
    d_sc[2 * B + b] = s_d2d;
    d_sc[3 * B + b] = s_d2m;
    d_sc[4 * B + b] = s_sb;
  }
}

// The count reduction out[e] = sum over b of partial[b][e] (K3's cross-pair
// sum), in one fixed order that dp/estep.estep_reduce_reference repeats
// step by step, so the two agree bit for bit and every run repeats:
//
//   1. a block owns 32 consecutive columns (a warp reads 128 contiguous
//      bytes of a row) and has kRedWarps = 8 warps;
//   2. warp g sums rows g, g+8, g+16, ... in increasing order, from 0.f, in
//      float32 (16 independent loads in flight, added in row order);
//   3. the 8 partial columns combine by one fixed pairwise tree,
//      ((0+1)+(2+3))+((4+5)+(6+7)).
//
// Float32 adds are correctly rounded and nvcc does not reassociate them
// without fast-math, so the order is the arithmetic.  What bounds it: the
// [B][E] read (bytes), but at the phase-5 chunk's [256][1884] that is 1.9
// MB, under a microsecond at the card's rate, so the launch and the memory
// latency of each warp's row loads set its time; the 8 warps a column tile
// keep 128 loads of a column in flight at once.
constexpr int kRedWarps = 8;
constexpr int kRedUnroll = 16;

__global__ void __launch_bounds__(kRedWarps * 32) estep_reduce_kernel(
    const float* __restrict__ partial, int B, int E, float* __restrict__ out) {
  __shared__ float acc[kRedWarps][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < E) {
    const float* p = partial + e;
    int b = g;
    for (; b + (kRedUnroll - 1) * kRedWarps < B; b += kRedUnroll * kRedWarps) {
      float v[kRedUnroll];
#pragma unroll
      for (int u = 0; u < kRedUnroll; ++u)
        v[u] = __ldg(p + (size_t)(b + u * kRedWarps) * E);
#pragma unroll
      for (int u = 0; u < kRedUnroll; ++u) s += v[u];
    }
    for (; b < B; b += kRedWarps) s += __ldg(p + (size_t)b * E);
  }
  acc[g][lane] = s;
  __syncthreads();
  if (g == 0 && e < E) {
    const float a01 = acc[0][lane] + acc[1][lane];
    const float a23 = acc[2][lane] + acc[3][lane];
    const float a45 = acc[4][lane] + acc[5][lane];
    const float a67 = acc[6][lane] + acc[7][lane];
    out[e] = (a01 + a23) + (a45 + a67);
  }
}
static_assert(kRedWarps == 8, "the combining tree above is written for 8");

constexpr int kBwdStaticBytes = (3 * 32 + 32 * 16 + 16) * (int)sizeof(float);

}  // namespace

extern "C" {

// Launches K2's block route on `stream`: the scaled Forward fill of K1
// with rows[3][B][Ly][W] and their offsets offs[B][Ly] stored (rows past a
// pair's read length are left untouched).  out[b] is the pair's Forward
// score (out is sized [B + B*S] as K1's; the strip slots are not written);
// scratch is null or B*6*W floats.
int quaff_fwd_store(const void* x_tok, int Lx, const void* keys, int Ly,
                    const void* meta, const void* doff, int W,
                    const void* seg_start, const void* seg_width, int S,
                    const void* match, const void* match_noq,
                    const void* insert, const void* insert_noq, int Km, int Q,
                    const void* ik, int n_ik, const void* trans, int B,
                    int local, void* scratch, void* out, void* rows,
                    void* offs, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || S < 1 || S > kMaxSegs || n_ik < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_fill<false, true>(
      static_cast<const int8_t*>(x_tok), Lx, static_cast<const int4*>(keys),
      Ly, static_cast<const int4*>(meta), static_cast<const int*>(doff), W,
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_width),
      S, static_cast<const float*>(match), static_cast<const float*>(match_noq),
      static_cast<const float*>(insert), static_cast<const float*>(insert_noq),
      Km, Q, static_cast<const float*>(ik), n_ik,
      static_cast<const float*>(trans), B, local,
      static_cast<float*>(scratch), static_cast<float*>(out),
      static_cast<float*>(rows), static_cast<double*>(offs),
      static_cast<cudaStream_t>(stream));
}

// Launches K3's block route on `stream`: partial[B][E] per-pair count
// tables and d_sc[5][B] (i2i, i2m, d2d, d2m, back-start posterior per
// pair).  scratch is null (state in shared memory) or B*8*W floats.
int quaff_bwd_counts(const void* x_tok, int Lx, const void* keys, int Ly,
                     const void* meta, const void* doff, int W,
                     const void* match, const void* match_noq,
                     const void* insert, const void* insert_noq, int Km,
                     int Q, const void* ik, int n_ik, const void* trans,
                     const void* wrow, const void* rows, const void* offs,
                     int B, int local,
                     void* scratch, void* partial, void* d_sc,
                     void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || n_ik < 1) return (int)cudaErrorInvalidValue;
  const int threads = fill_threads(W);
  const int lanes_per_thread = (W + threads - 1) / threads;
  const size_t smem = scratch != nullptr ? 0 : (size_t)8 * W * sizeof(float);
  // the opt-in covers the kernel's static arrays too: dynamic bytes of
  // 48 KB or just under still need it
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bwd_counts_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x_tok), Lx, static_cast<const int4*>(keys),
      Ly, static_cast<const int4*>(meta), static_cast<const int*>(doff), W,
      static_cast<const float*>(match), static_cast<const float*>(match_noq),
      static_cast<const float*>(insert), static_cast<const float*>(insert_noq),
      Km, Q, static_cast<const float*>(ik), n_ik,
      static_cast<const float*>(trans), static_cast<const float*>(wrow),
      static_cast<const float*>(rows), static_cast<const double*>(offs), B,
      local, lanes_per_thread,
      static_cast<float*>(scratch), static_cast<float*>(partial),
      static_cast<float*>(d_sc));
  return (int)cudaGetLastError();
}

// Launches K2's warp route on `stream` (W <= 32 * lpt, lpt one of 1, 2, 4,
// 8, 16): the same outputs as quaff_fwd_store, no scratch.
int quaff_fwd_store_warp(const void* x_tok, int Lx, const void* keys, int Ly,
                         const void* meta, const void* doff, int W,
                         const void* match, const void* match_noq,
                         const void* insert, const void* insert_noq, int Km,
                         int Q, const void* ik, int n_ik, const void* trans,
                         int B, int local, int lpt, void* out, void* rows,
                         void* offs, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 32 * lpt || n_ik < 1 || Lx < 1)
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const auto st = static_cast<cudaStream_t>(stream);
#define QUAFF_FWD_STORE_CASE(L)                                              \
  case L:                                                                    \
    fwd_store_warp_kernel<L><<<blocks, kWarpsPerBlock * 32, 0, st>>>(        \
        static_cast<const int8_t*>(x_tok), Lx,                               \
        static_cast<const int4*>(keys), Ly, static_cast<const int4*>(meta),  \
        static_cast<const int*>(doff), W, tb,                                \
        static_cast<const float*>(trans), B, local,                          \
        static_cast<float*>(out), static_cast<float*>(rows),                 \
        static_cast<double*>(offs));                                         \
    break;
  switch (lpt) {
    QUAFF_ESTEP_LPT(QUAFF_FWD_STORE_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QUAFF_FWD_STORE_CASE
  return (int)cudaGetLastError();
}

// Launches K3's warp route on `stream` (W <= 32 * lpt, lpt one of 1, 2, 4,
// 8, 16): the same outputs as quaff_bwd_counts, no scratch.  Each warp's
// count table lives in shared memory while a block's fit kTableSmemBytes,
// else in its row of partial.
int quaff_bwd_counts_warp(const void* x_tok, int Lx, const void* keys,
                          int Ly, const void* meta, const void* doff, int W,
                          const void* match, const void* match_noq,
                          const void* insert, const void* insert_noq, int Km,
                          int Q, const void* ik, int n_ik, const void* trans,
                          const void* wrow, const void* rows,
                          const void* offs, int B, int local, int lpt,
                          void* partial, void* d_sc, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 32 * lpt || n_ik < 1 || Lx < 1)
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  const size_t E = (size_t)4 * Km * Q + 4 * Q + 4 * n_ik;
  const size_t table_bytes = kWarpsPerBlock * E * sizeof(float);
  const int smem_table = table_bytes <= (size_t)kTableSmemBytes;
  const size_t smem = smem_table ? table_bytes : 0;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const auto st = static_cast<cudaStream_t>(stream);
#define QUAFF_BWD_COUNTS_CASE(L)                                             \
  case L:                                                                    \
    bwd_counts_warp_kernel<L><<<blocks, kWarpsPerBlock * 32, smem, st>>>(    \
        static_cast<const int8_t*>(x_tok), Lx,                               \
        static_cast<const int4*>(keys), Ly, static_cast<const int4*>(meta),  \
        static_cast<const int*>(doff), W, tb,                                \
        static_cast<const float*>(trans), static_cast<const float*>(wrow),   \
        static_cast<const float*>(rows), static_cast<const double*>(offs),   \
        B, local, smem_table, static_cast<float*>(partial),                  \
        static_cast<float*>(d_sc));                                          \
    break;
  switch (lpt) {
    QUAFF_ESTEP_LPT(QUAFF_BWD_COUNTS_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QUAFF_BWD_COUNTS_CASE
  return (int)cudaGetLastError();
}

// Launches the fixed-order reduction out[E] = sum_b partial[b][E]: one
// block of kRedWarps warps per 32 columns.
int quaff_estep_reduce(const void* partial, int B, int E, void* out,
                       void* stream) {
  if (E <= 0) return 0;
  estep_reduce_kernel<<<(E + 31) / 32, kRedWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), B, E, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Widest band whose K3 state (8 words a lane) fits shared memory.
int quaff_bwd_counts_max_smem_lanes(int device) {
  return smem_lanes(device, 8, kBwdStaticBytes);
}

}  // extern "C"
