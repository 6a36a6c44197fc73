// The banded pair-HMM row fill shared by K1 (band_fill.cu) and K2
// (estep.cu), for NVIDIA Hopper (sm_90a).
//
// band_fill_kernel<VIT, STORE> fills one pair per block (Viterbi when VIT,
// else Forward; local or global).  K1 is <VIT, false>: end scores and
// per-strip maxima only.  K2 is <false, true>: the same Forward fill also
// writing every row's match, insert and delete cells to `rows` (pair-major
// [3][B][Ly][W]: one contiguous run of W floats per pair and row), the
// checkpoint K3's backward sweep reads.  One row recurrence and one
// log-add-exp serve both kernels.
//
// K2 keeps its fill scaled: after each row, a block reduction finds the
// row's largest cell, which is subtracted from the row and added to the
// pair's float64 offset (stored per row in offs[B][Ly]).  The cells stay
// near 0, where float32 is fine; unscaled, a Forward fill at -2e4 nats
// steps in 2e-3 and loses its small log-add-exp terms, enough over the
// 6604-row c8f30 read to move its printed log-likelihood.  The pair score
// is offset + end score.
//
// Design.  Pairs are independent, so one block fills one pair and the
// TPU's sequential row grid becomes a row loop inside the block.  The
// lanes of the band (one diagonal each) are split into contiguous runs,
// one run per thread.  The M/I/D band row stays resident for the whole
// loop: in shared memory when 6 words a lane fit (mat and ins are double
// buffered because ins reads lane w+1 of the previous row; del and the
// lane's diagonal take one word each), else in a global scratch row set
// that the wrapper allocates.  Per row:
//
//   A  match and insert cells of the thread's lanes from the previous row;
//      the five emission values of the row (4 match scores for the read's
//      (k-mer, quality), 1 insert score) are read from the score tables in
//      global memory, and each lane's ref token directly from x_tok.
//   B  the delete chain del[w] = combine(del[w-1] + d2d, mat[w-1] + m2d) is
//      a first-order max-plus (Viterbi) or log-plus (Forward) recurrence
//      across the row: each thread composes its lanes' (c, b) steps
//      sequentially, a warp-shuffle scan and a scan of the warp totals
//      give each thread its incoming value, and
//   C  each thread replays its lanes from that value (and, with STORE,
//      writes the row's three cells of its lanes).
//
// Lanes outside the envelope carry c = -inf, which stops the chain at
// strip seams exactly as the TPU kernel's masking does.  The end row's
// match cells reduce to the pair score (max, or log-sum-exp) and to the
// per-strip maxima, written straight to out[B + B*S].  Rows past a pair's
// read length are neither filled nor stored.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kSentinel = 1 << 24;  // fill_v2.D_SENTINEL
constexpr int kMaxThreads = 1024;
constexpr int kMaxSegs = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_big() { return -FLT_MAX; }  // NEG_INF
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// max, or pallas_v2._lse2_fast: log-add-exp guarded for two operands near
// -inf (-inf - -inf would give NaN; the max is exact there)
template <bool VIT>
__device__ __forceinline__ float comb(float a, float b) {
  const float m = fmaxf(a, b);
  if (VIT) return m;
  return m < -1e38f ? m : m + log1pf(expf(-fabsf(a - b)));
}

// inclusive scan over a warp of recurrence steps (C, B): x -> comb(x + C, B)
template <bool VIT>
__device__ __forceinline__ void warp_scan(float& c, float& b, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float co = __shfl_up_sync(kFull, c, off);
    const float bo = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      b = comb<VIT>(bo + c, b);  // earlier step (co, bo), then (c, b)
      c = co + c;
    }
  }
}

// Exclusive block scan of per-thread recurrence steps (c_acc, b_acc) in
// thread order: returns the value entering this thread's first step (the
// chain starts at -inf before thread 0).  Two barriers; warp_c/warp_b are
// 32-float shared arrays.
template <bool VIT>
__device__ __forceinline__ float block_scan_in(float c_acc, float b_acc,
                                               float* warp_c, float* warp_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_scan<VIT>(c_acc, b_acc, lane);
  float c_ex = __shfl_up_sync(kFull, c_acc, 1);
  float b_ex = __shfl_up_sync(kFull, b_acc, 1);
  if (lane == 0) {
    c_ex = 0.f;
    b_ex = neg_inf();
  }
  if (lane == 31) {
    warp_c[warp] = c_acc;
    warp_b[warp] = b_acc;
  }
  __syncthreads();
  if (warp == 0) {
    float c = lane < nwarps ? warp_c[lane] : 0.f;
    float bv = lane < nwarps ? warp_b[lane] : neg_inf();
    warp_scan<VIT>(c, bv, lane);
    float ce = __shfl_up_sync(kFull, c, 1);
    float be = __shfl_up_sync(kFull, bv, 1);
    if (lane == 0) {
      ce = 0.f;
      be = neg_inf();
    }
    if (lane < nwarps) {
      warp_c[lane] = ce;
      warp_b[lane] = be;
    }
  }
  __syncthreads();
  return comb<VIT>(warp_b[warp] + c_ex, b_ex);
}

template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, off);
    v = IS_MAX ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : (IS_MAX ? neg_big() : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, off);
      v = IS_MAX ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <bool VIT, bool STORE>
__global__ void __launch_bounds__(kMaxThreads) band_fill_kernel(
    const int8_t* __restrict__ x_tok, int Lx,
    const int4* __restrict__ keys, int Ly,
    const int4* __restrict__ meta,
    const int* __restrict__ doff, int W,
    const int* __restrict__ seg_start, const int* __restrict__ seg_width,
    int S,
    const float* __restrict__ match, const float* __restrict__ match_noq,
    const float* __restrict__ insert, const float* __restrict__ insert_noq,
    int Km, int Q,
    const float* __restrict__ ik, int n_ik,
    const float* __restrict__ trans,
    int B, int local, int lanes_per_thread,
    float* __restrict__ scratch, float* __restrict__ out,
    float* __restrict__ rows, double* __restrict__ offs) {
  extern __shared__ float smem[];
  __shared__ float warp_c[32], warp_b[32], red[32];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float NEG = neg_big();

  float* st = scratch != nullptr ? scratch + (size_t)b * 6 * W : smem;
  float* matp = st;
  float* matc = st + W;
  float* insp = st + 2 * W;
  float* insc = st + 3 * W;
  float* del = st + 4 * W;
  int* dof = reinterpret_cast<int*>(st + 5 * W);

  const int w0 = min(t * lanes_per_thread, W);
  const int w1 = min(w0 + lanes_per_thread, W);
  const int4 pm = meta[b];
  const int xlen = pm.x, ylen = min(pm.y, Ly), hq = pm.z;
  const float d2d = trans[0], d2m = trans[1], i2i = trans[2], i2m = trans[3];
  const int8_t* xb = x_tok + (size_t)b * Lx;
  const int4* kb = keys + (size_t)b * Ly;
  const size_t sym_stride = hq ? (size_t)Km * Q : (size_t)Km;
  const size_t plane = (size_t)B * Ly * W;  // one state's [B][Ly][W] rows

  for (int w = w0; w < w1; ++w) {
    matp[w] = NEG;
    insp[w] = NEG;
    del[w] = NEG;
    dof[w] = doff[(size_t)b * W + w];
  }
  __syncthreads();

  int ik_prev = 0;
  float m2e = ik[3];
  double off = 0.0;  // K2: the pair's offset (all threads hold it)
  for (int j = 1; j <= ylen; ++j) {
    const int4 kk = kb[j - 1];  // match k-mer, quality, read token, indel ctx
    float m2m, m2i, m2d;
    if (n_ik == 1) {
      m2m = ik[0];
      m2i = ik[1];
      m2d = ik[2];
    } else {
      // m2m/m2i follow the previous row's indel context, m2d/m2e this row's
      m2m = ik[ik_prev * 4 + 0];
      m2i = ik[ik_prev * 4 + 1];
      m2d = ik[kk.w * 4 + 2];
      m2e = ik[kk.w * 4 + 3];
    }
    const float ins_emit = hq ? insert[kk.z * Q + kk.y] : insert_noq[kk.z];
    const float* mrow = hq ? match + (size_t)kk.x * Q + kk.y : match_noq + kk.x;

    // A: match and insert cells
    for (int w = w0; w < w1; ++w) {
      const int d = dof[w];
      const int idx = d + j - 1;  // i - 1
      float mc = NEG, ic = NEG;
      if (d != kSentinel && idx >= 0 && idx < xlen) {
        float a = comb<VIT>(comb<VIT>(matp[w] + m2m, del[w] + d2m),
                            insp[w] + i2m);
        if (j == 1 && (local || idx == 0)) a = comb<VIT>(a, 0.f);
        mc = a + mrow[(size_t)xb[idx] * sym_stride];
        const float ih = w + 1 < W ? insp[w + 1] : NEG;
        const float mh = w + 1 < W ? matp[w + 1] : NEG;
        ic = ins_emit + comb<VIT>(ih + i2i, mh + m2i);
      }
      matc[w] = mc;
      insc[w] = ic;
    }
    __syncthreads();

    // B: compose this thread's delete-chain steps, then scan across threads
    float c_acc = 0.f, b_acc = neg_inf();  // the identity step
    for (int w = w0; w < w1; ++w) {
      const int idx = dof[w] + j - 1;
      const bool v = dof[w] != kSentinel && idx >= 0 && idx < xlen;
      const float c = v ? d2d : NEG;
      const float bb = v ? (w > 0 ? matc[w - 1] : NEG) + m2d : NEG;
      b_acc = comb<VIT>(b_acc + c, bb);
      c_acc = c_acc + c;
    }
    float x = block_scan_in<VIT>(c_acc, b_acc, warp_c, warp_b);

    // C: replay this thread's lanes from its incoming delete value
    float top = NEG;
    for (int w = w0; w < w1; ++w) {
      const int idx = dof[w] + j - 1;
      const bool v = dof[w] != kSentinel && idx >= 0 && idx < xlen;
      const float c = v ? d2d : NEG;
      const float bb = v ? (w > 0 ? matc[w - 1] : NEG) + m2d : NEG;
      x = comb<VIT>(x + c, bb);
      del[w] = v ? x : NEG;
      if (STORE) top = fmaxf(top, fmaxf(fmaxf(matc[w], insc[w]), del[w]));
    }
    if (STORE) {
      // scale the row and store it (after the reduction's barriers no
      // thread reads this row's unscaled cells any more)
      top = block_reduce<true>(top, red);
      const float shift = top > NEG / 2 ? top : 0.f;
      off += shift;
      const size_t row = ((size_t)b * Ly + (j - 1)) * W;
      for (int w = w0; w < w1; ++w) {
        const int idx = dof[w] + j - 1;
        const bool v = dof[w] != kSentinel && idx >= 0 && idx < xlen;
        const float mc = v ? matc[w] - shift : NEG;
        const float ic = v ? insc[w] - shift : NEG;
        const float dc = v ? del[w] - shift : NEG;
        matc[w] = mc;
        insc[w] = ic;
        del[w] = dc;
        rows[row + w] = mc;
        rows[plane + row + w] = ic;
        rows[2 * plane + row + w] = dc;
      }
      if (t == 0) offs[(size_t)b * Ly + (j - 1)] = off;
      __syncthreads();  // the next row reads neighbouring lanes
    }
    ik_prev = kk.w;
    float* tmp = matp;
    matp = matc;
    matc = tmp;
    tmp = insp;
    insp = insc;
    insc = tmp;
  }

  // end row: pair score and per-strip maxima (matp holds row ylen)
  float vmax = NEG;
  float smax[kMaxSegs];
#pragma unroll
  for (int k = 0; k < kMaxSegs; ++k) smax[k] = NEG;
  if (ylen >= 1) {
    for (int w = w0; w < w1; ++w) {
      const int idx = dof[w] + ylen - 1;
      const bool v = dof[w] != kSentinel && idx >= 0 && idx < xlen;
      if (!v || !(local || idx == xlen - 1)) continue;
      const float e = matp[w] + m2e;
      vmax = fmaxf(vmax, e);
#pragma unroll
      for (int k = 0; k < kMaxSegs; ++k) {
        if (k < S) {
          const int s0 = seg_start[b * S + k];
          if (w >= s0 && w < s0 + seg_width[b * S + k]) smax[k] = fmaxf(smax[k], e);
        }
      }
    }
  }
  const float m = block_reduce<true>(vmax, red);
  float score = m;
  if (!VIT && m > NEG / 2) {
    float sum = 0.f;
    if (ylen >= 1) {
      for (int w = w0; w < w1; ++w) {
        const int idx = dof[w] + ylen - 1;
        const bool v = dof[w] != kSentinel && idx >= 0 && idx < xlen;
        if (v && (local || idx == xlen - 1)) sum += expf(matp[w] + m2e - m);
      }
    }
    sum = block_reduce<false>(sum, red);
    score = m + logf(sum);
  }
  if (STORE) {
    // K2: the absolute Forward score; strip maxima are K1's alone
    if (t == 0) out[b] = score > NEG / 2 ? (float)(off + (double)score) : score;
    return;
  }
  if (t == 0) out[b] = score;
#pragma unroll
  for (int k = 0; k < kMaxSegs; ++k) {
    if (k < S) {  // S is the same for the whole block
      const float sk = block_reduce<true>(smax[k], red);
      if (t == 0) out[(size_t)B + (size_t)b * S + k] = sk;
    }
  }
}

// Threads for a band of W lanes: one warp-multiple per lane, at most 1024
// (wider bands give each thread a run of several lanes).
inline int fill_threads(int W) {
  const int padded = ((W + 31) / 32) * 32;
  return padded < kMaxThreads ? padded : kMaxThreads;
}

template <bool VIT, bool STORE>
cudaError_t launch_fill(const int8_t* x_tok, int Lx, const int4* keys, int Ly,
                        const int4* meta, const int* doff, int W,
                        const int* seg_start, const int* seg_width, int S,
                        const float* match, const float* match_noq,
                        const float* insert, const float* insert_noq, int Km,
                        int Q, const float* ik, int n_ik, const float* trans,
                        int B, int local, float* scratch, float* out,
                        float* rows, double* offs, cudaStream_t stream) {
  const int threads = fill_threads(W);
  const int lanes_per_thread = (W + threads - 1) / threads;
  const size_t smem = scratch != nullptr ? 0 : (size_t)6 * W * sizeof(float);
  // the opt-in covers the kernel's static arrays too: dynamic bytes of
  // 48 KB or just under still need it
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_fill_kernel<VIT, STORE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  band_fill_kernel<VIT, STORE><<<B, threads, smem, stream>>>(
      x_tok, Lx, keys, Ly, meta, doff, W, seg_start, seg_width, S, match,
      match_noq, insert, insert_noq, Km, Q, ik, n_ik, trans, B, local,
      lanes_per_thread, scratch, out, rows, offs);
  return cudaGetLastError();
}

// Widest band whose per-lane state of `words` floats fits a block's shared
// memory on `device`, next to `static_bytes` of static shared arrays.
inline int smem_lanes(int device, int words, int static_bytes) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (optin - static_bytes) / (words * (int)sizeof(float));
}

}  // namespace
