// K4: banded read-vs-read overlap Viterbi score fill for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel quaff_tpu/dp/pallas_overlap.py:221 (_ov_fill,
// kernel body _ov_kernel) together with the end reduction of
// _ov_reduce_segments.  The plain PyTorch version of the same function is
// quaff_tpu_torch/dp/ov_fill.py::ov_fill_reference; the input layout (the
// sequence bank, meta, doff, strips, insert sums, transitions) is described
// in that module's docstring.
//
// Per cell (i, j) of pair b, lane w holding diagonal d = doff[w], row j and
// t = i - 1 = d + j - 1:
//
//   emit = lse_r(xb[r][t] + yb[r][j-1]) - xb[4][t] - yb[4][j-1]
//   mat  = max(mat'[w] + m2m, del'[w] + d2m, ins'[w] + i2m)  (+ 0 at a start)
//          + emit
//   ins  = max(lse(ins'[w+1] + i2i, del'[w+1] + d2i), mat'[w+1] + m2i)
//   del  = max(lse(del[w-1] + d2d, ins[w-1] + d2i), mat[w-1] + m2d)
//
// (primes: the previous row).  At gap order > 0 (7 bank channels) the m2*
// transitions are per cell: m2m = stay_x(i-1) + stay_y(j-1), m2i =
// open_x(i), m2d = stay_x(i-1) + open_y(j); at gap order 0 they are the
// scalars of `trans`.  Transitions are run-time data, never compile-time
// constants: trained parameters recompile nothing.
//
// Two routes, picked by dp/ov_fill.ov_route from the band's width W:
//
//   warp route   W <= dp/ov_fill.OV_WARP_MAX_LANES (the measured cutover):
//                ov_fill_warp_kernel<IK, LPT> (ov_fill_warp.cuh), one warp
//                per pair, the band row in registers, the row's inputs and
//                emission a row ahead, no block barrier in the row loop;
//   block route  wider bands, up to OV_LANE_CAP: ov_fill_kernel below.
//
// The block route.  Pairs are independent, so one block fills one pair,
// and the TPU's sequential row grid becomes a row loop inside the block
// that stops at the pair's own live rows.  The lanes of the packed band
// are split into contiguous runs, one run per thread, and the M/I/D row
// state lives in shared memory (mat and ins double buffered, del single:
// it is read only before the row's first barrier and written after it),
// with each lane's diagonal and its end accumulator: 7 words a lane.  Each
// lane gathers its x values straight from the bank at t (and t - 1 for
// stay_x(i-1)): neighbouring lanes read neighbouring addresses, where the
// TPU kernel had to roll windows.  The row's y values are one broadcast
// load each.  The delete chain is scanned as affine-max maps x ->
// max(lse(x + c, k), b) carried as triples (c, k, b) (ov_fill_warp.cuh):
// each thread composes its lanes' triples in order, a warp-shuffle scan
// and a scan of the warp totals give each thread the map of all lanes
// before it, and the thread replays its lanes from that map applied to
// -inf.  Lanes outside the envelope carry c = -inf, so no path crosses a
// strip seam.  At the end the block reduces its end accumulators to the
// pair score (end + x and y insert sums) and the per-strip maxima: no
// [B, W] array returns to device memory.
//
// What bounds the block route: per row, three block barriers and the
// two-level scan, plus 7 (gap order 0) or 9 dependent loads of a lane's x
// values; with ~100 float32 operations a cell, not bandwidth (the bank is
// read once per lane and row from L2) and not the FP32 rate.  Many blocks
// per SM hide the barrier latency; each block stops at its own rows and
// its own lanes.

#include "ov_fill_warp.cuh"

namespace {

// The map of all lanes of the threads before this one (thread order),
// applied to -inf: the delete value entering this thread's first lane.  Two
// barriers; sc/sk/sb are 32-float shared arrays.
__device__ __forceinline__ float block_scan3_in(float c, float k, float b,
                                                float* sc, float* sk,
                                                float* sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_scan3(c, k, b, lane);
  float ce = __shfl_up_sync(kFull, c, 1);
  float ke = __shfl_up_sync(kFull, k, 1);
  float be = __shfl_up_sync(kFull, b, 1);
  if (lane == 0) {
    ce = 0.f;
    ke = neg_inf();
    be = neg_inf();
  }
  if (lane == 31) {
    sc[warp] = c;
    sk[warp] = k;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float wc = lane < nwarps ? sc[lane] : 0.f;
    float wk = lane < nwarps ? sk[lane] : neg_inf();
    float wb = lane < nwarps ? sb[lane] : neg_inf();
    warp_scan3(wc, wk, wb, lane);
    float xc = __shfl_up_sync(kFull, wc, 1);
    float xk = __shfl_up_sync(kFull, wk, 1);
    float xb = __shfl_up_sync(kFull, wb, 1);
    if (lane == 0) {
      xc = 0.f;
      xk = neg_inf();
      xb = neg_inf();
    }
    if (lane < nwarps) {
      sc[lane] = xc;
      sk[lane] = xk;
      sb[lane] = xb;
    }
  }
  __syncthreads();
  float pc = sc[warp], pk = sk[warp], pb = sb[warp];
  compose(pc, pk, pb, ce, ke, be);  // earlier warps, then earlier lanes
  return fmaxf(pk, pb);
}

__global__ void __launch_bounds__(kMaxThreads) ov_fill_kernel(
    const float* __restrict__ bank, int C, int L,
    const int4* __restrict__ meta, const int* __restrict__ doff, int W,
    const int* __restrict__ seg_start, const int* __restrict__ seg_width,
    int S, const float2* __restrict__ ins_xy,
    const float* __restrict__ trans, int B, int lanes_per_thread,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float sc[32], sk[32], sb[32], red[32];

  const int pb = blockIdx.x;
  const int t = threadIdx.x;
  const float NEG = neg_big();

  float* matp = smem;
  float* matc = smem + W;
  float* insp = smem + 2 * W;
  float* insc = smem + 3 * W;
  float* del = smem + 4 * W;
  float* endw = smem + 5 * W;
  int* dof = reinterpret_cast<int*>(smem + 6 * W);

  const int4 m0 = meta[2 * pb], m1 = meta[2 * pb + 1];
  const int xlen = m0.z, ylen = m0.w, joff = m1.x, nrows = m1.y;
  const float* xb = bank + (size_t)m0.x * C * L;
  const float* yb = bank + (size_t)m0.y * C * L;
  const bool ik = C == 7;
  const float m2m_s = trans[0], m2i_s = trans[1], m2d_s = trans[2];
  const float i2m = trans[3], i2i = trans[4];
  const float d2m = trans[6], d2i = trans[7], d2d = trans[8];

  // the pair's own lane extent: lanes past its last strip stay -inf
  int wb = 0;
  for (int k = 0; k < S; ++k)
    wb = max(wb, seg_start[pb * S + k] + seg_width[pb * S + k]);
  wb = min(wb, W);
  const int w0 = min(t * lanes_per_thread, wb);
  const int w1 = min(w0 + lanes_per_thread, wb);

  // both buffers of mat and ins: lanes past the pair's extent are never
  // written, and the lane before them reads them as its w + 1 neighbour
  for (int w = t; w < W; w += blockDim.x) {
    matp[w] = NEG;
    matc[w] = NEG;
    insp[w] = NEG;
    insc[w] = NEG;
    del[w] = NEG;
    endw[w] = NEG;
    dof[w] = doff[(size_t)pb * W + w];
  }
  __syncthreads();

  for (int jj = 1; jj <= nrows; ++jj) {
    const int jf = joff + jj;  // true row
    const int yi = min(jf - 1, L - 1);
    float yv[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) yv[c] = c < C ? yb[(size_t)c * L + yi] : 0.f;
    const bool row_ok = jf <= ylen;

    // A: match and insert cells from the previous row
    for (int w = w0; w < w1; ++w) {
      const int d = dof[w];
      const int ti = d + jf - 1;  // i - 1
      float mc = NEG, ic = NEG;
      if (row_ok && d != kSentinel && ti >= 0 && ti < xlen) {
        float acc = xb[ti] + yv[0];
#pragma unroll
        for (int r = 1; r < 4; ++r) acc = lse(acc, xb[(size_t)r * L + ti] + yv[r]);
        const float emit = acc - xb[(size_t)kChIns * L + ti] - yv[kChIns];
        float m2m = m2m_s, m2i = m2i_s;
        if (ik) {
          const float stay_xm1 = ti >= 1 ? xb[(size_t)kChStay * L + ti - 1] : 0.f;
          m2m = stay_xm1 + yv[kChStay];
          m2i = xb[(size_t)kChOpen * L + ti];
        }
        float a = fmaxf(fmaxf(matp[w] + m2m, del[w] + d2m), insp[w] + i2m);
        if (jf == 1 || ti == 0) a = fmaxf(a, 0.f);
        mc = a + emit;
        const bool hi = w + 1 < W;
        const float ih = hi ? insp[w + 1] : NEG;
        const float dh = hi ? del[w + 1] : NEG;
        const float mh = hi ? matp[w + 1] : NEG;
        ic = fmaxf(lse(ih + i2i, dh + d2i), mh + m2i);
      }
      matc[w] = mc;
      insc[w] = ic;
    }
    __syncthreads();

    // B: compose this thread's delete-chain triples, then scan across
    // threads; C: replay the lanes from the incoming value
    float c_acc = 0.f, k_acc = neg_inf(), b_acc = neg_inf();  // identity
    for (int pass = 0; pass < 2; ++pass) {
      float x = 0.f;
      if (pass == 1) x = block_scan3_in(c_acc, k_acc, b_acc, sc, sk, sb);
      for (int w = w0; w < w1; ++w) {
        const int d = dof[w];
        const int ti = d + jf - 1;
        const bool v = row_ok && d != kSentinel && ti >= 0 && ti < xlen;
        float c = NEG, k = NEG, b = NEG;
        if (v) {
          float m2d = m2d_s;
          if (ik)
            m2d = (ti >= 1 ? xb[(size_t)kChStay * L + ti - 1] : 0.f) + yv[kChOpen];
          c = d2d;
          k = (w > 0 ? insc[w - 1] : NEG) + d2i;
          b = (w > 0 ? matc[w - 1] : NEG) + m2d;
        }
        if (pass == 0) {
          compose(c_acc, k_acc, b_acc, c, k, b);
        } else {
          x = fmaxf(lse(x + c, k), b);
          del[w] = v ? x : NEG;
          if (v && (jf == ylen || ti == xlen - 1)) endw[w] = fmaxf(endw[w], matc[w]);
        }
      }
    }
    __syncthreads();  // the next row reads neighbouring lanes' cells
    float* tmp = matp;
    matp = matc;
    matc = tmp;
    tmp = insp;
    insp = insc;
    insc = tmp;
  }

  // epilogue: the pair's end score and the per-strip end maxima
  float vmax = NEG;
  float smax[kMaxSegs];
#pragma unroll
  for (int k = 0; k < kMaxSegs; ++k) smax[k] = NEG;
  for (int w = w0; w < w1; ++w) {
    const float e = endw[w];
    vmax = fmaxf(vmax, e);
#pragma unroll
    for (int k = 0; k < kMaxSegs; ++k) {
      if (k < S) {
        const int s0 = seg_start[pb * S + k];
        if (w >= s0 && w < s0 + seg_width[pb * S + k]) smax[k] = fmaxf(smax[k], e);
      }
    }
  }
  const float end = block_reduce<true>(vmax, red);
  if (t == 0) {
    const float2 iv = ins_xy[pb];
    out[pb] = end <= NEG / 2 ? neg_inf() : (end + iv.x) + iv.y;
  }
#pragma unroll
  for (int k = 0; k < kMaxSegs; ++k) {
    if (k < S) {  // S is the same for the whole block
      const float sk_ = block_reduce<true>(smax[k], red);
      if (t == 0) out[(size_t)B + (size_t)pb * S + k] = sk_ <= NEG / 2 ? neg_inf() : sk_;
    }
  }
}

constexpr int kStaticSmem = 4 * 32 * (int)sizeof(float);

}  // namespace

extern "C" {

// Launches K4's block route on `stream`; returns the cudaError_t of the
// launch.  Does not synchronise and allocates nothing.  meta is [B][8]
// int32 (two int4 per pair), ins_xy [B][2] float32, out [B + B*S] float32.
int quaff_ov_fill(const void* bank, int C, int L, const void* meta,
                  const void* doff, int W, const void* seg_start,
                  const void* seg_width, int S, const void* ins_xy,
                  const void* trans, int B, void* out, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || S < 1 || S > kMaxSegs || (C != 5 && C != 7) || L < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = fill_threads(W);
  const int lanes_per_thread = (W + threads - 1) / threads;
  const size_t smem = (size_t)7 * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ov_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ov_fill_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bank), C, L, static_cast<const int4*>(meta),
      static_cast<const int*>(doff), W, static_cast<const int*>(seg_start),
      static_cast<const int*>(seg_width), S,
      static_cast<const float2*>(ins_xy), static_cast<const float*>(trans), B,
      lanes_per_thread, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Launches K4's warp route on `stream` (W <= 32 * lpt, lpt one of 1, 2, 4,
// 8, 16); returns the cudaError_t of the launch.  Same inputs and output as
// quaff_ov_fill.
int quaff_ov_fill_warp(const void* bank, int C, int L, const void* meta,
                       const void* doff, int W, const void* seg_start,
                       const void* seg_width, int S, const void* ins_xy,
                       const void* trans, int B, int lpt, void* out,
                       void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 32 * lpt || S < 1 || S > kMaxSegs || (C != 5 && C != 7) ||
      L < 1)
    return (int)cudaErrorInvalidValue;
  const auto* bk = static_cast<const float*>(bank);
  const auto* m4 = static_cast<const int4*>(meta);
  const auto* dof = static_cast<const int*>(doff);
  const auto* s0 = static_cast<const int*>(seg_start);
  const auto* sw = static_cast<const int*>(seg_width);
  const auto* iv = static_cast<const float2*>(ins_xy);
  const auto* tr = static_cast<const float*>(trans);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      C == 7 ? launch_ov_warp_lpt<true>(lpt, bk, L, m4, dof, W, s0, sw, S, iv,
                                        tr, B, o, st)
             : launch_ov_warp_lpt<false>(lpt, bk, L, m4, dof, W, s0, sw, S,
                                         iv, tr, B, o, st);
  return (int)e;
}

// Widest band whose row state (7 words a lane) fits a block's shared memory
// on `device`, next to the kernel's static scan and reduction arrays.
int quaff_ov_fill_max_smem_lanes(int device) {
  return smem_lanes(device, 7, kStaticSmem);
}

}  // extern "C"
