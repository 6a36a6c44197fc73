// K2 and K3: the training E-step (forward fill with stored rows, then the
// backward sweep with posterior-weighted expected counts) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels quaff_tpu/dp/pallas_counts.py::_fwd_store
// (kernel _fwd_kernel) and ::_bwd_counts (kernel _bwd_kernel).  The plain
// PyTorch versions are quaff_tpu_torch/dp/estep.py::fwd_store_reference
// and ::bwd_counts_reference; the input layout is fill_v2.kernel_inputs.
//
// Three routes each, picked by dp/estep.estep_route from the band's width
// W (and each kernel's measured cutover):
//
//   warp route     fwd_store_warp_kernel<LPT> and
//                  bwd_counts_warp_kernel<LPT> (estep_warp.cuh, launched
//                  below): one warp per pair, the band row in registers,
//                  LPT lanes a thread, no block barrier in the row loop;
//   cluster route  wider bands up to dp/estep.ESTEP_CLUSTER_MAX_LANES:
//                  K1's cluster fill with STORE set
//                  (band_fill_cluster_kernel<false, true, LPT>, to
//                  ESTEP_WIDE_LANES) and bwd_counts_cluster_kernel<LPT,
//                  MODE>, a pair's band tiled over the warps of a
//                  thread-block cluster, K3's past 32 tiles folded in two
//                  levels (estep_cluster.cu, with their entries);
//   smem route     every wider band: fwd_store_smem_kernel and
//                  bwd_counts_smem_kernel (estep_smem.cu), the two-level
//                  fold over up to 16 CTAs with each thread's lanes in
//                  shared memory up to dp/estep.ESTEP_SMEM_MAX_LANES (the
//                  shared tier), in a per-pair slab of global memory past
//                  it (the global tier).
//
// All routes keep one layout, so any route's K2 store feeds any route's
// K3.  K2 keeps its fill scaled, and every row's M/I/D cells go to
// rows[3][B][Ly][W] relative to the row's float64 offset offs[B][Ly],
// pair-major, so each pair writes its own contiguous runs.  K3 walks rows
// ylen -> 1 carrying the backward match/insert/delete state of the next
// row, in band coordinates:
//
//   bd[w] = lse(bd[w+1] + d2d, d2m + me'[w] + bm'[w])      (in-row, reverse)
//   bm[w] = lse(end term, m2m + me'[w] + bm'[w],
//               m2i + ie' + bi'[w-1], m2d + bd[w+1])
//   bi[w] = lse(i2m + me'[w] + bm'[w], i2i + ie' + bi'[w-1])
//
// (primes: row j+1; the recursion's transitions come from this row's indel
// context).  Each lane's posterior transition weights are exp(fwd_src +
// trans + back_dst - fwd_total), clamped at 40, with the m2m/m2i weights
// taking the row's previous-context transitions.  The backward sweep is
// kept scaled like K2's fill: after each row its shift is subtracted from
// the row and added to the pair's float64 backward offset.  A weight takes
// the relative forward and backward cells plus the row constant (forward
// offset + backward offset - fwd_total), formed in float64 once per row.
// Each row gives 15 sums: the row's match+insert mass (for the per-row
// renormalisation, which cancels float32 forward/backward drift), the 4
// per-symbol match sums, the insert sum, m2m/m2i/m2d/m2e,
// i2i/i2m/d2d/d2m and the back-start posterior.  All of a row's keys come
// from the read's row j, so its contribution, scaled by w_pair / row mass,
// goes to 4 + 1 + 4 table entries.
//
// Deterministic counts: each pair accumulates into its own slice of a
// [B][E] partial table, each entry always by the same thread, in row
// order (kept in shared memory while it fits); the reduce kernel then sums
// the B slices of every entry in one fixed order (estep_reduce_kernel
// below).  No float atomics, so two runs on the same inputs give
// bit-identical tables (an order-3 match table, ~385 KB, would not fit
// shared memory anyway).  E = 4*Km*Q (match, symbol-major) + 4*Q (insert)
// + 4*n_ik (m2m, m2i, m2d, m2e per indel context).

#include "estep_warp.cuh"

namespace {

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

}  // namespace

extern "C" {

// Launches K2's warp route on `stream` (W <= 32 * lpt, lpt one of 1, 2, 4,
// 8, 16): the pairs' Forward scores out[b] (out is sized [B + B*S] as K1's;
// the strip slots are not written), rows[3][B][Ly][W] and their offsets
// offs[B][Ly] (rows past a pair's read length are left untouched).
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
// 8, 16): partial[B][E] per-pair count tables and d_sc[5][B] (i2i, i2m,
// d2d, d2m, back-start posterior per pair).  Each warp's
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

}  // extern "C"
