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
// Two routes, picked by dp/ov_fill.ov_route from the band's width W alone:
//
//   warp route     W <= dp/ov_fill.OV_WARP_MAX_LANES (the measured cutover):
//                  ov_fill_warp_kernel<IK, LPT> (ov_fill_warp.cuh), one
//                  warp per pair, the band row in registers, the row's
//                  inputs and emission a row ahead, no block barrier in the
//                  row loop;
//   cluster route  wider bands, up to OV_LANE_CAP:
//                  ov_fill_cluster_kernel<IK, LPT> (ov_fill_cluster.cuh),
//                  the pair's band tiled over the warps of a thread-block
//                  cluster, each warp on the warp route's row code, the
//                  tiles meeting once a row.
//
// Each lane gathers its x values straight from the bank at t (and t - 1
// for stay_x(i-1)): neighbouring lanes read neighbouring addresses, where
// the TPU kernel had to roll windows.  The row's y values are one
// broadcast load each.  The delete chain is scanned as affine-max maps
// x -> max(lse(x + c, k), b) carried as triples (c, k, b)
// (ov_fill_warp.cuh); lanes outside the envelope carry c = -inf, so no
// path crosses a strip seam.  At the end the pair's end accumulators
// reduce to the pair score (end + x and y insert sums) and the per-strip
// maxima: no [B, W] array returns to device memory.
//
// What bounds it: neither bytes (the bank is read once per lane and row
// from L2) nor the FP32 rate, but each row's dependent chain: the cells,
// the delete chain's composes and scans, and on the cluster route the
// row's one cluster barrier.

#include "ov_fill_cluster.cuh"

extern "C" {

// Launches K4's warp route on `stream` (W <= 32 * lpt, lpt one of 1, 2, 4,
// 8, 16); returns the cudaError_t of the launch.  Does not synchronise and
// allocates nothing.  meta is [B][8] int32 (two int4 per pair), ins_xy
// [B][2] float32, out [B + B*S] float32.
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

// Launches K4's cluster route on `stream`: each pair's band tiled over
// nct CTAs (a thread-block cluster) of `warps` warps, lpt lanes a thread
// (one of 2, 4, 8), at most kMaxTiles tiles, which must cover the band.
// Returns the cudaError_t of the launch, or of the card's refusal of the
// cluster shape.  Same inputs and output as quaff_ov_fill_warp.
int quaff_ov_fill_cluster(const void* bank, int C, int L, const void* meta,
                          const void* doff, int W, const void* seg_start,
                          const void* seg_width, int S, const void* ins_xy,
                          const void* trans, int B, int lpt, int nct,
                          int warps, void* out, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || nct < 1 || warps < 1 || nct * warps > kMaxTiles ||
      W > nct * warps * 32 * lpt || S < 1 || S > kMaxSegs ||
      (C != 5 && C != 7) || L < 1)
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
      C == 7 ? launch_ov_cluster<true>(lpt, nct, warps, bk, L, m4, dof, W, s0,
                                       sw, S, iv, tr, B, o, st)
             : launch_ov_cluster<false>(lpt, nct, warps, bk, L, m4, dof, W,
                                        s0, sw, S, iv, tr, B, o, st);
  return (int)e;
}

}  // extern "C"
