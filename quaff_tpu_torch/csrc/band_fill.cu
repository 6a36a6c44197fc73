// K1: banded pair-HMM score fill (Viterbi or Forward, local or global) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel quaff_tpu/dp/pallas_v2.py::fill_v2 (kernel body
// _row_kernel -> _one_row) together with the end reduction of
// scores_v2_traceable.  The plain PyTorch version of the same function is
// quaff_tpu_torch/dp/fill_v2.py::band_fill_reference; the input layout is
// described there (kernel_inputs).
//
// Three routes, picked by dp/fill_v2.fill_route from the band's width W
// alone:
//
//   warp route     W <= 32 * 16: band_fill_warp_kernel<VIT, LPT>
//                  (band_fill_warp.cuh), one warp per pair, the band row in
//                  registers, LPT lanes a thread (the smallest of 1, 2, 4,
//                  8, 16 with 32 * LPT >= W), no block barrier in the row
//                  loop;
//   cluster route  W <= dp/fill_v2.FILL_CLUSTER_MAX_LANES (16384):
//                  band_fill_cluster_kernel<VIT, false, LPT>
//                  (band_fill_cluster.cuh), the pair's band tiled over the
//                  warps of a thread-block cluster, each warp on the warp
//                  route's row code, the tiles meeting once a row;
//   smem route     every wider band: band_fill_smem_kernel<GLOBAL, VIT>
//                  (band_fill_smem.cuh), the pair's band over a cluster of
//                  up to 16 CTAs of up to 16 warps, each thread's run of
//                  lanes in shared memory up to
//                  dp/fill_v2.FILL_SMEM_MAX_LANES (the shared tier), in a
//                  per-pair slab of global memory past it (the global
//                  tier), the tiles meeting once a row in the two-level
//                  fold of cluster_smem.cuh.
// No route gives a pair one block (the former block route is deleted).
//
// What bounds them: neither bytes nor FLOPs (a pair of Ly rows and W lanes
// moves about 16*Ly + W*Ly bytes); the warp route issues ~50 instructions
// a lane and row, the cluster and smem routes add a cluster barrier and
// scans over their tiles to each row's dependent chain.

#include "band_fill_cluster.cuh"
#include "band_fill_smem.cuh"

extern "C" {

// Launches K1's warp route on `stream` (W <= 32 * lpt, lpt one of 1, 2, 4,
// 8, 16); returns the cudaError_t of the launch.  Every K1 entry takes the
// same inputs (dp/fill_v2.launch_args) and writes the same [B + B*S]
// output: the pair scores, then the per-strip end maxima.
int quaff_band_fill_warp(const void* x_tok, int Lx, const void* keys, int Ly,
                         const void* meta, const void* doff, int W,
                         const void* seg_start, const void* seg_width, int S,
                         const void* match, const void* match_noq,
                         const void* insert, const void* insert_noq, int Km,
                         int Q, const void* ik, int n_ik, const void* trans,
                         int B, int viterbi, int local, int lpt, void* out,
                         void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 32 * lpt || S < 1 || S > kMaxSegs || n_ik < 1 || Lx < 1)
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  const auto* xt = static_cast<const int8_t*>(x_tok);
  const auto* k4 = static_cast<const int4*>(keys);
  const auto* m4 = static_cast<const int4*>(meta);
  const auto* dof = static_cast<const int*>(doff);
  const auto* s0 = static_cast<const int*>(seg_start);
  const auto* sw = static_cast<const int*>(seg_width);
  const auto* tr = static_cast<const float*>(trans);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      viterbi ? launch_warp_lpt<true>(lpt, xt, Lx, k4, Ly, m4, dof, W, s0, sw,
                                      S, tb, tr, B, local, o, st)
              : launch_warp_lpt<false>(lpt, xt, Lx, k4, Ly, m4, dof, W, s0,
                                       sw, S, tb, tr, B, local, o, st);
  return (int)e;
}

// Launches K1's cluster route on `stream`: each pair's band tiled over
// nct CTAs (a thread-block cluster) of `warps` warps, lpt lanes a thread
// (one of 4, 8, 16), at most kMaxTiles tiles, which must cover the band.
// Returns the cudaError_t of the launch, or of the card's refusal of the
// cluster shape.
int quaff_band_fill_cluster(const void* x_tok, int Lx, const void* keys,
                            int Ly, const void* meta, const void* doff, int W,
                            const void* seg_start, const void* seg_width,
                            int S, const void* match, const void* match_noq,
                            const void* insert, const void* insert_noq,
                            int Km, int Q, const void* ik, int n_ik,
                            const void* trans, int B, int viterbi, int local,
                            int lpt, int nct, int warps, void* out,
                            void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || nct < 1 || warps < 1 || nct * warps > kMaxTiles ||
      W > nct * warps * 32 * lpt || S < 1 || S > kMaxSegs || n_ik < 1 ||
      Lx < 1)
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  const auto* xt = static_cast<const int8_t*>(x_tok);
  const auto* k4 = static_cast<const int4*>(keys);
  const auto* m4 = static_cast<const int4*>(meta);
  const auto* dof = static_cast<const int*>(doff);
  const auto* s0 = static_cast<const int*>(seg_start);
  const auto* sw = static_cast<const int*>(seg_width);
  const auto* tr = static_cast<const float*>(trans);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      viterbi ? launch_fill_cluster<true, false>(lpt, nct, warps, xt, Lx, k4,
                                                 Ly, m4, dof, W, s0, sw, S, tb,
                                                 tr, B, local, o, st)
              : launch_fill_cluster<false, false>(lpt, nct, warps, xt, Lx, k4,
                                                  Ly, m4, dof, W, s0, sw, S,
                                                  tb, tr, B, local, o, st);
  return (int)e;
}

// Launches K1's smem route on `stream`: each pair's band over nct CTAs (a
// thread-block cluster, at most 16) of `warps` warps (at most 16), lpt
// lanes a thread, which must cover the band; each thread's run in shared
// memory (slab null: the shared tier) or in `slab`, slab_bytes of global
// memory that must hold B * nct * warps * 32 * lpt lanes of 16 bytes (the
// global tier).  Returns the cudaError_t of the launch, or of the card's
// refusal of the cluster shape or its shared memory.
int quaff_band_fill_smem(const void* x_tok, int Lx, const void* keys, int Ly,
                         const void* meta, const void* doff, int W,
                         const void* seg_start, const void* seg_width, int S,
                         const void* match, const void* match_noq,
                         const void* insert, const void* insert_noq, int Km,
                         int Q, const void* ik, int n_ik, const void* trans,
                         int B, int viterbi, int local, int lpt, int nct,
                         int warps, void* slab, long long slab_bytes,
                         void* out, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || lpt < 1 || nct < 1 || warps < 1 ||
      (long long)W > (long long)nct * warps * 32 * lpt || S < 1 ||
      S > kMaxSegs || n_ik < 1 || Lx < 1 ||
      !slab_ok(slab, slab_bytes, B, nct, lpt, warps, kFillLaneBytes))
    return (int)cudaErrorInvalidValue;
  const FillTables tb{static_cast<const float*>(match),
                      static_cast<const float*>(match_noq),
                      static_cast<const float*>(insert),
                      static_cast<const float*>(insert_noq),
                      static_cast<const float*>(ik), Km, Q, n_ik};
  const auto* xt = static_cast<const int8_t*>(x_tok);
  const auto* k4 = static_cast<const int4*>(keys);
  const auto* m4 = static_cast<const int4*>(meta);
  const auto* dof = static_cast<const int*>(doff);
  const auto* s0 = static_cast<const int*>(seg_start);
  const auto* sw = static_cast<const int*>(seg_width);
  const auto* tr = static_cast<const float*>(trans);
  auto* sl = static_cast<unsigned char*>(slab);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      viterbi ? launch_fill_smem<true>(lpt, nct, warps, xt, Lx, k4, Ly, m4,
                                       dof, W, s0, sw, S, tb, tr, B, local,
                                       sl, o, st)
              : launch_fill_smem<false>(lpt, nct, warps, xt, Lx, k4, Ly, m4,
                                        dof, W, s0, sw, S, tb, tr, B, local,
                                        sl, o, st);
  return (int)e;
}

const char* quaff_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
