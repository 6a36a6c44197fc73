// P1 and P2: speed-of-light probes for the row-loop kernels, for NVIDIA
// Hopper (sm_90a).
//
// Replaces two TPU kernels that measured the TPU's own ceilings:
//   P1  tools/prof/roofline_probe.py chain_kernel (pallas_call :78):
//       dependent add+max chains, x = max(x + a, b), and roll+add chains,
//       x = roll(x, 1) + a (cyclic: lane 0 takes lane W-1), on a resident
//       [B, W] float32 block;
//   P2  tools/prof/sol_transcendental.py chain_kernel (pallas_call :29):
//       dependent log-add-exp chains, x = lse(x, a), in three forms.
// The plain PyTorch versions are quaff_tpu_torch/prof/chains.py
// (chain_reference); the entry points are prof/roofline_probe.py and
// prof/sol_transcendental.py.
//
// Layout.  A row b of the [B, W] block is laid out as K1 lays out a pair's
// band at the same width: prof/chains.chain takes the tiling from
// dp/fill_v2.fill_route(W), so a probe step at (B, W) runs at K1's tiling
// there, and the TPU's sequential GRID axis becomes a loop inside the
// kernel (the state stays resident across it, as o_ref stays in VMEM).
// Each thread owns lpt consecutive lanes, w = (tile * 32 + t) * lpt + k,
// as in K1; lanes past W take no part.
//   warp     sol_warp_kernel<OP, LPT, E> (W <= 512): one warp a row, its
//            lanes in registers, kWarpsPerBlock rows a block, as
//            band_fill_warp.cuh; no block barrier;
//   cluster  sol_cluster_kernel<OP, LPT> (W <= 16384): the row tiled over
//            the warps of a thread-block cluster of nct CTAs, the lanes in
//            registers, as band_fill_cluster.cuh;
//   smem     sol_smem_kernel<GLOBAL, OP> (every wider row): up to 16 CTAs
//            of up to 16 warps, each thread's run of lpt lanes (x, a and b,
//            kSolLaneBytes a lane) laid out [lane of the run][thread] in
//            the CTA's dynamic shared memory (the shared tier) or in the
//            CTA's part of a per-row slab of global memory the wrapper
//            allocates (GLOBAL, the global tier), as band_fill_smem.cuh.
// roll_add's exchange is the row's: the run shifts by one lane in place,
// and its first lane takes the lane before it,
//   - in a warp by __shfl_sync of the previous thread's last lane (thread 0
//     takes lane W-1 from the thread that holds it: E, its index in that
//     thread's run, is a template argument, so no lane is picked at run
//     time);
//   - across tiles through a slot a row: before the step's one barrier
//     each tile's thread 31 posts its last lane to the next tile's slot in
//     that tile's CTA (distributed shared memory past one CTA) and the
//     thread holding lane W-1 posts it to tile 0's; after it thread 0 of
//     each tile reads its own slot.  The barrier is a block barrier where
//     the cluster is one CTA, else one cluster barrier
//     (cluster_seam.cuh's seam_arrive / seam_wait, the run's in-place
//     shift between the two halves), and the slots are double buffered by
//     step parity as K1's are: a step's slot is written only after every
//     tile has passed the previous step's barrier, by which time each has
//     read the slot of two steps ago.
// add_max and the lse ops run at the same tiling with lpt independent
// chains a thread and no exchange.  Each thread runs grid * iters steps;
// in the register layouts the cheap ops' steps are unrolled by 16 so that
// loop control is not a chain op.  Tiles past the row's last lane (the
// ragged end of a tiling) skip their lanes, keeping the barriers.  x
// starts at x0 (a, as at pl.program_id(0) == 0, unless the caller gives
// another start).  Every element gets one add (and max) a step in the
// plain version's order, so add_max and roll_add are bitwise equal to it.
//
// What bounds each op on this card, and what the layout does about it:
//   add_max      two dependent ALU ops a lane and step (FADD, FMNMX):
//                latency-bound per warp, throughput-bound once enough warps are
//                resident; lpt independent chains a thread give each warp
//                lpt-fold ILP, the smem layouts add a run's shared- or
//                global-memory load and store a lane and step;
//   roll_add     the row's lane exchange and barrier, which every row loop
//                of K1 pays at this tiling: in the warp layout one shuffle
//                a step (the in-register shift is lpt adds), in the
//                cluster and smem layouts one shuffle, one slot store and
//                read, and one block or cluster barrier a step;
//   lse_*        expf and log1pf/logf go through the special-function units
//                and software sequences around them, a fraction of the FMA
//                rate.  lse_guarded is comb<false> of band_fill.cuh, the
//                log-add-exp K2, K3 and K4 run.
// Built with the same flags as K1-K4 (no --use_fast_math), so it measures
// the arithmetic those kernels get.

#include <cstdint>
#include <type_traits>

#include "band_fill_warp.cuh"
#include "cluster_smem.cuh"

namespace {

enum SolOp { kAddMax = 0, kRollAdd = 1, kLseGuarded = 2, kRawLse = 3,
             kRawLseLog = 4 };

// bytes a lane of the smem layouts' run: x, a and b
constexpr size_t kSolLaneBytes = 3 * sizeof(float);

// steps unrolled a loop iteration of the register layouts: 16 for the
// cheap ops (loop control would be a chain op), 1 for the lse ops (a step
// is ~20 add_max steps a lane); the smem layouts' step is a loop over the
// run already, one a loop iteration
template <int OP>
constexpr int kSolUnroll = OP == kAddMax || OP == kRollAdd ? 16 : 1;

// one elementwise step of x (not roll_add)
template <int OP>
__device__ __forceinline__ float sol_elem(float x, float a, float b) {
  if (OP == kAddMax) return fmaxf(x + a, b);
  if (OP == kLseGuarded) return comb<false>(x, a);
  const float m = fmaxf(x, a);
  if (OP == kRawLse) return m + log1pf(expf(-fabsf(x - a)));
  return m + logf(1.0f + expf(-fabsf(x - a)));  // kRawLseLog
}

// grid * iters calls of step()
template <int UNROLL, typename Step>
__device__ __forceinline__ void sol_steps(int grid, int iters, Step&& step) {
  const int blocks = iters / UNROLL, tail = iters % UNROLL;
  for (int q = 0; q < grid; ++q) {
    for (int k = 0; k < blocks; ++k) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) step();
    }
    for (int u = 0; u < tail; ++u) step();
  }
}

// lane e (a run-time index) of a thread's register run
template <int LPT>
__device__ __forceinline__ float lane_at(const float (&x)[LPT], int e) {
  float v = x[0];
#pragma unroll
  for (int k = 1; k < LPT; ++k) v = k == e ? x[k] : v;
  return v;
}

// v into `slot` of this CTA (one CTA) or, at `remote`, of a peer's
__device__ __forceinline__ void sol_post(float* slot, uint32_t remote, float v,
                                         int nct) {
  if (nct > 1)
    remote_store(remote, v);
  else
    *slot = v;
}

// The distributed-shared-memory addresses of a tile's posts in both slot
// buffers (s0, s1: this CTA's copies): its last lane to tile g + 1's slot
// in that tile's CTA, the row's last lane to tile 0's in CTA 0; picked by
// step parity with a select, never an indexed array (local memory).
struct SolPeers {
  uint32_t n0, n1, w0, w1;
  __device__ __forceinline__ uint32_t next(int buf) const {
    return buf ? n1 : n0;
  }
  __device__ __forceinline__ uint32_t wrap(int buf) const {
    return buf ? w1 : w0;
  }
};

__device__ __forceinline__ SolPeers sol_peers(float* s0, float* s1,
                                              bool post_next, bool post_wrap,
                                              int g, int nw, int nct) {
  SolPeers p{0u, 0u, 0u, 0u};
  if (nct > 1 && post_next) {
    p.n0 = remote_addr(s0 + g + 1, (g + 1) / nw);
    p.n1 = remote_addr(s1 + g + 1, (g + 1) / nw);
  }
  if (nct > 1 && post_wrap) {
    p.w0 = remote_addr(s0, 0);
    p.w1 = remote_addr(s1, 0);
  }
  return p;
}

// ------------------------------------------------------------- warp layout

template <int OP, int LPT, int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) sol_warp_kernel(
    const float* __restrict__ x0, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ out, int B, int W,
    int grid, int iters) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp: no barrier follows
  const int t = threadIdx.x & 31;
  const size_t base = (size_t)row * W;
  float x[LPT], av[LPT], bv[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = t * LPT + k;
    const bool ok = w < W;
    x[k] = ok ? x0[base + w] : 0.f;
    av[k] = ok ? a[base + w] : 0.f;
    bv[k] = ok ? b[base + w] : 0.f;
  }
  if constexpr (OP == kRollAdd) {
    // lane W-1 is lane E of thread tl's run; thread 0 takes it
    const int tl = (W - 1) / LPT;
    const int src = t == 0 ? tl : t - 1;
    sol_steps<kSolUnroll<OP>>(grid, iters, [&] {
      const float edge = t == tl ? x[E] : x[LPT - 1];
      const float left = __shfl_sync(kFull, edge, src);
#pragma unroll
      for (int k = LPT - 1; k > 0; --k) x[k] = x[k - 1] + av[k];
      x[0] = left + av[0];
    });
  } else {
    sol_steps<kSolUnroll<OP>>(grid, iters, [&] {
#pragma unroll
      for (int k = 0; k < LPT; ++k) x[k] = sol_elem<OP>(x[k], av[k], bv[k]);
    });
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = t * LPT + k;
    if (w < W) out[base + w] = x[k];
  }
}

// ---------------------------------------------------------- cluster layout

template <int OP, int LPT>
__global__ void __launch_bounds__(kSmemMaxWarps * 32, 1) sol_cluster_kernel(
    const float* __restrict__ x0, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ out, int W, int grid,
    int iters) {
  // by the tile that reads it, in that tile's CTA
  __shared__ float slots[2][kMaxTiles];
  const int nct = cluster_ctas(), rank = cluster_rank();
  const int nw = blockDim.x >> 5, t = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int g = rank * nw + wi;
  const size_t base = (size_t)(blockIdx.x / nct) * W;
  const int gl = (W - 1) / (32 * LPT);  // the row's last live tile
  const bool live = g <= gl;
  float x[LPT], av[LPT], bv[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = (g * 32 + t) * LPT + k;
    const bool ok = w < W;
    x[k] = ok ? x0[base + w] : 0.f;
    av[k] = ok ? a[base + w] : 0.f;
    bv[k] = ok ? b[base + w] : 0.f;
  }
  if constexpr (OP == kRollAdd) {
    // lane W-1 is lane e of thread tl of tile gl; each live tile's thread
    // 31 posts its last lane to tile g + 1's slot (in that tile's CTA)
    // while g + 1 is live, thread tl of tile gl lane W-1 to tile 0's
    const int tl = (W - 1) % (32 * LPT) / LPT, e = (W - 1) % LPT;
    const bool post_next = t == 31 && g < gl, post_wrap = g == gl && t == tl;
    const SolPeers pr = sol_peers(slots[0], slots[1], post_next, post_wrap,
                                  g, nw, nct);
    // every CTA of the cluster has started before a peer's first post
    // stores into its shared memory
    cluster_sync(nct);
    int buf = 0;
    sol_steps<kSolUnroll<OP>>(grid, iters, [&] {
      float left = 0.f;
      if (live) {
        if (post_next)
          sol_post(&slots[buf][g + 1], pr.next(buf), x[LPT - 1], nct);
        if (g == gl) {
          const float v = lane_at(x, e);
          if (post_wrap) sol_post(&slots[buf][0], pr.wrap(buf), v, nct);
        }
        left = __shfl_up_sync(kFull, x[LPT - 1], 1);
      }
      seam_arrive(nct);
      if (live) {
#pragma unroll
        for (int k = LPT - 1; k > 0; --k) x[k] = x[k - 1] + av[k];
      }
      seam_wait(nct);
      if (live) x[0] = (t == 0 ? slots[buf][g] : left) + av[0];
      buf ^= 1;
    });
  } else if (live) {  // no barrier: the tiles past the row's last idle
    sol_steps<kSolUnroll<OP>>(grid, iters, [&] {
#pragma unroll
      for (int k = 0; k < LPT; ++k) x[k] = sol_elem<OP>(x[k], av[k], bv[k]);
    });
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int w = (g * 32 + t) * LPT + k;
    if (w < W) out[base + w] = x[k];
  }
}

// ------------------------------------------------------------- smem layout

template <bool GLOBAL, int OP>
__global__ void __launch_bounds__(kSmemMaxWarps * 32, 1) sol_smem_kernel(
    const float* __restrict__ x0, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ out, int W, int grid,
    int iters, int lpt, unsigned char* __restrict__ slab) {
  extern __shared__ __align__(16) unsigned char sol_smem[];
  // by the tile that reads it, in that tile's CTA
  __shared__ float slots[2][kMaxClusterCtas * kSmemMaxWarps];
  const int NT = blockDim.x, tid = threadIdx.x;
  const int nct = cluster_ctas(), rank = cluster_rank();
  const int nw = NT >> 5, t = tid & 31, wi = tid >> 5;
  const int g = rank * nw + wi;
  const size_t base = (size_t)(blockIdx.x / nct) * W;
  const size_t run = (size_t)lpt * NT;
  float* X = reinterpret_cast<float*>(
      GLOBAL ? slab + (size_t)blockIdx.x * run * kSolLaneBytes : sol_smem);
  float* A = X + run;
  float* Bv = A + run;
  const int w0 = (g * 32 + t) * lpt;  // the thread's first lane
  const int gl = (W - 1) / (32 * lpt);
  const bool live = g <= gl;
  for (int k = 0; k < lpt; ++k) {
    const int w = w0 + k;
    const size_t i = (size_t)k * NT + tid;
    const bool ok = w < W;
    X[i] = ok ? x0[base + w] : 0.f;
    A[i] = ok ? a[base + w] : 0.f;
    if (OP == kAddMax) Bv[i] = ok ? b[base + w] : 0.f;
  }
  if constexpr (OP == kRollAdd) {
    const int tl = (W - 1) % (32 * lpt) / lpt, e = (W - 1) % lpt;
    const bool post_next = t == 31 && g < gl, post_wrap = g == gl && t == tl;
    const SolPeers pr = sol_peers(slots[0], slots[1], post_next, post_wrap,
                                  g, nw, nct);
    float* last = X + (size_t)(lpt - 1) * NT + tid;
    float* edge = X + (size_t)e * NT + tid;
    cluster_sync(nct);
    int buf = 0;
    sol_steps<1>(grid, iters, [&] {
      float left = 0.f;
      if (live) {
        const float xl = *last;
        if (post_next) sol_post(&slots[buf][g + 1], pr.next(buf), xl, nct);
        if (post_wrap) sol_post(&slots[buf][0], pr.wrap(buf), *edge, nct);
        left = __shfl_up_sync(kFull, xl, 1);
      }
      seam_arrive(nct);
      if (live) {
        for (int k = lpt - 1; k > 0; --k) {
          const size_t i = (size_t)k * NT + tid;
          X[i] = X[i - NT] + A[i];
        }
      }
      seam_wait(nct);
      if (live) X[tid] = (t == 0 ? slots[buf][g] : left) + A[tid];
      buf ^= 1;
    });
  } else if (live) {  // no barrier: the tiles past the row's last idle
    sol_steps<1>(grid, iters, [&] {
      for (int k = 0; k < lpt; ++k) {
        const size_t i = (size_t)k * NT + tid;
        X[i] = sol_elem<OP>(X[i], A[i], OP == kAddMax ? Bv[i] : 0.f);
      }
    });
  }
  for (int k = 0; k < lpt; ++k) {
    const int w = w0 + k;
    if (w < W) out[base + w] = X[(size_t)k * NT + tid];
  }
}

// ---------------------------------------------------------------- launches

// f(std::integral_constant<int, N>) for the N of Ns that equals n;
// cudaErrorInvalidValue where none does
template <int... Ns, typename F>
cudaError_t with_int(int n, F&& f) {
  cudaError_t e = cudaErrorInvalidValue;
  (void)((n == Ns ? (e = f(std::integral_constant<int, Ns>{}), true)
                  : false) ||
         ...);
  return e;
}

template <int OP, int LPT, int E = 0>
cudaError_t launch_sol_warp(int e, const float* x0, const float* a,
                            const float* b, float* out, int B, int W,
                            int grid, int iters, cudaStream_t stream) {
  if constexpr (OP == kRollAdd && E + 1 < LPT) {
    if (e != E)
      return launch_sol_warp<OP, LPT, E + 1>(e, x0, a, b, out, B, W, grid,
                                             iters, stream);
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sol_warp_kernel<OP, LPT, E><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      x0, a, b, out, B, W, grid, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The chain entries: `op` (0 add_max, 1 roll_add, 2 lse_guarded, 3
// raw_lse, 4 raw_lse_log) for grid * iters steps over [B, W] float32 rows
// from x0, on `stream`, at one of K1's layouts (prof/chains.chain picks it
// with dp/fill_v2.fill_route).  Each returns the cudaError_t of the launch,
// or of the card's refusal of the cluster shape or its shared memory; none
// synchronises or allocates.

// The warp layout: one warp a row, lpt (1, 2, 4, 8 or 16) lanes a thread,
// W <= 32 * lpt.
int quaff_sol_chain_warp(int op, const void* x0, const void* a, const void* b,
                         void* out, int B, int W, int grid, int iters,
                         int lpt, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 32 * lpt || grid < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x0);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)with_int<kAddMax, kRollAdd, kLseGuarded, kRawLse, kRawLseLog>(
      op, [&](auto o_) {
        return with_int<1, 2, 4, 8, 16>(lpt, [&](auto l_) {
          constexpr int L = decltype(l_)::value;
          return launch_sol_warp<decltype(o_)::value, L>((W - 1) % L, xp, ap,
                                                         bp, o, B, W, grid,
                                                         iters, st);
        });
      });
}

// The cluster layout: a row over nct CTAs (a thread-block cluster, at most
// 8) of `warps` warps, lpt (4, 8 or 16) lanes a thread, the lanes in
// registers; at most kMaxTiles tiles, which must cover the row.
int quaff_sol_chain_cluster(int op, const void* x0, const void* a,
                            const void* b, void* out, int B, int W, int grid,
                            int iters, int lpt, int nct, int warps,
                            void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || grid < 0 || iters < 0 || nct < 1 || nct > 8 || warps < 1 ||
      warps > kSmemMaxWarps || nct * warps > kMaxTiles ||
      (long long)W > (long long)nct * warps * 32 * lpt)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x0);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)with_int<kAddMax, kRollAdd, kLseGuarded, kRawLse, kRawLseLog>(
      op, [&](auto o_) {
        return with_int<4, 8, 16>(lpt, [&](auto l_) {
          return launch_cluster(
              sol_cluster_kernel<decltype(o_)::value, decltype(l_)::value>, B,
              nct, warps, 0, st, false, xp, ap, bp, o, W, grid, iters);
        });
      });
}

// The smem layout: a row over nct CTAs (a cluster, at most 16) of `warps`
// warps (at most 16), lpt lanes a thread, which must cover the row; each
// thread's run in shared memory (slab null: the shared tier) or in `slab`,
// slab_bytes of global memory that must hold B * nct * warps * 32 * lpt
// lanes of kSolLaneBytes (the global tier).
int quaff_sol_chain_smem(int op, const void* x0, const void* a, const void* b,
                         void* out, int B, int W, int grid, int iters,
                         int lpt, int nct, int warps, void* slab,
                         long long slab_bytes, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || grid < 0 || iters < 0 || lpt < 1 || nct < 1 || warps < 1 ||
      (long long)W > (long long)nct * warps * 32 * lpt ||
      !slab_ok(slab, slab_bytes, B, nct, lpt, warps, kSolLaneBytes))
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x0);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  auto* sl = static_cast<unsigned char*>(slab);
  auto st = static_cast<cudaStream_t>(stream);
  const bool global = sl != nullptr;
  return (int)with_int<kAddMax, kRollAdd, kLseGuarded, kRawLse, kRawLseLog>(
      op, [&](auto o_) {
        constexpr int OP = decltype(o_)::value;
        return launch_smem(
            global ? sol_smem_kernel<true, OP> : sol_smem_kernel<false, OP>,
            B, nct, warps,
            global ? 0 : run_bytes(lpt, warps, kSolLaneBytes), st, xp, ap,
            bp, o, W, grid, iters, lpt, sl);
      });
}

}  // extern "C"
