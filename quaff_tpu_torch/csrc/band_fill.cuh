// What every route of K1-K4 shares, for NVIDIA Hopper (sm_90a): the
// constants, the cells' combine (comb: the Viterbi max, else the
// log-add-exp), the inclusive warp scan of delete-chain steps (warp_scan),
// the rounding of float64 cells to stored float32 ones (to_row) and the
// reference of a relative delete chain (wide_chain_ref).
//
// The delete chain del[w] = comb(del[w-1] + d2d, mat[w-1] + m2d) is a
// first-order max-plus (Viterbi) or log-plus (Forward) recurrence across a
// row: every route has each thread compose its lanes' (c, b) steps
// sequentially, scans the threads' composites (warp_scan, then the tiles'
// and CTAs' folds of the cluster routes), and has each thread replay its
// lanes from the value entering it.  Lanes outside the envelope carry c =
// -inf, which stops the chain at strip seams exactly as the TPU kernel's
// masking does.  No route of K1-K4 gives a pair one block: K1's former
// block route, one block a pair with its row in global scratch past ~9.6k
// lanes, is deleted, and its bands past shared memory take the smem
// route's global tier (band_fill_smem.cuh).
//
// K2's float64 cells (its smem route, estep_smem.cu) take comb on doubles
// below: the max in float64, the log-add-exp's one transcendental,
// log1p(exp(-|a - b|)), in float32, whose absolute error (~1e-7 nats) does
// not grow with the cells' magnitude.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kSentinel = 1 << 24;  // fill_v2.D_SENTINEL
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

// the log-add-exp on float64 cells (K2's): the max in float64, the
// correction log1p(exp(-|a - b|)) in float32 (its absolute error ~1e-7
// whatever the cells' magnitude); the max alone below -1e38, as above
template <bool VIT>
__device__ __forceinline__ double comb(double a, double b) {
  const double m = fmax(a, b);
  if (VIT) return m;
  const double r = m + (double)log1pf(expf((float)(-fabs(a - b))));
  return m < -1e38 ? m : r;
}

__device__ __forceinline__ float vmax2(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double vmax2(double a, double b) {
  return fmax(a, b);
}

// a cell as a stored float32 one: float64 cells rounded once, NEG and
// below as NEG
__device__ __forceinline__ float to_row(float x) { return x; }
__device__ __forceinline__ float to_row(double x) {
  return x <= -(double)FLT_MAX ? -FLT_MAX : (float)x;
}

// the reference a thread's lanes compose their delete chain relative to,
// its largest opening term (K3's wide arithmetic: of the row; K1's smem
// route past 16 lanes a thread: of the previous row), 0 where it has none,
// so that a thread of invalid lanes composes exactly as the sequential
// chain
__device__ __forceinline__ float wide_chain_ref(float bmax) {
  return bmax > -FLT_MAX / 2 ? bmax : 0.f;
}

// inclusive scan over a warp of recurrence steps (C, B): x -> comb(x + C, B)
template <bool VIT, typename T>
__device__ __forceinline__ void warp_scan(T& c, T& b, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T co = __shfl_up_sync(kFull, c, off);
    const T bo = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      b = comb<VIT>(bo + c, b);  // earlier step (co, bo), then (c, b)
      c = co + c;
    }
  }
}

}  // namespace
