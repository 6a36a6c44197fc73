// P1 and P2: speed-of-light probes for the row-loop kernels, for NVIDIA
// Hopper (sm_90a).
//
// Replaces two TPU kernels that measured the TPU's own ceilings:
//   P1  tools/prof/roofline_probe.py chain_kernel (pallas_call :78):
//       dependent add+max chains, x = max(x + a, b), and roll+add chains,
//       x = roll(x, 1) + a, on a resident [B, W] float32 block;
//   P2  tools/prof/sol_transcendental.py chain_kernel (pallas_call :29):
//       dependent log-add-exp chains, x = lse(x, a), in three forms.
// The plain PyTorch versions are quaff_tpu_torch/prof/chains.py
// (chain_reference); the entry points are prof/roofline_probe.py and
// prof/sol_transcendental.py.
//
// Shape.  The probe is laid out as K1 (band_fill.cuh) is: one block per row
// b of the [B, W] block, one thread per lane, and the TPU's sequential GRID
// axis becomes a loop inside the block (the state x stays in a register
// across it, as o_ref stays resident in VMEM).  So a step costs what a
// step of K1-K4's row loops costs at the same occupancy.  Each thread runs
// grid * iters dependent steps of one op; the inner loop is unrolled by
// kUnroll so that loop control is not a chain op.  x starts at x0 (a, as
// at pl.program_id(0) == 0, unless the caller gives another start).
//
// What bounds each op on this card:
//   add_max      two dependent ALU ops a step (FADD, FMNMX): latency-bound
//                per warp, throughput-bound once enough warps are resident;
//   roll_add     the in-row dependency every row loop pays: store the lane
//                to shared memory, a barrier, read lane w-1, add, and a
//                second barrier before the next store; the barrier's
//                latency sets the pace, not the add;
//   lse_*        expf and log1pf/logf go through the special-function units
//                and software sequences around them, a fraction of the FMA
//                rate.  lse_guarded is comb<false> of band_fill.cuh, the
//                log-add-exp K2, K3 and K4 run.
// Built with the same flags as K1-K4 (no --use_fast_math), so it measures
// the arithmetic those kernels get.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 16;
constexpr int kMaxLanes = 1024;

enum Op { kAddMax = 0, kRollAdd = 1, kLseGuarded = 2, kRawLse = 3,
          kRawLseLog = 4 };

// one chain step of x; roll_add exchanges x through the block's shared row
// (`left` is the lane it reads), the other ops are elementwise
template <int OP>
__device__ __forceinline__ float step(float x, float a, float b, float* row,
                                      int left) {
  if (OP == kRollAdd) {
    row[threadIdx.x] = x;
    __syncthreads();
    x = row[left] + a;
    __syncthreads();  // the next step's store overwrites what was read
    return x;
  }
  if (OP == kAddMax) return fmaxf(x + a, b);
  const float m = fmaxf(x, a);
  if (OP == kLseGuarded)  // comb<false> of band_fill.cuh
    return m < -1e38f ? m : m + log1pf(expf(-fabsf(x - a)));
  if (OP == kRawLse) return m + log1pf(expf(-fabsf(x - a)));
  return m + logf(1.0f + expf(-fabsf(x - a)));  // kRawLseLog
}

template <int OP>
__global__ void __launch_bounds__(kMaxLanes) sol_chain_kernel(
    const float* __restrict__ x0, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ out, int W, int grid,
    int iters) {
  __shared__ float row[kMaxLanes];
  const size_t i = (size_t)blockIdx.x * W + threadIdx.x;
  const int left = threadIdx.x == 0 ? W - 1 : threadIdx.x - 1;
  const float av = a[i];
  const float bv = b[i];
  float x = x0[i];
  const int blocks = iters / kUnroll, tail = iters % kUnroll;
  for (int g = 0; g < grid; ++g) {
    for (int k = 0; k < blocks; ++k) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x = step<OP>(x, av, bv, row, left);
    }
    for (int u = 0; u < tail; ++u) x = step<OP>(x, av, bv, row, left);
  }
  out[i] = x;
}

template <int OP>
cudaError_t launch(const float* x0, const float* a, const float* b,
                   float* out, int B, int W, int grid, int iters,
                   cudaStream_t stream) {
  sol_chain_kernel<OP><<<B, W, 0, stream>>>(x0, a, b, out, W, grid, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the chain of `op` (0 add_max, 1 roll_add, 2 lse_guarded,
// 3 raw_lse, 4 raw_lse_log) over [B, W] float32 rows on `stream`; returns
// the cudaError_t of the launch.  Does not synchronise and allocates
// nothing.
int quaff_sol_chain(int op, const void* x0, const void* a, const void* b,
                    void* out, int B, int W, int grid, int iters,
                    void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > kMaxLanes || grid < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x0);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (op) {
    case kAddMax:
      e = launch<kAddMax>(xp, ap, bp, o, B, W, grid, iters, st);
      break;
    case kRollAdd:
      e = launch<kRollAdd>(xp, ap, bp, o, B, W, grid, iters, st);
      break;
    case kLseGuarded:
      e = launch<kLseGuarded>(xp, ap, bp, o, B, W, grid, iters, st);
      break;
    case kRawLse:
      e = launch<kRawLse>(xp, ap, bp, o, B, W, grid, iters, st);
      break;
    case kRawLseLog:
      e = launch<kRawLseLog>(xp, ap, bp, o, B, W, grid, iters, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
