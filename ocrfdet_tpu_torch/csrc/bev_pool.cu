// Depth-weighted BEV pooling (LSS splat), forward and backward (Hopper,
// sm_90a).
//
// Replaces: ocrfdet_tpu/ops/bev_pool_pallas.py::bev_pool_points, the
// Pallas kernels _fwd_kernel (forward) and _bwd_kernel (backward). It is
// also the counterpart of the reference's CUDA bev_pool_v2.
//
//   out[b, cell, c] = sum over points p with cell_p == cell of
//                     w[b, p] * feat[b, pix_p, c]
//   dfeat[b, pix, c] = sum over points p with pix_p == pix of
//                      w[b, p] * g[b, cell_p, c]
//   dw[b, p]         = <feat[b, pix_p, :], g[b, cell_p, :]>
// Points whose cell id lies outside [0, cells) (the invalid id is
// `cells`) or whose pixel id lies outside [0, npix) are dropped (their dw
// is 0).
//
// What bounds it on an H100: at flagship shapes (498,432 points, 4,224
// pixels x 80 channels, 16,384 cells) the compulsory traffic is ~12.6 MB
// forward (three 4-byte point streams, feat, out) and ~14.6 MB backward
// (the streams, feat, g, dfeat, dw), ~4 us at 3.35 TB/s; the work is
// ~40 M fp32 atomic adds into an output that lives in L2, so the L2
// atomic throughput bounds both kernels. Forward design: one thread per
// (point, channel); a warp covers consecutive channels of one or two
// points, so the feat reads and the atomics are coalesced. The output
// must be zeroed by the caller. Backward design: one warp per point, its
// lanes over the channels: each lane adds w * g[cell, c] into dfeat (an
// atomic, many points share a pixel) and accumulates feat * g, which a
// warp shuffle reduces to the point's dw; dw is written once, so it is
// deterministic (its sum order is fixed), while dfeat's atomics make the
// order, and so the last bits, vary from run to run. dfeat must be
// zeroed by the caller. The deterministic interval design of bev_pool_v2
// (sort by cell, one thread per interval and channel) is left for a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;

// w/pix/cell [B, P]; feat [B, npix, C]; out [B, cells, C] (zeroed).
__global__ void __launch_bounds__(kThreads)
bev_pool_forward_kernel(const float* __restrict__ w,
                        const int* __restrict__ pix,
                        const int* __restrict__ cell,
                        const float* __restrict__ feat,
                        float* __restrict__ out, int B, int64_t P, int npix,
                        int C, int cells) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)B * P * C) return;
  const int64_t bp = i / C;  // b * P + p
  const int c = (int)(i - bp * C);
  const int cl = cell[bp];
  const int px = pix[bp];
  if (cl < 0 || cl >= cells || px < 0 || px >= npix) return;
  const int64_t b = bp / P;
  const float v = w[bp] * feat[(b * npix + px) * C + c];
  atomicAdd(out + (b * cells + cl) * C + c, v);
}

// g [B, cells, C]; dfeat [B, npix, C] (zeroed); dw [B, P].
__global__ void __launch_bounds__(kThreads)
bev_pool_backward_kernel(const float* __restrict__ w,
                         const int* __restrict__ pix,
                         const int* __restrict__ cell,
                         const float* __restrict__ feat,
                         const float* __restrict__ g,
                         float* __restrict__ dfeat, float* __restrict__ dw,
                         int B, int64_t P, int npix, int C, int cells) {
  const int lane = threadIdx.x % kLanes;
  const int64_t bp = (int64_t)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (bp >= (int64_t)B * P) return;
  const int cl = cell[bp];
  const int px = pix[bp];
  if (cl < 0 || cl >= cells || px < 0 || px >= npix) {
    if (lane == 0) dw[bp] = 0.f;
    return;
  }
  const int64_t b = bp / P;
  const float wp = w[bp];
  const float* grow = g + (b * cells + cl) * C;
  const float* frow = feat + (b * npix + px) * C;
  float* drow = dfeat + (b * npix + px) * C;
  float acc = 0.f;
  for (int c = lane; c < C; c += kLanes) {
    const float gv = grow[c];
    atomicAdd(drow + c, wp * gv);
    acc += frow[c] * gv;
  }
#pragma unroll
  for (int s = kLanes / 2; s > 0; s /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, s);
  if (lane == 0) dw[bp] = acc;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int bev_pool_forward(const float* w, const int* pix, const int* cell,
                     const float* feat, float* out, int B, int64_t P,
                     int npix, int C, int cells, void* stream) {
  const int64_t total = (int64_t)B * P * C;
  if (total > 0) {
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    bev_pool_forward_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        w, pix, cell, feat, out, B, P, npix, C, cells);
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success).
int bev_pool_backward(const float* w, const int* pix, const int* cell,
                      const float* feat, const float* g, float* dfeat,
                      float* dw, int B, int64_t P, int npix, int C,
                      int cells, void* stream) {
  const int64_t points = (int64_t)B * P;
  if (points > 0) {
    const unsigned blocks = (unsigned)((points + kWarps - 1) / kWarps);
    bev_pool_backward_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        w, pix, cell, feat, g, dfeat, dw, B, P, npix, C, cells);
  }
  return (int)cudaGetLastError();
}

const char* bev_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
