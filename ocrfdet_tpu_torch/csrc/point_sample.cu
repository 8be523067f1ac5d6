// Bilinear point sampling of per-camera maps, forward and backward
// (Hopper, sm_90a).
//
// Replaces: ocrfdet_tpu/ops/point_sample.py::_point_sample_mm, the
// Pallas kernels _fwd_kernel (forward) and _bwd_kernel (backward, through
// _ps_bwd).
//
//   out[bn, p, c] = sum over the taps (u, v) in {x0, x0+1} x {y0, y0+1}
//                   of relu(1-|px-u|) relu(1-|py-v|) map[bn, v, u, c],
//   x0 = floor(px), y0 = floor(py), taps outside the image weigh zero.
//
// This is the separable-tent formulation of the Pallas kernel, which
// evaluated the tent weights of every pixel as matrix products for the
// MXU; here each point reads only its four taps.
//
// What bounds it on an H100: at flagship shapes (6 cameras, 212,992
// points each, 256 x 704 maps with C = 1) it must move ~20 MB: the maps
// (4.3 MB), px and py (10.2 MB) and out (5.1 MB), ~6 us at 3.35 TB/s;
// the arithmetic is ~20 flops per point: bound by bytes. Design: one
// thread per (camera, point), the camera from blockIdx.y (no 64-bit
// division per thread), coalesced px/py reads and output writes; the
// maps are small enough to stay in L2, so the scattered tap reads hit
// cache. The weights and the sum are computed in the plain version's
// order with separately rounded operations (no FMA contraction), and the
// in-image tests are done in float, so far-off points cannot overflow an
// integer index.
//
// Backward: dmap[bn, v, u, c] += tent(px-u) tent(py-v) dout[bn, p, c] over
// the 4 taps of every point; px and py get no gradient (as the Pallas
// VJP). One thread per point recomputes the forward's tap weights and
// adds the weighted dout into the taps with fp32 atomics (neighbouring
// points share taps); a tap of weight 0 (outside the image) adds
// nothing. Every channel of the map gets its gradient. At flagship
// training shapes (12 maps of 256 x 704 x 4, 212,992 points each) it
// moves ~64 MB (px, py, dout, dmap), ~19 us at 3.35 TB/s, with up to
// 41 M atomic adds into dmap: the atomics bound it. Their order, and so
// the last bits of dmap, vary from run to run. dmap must be zeroed by the
// caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4;

__device__ __forceinline__ void axis_weights(float t0, float tt, int n,
                                             float* w0, float* w1) {
  const float in0 = (t0 >= 0.f && t0 <= (float)(n - 1)) ? 1.f : 0.f;
  const float t1 = __fadd_rn(t0, 1.f);
  const float in1 = (t1 >= 0.f && t1 <= (float)(n - 1)) ? 1.f : 0.f;
  *w0 = __fmul_rn(__fsub_rn(1.f, tt), in0);
  *w1 = __fmul_rn(tt, in1);
}

// maps [BN,H,W,C]; px/py [BN,P]; out [BN,P,C].
__global__ void __launch_bounds__(kThreads)
point_sample_forward_kernel(const float* __restrict__ maps,
                            const float* __restrict__ px,
                            const float* __restrict__ py,
                            float* __restrict__ out, int H, int W, int C,
                            int64_t P) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int bn = blockIdx.y;
  const int64_t i = bn * P + p;
  const float x = px[i], y = py[i];
  const float x0 = floorf(x), y0 = floorf(y);
  const float tx = __fsub_rn(x, x0), ty = __fsub_rn(y, y0);
  float wx0, wx1, wy0, wy1;
  axis_weights(x0, tx, W, &wx0, &wx1);
  axis_weights(y0, ty, H, &wy0, &wy1);
  // clamped tap indices (a clamped tap always has weight 0)
  const int xa = (int)fminf(fmaxf(x0, 0.f), (float)(W - 1));
  const int xb = (int)fminf(fmaxf(__fadd_rn(x0, 1.f), 0.f), (float)(W - 1));
  const int ya = (int)fminf(fmaxf(y0, 0.f), (float)(H - 1));
  const int yb = (int)fminf(fmaxf(__fadd_rn(y0, 1.f), 0.f), (float)(H - 1));
  const float* m = maps + (int64_t)bn * H * W * C;
  const float* t00 = m + ((int64_t)ya * W + xa) * C;
  const float* t01 = m + ((int64_t)ya * W + xb) * C;
  const float* t10 = m + ((int64_t)yb * W + xa) * C;
  const float* t11 = m + ((int64_t)yb * W + xb) * C;
  const float w00 = __fmul_rn(wy0, wx0), w01 = __fmul_rn(wy0, wx1);
  const float w10 = __fmul_rn(wy1, wx0), w11 = __fmul_rn(wy1, wx1);
  float* o = out + i * C;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      float v = __fmul_rn(w00, t00[c]);
      v = __fadd_rn(v, __fmul_rn(w01, t01[c]));
      v = __fadd_rn(v, __fmul_rn(w10, t10[c]));
      v = __fadd_rn(v, __fmul_rn(w11, t11[c]));
      o[c] = v;
    }
  }
}

// dout [BN,P,C]; dmap [BN,H,W,C] (zeroed).
__global__ void __launch_bounds__(kThreads)
point_sample_backward_kernel(const float* __restrict__ px,
                             const float* __restrict__ py,
                             const float* __restrict__ dout,
                             float* __restrict__ dmap, int H, int W, int C,
                             int64_t P) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int bn = blockIdx.y;
  const int64_t i = bn * P + p;
  const float x = px[i], y = py[i];
  const float x0 = floorf(x), y0 = floorf(y);
  const float tx = __fsub_rn(x, x0), ty = __fsub_rn(y, y0);
  float wx0, wx1, wy0, wy1;
  axis_weights(x0, tx, W, &wx0, &wx1);
  axis_weights(y0, ty, H, &wy0, &wy1);
  const int xa = (int)fminf(fmaxf(x0, 0.f), (float)(W - 1));
  const int xb = (int)fminf(fmaxf(__fadd_rn(x0, 1.f), 0.f), (float)(W - 1));
  const int ya = (int)fminf(fmaxf(y0, 0.f), (float)(H - 1));
  const int yb = (int)fminf(fmaxf(__fadd_rn(y0, 1.f), 0.f), (float)(H - 1));
  float* m = dmap + (int64_t)bn * H * W * C;
  float* taps[4] = {m + ((int64_t)ya * W + xa) * C,
                    m + ((int64_t)ya * W + xb) * C,
                    m + ((int64_t)yb * W + xa) * C,
                    m + ((int64_t)yb * W + xb) * C};
  const float wts[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1),
                        __fmul_rn(wy1, wx0), __fmul_rn(wy1, wx1)};
  const float* g = dout + i * C;
  float gv[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) gv[c] = c < C ? g[c] : 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (wts[k] == 0.f) continue;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) atomicAdd(taps[k] + c, wts[k] * gv[c]);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int point_sample_forward(const float* maps, const float* px, const float* py,
                         float* out, int BN, int H, int W, int C, int64_t P,
                         void* stream) {
  if (C <= 0 || C > kMaxC || BN > 65535) return (int)cudaErrorInvalidValue;
  if (BN > 0 && P > 0) {
    const dim3 blocks((unsigned)((P + kThreads - 1) / kThreads),
                      (unsigned)BN);
    point_sample_forward_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        maps, px, py, out, H, W, C, P);
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success).
int point_sample_backward(const float* px, const float* py, const float* dout,
                          float* dmap, int BN, int H, int W, int C, int64_t P,
                          void* stream) {
  if (C <= 0 || C > kMaxC || BN > 65535) return (int)cudaErrorInvalidValue;
  if (BN > 0 && P > 0) {
    const dim3 blocks((unsigned)((P + kThreads - 1) / kThreads),
                      (unsigned)BN);
    point_sample_backward_kernel<<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        px, py, dout, dmap, H, W, C, P);
  }
  return (int)cudaGetLastError();
}

const char* point_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
