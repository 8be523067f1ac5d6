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
// What bounds it on an H100: it must read px and py and the maps and
// write out. At flagship shapes that is ~20 MB at eval (6 cameras,
// 212,992 points each, 256 x 704 maps with C = 1) and ~96 MB in the
// training step (12 maps with C = 4: alpha and RGB, 34.6 MB of maps,
// 41 MB of output), 6 / 29 us at 3.35 TB/s; the arithmetic is ~20 flops
// per point: bound by bytes. Design: one thread per (camera, point), the
// camera from blockIdx.y (no 64-bit division per thread), coalesced px/py
// reads and output writes; the maps are small enough to stay in L2, so
// the scattered tap reads hit cache (points come in (height, BEV cell)
// order, so a warp's taps land in nearby pixels). The kernel is a
// template on C, so a point's channels are a fixed, unrolled set of loads
// and stores; for C = 4 with 16-byte aligned maps and output (the
// launcher checks both pointers) each tap is one 16-byte load and the
// output one 16-byte store, where the scalar form issues 16 loads and 4
// stores strided by 16 bytes. Offsets inside a map are 32-bit (the
// launcher rejects maps of 2^31 elements or more). The weights and the
// sum are computed in the plain version's order with separately rounded
// operations (no FMA contraction), so every specialisation gives the
// plain version's bits, and the in-image tests are done in float, so
// far-off points cannot overflow an integer index.
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

// A point's four taps: their pixel indices in the map (clamped; a clamped
// tap always weighs 0) and weights, in the plain version's order (x0,y0),
// (x0+1,y0), (x0,y0+1), (x0+1,y0+1).
struct Taps {
  int pix[4];
  float w[4];
};

__device__ __forceinline__ void axis_weights(float t0, float tt, int n,
                                             float* w0, float* w1) {
  const float in0 = (t0 >= 0.f && t0 <= (float)(n - 1)) ? 1.f : 0.f;
  const float t1 = __fadd_rn(t0, 1.f);
  const float in1 = (t1 >= 0.f && t1 <= (float)(n - 1)) ? 1.f : 0.f;
  *w0 = __fmul_rn(__fsub_rn(1.f, tt), in0);
  *w1 = __fmul_rn(tt, in1);
}

__device__ __forceinline__ Taps taps_of(float x, float y, int H, int W) {
  const float x0 = floorf(x), y0 = floorf(y);
  float wx0, wx1, wy0, wy1;
  axis_weights(x0, __fsub_rn(x, x0), W, &wx0, &wx1);
  axis_weights(y0, __fsub_rn(y, y0), H, &wy0, &wy1);
  const int xa = (int)fminf(fmaxf(x0, 0.f), (float)(W - 1));
  const int xb = (int)fminf(fmaxf(__fadd_rn(x0, 1.f), 0.f), (float)(W - 1));
  const int ya = (int)fminf(fmaxf(y0, 0.f), (float)(H - 1));
  const int yb = (int)fminf(fmaxf(__fadd_rn(y0, 1.f), 0.f), (float)(H - 1));
  Taps t;
  t.pix[0] = ya * W + xa;
  t.pix[1] = ya * W + xb;
  t.pix[2] = yb * W + xa;
  t.pix[3] = yb * W + xb;
  t.w[0] = __fmul_rn(wy0, wx0);
  t.w[1] = __fmul_rn(wy0, wx1);
  t.w[2] = __fmul_rn(wy1, wx0);
  t.w[3] = __fmul_rn(wy1, wx1);
  return t;
}

__device__ __forceinline__ float blend(const Taps& t, float a, float b,
                                       float c, float d) {
  float v = __fmul_rn(t.w[0], a);
  v = __fadd_rn(v, __fmul_rn(t.w[1], b));
  v = __fadd_rn(v, __fmul_rn(t.w[2], c));
  return __fadd_rn(v, __fmul_rn(t.w[3], d));
}

// maps [BN,H,W,C]; px/py [BN,P]; out [BN,P,C]. kVec (C == 4 only): maps
// and out are 16-byte aligned.
template <int C, bool kVec>
__global__ void __launch_bounds__(kThreads)
point_sample_forward_kernel(const float* __restrict__ maps,
                            const float* __restrict__ px,
                            const float* __restrict__ py,
                            float* __restrict__ out, int H, int W,
                            int64_t P) {
  static_assert(!kVec || C == 4, "the vector form takes C = 4");
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int bn = blockIdx.y;
  const float* m = maps + (int64_t)bn * H * W * C;
  const int64_t i = bn * P + p;
  const Taps t = taps_of(__ldg(px + i), __ldg(py + i), H, W);
  float* o = out + i * C;
  if constexpr (kVec) {
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4 a = __ldg(m4 + t.pix[0]), b = __ldg(m4 + t.pix[1]);
    const float4 c = __ldg(m4 + t.pix[2]), d = __ldg(m4 + t.pix[3]);
    *reinterpret_cast<float4*>(o) =
        make_float4(blend(t, a.x, b.x, c.x, d.x),
                    blend(t, a.y, b.y, c.y, d.y),
                    blend(t, a.z, b.z, c.z, d.z),
                    blend(t, a.w, b.w, c.w, d.w));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[c] = blend(t, __ldg(m + t.pix[0] * C + c),
                   __ldg(m + t.pix[1] * C + c),
                   __ldg(m + t.pix[2] * C + c),
                   __ldg(m + t.pix[3] * C + c));
  }
}

template <int C, bool kVec>
void launch_forward(const float* maps, const float* px, const float* py,
                    float* out, int BN, int H, int W, int64_t P,
                    cudaStream_t stream) {
  const dim3 blocks((unsigned)((P + kThreads - 1) / kThreads),
                    (unsigned)BN);
  point_sample_forward_kernel<C, kVec><<<blocks, kThreads, 0, stream>>>(
      maps, px, py, out, H, W, P);
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
  const Taps t = taps_of(px[i], py[i], H, W);
  float* m = dmap + (int64_t)bn * H * W * C;
  const float* g = dout + i * C;
  float gv[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) gv[c] = c < C ? g[c] : 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.w[k] == 0.f) continue;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) atomicAdd(m + t.pix[k] * C + c, t.w[k] * gv[c]);
  }
}

bool valid_shape(int BN, int H, int W, int C) {
  return C > 0 && C <= kMaxC && BN <= 65535 && H > 0 && W > 0 &&
         (int64_t)H * W * C <= INT32_MAX;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int point_sample_forward(const float* maps, const float* px, const float* py,
                         float* out, int BN, int H, int W, int C, int64_t P,
                         void* stream) {
  if (!valid_shape(BN, H, W, C)) return (int)cudaErrorInvalidValue;
  if (BN > 0 && P > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool aligned = ((uintptr_t)maps | (uintptr_t)out) % 16 == 0;
    switch (C) {
      case 1: launch_forward<1, false>(maps, px, py, out, BN, H, W, P, s);
              break;
      case 2: launch_forward<2, false>(maps, px, py, out, BN, H, W, P, s);
              break;
      case 3: launch_forward<3, false>(maps, px, py, out, BN, H, W, P, s);
              break;
      default:
        if (aligned)
          launch_forward<4, true>(maps, px, py, out, BN, H, W, P, s);
        else
          launch_forward<4, false>(maps, px, py, out, BN, H, W, P, s);
    }
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success).
int point_sample_backward(const float* px, const float* py, const float* dout,
                          float* dmap, int BN, int H, int W, int C, int64_t P,
                          void* stream) {
  if (!valid_shape(BN, H, W, C)) return (int)cudaErrorInvalidValue;
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
