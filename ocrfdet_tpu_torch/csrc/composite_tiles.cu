// Per-tile front-to-back alpha compositing of depth-sorted Gaussians,
// forward and backward (Hopper, sm_90a).
//
// Replaces: ocrfdet_tpu/ops/splat/render_pallas.py::composite_tiles, the
// Pallas kernels _fwd_kernel (forward) and _bwd_kernel (backward).
//
// Input: attrs [NT, M, 11] f32, for every tile (NT = samples x tiles) its
// M Gaussians in front-to-back order (dead slots have op == 0), with the
// attributes (mx, my, ca, cb, cc, rad, dep, op, cr, cg, cb_col). For a
// pixel at (x, y) of the tile and Gaussian i:
//   dx = x - mx, dy = y - my
//   power = -0.5 (ca dx dx + cc dy dy) - cb dx dy
//   alpha = min(op exp(min(power, 0)), 0.99), kept (else 0) where
//           |dx| <= rad, |dy| <= rad, power <= 0 and alpha >= 1/255
//   T_i = exp(sum_{j<i} log1p(-alpha_j)),  rgb = sum_i alpha_i T_i c_i
//   logt = sum_i log1p(-alpha_i);  med = dep of the first i with
//          T_{i+1} < 0.5 (15.0 if none).
// Backward (the 3DGS suffix trick, as the Pallas kernel): a second
// front-to-back walk rebuilds T_i and the prefix sum of <g, c_j alpha_j
// T_j>; what lies behind Gaussian i is (total - prefix), so
//   dalpha_i = <g, c_i> T_i - (<g, rgb> - prefix_i) / (1 - alpha_i)
//              - g_logt / (1 - alpha_i)       (0 where alpha was capped)
// and the chain rule through power gives dmx, dmy, dca, dcb, dcc and dop;
// dc = alpha T g; the median's gradient lands on the crossing Gaussian's
// dep; rad gets none. Every per-Gaussian gradient is a sum over the
// tile's pixels.
//
// The Gaussians are walked in chunks of 128, as the Pallas kernel's grid
// steps: within a chunk the transmittance comes from a running sum that
// starts at the chunk's carried log T, and the median from the chunk's
// first crossing, so the kernel and the plain version (which mirrors the
// Pallas chunks with tensor ops) differ only in the order of the sums
// inside a chunk.
//
// What bounds it on an H100: at flagship shapes (704 tiles of 16 x 16
// pixels, M = 512) the forward must read the 11 streams (15.9 MB) and
// write rgb, med and logt (1.4 MB), ~5 us at 3.35 TB/s, and evaluate up
// to 92 M (pixel, Gaussian) pairs at ~25 fp32 operations each (~2.3
// GFLOP, ~35 us at 67 TFLOP/s): bound by operations; the backward about
// twice that. Design: one block per tile, one thread per pixel (256).
// The block stages each chunk's 128 x 11 attributes in shared memory
// (one coalesced read of the tile's contiguous rows), and every thread
// walks them front to back with its pixel's running log T, RGB, median
// and `found` in registers. Dead slots (op == 0) are skipped by the whole
// block at once (the same slot for every thread). In the backward each
// thread forms its pixel's 10 contributions to a Gaussian; a warp
// shuffle sums them over the warp's 32 pixels (skipped when no lane of
// the warp contributes), lane 0 puts the warp's sums in shared memory,
// and after the chunk the block adds the 8 warps' sums and writes each
// (tile, slot) gradient once: no atomics, deterministic. A block owns its
// tile, so no other block writes its slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 256;            // threads per block = pixels per tile
constexpr int kWarps = kPix / 32;
constexpr int kChunk = 128;          // Gaussians per chunk
constexpr int kAttr = 11;            // mx my ca cb cc rad dep op cr cg cb_col
constexpr int kGrad = 10;            // every attribute but rad
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kMedianDefault = 15.0f;
constexpr float kMedBig = 1e30f;

// Products and sums are rounded separately (no FMA contraction), in the
// plain version's order, so that the keep and crossing tests decide as
// the plain version's separate tensor operations do.
struct Eval {
  float dx, dy, power, e, raw, alpha;
  bool keep;
};

__device__ __forceinline__ Eval evaluate(const float* q, float fx, float fy) {
  Eval v;
  v.dx = __fsub_rn(fx, q[0]);
  v.dy = __fsub_rn(fy, q[1]);
  const float a = __fmul_rn(__fmul_rn(q[2], v.dx), v.dx);
  const float c = __fmul_rn(__fmul_rn(q[4], v.dy), v.dy);
  const float b = __fmul_rn(__fmul_rn(q[3], v.dx), v.dy);
  v.power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(a, c)), b);
  v.e = expf(fminf(v.power, 0.f));
  v.raw = __fmul_rn(q[7], v.e);
  v.alpha = fminf(v.raw, kAlphaMax);
  v.keep = fabsf(v.dx) <= q[5] && fabsf(v.dy) <= q[5] && v.power <= 0.f &&
           v.alpha >= kAlphaEps;
  return v;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s /= 2) x += __shfl_down_sync(0xffffffffu, x, s);
  return x;
}

// attrs [NT, M, 11]; rgb [NT, 256, 3]; med, logt [NT, 256].
__global__ void __launch_bounds__(kPix)
composite_forward_kernel(const float* __restrict__ attrs,
                         float* __restrict__ rgb, float* __restrict__ med,
                         float* __restrict__ logt, int T, int M, int n_tx,
                         int tile_w) {
  __shared__ float s[kChunk * kAttr];
  const int64_t tg = blockIdx.x;
  const int t = (int)(tg % T);
  const int p = threadIdx.x;
  const int tile_h = kPix / tile_w;
  const float fx = (float)((t % n_tx) * tile_w + p % tile_w);
  const float fy = (float)((t / n_tx) * tile_h + p / tile_w);
  const float* a = attrs + tg * M * kAttr;

  float r = 0.f, g = 0.f, b = 0.f, log_t = 0.f, md = kMedianDefault;
  bool found = false;
  for (int k0 = 0; k0 < M; k0 += kChunk) {
    const int n = min(kChunk, M - k0);
    __syncthreads();
    for (int i = p; i < n * kAttr; i += kPix) s[i] = a[k0 * kAttr + i];
    __syncthreads();
    float cum = 0.f;          // inclusive sum of log1p(-alpha) in the chunk
    float mc = kMedBig;       // nearest crossing depth in the chunk
    for (int j = 0; j < n; ++j) {
      const float* q = s + j * kAttr;
      if (q[7] == 0.f) continue;  // dead slot: alpha 0 for every pixel
      const Eval v = evaluate(q, fx, fy);
      if (!v.keep) continue;
      const float t_here = expf(__fadd_rn(log_t, cum));
      cum = __fadd_rn(cum, log1pf(-v.alpha));
      const float w = __fmul_rn(v.alpha, t_here);
      r = __fadd_rn(r, __fmul_rn(w, q[8]));
      g = __fadd_rn(g, __fmul_rn(w, q[9]));
      b = __fadd_rn(b, __fmul_rn(w, q[10]));
      if (expf(__fadd_rn(log_t, cum)) < 0.5f) mc = fminf(mc, q[6]);
    }
    if (!found && mc < kMedBig) md = mc;
    found = found || mc < kMedBig;
    log_t = __fadd_rn(log_t, cum);
  }
  const int64_t o = tg * kPix + p;
  rgb[o * 3 + 0] = r;
  rgb[o * 3 + 1] = g;
  rgb[o * 3 + 2] = b;
  med[o] = md;
  logt[o] = log_t;
}

// tot_rgb, g_rgb [NT, 256, 3]; g_logt, g_med [NT, 256];
// dattrs [NT, M, 11] (every slot written; rad's column is 0).
__global__ void __launch_bounds__(kPix)
composite_backward_kernel(const float* __restrict__ attrs,
                          const float* __restrict__ tot_rgb,
                          const float* __restrict__ g_rgb,
                          const float* __restrict__ g_logt,
                          const float* __restrict__ g_med,
                          float* __restrict__ dattrs, int T, int M, int n_tx,
                          int tile_w) {
  __shared__ float s[kChunk * kAttr];
  __shared__ float part[kWarps][kChunk][kGrad];
  const int64_t tg = blockIdx.x;
  const int t = (int)(tg % T);
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int tile_h = kPix / tile_w;
  const float fx = (float)((t % n_tx) * tile_w + p % tile_w);
  const float fy = (float)((t / n_tx) * tile_h + p / tile_w);
  const float* a = attrs + tg * M * kAttr;
  float* da = dattrs + tg * M * kAttr;

  const int64_t o = tg * kPix + p;
  const float gr = g_rgb[o * 3 + 0], gg = g_rgb[o * 3 + 1],
              gb = g_rgb[o * 3 + 2];
  const float gl = g_logt[o], gm = g_med[o];
  // <g, total rgb> of this pixel
  const float gt = gr * tot_rgb[o * 3 + 0] + gg * tot_rgb[o * 3 + 1] +
                   gb * tot_rgb[o * 3 + 2];

  float log_t = 0.f, gpre = 0.f;
  for (int k0 = 0; k0 < M; k0 += kChunk) {
    const int n = min(kChunk, M - k0);
    __syncthreads();
    for (int i = p; i < n * kAttr; i += kPix) s[i] = a[k0 * kAttr + i];
    __syncthreads();
    float cum = 0.f, gp = 0.f;
    for (int j = 0; j < n; ++j) {
      const float* q = s + j * kAttr;
      if (q[7] == 0.f) {             // dead slot, the same for the block
        if (lane == 0)
          for (int k = 0; k < kGrad; ++k) part[warp][j][k] = 0.f;
        continue;
      }
      const Eval v = evaluate(q, fx, fy);
      float d[kGrad];
#pragma unroll
      for (int k = 0; k < kGrad; ++k) d[k] = 0.f;
      if (v.keep) {
        const float t_here = expf(log_t + cum);
        cum += log1pf(-v.alpha);
        const float w = v.alpha * t_here;
        const float gc = gr * q[8] + gg * q[9] + gb * q[10];
        gp += w * gc;
        const float suffix = gt - (gpre + gp);
        const float one_m = 1.f - v.alpha;
        float dalpha = gc * t_here - suffix / one_m - gl / one_m;
        if (!(v.raw < kAlphaMax)) dalpha = 0.f;
        const float dpow = v.power < 0.f ? dalpha * q[7] * v.e : 0.f;
        d[0] = dpow * (q[2] * v.dx + q[3] * v.dy);          // mx
        d[1] = dpow * (q[4] * v.dy + q[3] * v.dx);          // my
        d[2] = dpow * (-0.5f * v.dx * v.dx);                // ca
        d[3] = dpow * (-v.dx * v.dy);                       // cb
        d[4] = dpow * (-0.5f * v.dy * v.dy);                // cc
        const float t_after = expf(log_t + cum);
        d[5] = (t_here >= 0.5f && t_after < 0.5f) ? gm : 0.f;  // dep
        d[6] = dalpha * v.e;                                // op
        d[7] = w * gr;                                      // cr
        d[8] = w * gg;                                      // cg
        d[9] = w * gb;                                      // cb_col
      }
      if (__any_sync(0xffffffffu, v.keep)) {
#pragma unroll
        for (int k = 0; k < kGrad; ++k) d[k] = warp_sum(d[k]);
      }
      if (lane == 0)
        for (int k = 0; k < kGrad; ++k) part[warp][j][k] = d[k];
    }
    log_t += cum;
    gpre += gp;
    __syncthreads();
    for (int i = p; i < n * kAttr; i += kPix) {
      const int j = i / kAttr, k = i % kAttr;
      float sum = 0.f;
      if (k != 5) {
        const int slot = k < 5 ? k : k - 1;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[w][j][slot];
      }
      da[k0 * kAttr + i] = sum;
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int composite_tiles_forward(const float* attrs, float* rgb, float* med,
                            float* logt, int NT, int T, int M, int n_tx,
                            int tile_w, void* stream) {
  if (T <= 0 || n_tx <= 0 || tile_w <= 0 || kPix % tile_w)
    return (int)cudaErrorInvalidValue;
  if (NT > 0)
    composite_forward_kernel<<<NT, kPix, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        attrs, rgb, med, logt, T, M, n_tx, tile_w);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success).
int composite_tiles_backward(const float* attrs, const float* tot_rgb,
                             const float* g_rgb, const float* g_logt,
                             const float* g_med, float* dattrs, int NT, int T,
                             int M, int n_tx, int tile_w, void* stream) {
  if (T <= 0 || n_tx <= 0 || tile_w <= 0 || kPix % tile_w)
    return (int)cudaErrorInvalidValue;
  if (NT > 0)
    composite_backward_kernel<<<NT, kPix, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        attrs, tot_rgb, g_rgb, g_logt, g_med, dattrs, T, M, n_tx, tile_w);
  return (int)cudaGetLastError();
}

const char* composite_tiles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
