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
// steps: within a chunk the forward's transmittance comes from a running
// sum that starts at the chunk's carried log T, and the median from the
// chunk's first crossing, so the forward and the plain version (which
// mirrors the Pallas chunks with tensor ops) differ only in the order of
// the sums inside a chunk.
//
// What bounds it on an H100: at flagship training shapes (1,408 tiles of
// 16 x 16 pixels, M = 512) the forward must read the 11 streams (31.7
// MB) and write rgb, med and logt (7.2 MB), ~12 us at 3.35 TB/s, and
// evaluate up to 185 M (pixel, Gaussian) pairs at ~25 operations each,
// exp and log1p among them on the special-function units (16 a clock per
// SM): bound by operations; the backward about twice that. Design: one
// block per tile, one thread per pixel (256).
// The block stages each chunk's 128 x 11 attributes in shared memory
// (one coalesced read of the tile's contiguous rows), and every thread
// walks them front to back with its pixel's running log T, RGB, median
// and `found` in registers. Dead slots (op == 0) are skipped by the whole
// block at once (the same slot for every thread). A block owns its tile,
// so no other block writes its slots.
//
// The backward issues instructions at the card's limit (on the recorded
// flagship streams every slot is live and 73% of the pairs are kept), so
// its design cuts instructions per (warp, Gaussian) step:
// - Reductions in rounds. Each thread forms its pixel's 10 contributions
//   to a Gaussian and stores them in shared memory: a round stages
//   kGroup Gaussians as kGroup x 10 rows of 256 pixels (10 stores per
//   thread and Gaussian, conflict-free). After a barrier, thread t <
//   kTasks sums segment t % 4 (64 pixels, 16 float4 loads into four
//   running sums) of row t / 4; the segments of a row start 17 float4s
//   apart and rows 68, so each quarter-warp's loads hit 8 different
//   bank groups. The 4 lanes of a row add their segment sums with two
//   shuffles, and the first writes the (tile, slot) gradient: every
//   output written once, every sum in a fixed order, no atomics, the
//   same bits on every run. (A warp shuffle sum of each of the 10 values
//   costs ~110 instructions per (warp, Gaussian); a round ~25.) Shared
//   memory (49.5 KB) and registers (<= 64) leave room for 4 blocks of
//   256 threads on an SM.
// - No exp or log1p per kept pair: the forward writes each pixel's
//   crossing slot (the Gaussian at which T first drops below 0.5, whose
//   depth is the median; -1 if none), and the backward puts the median's
//   gradient there, so it need not rebuild log T with the forward's
//   roundings; it carries T as the running product of (1 - alpha),
//   which differs from the plain version's exp of a sum of log1p only
//   in rounding.
// - One approximate reciprocal (one MUFU.RCP, ~1 ulp) instead of two
//   divisions: dalpha = <g, c> T - (behind + g_logt) / (1 - alpha),
//   1 - alpha in [0.01, 1].
// - No branch per pixel: a pixel that does not keep the pair takes
//   alpha 0, which makes all its terms 0 and leaves T as it was.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 256;            // threads per block = pixels per tile
constexpr int kChunk = 128;          // Gaussians per chunk
constexpr int kAttr = 11;            // mx my ca cb cc rad dep op cr cg cb_col
constexpr int kGrad = 10;            // every attribute but rad
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kMedianDefault = 15.0f;
constexpr float kMedBig = 1e30f;

// The backward's rounds (see the note at the top) and the blocks an SM
// its registers must leave room for.
constexpr int kBwdBlocksPerSM = 4;
constexpr int kGroup = 4;                // Gaussians staged per round
constexpr int kRows = kGroup * kGrad;    // staged rows, one per value
constexpr int kSeg = 64;                 // pixels per segment sum
constexpr int kSegs = kPix / kSeg;
constexpr int kSegStride = kSeg + 4;     // floats: 17 float4s
constexpr int kRowStride = kSegs * kSegStride;  // 68 float4s
constexpr int kTasks = kRows * kSegs;    // segment sums per round
constexpr int kQ = 12;                   // attributes padded to 3 float4s
constexpr int kBwdShared =
    (int)sizeof(float) * (kChunk * kQ + kRows * kRowStride);
static_assert(kChunk % kGroup == 0 && kTasks % 32 == 0 &&
              kTasks + kGroup <= kPix && kSegs == 4, "round layout");
static_assert(kSegStride % 8 == 4 && kRowStride % 32 == 16,
              "segments start in different banks");

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
  v.keep = (fabsf(v.dx) <= q[5]) & (fabsf(v.dy) <= q[5]) & (v.power <= 0.f) &
           (v.alpha >= kAlphaEps);
  return v;
}

// 1 / x to ~1 ulp for a normal x (one MUFU.RCP, no range handling).
__device__ __forceinline__ float fast_rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// attrs [NT, M, 11]; rgb [NT, 256, 3]; med, logt [NT, 256]; cross
// [NT, 256]: the slot of the Gaussian at which T first drops below 0.5
// (the median's), -1 if none.
__global__ void __launch_bounds__(kPix)
composite_forward_kernel(const float* __restrict__ attrs,
                         float* __restrict__ rgb, float* __restrict__ med,
                         float* __restrict__ logt, int* __restrict__ cross,
                         int T, int M, int n_tx, int tile_w) {
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
  int slot = -1;
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
      if (expf(__fadd_rn(log_t, cum)) < 0.5f) {
        mc = fminf(mc, q[6]);
        if (slot < 0) slot = k0 + j;
      }
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
  cross[o] = slot;
}

// tot_rgb, g_rgb [NT, 256, 3]; g_logt, g_med [NT, 256];
// dattrs [NT, M, 11] (every slot written; rad's column is 0).
// Dynamic shared memory: kBwdShared bytes.
__global__ void __launch_bounds__(kPix, kBwdBlocksPerSM)
composite_backward_kernel(const float* __restrict__ attrs,
                          const float* __restrict__ tot_rgb,
                          const float* __restrict__ g_rgb,
                          const float* __restrict__ g_logt,
                          const float* __restrict__ g_med,
                          const int* __restrict__ cross,
                          float* __restrict__ dattrs, int T, int M, int n_tx,
                          int tile_w) {
  extern __shared__ float4 smem[];
  float* s = reinterpret_cast<float*>(smem);   // [kChunk][kQ] attributes
  float* stage = s + kChunk * kQ;              // [kRows][kRowStride]
  const int64_t tg = blockIdx.x;
  const int t = (int)(tg % T);
  const int p = threadIdx.x;
  const int tile_h = kPix / tile_w;
  const float fx = (float)((t % n_tx) * tile_w + p % tile_w);
  const float fy = (float)((t / n_tx) * tile_h + p / tile_w);
  const float* a = attrs + tg * M * kAttr;
  float* da = dattrs + tg * M * kAttr;
  float* my_stage = stage + (p / kSeg) * kSegStride + p % kSeg;

  const int64_t o = tg * kPix + p;
  const float gr = g_rgb[o * 3 + 0], gg = g_rgb[o * 3 + 1],
              gb = g_rgb[o * 3 + 2];
  const float gl = g_logt[o], gm = g_med[o];
  const int cross_slot = cross[o];
  // <g, total rgb> of this pixel
  const float gt = gr * tot_rgb[o * 3 + 0] + gg * tot_rgb[o * 3 + 1] +
                   gb * tot_rgb[o * 3 + 2];

  // tr: T in front of the next Gaussian, the running product of
  // (1 - alpha) over the kept ones
  float gpre = 0.f, tr = 1.f;
  for (int k0 = 0; k0 < M; k0 += kChunk) {
    const int n = min(kChunk, M - k0);
    __syncthreads();
    for (int i = p; i < n * kAttr; i += kPix)
      s[(i / kAttr) * kQ + i % kAttr] = a[k0 * kAttr + i];
    __syncthreads();
    float gp = 0.f;
    for (int g0 = 0; g0 < n; g0 += kGroup) {
#pragma unroll 1
      for (int jg = 0; jg < kGroup; ++jg) {
        const int j = g0 + jg;
        float* st = my_stage + jg * kGrad * kRowStride;
        // a slot past the chunk's end or dead (op == 0) is the same for
        // the block: every pixel's contributions are 0
        if (j < n && s[j * kQ + 7] != 0.f) {
          const float4 q0 = smem[3 * j], q1 = smem[3 * j + 1],
                       q2 = smem[3 * j + 2];
          const float q[kAttr] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                                  q1.z, q1.w, q2.x, q2.y, q2.z};
          // without branches: a lane that does not keep the pair has
          // alpha 0, so w, dalpha and every term are 0 and T stays
          const Eval v = evaluate(q, fx, fy);
          const float alpha = v.keep ? v.alpha : 0.f;
          const float one_m = 1.f - alpha;
          const float t_here = tr;
          tr = t_here * one_m;
          const float w = alpha * t_here;
          const float gc = gr * q[8] + gg * q[9] + gb * q[10];
          gp += w * gc;
          const float behind = gt - (gpre + gp);
          float dalpha = gc * t_here - (behind + gl) * fast_rcp(one_m);
          if (!(v.keep && v.raw < kAlphaMax)) dalpha = 0.f;
          const float dpow = v.power < 0.f ? dalpha * q[7] * v.e : 0.f;
          st[0 * kRowStride] = dpow * (q[2] * v.dx + q[3] * v.dy);  // mx
          st[1 * kRowStride] = dpow * (q[4] * v.dy + q[3] * v.dx);  // my
          st[2 * kRowStride] = dpow * (-0.5f * v.dx * v.dx);        // ca
          st[3 * kRowStride] = dpow * (-v.dx * v.dy);               // cb
          st[4 * kRowStride] = dpow * (-0.5f * v.dy * v.dy);        // cc
          st[5 * kRowStride] = k0 + j == cross_slot ? gm : 0.f;     // dep
          st[6 * kRowStride] = dalpha * v.e;                        // op
          st[7 * kRowStride] = w * gr;                              // cr
          st[8 * kRowStride] = w * gg;                              // cg
          st[9 * kRowStride] = w * gb;                              // cb_col
        } else {
#pragma unroll
          for (int k = 0; k < kGrad; ++k) st[k * kRowStride] = 0.f;
        }
      }
      __syncthreads();
      // thread p < kTasks sums segment p % 4 of staged row p / 4; the 4
      // lanes of a row add their sums in a fixed order, and the first
      // writes the (tile, slot, attribute) gradient
      if (p < kTasks) {
        const float4* seg = reinterpret_cast<const float4*>(
            stage + (p / kSegs) * kRowStride + (p % kSegs) * kSegStride);
        float4 acc = seg[0];
#pragma unroll
        for (int i = 1; i < kSeg / 4; ++i) {
          const float4 x = seg[i];
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
        float sum = (acc.x + acc.y) + (acc.z + acc.w);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int j = g0 + p / (kSegs * kGrad), k = p / kSegs % kGrad;
        if (p % kSegs == 0 && j < n)
          da[(k0 + j) * kAttr + (k < 5 ? k : k + 1)] = sum;
      } else if (p < kTasks + kGroup && g0 + p - kTasks < n) {
        da[(k0 + g0 + p - kTasks) * kAttr + 5] = 0.f;   // rad
      }
      __syncthreads();
    }
    gpre += gp;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int composite_tiles_forward(const float* attrs, float* rgb, float* med,
                            float* logt, int* cross, int NT, int T, int M,
                            int n_tx, int tile_w, void* stream) {
  if (T <= 0 || n_tx <= 0 || tile_w <= 0 || kPix % tile_w)
    return (int)cudaErrorInvalidValue;
  if (NT > 0)
    composite_forward_kernel<<<NT, kPix, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        attrs, rgb, med, logt, cross, T, M, n_tx, tile_w);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success).
int composite_tiles_backward(const float* attrs, const float* tot_rgb,
                             const float* g_rgb, const float* g_logt,
                             const float* g_med, const int* cross,
                             float* dattrs, int NT, int T, int M, int n_tx,
                             int tile_w, void* stream) {
  if (T <= 0 || n_tx <= 0 || tile_w <= 0 || kPix % tile_w)
    return (int)cudaErrorInvalidValue;
  if (NT > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_backward_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdShared);
    if (e != cudaSuccess) return (int)e;
    composite_backward_kernel<<<NT, kPix, kBwdShared,
                                static_cast<cudaStream_t>(stream)>>>(
        attrs, tot_rgb, g_rgb, g_logt, g_med, cross, dattrs, T, M, n_tx,
        tile_w);
  }
  return (int)cudaGetLastError();
}

const char* composite_tiles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
