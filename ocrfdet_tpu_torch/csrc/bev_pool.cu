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
// Forward: sorted cell intervals, no atomics (bev_pool_v2's design). The
// caller (ops/bev_pool.py::cell_intervals) stable-sorts the points by the
// key b * (cells + 1) + cell (an invalid cell counts as `cells`, so those
// points come last in each sample) into `perm`, and gives each key's
// interval of sorted positions in `offsets`. At flagship shapes (498,432
// points a sample, 80 channels, 16,384 cells) the intervals are very
// uneven: 9,031 of the cells are hit, on average by 44 points, but the
// cells by the ego hold up to 5,152 points and the 250 cells above 256
// points hold over half of all points. One warp per cell would wait on
// those few long walks, so the sorted points are cut into chunks of
// kChunk positions, one warp each (pass 1). A warp walks its chunk in
// order, 32 points at a time (one coalesced read of perm, then w, pix and
// cell of each point), broadcasts each point to the lanes, which hold 4
// (or 1) channels each, and sums w * feat[pix] in registers while the key
// stays the same. A run of one key that is the key's whole interval is
// written straight to `out`; a run that continues into the chunk before
// or after goes to the chunk's scratch row: slot 0 for the run that
// touches the chunk's start, slot 1 for the run that touches its end.
// Pass 2, one warp per (b, cell), writes zeros for an empty cell and
// sums a cell that spans chunks from its chunks' scratch rows, in chunk
// order. Every output row is written once, so the caller allocates it
// without zeroing, and the sum order depends only on the sorted order:
// the same bits on every run.
// What bounds it on an H100: the compulsory traffic is ~12.6 MB (three
// 4-byte point streams, feat, out), ~4 us at 3.35 TB/s, and the kernel
// reads a 320-byte feat row per in-grid point (~128 MB a sample, served
// by L2: feat is 1.35 MB) through one dependent chain per 32 points
// (perm -> point streams -> feat rows), so L2 latency and bandwidth bound
// the two passes; the sort in cell_intervals costs more than both.
//
// Backward: pixel-stationary, no atomics, no zero fill, the same bits on
// every run. One warp owns one (b, pixel): it holds the pixel's feat row
// in registers (lanes over the channels: a float4 each where C % 4 == 0,
// else 4 channels 32 apart; blocks of 128 channels), walks the pixel's
// points in ascending p, 32 at a time (one point a lane), finds those
// whose cell lies in the grid with one __ballot_sync, gathers the g rows
// of up to kBwdBatch of them before it uses the first, and for each adds
// w * g into the pixel's dfeat row in registers (product and sum rounded
// on their own, as the plain version's weighted rows) and takes dw =
// <feat, g>: the batch's dot products are reduced together across the
// warp (a transposed butterfly, 9 shuffles for 8 points), and each sum
// goes back to the lane of its point. A point outside the grid gets dw =
// 0 and adds nothing. The warp writes its dfeat row once and every dw
// once. Which points belong to a pixel is named in one of two ways:
// - the LSS layout (the model's path, `lss_points`): every (b, camera n,
//   pixel hw) owns exactly the D points p = (n * D + d) * HW + hw, so
//   nothing is sorted and pix is not read. A block takes kPixQ = 8
//   consecutive pixels of one (b, n), a warp each, and lane j of a warp
//   reads w and cell of bin d0 + j itself: the block's 8 warps read the
//   same 32-byte sectors (8 neighbouring pixels), which L1 can serve
//   after the first. Staging [32 bins][8 pixels] tiles through shared
//   memory (one barrier a slab) was slower on an H100 at flagship
//   shapes: 0.0667 against 0.0642 ms;
// - any other pix stream: the caller sorts the points by pixel
//   (`cell_intervals(pix, npix)`, the forward's stable sort keyed by
//   pixel), and a warp walks perm[offsets[k]:offsets[k + 1]] of its key
//   k = b * (npix + 1) + pixel; the points whose pix lies outside [0,
//   npix) land in the last key of their sample, whose warp writes their
//   dw = 0.
// Both walk a pixel's points in ascending p with the same arithmetic, so
// on LSS streams they give the same bits. What bounds it: the compulsory
// traffic of the LSS path is ~28 MB at flagship shapes, batch 2 (w,
// cell, dw, feat, dfeat, g; pix is not read), ~8.3 us at 3.35 TB/s;
// each in-grid point (801 k of 997 k) gathers a 320-byte g row from L2,
// 256 MB, which sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr int kChunk = 128;   // sorted positions per pass-1 warp
constexpr int kUnroll = 8;    // feat rows in flight per lane
constexpr unsigned kFull = 0xffffffffu;

// VEC consecutive channels of a row: float4 or float.
template <int VEC> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  // acc + w * v, one rounding for the product and one for the sum, as
  // the plain version (a weighted row, then index_add_)
  __device__ static T axpy(T acc, float w, T v) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(w, v.x)),
                       __fadd_rn(acc.y, __fmul_rn(w, v.y)),
                       __fadd_rn(acc.z, __fmul_rn(w, v.z)),
                       __fadd_rn(acc.w, __fmul_rn(w, v.w)));
  }
  __device__ static T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};
template <> struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, T v) { *p = v; }
  __device__ static T axpy(T acc, float w, T v) {
    return __fadd_rn(acc, __fmul_rn(w, v));
  }
  __device__ static T add(T a, T b) { return a + b; }
};

// The sort key of point p (flat index b * P + p'), as cell_intervals
// computes it (the wrapper keeps B * P and B * (cells + 1) below 2^31).
__device__ __forceinline__ int key_of(const int* __restrict__ cell, int p,
                                      int P, int cells) {
  const int c = cell[p];
  return (p / P) * (cells + 1) + ((c >= 0 && c < cells) ? c : cells);
}

// Pass 1. w/pix/cell [B*P]; perm [B*P] (sorted position -> point);
// feat [B, npix, C]; out [B, cells, C]; part [chunks, 2, C].
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bev_pool_chunk_kernel(const float* __restrict__ w,
                      const int* __restrict__ pix,
                      const int* __restrict__ cell,
                      const int64_t* __restrict__ perm,
                      const float* __restrict__ feat,
                      float* __restrict__ out, float* __restrict__ part,
                      int P, int total, int npix, int C, int cells) {
  using V = Vec<VEC>;
  const int lane = threadIdx.x % kLanes;
  const int chunk = blockIdx.x * kWarps + threadIdx.x / kLanes;
  const int cs = chunk * kChunk;
  if (cs >= total) return;  // uniform across the warp
  const int ce = cs + kChunk < total ? cs + kChunk : total;
  const int K = cells + 1;
  // the keys just outside the chunk: does a run go on beyond it?
  const int key_before = cs > 0 ? key_of(cell, (int)perm[cs - 1], P, cells) : -1;
  const int key_after = ce < total ? key_of(cell, (int)perm[ce], P, cells) : -1;

  for (int c0 = 0; c0 < C; c0 += kLanes * VEC) {
    const int ch = c0 + lane * VEC;
    const bool active = ch < C;  // C % VEC == 0
    typename V::T acc = V::zero();
    int cur = -1;                // the key of the open run
    int rs = cs;                 // where it started

    // write the open run [rs, re) of key `cur`
    auto flush = [&](int re) {
      const int b = cur / K;
      const int c = cur - b * K;
      if (c == cells || !active) return;
      const bool before = rs == cs && key_before == cur;
      const bool after = re == ce && key_after == cur;
      float* dst = (before || after)
                       ? part + ((int64_t)chunk * 2 + (rs == cs ? 0 : 1)) * C
                       : out + ((int64_t)b * cells + c) * C;
      V::store(dst + ch, acc);
    };

    for (int base = cs; base < ce; base += kLanes) {
      const int n = ce - base < kLanes ? ce - base : kLanes;
      int key = -1;
      int64_t row = 0;
      float wv = 0.f;
      int use = 0;
      if (lane < n) {
        const int p = (int)perm[base + lane];
        const int b = p / P;
        const int c = cell[p];
        const bool vc = c >= 0 && c < cells;
        key = b * K + (vc ? c : cells);
        if (vc) {
          const int px = pix[p];
          if (px >= 0 && px < npix) {
            use = 1;
            wv = w[p];
            row = ((int64_t)b * npix + px) * C;
          }
        }
      }
      for (int j0 = 0; j0 < n; j0 += kUnroll) {
        typename V::T v[kUnroll];
        int kk[kUnroll];
        float ww[kUnroll];
        int uu[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u;  // < 32: j0 < n <= 32, j0 % kUnroll == 0
          kk[u] = __shfl_sync(kFull, key, j);
          ww[u] = __shfl_sync(kFull, wv, j);
          uu[u] = __shfl_sync(kFull, use, j);
          const int64_t r = __shfl_sync(kFull, row, j);
          v[u] = (j < n && uu[u] && active) ? V::load(feat + r + ch)
                                            : V::zero();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u < n) {
            if (kk[u] != cur) {
              if (cur >= 0) flush(base + j0 + u);
              cur = kk[u];
              rs = base + j0 + u;
              acc = V::zero();
            }
            if (uu[u]) acc = V::axpy(acc, ww[u], v[u]);
          }
        }
      }
    }
    flush(ce);
  }
}

// Pass 2: one warp per (b, cell). offsets [B*(cells+1) + 1].
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bev_pool_cells_kernel(const int* __restrict__ offsets,
                      const float* __restrict__ part,
                      float* __restrict__ out, int B, int C, int cells) {
  using V = Vec<VEC>;
  const int lane = threadIdx.x % kLanes;
  const int64_t q = (int64_t)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (q >= (int64_t)B * cells) return;
  const int64_t b = q / cells;
  const int64_t key = q + b;  // b * (cells + 1) + cell
  const int64_t start = offsets[key];
  const int64_t end = offsets[key + 1];
  const int64_t t0 = start / kChunk;
  const int64_t t1 = (end - 1) / kChunk;
  if (end > start && t0 == t1) return;  // pass 1 wrote it
  float* dst = out + q * C;
  for (int ch = lane * VEC; ch < C; ch += kLanes * VEC) {
    if (end == start) {
      V::store(dst + ch, V::zero());
      continue;
    }
    const int slot0 = start == t0 * kChunk ? 0 : 1;
    typename V::T acc = V::load(part + (t0 * 2 + slot0) * C + ch);
    int64_t t = t0 + 1;
    for (; t + 3 <= t1; t += 4) {
      const typename V::T a = V::load(part + (t * 2) * C + ch);
      const typename V::T b1 = V::load(part + ((t + 1) * 2) * C + ch);
      const typename V::T b2 = V::load(part + ((t + 2) * 2) * C + ch);
      const typename V::T b3 = V::load(part + ((t + 3) * 2) * C + ch);
      acc = V::add(V::add(V::add(V::add(acc, a), b1), b2), b3);
    }
    for (; t <= t1; ++t) acc = V::add(acc, V::load(part + (t * 2) * C + ch));
    V::store(dst + ch, acc);
  }
}

template <int VEC>
void launch_forward(const float* w, const int* pix, const int* cell,
                    const int64_t* perm, const int* offsets,
                    const float* feat, float* out, float* part, int B,
                    int64_t P, int npix, int C, int cells,
                    cudaStream_t stream) {
  const int64_t total = (int64_t)B * P;
  if (total > 0) {
    const int64_t chunks = (total + kChunk - 1) / kChunk;
    bev_pool_chunk_kernel<VEC><<<(unsigned)((chunks + kWarps - 1) / kWarps),
                                 kThreads, 0, stream>>>(
        w, pix, cell, perm, feat, out, part, (int)P, (int)total, npix, C,
        cells);
  }
  const int64_t rows = (int64_t)B * cells;
  if (rows > 0) {
    bev_pool_cells_kernel<VEC><<<(unsigned)((rows + kWarps - 1) / kWarps),
                                 kThreads, 0, stream>>>(offsets, part, out, B,
                                                        C, cells);
  }
}

constexpr int kPerLane = 4;    // channels a lane holds: blocks of 128
constexpr int kBwdBatch = 8;   // g rows a backward warp has in flight
constexpr int kPixQ = 8;       // pixels of an LSS backward block

// The kPerLane channels a lane holds of a row of C: with VEC = 4 the
// float4 at channel 4 * lane (C % 4 == 0, rows 16-byte aligned), with
// VEC = 1 the channels lane + 32 k. Channels past C read as 0.
template <int VEC>
__device__ __forceinline__ void load_lane(const float* __restrict__ row,
                                          int lane, int C, float x[4]) {
  if (VEC == 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * lane < C) v = __ldg(reinterpret_cast<const float4*>(row) + lane);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + k * kLanes;
      x[k] = c < C ? __ldg(row + c) : 0.f;
    }
  }
}
template <int VEC>
__device__ __forceinline__ void store_lane(float* __restrict__ row, int lane,
                                           int C, const float x[4]) {
  if (VEC == 4) {
    if (4 * lane < C)
      reinterpret_cast<float4*>(row)[lane] = make_float4(x[0], x[1], x[2],
                                                         x[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + k * kLanes;
      if (c < C) row[c] = x[k];
    }
  }
}

// The warp's sums of 8 values at once: lane l returns the sum over the
// 32 lanes of v[(l >> 2) & 7]. Each step halves the values a lane holds
// (16, 8, 4 lanes apart), then two steps finish the sum; every value
// meets the same tree of additions, whatever its slot.
__device__ __forceinline__ float warp_sum8(float v[8]) {
  const int lane = threadIdx.x % kLanes;
#pragma unroll
  for (int h = 4; h >= 1; h /= 2) {
    const bool hi = lane & (4 * h);  // lane bit 4, 3, 2
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = hi ? v[i] : v[i + h];
      const float keep = hi ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, 4 * h);
    }
  }
  v[0] += __shfl_xor_sync(kFull, v[0], 2);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
  return v[0];
}

// One step of a pixel's walk: lane j holds one point (in ascending p
// over the lanes), in the grid if `valid`, with weight wl and g row
// `grow` (rows of C, channels from `g`'s first). Adds w * g[grow] to the
// lane's dfeat channels `acc` point after point and returns lane j's
// <f, g[grow]> over the block's channels (0 if not valid).
template <int VEC>
__device__ __forceinline__ float walk(bool valid, float wl, int grow,
                                      const float* __restrict__ g, int C,
                                      int Cb, int lane, const float f[4],
                                      float acc[4]) {
  unsigned mask = __ballot_sync(kFull, valid);
  float mine = 0.f;
  while (mask) {
    int src[kBwdBatch];
    float x[kBwdBatch][kPerLane];
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {
      src[u] = mask ? __ffs(mask) - 1 : -1;
      mask &= mask - 1;
      const int r = __shfl_sync(kFull, grow, src[u] & (kLanes - 1));
      if (src[u] >= 0) {
        load_lane<VEC>(g + (int64_t)r * C, lane, Cb, x[u]);
      } else {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) x[u][k] = 0.f;
      }
    }
    float part[kBwdBatch];
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {
      const float w = __shfl_sync(kFull, wl, src[u] & (kLanes - 1));
      part[u] = 0.f;
      if (src[u] >= 0) {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(w, x[u][k]));
        part[u] = fmaf(f[3], x[u][3], fmaf(f[2], x[u][2],
                       fmaf(f[1], x[u][1], f[0] * x[u][0])));
      }
    }
    const float s = warp_sum8(part);
    int slot = -1;  // the batch slot of this lane's point
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u)
      if (src[u] == lane) slot = u;
    const float got = __shfl_sync(kFull, s, 4 * max(slot, 0));
    if (slot >= 0) mine = got;
  }
  return mine;
}

// The LSS layout: w/cell/dw [B, N*D*HW] with point (n, d, hw) at (n * D
// + d) * HW + hw and pixel n * HW + hw; feat/dfeat [B, N*HW, C]; g [B,
// cells, C]. A block: kPixQ pixels of one (b, n), a warp each; lane j
// takes bin d0 + j of a slab of 32 bins, the next slab's w and cell
// loaded while this one is walked.
template <int VEC>
__global__ void __launch_bounds__(kPixQ * kLanes)
bev_pool_backward_lss_kernel(const float* __restrict__ w,
                             const int* __restrict__ cell,
                             const float* __restrict__ feat,
                             const float* __restrict__ g,
                             float* __restrict__ dfeat,
                             float* __restrict__ dw, int N, int D, int HW,
                             int C, int cells) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int tiles = (HW + kPixQ - 1) / kPixQ;
  const int bn = blockIdx.x / tiles;  // b * N + n
  const int hw0 = (blockIdx.x - bn * tiles) * kPixQ;
  const int b = bn / N;
  // point d of this warp's pixel at base + d * HW
  const int64_t base = (int64_t)bn * D * HW + hw0 + warp;
  if (hw0 + warp >= HW) return;  // uniform across the warp
  const int64_t frow = ((int64_t)bn * HW + hw0 + warp) * C;
  for (int c0 = 0; c0 < C; c0 += kPerLane * kLanes) {
    const int Cb = min(C - c0, kPerLane * kLanes);
    float f[kPerLane], acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) f[k] = acc[k] = 0.f;
    load_lane<VEC>(feat + frow + c0, lane, Cb, f);
    float wn = 0.f;
    int cn = -1;
    if (lane < D) {
      wn = __ldg(w + base + (int64_t)lane * HW);
      cn = __ldg(cell + base + (int64_t)lane * HW);
    }
    for (int d0 = 0; d0 < D; d0 += kLanes) {
      const float wl = wn;
      const int c = cn;
      const int d = d0 + lane;
      if (d + kLanes < D) {
        wn = __ldg(w + base + (int64_t)(d + kLanes) * HW);
        cn = __ldg(cell + base + (int64_t)(d + kLanes) * HW);
      }
      const bool valid = d < D && c >= 0 && c < cells;
      float part = walk<VEC>(valid, wl, b * cells + c, g + c0, C, Cb, lane,
                             f, acc);
      if (d < D) {
        float* o = dw + base + (int64_t)d * HW;
        *o = c0 > 0 ? *o + part : part;
      }
    }
    store_lane<VEC>(dfeat + frow + c0, lane, Cb, acc);
  }
}

// Any pix stream: w/cell/dw [B*P]; perm/offsets = cell_intervals(pix,
// npix) (key b * (npix + 1) + pixel, pix outside [0, npix) as npix);
// feat/dfeat [B, npix, C]; g [B, cells, C]. One warp a key.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bev_pool_backward_sorted_kernel(const float* __restrict__ w,
                                const int* __restrict__ cell,
                                const int64_t* __restrict__ perm,
                                const int* __restrict__ offsets,
                                const float* __restrict__ feat,
                                const float* __restrict__ g,
                                float* __restrict__ dfeat,
                                float* __restrict__ dw, int B, int npix,
                                int C, int cells) {
  const int lane = threadIdx.x % kLanes;
  const int64_t k = (int64_t)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (k >= (int64_t)B * (npix + 1)) return;  // uniform across the warp
  const int b = (int)(k / (npix + 1));
  const int px = (int)(k - (int64_t)b * (npix + 1));
  const bool in = px < npix;  // the last key holds the pixels past npix
  const int start = offsets[k], end = offsets[k + 1];
  const int64_t frow = ((int64_t)b * npix + px) * C;
  for (int c0 = 0; c0 < C; c0 += kPerLane * kLanes) {
    const int Cb = min(C - c0, kPerLane * kLanes);
    float f[kPerLane], acc[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) f[i] = acc[i] = 0.f;
    if (in) load_lane<VEC>(feat + frow + c0, lane, Cb, f);
    for (int s = start; s < end; s += kLanes) {
      const int j = s + lane;
      int64_t p = 0;
      int c = -1;
      float wl = 0.f;
      if (j < end) {
        p = perm[j];
        c = cell[p];
        if (in && c >= 0 && c < cells) wl = w[p];
      }
      const bool valid = j < end && in && c >= 0 && c < cells;
      float part = walk<VEC>(valid, wl, b * cells + c, g + c0, C, Cb, lane,
                             f, acc);
      if (j < end) dw[p] = c0 > 0 ? dw[p] + part : part;
    }
    if (in) store_lane<VEC>(dfeat + frow + c0, lane, Cb, acc);
  }
}

}  // namespace

extern "C" {

// The sorted positions each pass-1 warp pools (the caller sizes the
// forward's scratch by it).
int bev_pool_forward_chunk(void) { return kChunk; }

// Both passes of the forward, on one stream. perm [B*P] int64 and
// offsets [B*(cells+1) + 1] int32 come from cell_intervals; part is
// scratch of part_chunks x [2, C] floats, part_chunks >= ceil(B*P /
// kChunk); out [B, cells, C] needs no zeroing. Returns cudaGetLastError()
// after the launches (0 on success), cudaErrorInvalidValue if the scratch
// is too small.
int bev_pool_forward(const float* w, const int* pix, const int* cell,
                     const int64_t* perm, const int* offsets,
                     const float* feat, float* out, float* part,
                     int64_t part_chunks, int B, int64_t P, int npix, int C,
                     int cells, void* stream) {
  if (part_chunks < ((int64_t)B * P + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      C % 4 == 0 && ((reinterpret_cast<uintptr_t>(feat) |
                      reinterpret_cast<uintptr_t>(out) |
                      reinterpret_cast<uintptr_t>(part)) % 16) == 0;
  if (vec4)
    launch_forward<4>(w, pix, cell, perm, offsets, feat, out, part, B, P,
                      npix, C, cells, s);
  else
    launch_forward<1>(w, pix, cell, perm, offsets, feat, out, part, B, P,
                      npix, C, cells, s);
  return (int)cudaGetLastError();
}

// The backward: dw [B*P] and dfeat [B, npix, C], every value written
// (no zeroing). With perm == NULL the points are in the LSS layout (N, D,
// HW): P = N * D * HW, npix = N * HW, and pix is not read; else perm
// [B*P] int64 and offsets [B*(npix+1) + 1] int32 are cell_intervals(pix,
// npix). Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a layout that does not match P and npix.
int bev_pool_backward(const float* w, const int* cell, const int64_t* perm,
                      const int* offsets, const float* feat, const float* g,
                      float* dfeat, float* dw, int B, int64_t P, int npix,
                      int C, int cells, int N, int D, int HW, void* stream) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(feat) |
                                    reinterpret_cast<uintptr_t>(g) |
                                    reinterpret_cast<uintptr_t>(dfeat)) %
                                   16) == 0;
  if (perm == nullptr) {
    if (N <= 0 || D <= 0 || HW <= 0 || (int64_t)N * D * HW != P ||
        (int64_t)N * HW != npix)
      return (int)cudaErrorInvalidValue;
    const int64_t blocks = (int64_t)B * N * ((HW + kPixQ - 1) / kPixQ);
    if (blocks > 0) {
      auto kernel = vec4 ? bev_pool_backward_lss_kernel<4>
                         : bev_pool_backward_lss_kernel<1>;
      kernel<<<(unsigned)blocks, kPixQ * kLanes, 0, s>>>(
          w, cell, feat, g, dfeat, dw, N, D, HW, C, cells);
    }
  } else {
    const int64_t keys = (int64_t)B * (npix + 1);
    if (keys > 0) {
      auto kernel = vec4 ? bev_pool_backward_sorted_kernel<4>
                         : bev_pool_backward_sorted_kernel<1>;
      kernel<<<(unsigned)((keys + kWarps - 1) / kWarps), kThreads, 0, s>>>(
          w, cell, perm, offsets, feat, g, dfeat, dw, B, npix, C, cells);
    }
  }
  return (int)cudaGetLastError();
}

const char* bev_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
