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
// Backward: one warp per point, its lanes over the channels: each lane
// adds w * g[cell, c] into dfeat (an atomic, many points share a pixel)
// and accumulates feat * g, which a warp shuffle reduces to the point's
// dw; dw is written once, so it is deterministic (its sum order is
// fixed), while dfeat's atomics make the order, and so the last bits,
// vary from run to run. dfeat must be zeroed by the caller. Its bound is
// the L2 atomic throughput (~40 M fp32 atomic adds at batch 2).

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
