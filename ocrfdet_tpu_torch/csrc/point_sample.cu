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
// Backward: dmap[bn, v, u, c] = sum over the points p with a tap at (u, v)
// of w_tap(p) dout[bn, p, c], w_tap the forward's weight of that tap; a
// tap of weight 0 adds nothing; px and py get no gradient (as the Pallas
// VJP). Every value of dmap is written once, by the one block that owns
// its 16 x 16 output tile, summed in a fixed order: no float atomics, no
// zero fill, the same bits on every run.
//
// What bounds it on an H100: at flagship training shapes (12 maps of 256
// x 704 x 4, 212,992 points each) only ~16% of the points have a tap in
// the image. The function must read px and py (20.4 MB), the dout rows of
// those points (6.5 MB in 32-byte sectors) and write dmap once (34.6 MB):
// ~61.5 MB, ~18 us at 3.35 TB/s; bound by bytes. The first design (a
// thread a point, scalar float atomics into a zeroed dmap) spent its time
// on ~6.5 M scattered atomics and on threads that had nothing to add.
//
// Design: three kernels and a memset, in two entry points.
//  1. point_sample_order (count, place): a point whose base tap (x0, y0)
//     = (floor(px), floor(py)) lies in [-1, W-1] x [-1, H-1] has a tap in
//     the image; the others are never looked at again. Such a point goes
//     into the bin of every output tile one of its taps falls in: its
//     base tap's tile (x0 = -1 counts as column 0), and the next tile
//     column or row where its second tap crosses into it (1/16 of the
//     points each way; 455,516 keys for the flagship's 409,096 points). A
//     bin is (camera, tile row, tile column). The count kernel counts
//     each bin's points (the lanes of a warp that hit one bin share one
//     integer atomic); each camera's last block to finish scans the
//     camera's counts into its bins' spans, camera bn's within [bn 4P,
//     (bn + 1) 4P) of `placed` (a point lies in at most 4 tiles), so no
//     scan crosses cameras. The place kernel writes each point's key into
//     its bins, in no fixed order (integer atomics again). A key is (code
//     << 32) | p, code = the base tap's place in the tile's 17 x 17 frame,
//     which holds the halo row and column of base taps above and left of
//     the tile.
//  2. point_sample_backward (accumulate): a block of 256 threads per bin,
//     a thread a texel. It takes the bin's keys in chunks of kChunk and
//     orders each chunk by (base tap, point) in shared memory: integer
//     atomics count each base tap's points, a block scan turns the counts
//     into each base tap's run, each point writes itself into its run,
//     and its place there is the number of the run's points of lower
//     index. So the order does not depend on the order the place kernel
//     wrote. At its place a point stages its four contributions w_tap *
//     dout (w_tap recomputed by taps_of, the forward's own rounding; +0
//     where w_tap is 0). Each thread then adds, in registers, the runs
//     that reach its texel in the order base (v-1, u-1), (v-1, u), (v,
//     u-1), (v, u), each by point, each product and each sum rounded on
//     its own, and writes its texel once (for C = 4 one 16-byte store; a
//     tile row is 256 contiguous bytes), zeros where no point reaches it.
//     A bin of more than kChunk keys (adversarial inputs: every point of
//     a camera on one pixel; the flagship's largest holds 322) is first
//     sorted in place in global memory by the block (a bitonic network,
//     O(n log^2 n) passes); its chunks then follow the sorted order, so a
//     texel's sum runs in the same order however the bin is chunked.
// The plain walk in ops/point_sample.py adds in the same order and gives
// the same bits. A point with a non-finite coordinate has no tap in the
// image and adds nothing. On the flagship inputs (batch 2, C = 4, NVIDIA
// H100) the accumulate takes about half the time, the count and place
// kernels a quarter and a fifth: the count and the place pay for their
// integer atomics, the accumulate for the chain of phases of its 8,448
// blocks (loads, five barriers, the walk), not for bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

constexpr int kTile = 16;                    // texels a side of a tile
constexpr int kHalo = kTile + 1;             // base taps a side, with halo
constexpr int kCodes = kHalo * kHalo;
constexpr int kTileThreads = kTile * kTile;  // a thread a texel
constexpr int kChunk = 512;                  // points a block stages at once
constexpr int kPer = kChunk / kTileThreads;  // ... a thread
constexpr int kScanWarps = (kCodes + 63) / 64;  // warps scanning codes
static_assert(kScanWarps <= 8, "the code scan's warps");
constexpr int kBinThreads = 256;             // count and place blocks
constexpr int kCountUnroll = 8;              // points a counting thread takes
constexpr int kPlaceUnroll = 2;              // ... a placing thread
constexpr int kScanPer = 4;                  // counts a scanning thread adds
constexpr unsigned kFull = 0xffffffffu;

// The tiles of its camera a point's taps fall in (ty * ntx + tx; -1:
// none) and the point's base tap code in each (see the note at the top).
struct Dests {
  int tile[4];
  unsigned code[4];
};

__device__ __forceinline__ Dests no_dests() {
  Dests d;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d.tile[k] = -1;
    d.code[k] = 0;
  }
  return d;
}

__device__ __forceinline__ Dests dests_of(float x, float y, int H, int W,
                                          int ntx) {
  Dests d = no_dests();
  const float fx = floorf(x), fy = floorf(y);
  if (!(fx >= -1.f && fx <= (float)(W - 1) && fy >= -1.f &&
        fy <= (float)(H - 1)))
    return d;                                  // no tap in the image
  const int x0 = (int)fx, y0 = (int)fy;
  const int tx = max(x0, 0) / kTile, ty = max(y0, 0) / kTile;
  const bool right = x0 >= 0 && x0 + 1 <= W - 1 && (x0 + 1) % kTile == 0;
  const bool down = y0 >= 0 && y0 + 1 <= H - 1 && (y0 + 1) % kTile == 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dx = k & 1, dy = k >> 1;
    if ((dx && !right) || (dy && !down)) continue;
    d.tile[k] = (ty + dy) * ntx + tx + dx;
    const int by = y0 - ((ty + dy) * kTile - 1);
    const int bx = x0 - ((tx + dx) * kTile - 1);
    d.code[k] = (unsigned)(by * kHalo + bx);
  }
  return d;
}

// The U points a binning thread takes of its block's range (one camera,
// U * kBinThreads consecutive points, kBinThreads apart), all loads
// issued before any is used.
template <int U>
__device__ __forceinline__ void load_points(const float* __restrict__ px,
                                            const float* __restrict__ py,
                                            int bn, int64_t P, float* x,
                                            float* y) {
#pragma unroll
  for (int r = 0; r < U; ++r) {
    const int64_t p = ((int64_t)blockIdx.x * U + r) * kBinThreads +
                      threadIdx.x;
    x[r] = p < P ? __ldg(px + bn * P + p) : 0.f;
    y[r] = p < P ? __ldg(py + bn * P + p) : 0.f;
  }
}

// Adds the block's points to cnt[tile] (the camera's counts): the lanes
// of a warp that hit one tile share one atomic. With `slot`, also writes
// each point's key at slot[tile] + its place among the tile's points
// (the atomics return it).
template <int U>
__device__ __forceinline__ void bin_points(const float* x, const float* y,
                                           int64_t P, int H, int W, int ntx,
                                           int* cnt, const long long* slot,
                                           unsigned long long* placed) {
  const unsigned lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < U; ++r) {
    const int64_t p = ((int64_t)blockIdx.x * U + r) * kBinThreads +
                      threadIdx.x;
    const Dests d = p < P ? dests_of(x[r], y[r], H, W, ntx) : no_dests();
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = d.tile[k];
      if (!__any_sync(kFull, b >= 0)) continue;
      const unsigned mask = __match_any_sync(kFull, b);
      if (b < 0) continue;
      const int rank = __popc(mask & ((1u << lane) - 1u));
      if (!slot) {
        if (rank == 0) atomicAdd(cnt + b, __popc(mask));
        continue;
      }
      int base = 0;
      if (rank == 0) base = atomicAdd(cnt + b, __popc(mask));
      base = __shfl_sync(mask, base, __ffs(mask) - 1);
      placed[slot[b] + base + rank] =
          ((unsigned long long)d.code[k] << 32) | (unsigned long long)p;
    }
  }
}

// A camera's bins, by one block of kBinThreads: starts[b] = base +
// counts[0] + ... + counts[b - 1], ends[b] = starts[b] + counts[b], for
// b < tiles, kScanPer consecutive counts a thread (read from L2, where
// the other blocks' atomics wrote them; then set back to 0).
__device__ void scan_camera(int* counts, long long* starts, long long* ends,
                            int tiles, long long base) {
  __shared__ long long warp_sums[kBinThreads / 32];
  __shared__ long long round_total;
  constexpr int kWarps = kBinThreads / 32, kRound = kBinThreads * kScanPer;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  long long carry = base;
  for (int b0 = 0; b0 < tiles; b0 += kRound) {
    const int b = b0 + tid * kScanPer;
    int x[kScanPer];
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      x[i] = b + i < tiles ? __ldcg(counts + b + i) : 0;
      sum += x[i];
    }
    long long incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const long long y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sums[w] = incl;
    __syncthreads();
    if (w == 0) {
      const long long v = lane < kWarps ? warp_sums[lane] : 0;
      long long y = v;
#pragma unroll
      for (int d = 1; d < kWarps; d *= 2) {
        const long long u = __shfl_up_sync(kFull, y, d);
        if (lane >= d) y += u;
      }
      if (lane < kWarps) warp_sums[lane] = y - v;   // the warps before
    }
    __syncthreads();
    long long run = carry + warp_sums[w] + incl - sum;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      if (b + i >= tiles) break;
      starts[b + i] = run;
      run += x[i];
      ends[b + i] = run;
      counts[b + i] = 0;
    }
    if (tid == kBinThreads - 1) round_total = run;
    __syncthreads();
    carry = round_total;
  }
}

// counts [nbins + BN] (zeroed; the last BN are the cameras' tickets): the
// points of every bin. Grid (ceil(P / (kCountUnroll kBinThreads)), BN);
// the camera's last block to finish writes its bins' spans (starts, ends
// [nbins]: camera bn's keys go to placed[bn 4P, (bn + 1) 4P)) and sets
// their counts back to 0. Every lane of a warp reaches the warp
// intrinsics.
__global__ void __launch_bounds__(kBinThreads)
point_sample_count_kernel(const float* __restrict__ px,
                          const float* __restrict__ py, int* counts,
                          long long* __restrict__ starts,
                          long long* __restrict__ ends, int H, int W,
                          int nty, int ntx, int64_t P, long long nbins) {
  __shared__ bool last;
  const int bn = blockIdx.y, tiles = nty * ntx;
  const long long first = (long long)bn * tiles;
  float x[kCountUnroll], y[kCountUnroll];
  load_points<kCountUnroll>(px, py, bn, P, x, y);
  bin_points<kCountUnroll>(x, y, P, H, W, ntx, counts + first, nullptr,
                           nullptr);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned*>(counts + nbins + bn), 1u) ==
           gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    scan_camera(counts + first, starts + first, ends + first, tiles,
                4 * P * bn);
  }
}

// Writes every point's key into its bins' spans of `placed`, in no fixed
// order: each warp takes its slots of a bin with one atomic on its count
// (which the count kernel left at 0). Grid (ceil(P / (kPlaceUnroll
// kBinThreads)), BN).
__global__ void __launch_bounds__(kBinThreads)
point_sample_place_kernel(const float* __restrict__ px,
                          const float* __restrict__ py,
                          const long long* __restrict__ starts, int* counts,
                          unsigned long long* __restrict__ placed, int H,
                          int W, int nty, int ntx, int64_t P) {
  const int bn = blockIdx.y;
  const long long first = (long long)bn * nty * ntx;
  float x[kPlaceUnroll], y[kPlaceUnroll];
  load_points<kPlaceUnroll>(px, py, bn, P, x, y);
  bin_points<kPlaceUnroll>(x, y, P, H, W, ntx, counts + first,
                           starts + first, placed);
}

// Sorts s[0, n) ascending by a bitonic network whose comparators all put
// the smaller key at the lower index (each merge starts by comparing
// mirrored positions), padded to a power of two with virtual maxima: a
// comparator that reaches past n would keep its lower key in place, so it
// is skipped. Called by every thread of the block; only this block
// touches s[0, n).
__device__ void sort_keys(unsigned long long* s, long long n) {
  long long n2 = 1;
  while (n2 < n) n2 *= 2;
  for (long long k = 2; k <= n2; k *= 2) {
    for (long long j = k / 2, lj = __ffsll(j) - 1; j > 0; j /= 2, --lj) {
      for (long long i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        // the i-th pair (a, a + j) whose lower index has bit lj clear
        const long long a = ((i >> lj) << (lj + 1)) | (i & (j - 1));
        const long long b = j == k / 2 ? a ^ (k - 1) : a + j;
        if (b >= n) continue;
        const unsigned long long x = s[a], y = s[b];
        if (x > y) {
          s[a] = y;
          s[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

// One block per bin (camera bn, tile ty, tx), a thread a texel. starts,
// ends, placed from point_sample_order (a bin of more than kChunk keys
// is sorted here, in place). dout [BN,P,C]; writes every value of dmap
// [BN,H,W,C]. kVec (C == 4 only): dout and dmap are 16-byte aligned.
template <int C, bool kVec>
__global__ void __launch_bounds__(kTileThreads)
point_sample_backward_kernel(const float* __restrict__ px,
                             const float* __restrict__ py,
                             const float* __restrict__ dout,
                             const long long* __restrict__ starts,
                             const long long* __restrict__ ends,
                             unsigned long long* placed,
                             float* __restrict__ dmap, int H, int W,
                             int nty, int ntx, int64_t P) {
  static_assert(!kVec || C == 4, "the vector form takes C = 4");
  // each staged point's four contributions w_tap * dout (+0 where w_tap
  // is 0, which leaves a sum unchanged: a sum from +0 is never -0)
  __shared__ __align__(16) float s_add[kChunk][4][4];
  __shared__ unsigned s_pt[kChunk];           // points, by base tap
  __shared__ int s_cnt[kCodes];               // points of each base tap
  __shared__ int s_lo[kCodes], s_hi[kCodes];  // each base tap's run
  __shared__ int s_wsum[8];                   // the scan's warp totals
  const long long bin = blockIdx.x;
  const int tiles = nty * ntx;
  const int bn = (int)(bin / tiles);
  const int rem = (int)(bin - (long long)bn * tiles);
  const int ty = rem / ntx, tx = rem - ty * ntx;
  const int t = threadIdx.x, lv = t / kTile, lu = t % kTile;
  const int v = ty * kTile + lv, u = tx * kTile + lu;
  const long long start = starts[bin];
  const long long n = ends[bin] - start;
  unsigned long long* seg = placed + start;
  const float* pxb = px + (int64_t)bn * P;
  const float* pyb = py + (int64_t)bn * P;
  const float* db = dout + (int64_t)bn * P * C;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  // the runs that reach texel (v, u), in summation order: base (v-1,
  // u-1) by its tap 3, (v-1, u) by tap 2, (v, u-1) by tap 1, (v, u) by
  // tap 0; their codes in the 17 x 17 frame
  const int code = lv * kHalo + lu;
  // a bin of more than kChunk points is sorted in global memory first;
  // its chunks then arrive sorted
  if (n > kChunk) sort_keys(seg, n);
  for (int i = t; i < kCodes; i += kTileThreads) s_cnt[i] = 0;
  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    const int m = (int)min((long long)kChunk, n - c0);
    // each thread takes kPer of the chunk's keys and gathers their px,
    // py and dout row, held in registers until their places are known
    unsigned pt[kPer];
    int kc[kPer], slot[kPer];
    float xv[kPer], yv[kPer], dv[kPer][C];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = t + e * kTileThreads;
      const unsigned long long key = i < m ? seg[c0 + i] : 0ull;
      pt[e] = (unsigned)key;
      kc[e] = (int)(key >> 32);
    }
    __syncthreads();                 // s_cnt zeroed, the last walk done
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (t + e * kTileThreads >= m) continue;
      const unsigned p = pt[e];
      xv[e] = __ldg(pxb + p);
      yv[e] = __ldg(pyb + p);
      if constexpr (kVec) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(db) + p);
        dv[e][0] = g.x; dv[e][1] = g.y; dv[e][2] = g.z; dv[e][3] = g.w;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) dv[e][c] = __ldg(db + (int64_t)p * C + c);
      }
      slot[e] = atomicAdd(s_cnt + kc[e], 1);       // integer, shared
    }
    __syncthreads();
    // each base tap's run [lo, hi) in the chunk, in code order: a block
    // scan of the counts, two codes a thread; the counts back to 0
    {
      const int i0 = 2 * t;
      const int c0 = i0 < kCodes ? s_cnt[i0] : 0;
      const int c1 = i0 + 1 < kCodes ? s_cnt[i0 + 1] : 0;
      const int sum = c0 + c1;
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if ((t & 31) >= d) incl += y;
      }
      if ((t & 31) == 31 && t < 32 * kScanWarps) s_wsum[t >> 5] = incl;
      __syncthreads();
      if (i0 < kCodes) {
        int run = incl - sum;
        for (int w = 0; w < (t >> 5); ++w) run += s_wsum[w];
        s_lo[i0] = run;
        s_hi[i0] = run + c0;
        s_cnt[i0] = 0;
        if (i0 + 1 < kCodes) {
          s_lo[i0 + 1] = run + c0;
          s_hi[i0 + 1] = run + sum;
          s_cnt[i0 + 1] = 0;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (t + e * kTileThreads < m) s_pt[s_lo[kc[e]] + slot[e]] = pt[e];
    __syncthreads();
    // a point's place: its run's start plus the run's points below it;
    // there it stages its four contributions
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (t + e * kTileThreads >= m) continue;
      int r = s_lo[kc[e]];
      for (int j = r, end = s_hi[kc[e]]; j < end; ++j) r += s_pt[j] < pt[e];
      const Taps tp = taps_of(xv[e], yv[e], H, W);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (tp.w[k] != 0.f) {
#pragma unroll
          for (int c = 0; c < C; ++c) a[c] = __fmul_rn(tp.w[k], dv[e][c]);
        }
        *reinterpret_cast<float4*>(s_add[r][k]) =
            make_float4(a[0], a[1], a[2], a[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int run = code + (q >> 1) * kHalo + (q & 1);
      for (int i = s_lo[run], e = s_hi[run]; i < e; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(s_add[i][3 - q]);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], av[c]);
      }
    }
  }
  if (v >= H || u >= W) return;
  float* o = dmap + ((int64_t)bn * H * W + v * W + u) * C;
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c];
  }
}

template <int C, bool kVec>
void launch_backward(const float* px, const float* py, const float* dout,
                     const long long* starts, const long long* ends,
                     unsigned long long* placed, float* dmap, long long nbins,
                     int H, int W, int nty, int ntx, int64_t P,
                     cudaStream_t stream) {
  point_sample_backward_kernel<C, kVec>
      <<<(unsigned)nbins, kTileThreads, 0, stream>>>(
          px, py, dout, starts, ends, placed, dmap, H, W, nty, ntx, P);
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

// The backward's binning (see the note at the top): counts [nbins + BN]
// is scratch; spans [2 nbins] holds each bin's span in `placed`, its
// starts then its ends (bin b's keys at [starts[b], ends[b])); placed
// [4 BN P] (camera bn's bins within [bn 4P, (bn + 1) 4P)); nbins = BN *
// ceil(H / 16) * ceil(W / 16). Returns cudaGetLastError() after the
// launches (0 on success).
int point_sample_order(const float* px, const float* py, int* counts,
                       long long* spans, unsigned long long* placed, int BN,
                       int H, int W, int64_t P, void* stream) {
  if (!valid_shape(BN, H, W, 1) || P < 0 || P > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int nty = (H + kTile - 1) / kTile, ntx = (W + kTile - 1) / kTile;
  const long long nbins = (long long)BN * nty * ntx;
  if (nbins > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nbins > 0) {
    const cudaError_t e =
        cudaMemsetAsync(counts, 0, (nbins + BN) * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    auto grid = [&](int unroll) {
      const int64_t range = (int64_t)kBinThreads * unroll;
      return dim3((unsigned)std::max<int64_t>((P + range - 1) / range, 1),
                  (unsigned)BN);
    };
    point_sample_count_kernel<<<grid(kCountUnroll), kBinThreads, 0, st>>>(
        px, py, counts, spans, spans + nbins, H, W, nty, ntx, P, nbins);
    if (P > 0)
      point_sample_place_kernel<<<grid(kPlaceUnroll), kBinThreads, 0, st>>>(
          px, py, spans, counts, placed, H, W, nty, ntx, P);
  }
  return (int)cudaGetLastError();
}

// spans, placed from point_sample_order (placed is reordered); dout
// [BN,P,C]; writes every value of dmap [BN,H,W,C]. Returns
// cudaGetLastError() after the launch (0 on success).
int point_sample_backward(const float* px, const float* py, const float* dout,
                          const long long* spans, unsigned long long* placed,
                          float* dmap, int BN, int H, int W, int C, int64_t P,
                          void* stream) {
  if (!valid_shape(BN, H, W, C) || P < 0 || P > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int nty = (H + kTile - 1) / kTile, ntx = (W + kTile - 1) / kTile;
  const long long nbins = (long long)BN * nty * ntx;
  if (nbins > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (nbins > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long* ends = spans + nbins;
    const bool aligned = ((uintptr_t)dout | (uintptr_t)dmap) % 16 == 0;
    switch (C) {
      case 1: launch_backward<1, false>(px, py, dout, spans, ends, placed,
                                        dmap, nbins, H, W, nty, ntx, P, s);
              break;
      case 2: launch_backward<2, false>(px, py, dout, spans, ends, placed,
                                        dmap, nbins, H, W, nty, ntx, P, s);
              break;
      case 3: launch_backward<3, false>(px, py, dout, spans, ends, placed,
                                        dmap, nbins, H, W, nty, ntx, P, s);
              break;
      default:
        if (aligned)
          launch_backward<4, true>(px, py, dout, spans, ends, placed, dmap,
                                   nbins, H, W, nty, ntx, P, s);
        else
          launch_backward<4, false>(px, py, dout, spans, ends, placed, dmap,
                                    nbins, H, W, nty, ntx, P, s);
    }
  }
  return (int)cudaGetLastError();
}

const char* point_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
