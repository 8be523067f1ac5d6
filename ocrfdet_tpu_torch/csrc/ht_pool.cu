// Height-trick (HT) pillar pooling, forward and backward (Hopper,
// sm_90a).
//
// Replaces: ocrfdet_tpu/ops/ht_pool.py::_ht_pool_mm, the Pallas kernels
// _fwd_kernel (forward) and _bwd_kernel (backward, through _ht_bwd).
//
//   out[b, q, c] = sum_n sum_z wv[b,n,z,q] * dep[b,n,pix,di] * ctx[b,n,pix,c]
//   with pix = pix[b,n,z,q], di = di[b,n,z,q]
//   ddep[b,n,pix,di] += wv * <ctx[b,n,pix,:], dout[b,q,:]>
//   dctx[b,n,pix,c]  += wv * dep[b,n,pix,di] * dout[b,q,c]
// over every point (b,n,z,q); the index streams and wv get no gradient.
//
// The nearest pixel / depth bin indices and the validity weight are
// computed by the wrapper (ops/ht_pool.py::_indices), so the kernel and
// the plain version read identical index streams.
//
// What bounds it on an H100: at flagship shapes (6 cameras, 704 feature
// pixels, 118 bins, 80 channels, 13 heights x 16,384 pillars) it must
// move ~24 MB: the three 4-byte index streams (15.3 MB), dep (2.0 MB),
// ctx (1.4 MB) and out (5.2 MB), ~7 us at 3.35 TB/s, and do ~25 M fp32
// multiply-adds: bound by bytes. The Pallas kernel built one-hot
// matrices for the MXU; on Hopper the gather is cheap because dep and
// ctx (3.4 MB) stay in L2. Design: output-stationary, no atomics, so the
// result is deterministic. One warp owns one pillar q and its lanes run
// over the channels (up to 4 per lane, C <= 128). The warp walks the
// cameras and heights in order, reads the index triple once per point
// (the same address for all lanes: one broadcast transaction) and, where
// wv != 0, the scalar dep[pix, di] and the coalesced row ctx[pix, :].
// It sums the heights of one camera, then adds that to the running sum
// over cameras, in the plain version's order. Products and sums are
// rounded separately (no FMA contraction), as the plain version's
// separate tensor ops are.
//
// Backward: pixel-stationary, no float atomics. The points are first
// ordered by row, a row being one (b, camera, pixel) (`ht_pool_order`:
// a memset and four kernels): a count of each row's valid points (one
// integer atomic for the lanes of a warp that hit one row: neighbouring
// pillars often land on one pixel), one block's scan of the counts in
// coalesced tiles, the placement of every valid point's key in its
// row's range (integer atomics again, the order within a row left to
// chance), and a sort of each row, one warp a row, by key = di * Zh * Nq
// + z * Nq + q: the rank of each key among the row's keys, counted with
// shuffles. So `order` holds a fixed order: the row, then the depth
// bin, then the point. Then one warp owns one row (the backward
// kernel): it holds ctx[pix, :] in registers (lanes over the channels),
// walks the row's points in that order and, for each run of points on
// one depth bin di, sums S = sum wv * dout[q, :] (lanes over the
// channels; the dout rows of 4 points loaded at once, each point's
// weight and dep[pix, di] loaded with its key), then
//   ddep[pix, di] = <ctx[pix, :], S>   (one shuffle reduction per run)
//   dctx[pix, :] += dep[pix, di] * S.
// It writes its whole ddep row (through shared memory) and dctx row,
// zeros included, so nothing needs zeroing and every sum runs in one
// order: the same bits on every run. At flagship shapes (batch 2) 15% of
// the 2.56 M points are valid, 6.5 k of the 8.4 k rows are hit, with up
// to 204 points a row. The backward must read the index streams, dep,
// ctx and dout and write ddep and dctx, 54.5 MB, 16 us at 3.35 TB/s;
// the ordering reads the index streams twice, and the kernel gathers a
// 320-byte row of dout from L2 per valid point (126 MB) along chains of
// up to 51 dependent loads on the longest rows: latency, not bytes,
// sets its time. Blocks of 4 rows (kRowWarps) free an SM's slots sooner
// than blocks of 8 when one long row holds its block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // pillars per block of the forward kernel
constexpr int kRowWarps = 4;  // rows per block of the sort and backward
constexpr int kLanes = 32;
constexpr int kPerLane = 4;  // channels per lane: C <= 128

// dep [B,N,HW,D]; ctx [B,N,HW,C]; pix/di/wv [B,N,Zh,Nq]; out [B,Nq,C].
__global__ void __launch_bounds__(kWarps * kLanes)
ht_pool_forward_kernel(const float* __restrict__ dep,
                       const float* __restrict__ ctx,
                       const int* __restrict__ pix,
                       const int* __restrict__ di,
                       const float* __restrict__ wv,
                       float* __restrict__ out, int B, int N, int HW, int D,
                       int C, int Zh, int Nq) {
  const int lane = threadIdx.x % kLanes;
  const int64_t item = (int64_t)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (item >= (int64_t)B * Nq) return;
  const int b = (int)(item / Nq);
  const int q = (int)(item - (int64_t)b * Nq);

  float acc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;

  for (int n = 0; n < N; ++n) {
    const int64_t bn = (int64_t)b * N + n;
    const float* dep_n = dep + bn * HW * D;
    const float* ctx_n = ctx + bn * HW * C;
    float sub[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) sub[k] = 0.f;
    for (int z = 0; z < Zh; ++z) {
      const int64_t i = (bn * Zh + z) * Nq + q;
      const float v = wv[i];
      if (v == 0.f) continue;  // invalid point: adds exact zeros
      const int p = pix[i];
      const float w = __fmul_rn(dep_n[(int64_t)p * D + di[i]], v);
      const float* row = ctx_n + (int64_t)p * C;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = lane + k * kLanes;
        if (c < C) sub[k] = __fadd_rn(sub[k], __fmul_rn(row[c], w));
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = __fadd_rn(acc[k], sub[k]);
  }
  float* o = out + item * C;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + k * kLanes;
    if (c < C) o[c] = acc[k];
  }
}

// Row of a valid point i = ((b * N + n) * Zh + z) * Nq + q: (b * N + n)
// * HW + pix[i].
__device__ __forceinline__ int64_t row_of(int64_t i, int p, int64_t ZQ,
                                          int HW) {
  return i / ZQ * HW + p;
}

// The lanes of a warp that hold valid points of one row share one
// atomic (neighbouring pillars often land on one pixel): the lanes with
// row r, and this lane's rank among them.
struct RowGroup {
  unsigned mask;
  int leader, rank;
};
__device__ __forceinline__ RowGroup row_group(int64_t r) {
  RowGroup g;
  g.mask = __match_any_sync(__activemask(), (unsigned long long)r);
  g.leader = __ffs(g.mask) - 1;
  g.rank = __popc(g.mask & ((1u << (threadIdx.x % kLanes)) - 1u));
  return g;
}

// counts [R] (zeroed): the valid points of every row.
__global__ void ht_pool_count_kernel(const int* __restrict__ pix,
                                     const float* __restrict__ wv,
                                     int* __restrict__ counts, int64_t P,
                                     int64_t ZQ, int HW) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < P;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (wv[i] == 0.f) continue;
    const int64_t r = row_of(i, pix[i], ZQ, HW);
    const RowGroup g = row_group(r);
    if (g.rank == 0) atomicAdd(counts + r, __popc(g.mask));
  }
}

// ends[r] = counts[0] + ... + counts[r], one block of kScanThreads, in
// tiles of kScanThreads consecutive rows (a thread a row; the next
// tile's counts are loaded ahead).
constexpr int kScanThreads = 1024;
__global__ void __launch_bounds__(kScanThreads)
ht_pool_scan_kernel(const int* __restrict__ counts, int* __restrict__ ends,
                    int64_t R) {
  __shared__ int warp_sums[kScanThreads / kLanes];
  __shared__ int tile_total;
  const int tid = threadIdx.x, lane = tid % kLanes, w = tid / kLanes;
  int carry = 0;
  int next = tid < R ? counts[tid] : 0;
  for (int64_t t0 = 0; t0 < R; t0 += kScanThreads) {
    const int64_t r = t0 + tid;
    const int x = next;
    next = r + kScanThreads < R ? counts[r + kScanThreads] : 0;
    // inclusive scan within the warp, then of the warps' totals
    int incl = x;
#pragma unroll
    for (int d = 1; d < kLanes; d *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == kLanes - 1) warp_sums[w] = incl;
    __syncthreads();
    if (w == 0) {
      const int v = warp_sums[lane];
      int y = v;
#pragma unroll
      for (int d = 1; d < kLanes; d *= 2) {
        const int u = __shfl_up_sync(0xffffffffu, y, d);
        if (lane >= d) y += u;
      }
      warp_sums[lane] = y - v;       // the warps before this one
    }
    __syncthreads();
    const int block_incl = warp_sums[w] + incl;
    if (r < R) ends[r] = carry + block_incl;
    if (tid == kScanThreads - 1) tile_total = block_incl;
    __syncthreads();
    carry += tile_total;
  }
}

// Places every valid point's key in its row's range of `placed`, in no
// fixed order; counts [R] goes back to 0.
__global__ void ht_pool_place_kernel(const int* __restrict__ pix,
                                     const int* __restrict__ di,
                                     const float* __restrict__ wv,
                                     const int* __restrict__ ends,
                                     int* __restrict__ counts,
                                     int* __restrict__ placed, int64_t P,
                                     int64_t ZQ, int HW) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < P;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (wv[i] == 0.f) continue;
    const int64_t r = row_of(i, pix[i], ZQ, HW);
    const RowGroup g = row_group(r);
    // the group takes the next slots of the row: counts[r] counts down
    // from the row's length to 0
    int left = 0;
    if (g.rank == 0) left = atomicSub(counts + r, __popc(g.mask));
    left = __shfl_sync(g.mask, left, g.leader);
    placed[ends[r] - left + g.rank] = (int)(di[i] * ZQ + i % ZQ);
  }
}

// One warp a row: order[start + rank(key)] = key, rank(key) the number
// of the row's keys below it (the keys of a row are distinct).
__global__ void __launch_bounds__(kRowWarps * kLanes)
ht_pool_sort_kernel(const int* __restrict__ ends,
                    const int* __restrict__ placed, int* __restrict__ order,
                    int64_t R) {
  const int lane = threadIdx.x % kLanes;
  const int64_t r = (int64_t)blockIdx.x * kRowWarps + threadIdx.x / kLanes;
  if (r >= R) return;
  const int start = r ? ends[r - 1] : 0, L = ends[r] - start;
  const int* in = placed + start;
  for (int a0 = 0; a0 < L; a0 += kLanes) {
    const bool mine = a0 + lane < L;
    const int key = mine ? in[a0 + lane] : 0;
    int rank = 0;
    for (int c0 = 0; c0 < L; c0 += kLanes) {
      // past the row's end: INT_MAX, above every key
      const int other = c0 + lane < L ? in[c0 + lane] : INT32_MAX;
#pragma unroll
      for (int k = 0; k < kLanes; ++k)
        rank += __shfl_sync(0xffffffffu, other, k) < key;
    }
    if (mine) order[start + rank] = key;
  }
}

constexpr int kBatch = 4;      // points whose dout rows are loaded at once
constexpr int kMaxD = 2048;    // depth bins a warp's shared row holds

// dout [B,Nq,C]; ends [R], order (from ht_pool_order); writes every value
// of ddep [B,N,HW,D] and dctx [B,N,HW,C]. Dynamic shared memory:
// kRowWarps rows of D floats.
__global__ void __launch_bounds__(kRowWarps * kLanes)
ht_pool_backward_kernel(const float* __restrict__ dep,
                        const float* __restrict__ ctx,
                        const float* __restrict__ wv,
                        const float* __restrict__ dout,
                        const int* __restrict__ ends,
                        const int* __restrict__ order,
                        float* __restrict__ ddep, float* __restrict__ dctx,
                        int64_t R, int N, int HW, int D, int C, int Zh,
                        int Nq) {
  extern __shared__ float shared_rows[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int64_t r = (int64_t)blockIdx.x * kRowWarps + warp;
  if (r >= R) return;
  const int64_t bn = r / HW, b = bn / N;
  const int ZQ = Zh * Nq;
  float* sd = shared_rows + warp * D;       // this row's ddep
  for (int i = lane; i < D; i += kLanes) sd[i] = 0.f;
  float cx[kPerLane], S[kPerLane], acc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + k * kLanes;
    cx[k] = c < C ? ctx[r * C + c] : 0.f;
    S[k] = acc[k] = 0.f;
  }
  const float* go = dout + b * Nq * C;
  const float* wv_bn = wv + bn * ZQ;
  const float* dep_r = dep + r * D;
  const int start = r ? ends[r - 1] : 0, end = ends[r];
  __syncwarp();

  // the end of a run on bin `cur` (dep[pix, cur] = `dcur`): its ddep
  // slot and its share of dctx
  int cur = -1;
  float dcur = 0.f;
  auto flush = [&]() {
    if (cur < 0) return;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) part = fmaf(cx[k], S[k], part);
#pragma unroll
    for (int d = kLanes / 2; d > 0; d /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, d);
    if (lane == 0) sd[cur] = part;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      acc[k] = fmaf(dcur, S[k], acc[k]);
      S[k] = 0.f;
    }
  };
  // lane l decodes point l of a chunk of 32: bin, pillar, weight and
  // dep[pix, bin]; the next chunk's keys are loaded ahead
  int next = lane < end - start ? order[start + lane] : 0;
  for (int c0 = start; c0 < end; c0 += kLanes) {
    const int n = min(kLanes, end - c0);
    const int key = next;
    if (c0 + kLanes + lane < end) next = order[c0 + kLanes + lane];
    int dl = 0, ql = 0;
    float wl = 0.f, pl = 0.f;
    if (lane < n) {
      dl = key / ZQ;
      const int zq = key - dl * ZQ;
      ql = zq % Nq;
      wl = wv_bn[zq];
      pl = dep_r[dl];
    }
    for (int s0 = 0; s0 < n; s0 += kBatch) {
      int dj[kBatch];
      float wj[kBatch], pj[kBatch], x[kBatch][kPerLane];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int src = (s0 + j) % kLanes;
        dj[j] = __shfl_sync(0xffffffffu, dl, src);
        wj[j] = __shfl_sync(0xffffffffu, wl, src);
        pj[j] = __shfl_sync(0xffffffffu, pl, src);
        const int qj = __shfl_sync(0xffffffffu, ql, src);
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int c = lane + k * kLanes;
          x[j][k] = s0 + j < n && c < C ? go[(int64_t)qj * C + c] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (s0 + j >= n) break;       // the same for every lane
        if (dj[j] != cur) {
          flush();
          cur = dj[j];
          dcur = pj[j];
        }
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) S[k] = fmaf(wj[j], x[j][k], S[k]);
      }
    }
  }
  flush();
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + k * kLanes;
    if (c < C) dctx[r * C + c] = acc[k];
  }
  for (int i = lane; i < D; i += kLanes) ddep[r * D + i] = sd[i];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int ht_pool_forward(const float* dep, const float* ctx, const int* pix,
                    const int* di, const float* wv, float* out, int B, int N,
                    int HW, int D, int C, int Zh, int Nq, void* stream) {
  if (C <= 0 || C > kPerLane * kLanes) return (int)cudaErrorInvalidValue;
  const int64_t items = (int64_t)B * Nq;
  if (items > 0) {
    const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
    ht_pool_forward_kernel<<<blocks, kWarps * kLanes, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        dep, ctx, pix, di, wv, out, B, N, HW, D, C, Zh, Nq);
  }
  return (int)cudaGetLastError();
}

// The backward's ordering (see the note at the top): counts [R] is
// scratch, ends [R] each row's inclusive end in `order`, placed and order
// [B*N*Zh*Nq] (the first ends[R-1] entries used), R = B*N*HW. Returns
// cudaGetLastError() after the launches (0 on success).
int ht_pool_order(const int* pix, const int* di, const float* wv,
                  int* counts, int* ends, int* placed, int* order, int B,
                  int N, int HW, int D, int Zh, int Nq, void* stream) {
  const int64_t ZQ = (int64_t)Zh * Nq, R = (int64_t)B * N * HW,
                P = (int64_t)B * N * ZQ;
  if (D <= 0 || D * ZQ > INT32_MAX || P > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    cudaError_t e = cudaMemsetAsync(counts, 0, R * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (P + 255) / 256;
    const unsigned grid = (unsigned)(blocks < 4096 ? blocks : 4096);
    if (P > 0)
      ht_pool_count_kernel<<<grid, 256, 0, st>>>(pix, wv, counts, P, ZQ, HW);
    ht_pool_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, ends, R);
    if (P > 0)
      ht_pool_place_kernel<<<grid, 256, 0, st>>>(pix, di, wv, ends, counts,
                                                 placed, P, ZQ, HW);
    ht_pool_sort_kernel<<<(unsigned)((R + kRowWarps - 1) / kRowWarps),
                          kRowWarps * kLanes, 0, st>>>(ends, placed, order,
                                                       R);
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success).
int ht_pool_backward(const float* dep, const float* ctx, const float* wv,
                     const float* dout, const int* ends, const int* order,
                     float* ddep, float* dctx, int B, int N, int HW, int D,
                     int C, int Zh, int Nq, void* stream) {
  if (C <= 0 || C > kPerLane * kLanes || D <= 0 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const int64_t R = (int64_t)B * N * HW;
  if (R > 0) {
    const int shared = kRowWarps * D * (int)sizeof(float);
    ht_pool_backward_kernel<<<(unsigned)((R + kRowWarps - 1) / kRowWarps),
                              kRowWarps * kLanes, shared,
                              static_cast<cudaStream_t>(stream)>>>(
        dep, ctx, wv, dout, ends, order, ddep, dctx, R, N, HW, D, C, Zh, Nq);
  }
  return (int)cudaGetLastError();
}

const char* ht_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
