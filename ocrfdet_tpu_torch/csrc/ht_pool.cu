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
// Backward: scatter-style, one warp per point (b, n, z, q), its lanes over
// the channels. A point with wv == 0 is skipped. Each lane adds
// wv * dep * dout[q, c] into dctx[pix, c] (atomic: many pillars hit one
// pixel) and accumulates ctx[pix, c] * dout[q, c]; a warp shuffle reduces
// that to the dot product, and lane 0 adds wv times it into the single
// slot ddep[pix, di] (atomic too). Only bin di of each point gets a depth
// gradient. At flagship shapes the backward moves ~27 MB (the index
// streams, dep, ctx, dout, ddep, dctx), ~8 us at 3.35 TB/s, and its
// ~16 M atomic adds land in 3.4 MB that stay in L2. The atomics make the
// sum order, and so the last bits, vary from run to run. ddep and dctx
// must be zeroed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // pillars per block
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

// dout [B,Nq,C]; ddep [B,N,HW,D] and dctx [B,N,HW,C] (zeroed).
__global__ void __launch_bounds__(kWarps * kLanes)
ht_pool_backward_kernel(const float* __restrict__ dep,
                        const float* __restrict__ ctx,
                        const int* __restrict__ pix,
                        const int* __restrict__ di,
                        const float* __restrict__ wv,
                        const float* __restrict__ dout,
                        float* __restrict__ ddep, float* __restrict__ dctx,
                        int B, int N, int HW, int D, int C, int Zh, int Nq) {
  const int lane = threadIdx.x % kLanes;
  const int64_t i = (int64_t)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (i >= (int64_t)B * N * Zh * Nq) return;
  const float v = wv[i];
  if (v == 0.f) return;  // invalid point: no gradient
  const int64_t bnz = i / Nq;  // (b * N + n) * Zh + z
  const int q = (int)(i - bnz * Nq);
  const int64_t bn = bnz / Zh;
  const int64_t b = bn / N;
  const int p = pix[i];
  const int d = di[i];
  const float w = dep[(bn * HW + p) * D + d] * v;
  const float* row = ctx + (bn * HW + p) * C;
  float* drow = dctx + (bn * HW + p) * C;
  const float* go = dout + (b * Nq + q) * C;
  float acc = 0.f;
  for (int c = lane; c < C; c += kLanes) {
    const float gv = go[c];
    atomicAdd(drow + c, w * gv);
    acc += row[c] * gv;
  }
#pragma unroll
  for (int s = kLanes / 2; s > 0; s /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, s);
  if (lane == 0) atomicAdd(ddep + (bn * HW + p) * D + d, acc * v);
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

// Returns cudaGetLastError() after the launch (0 on success).
int ht_pool_backward(const float* dep, const float* ctx, const int* pix,
                     const int* di, const float* wv, const float* dout,
                     float* ddep, float* dctx, int B, int N, int HW, int D,
                     int C, int Zh, int Nq, void* stream) {
  const int64_t points = (int64_t)B * N * Zh * Nq;
  if (points > 0) {
    const unsigned blocks = (unsigned)((points + kWarps - 1) / kWarps);
    ht_pool_backward_kernel<<<blocks, kWarps * kLanes, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        dep, ctx, pix, di, wv, dout, ddep, dctx, B, N, HW, D, C, Zh, Nq);
  }
  return (int)cudaGetLastError();
}

const char* ht_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
