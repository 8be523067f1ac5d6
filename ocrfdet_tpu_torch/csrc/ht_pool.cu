// Height-trick (HT) pillar pooling, forward only (Hopper, sm_90a).
//
// Replaces: ocrfdet_tpu/ops/ht_pool.py::_ht_pool_mm, the Pallas forward
// kernel _fwd_kernel (the backward, _bwd_kernel, is not ported yet).
//
//   out[b, q, c] = sum_n sum_z wv[b,n,z,q] * dep[b,n,pix,di] * ctx[b,n,pix,c]
//   with pix = pix[b,n,z,q], di = di[b,n,z,q]
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

const char* ht_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
