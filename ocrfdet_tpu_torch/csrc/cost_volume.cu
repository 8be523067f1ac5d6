// Stereo plane-sweep cost volume, forward only (Hopper, sm_90a).
//
// Replaces: ocrfdet_tpu/ops/cost_volume.py::cost_volume_mm, the Pallas
// kernels _mm_kernel and _mm_chunk_kernel. Those rewrite the bilinear
// warp as windowed one-hot matmuls on the TPU's MXU, which clamps
// samples that leave the window (PARITY.md item 5). This kernel computes
// the EXACT warp: no window and no plane groups, one launch per volume.
//
// For each destination pixel (bn, y, x) and depth plane d:
//   den    = d * az + bz                  (behind the camera if < 1e-3)
//   px, py = (d * a2 + b2) / den           (feature-map pixels)
//   warp   = zero-padded bilinear sample of prev (bf16) at (px, py)
//   cost   = sum_c |curr - warp| (+ bias where warp[C - 4] == 0)
// The coordinate arithmetic uses __fmul_rn/__fadd_rn/__fdiv_rn so that
// it rounds exactly like the plain PyTorch version (one rounding per
// operation, no FMA contraction): a tap weight that is exactly 0 there
// is exactly 0 here, and the invalid flag agrees bit for bit.
//
// What bounds it on an H100: a flagship volume [6 cams, 118 planes,
// 64x176, C=256] has 8.0 M samples. Its compulsory HBM traffic is 136 MB
// (curr f32 69 MB + prev bf16 35 MB + out 32 MB, ~41 us) and its fp32
// work ~19 GFLOP (an FMA per channel per in-image tap, plus sub/abs/add
// per channel; ~0.29 ms at 67 TFLOP/s), so its roofline bound is the
// arithmetic. Every sample also reads up to four bf16 rows of C channels
// from prev (3.23 in-image taps per sample at the flagship geometry); the
// 35 MB prev image stays in the 50 MB L2.
//
// Design: one warp per destination pixel walks the planes; each lane
// keeps C/32 channels of curr in registers for the whole walk (curr is
// read from HBM once), and a tap row is one coalesced 16-byte-per-lane
// load. Three things keep the instructions per plane down, since the
// first design (every tap row loaded and converted at every plane, the
// coordinates worked out by all 32 lanes, a 5-step shuffle sum per plane)
// was bound by instruction issue (2.19 ms a flagship volume on an H100):
// - Row reuse along the walk (a register window, not a shared-memory
//   stage: a walk's rows repeat along its own epipolar line, half the
//   planes fall on the same 2x2 tap cell as the plane before, and the
//   shared-memory stage of a block's footprint would cut L2 reads, which
//   do not bound this kernel). Each lane holds four rows of its channels
//   in fp32, one slot per parity class (y & 1) * 2 + (x & 1) of the tap
//   pixel. A plane's four taps fall in four different slots (tap
//   (dy, dx) in slot Q ^ (dy * 2 + dx), Q the parity of the top-left
//   tap), and a pixel that the plane before also had in the image is in
//   the same slot still, so a plane loads only its other taps: 0.85 row
//   loads per sample instead of 3.23 at the flagship geometry. The loads
//   of the next plane are issued before this plane's arithmetic. The
//   plane's parity picks one of four unrolled copies of the tap sum, so
//   no register moves.
// - One lane per plane: lane j works out the coordinates, tap weights,
//   slot pixels and loads of plane d0 + j for a round of 32 planes and
//   leaves them in shared memory, where every lane reads them.
// - One channel sum per round: each lane leaves its partial sum of each
//   plane in shared memory, and lane j adds plane d0 + j's 32 partials in
//   the tree of the xor-shuffle butterfly (16, 8, 4, 2, 1).
// The taps are still added in (dy, dx) order by the same fmaf chain and
// the channel sums in the same tree, so the result is bit for bit the
// first design's. It is still bound by instruction issue: ~90
// instructions a plane per warp on a plane that loads nothing, about
// half of them the 32 FMAs and 16 adds of the channels, the rest the
// bookkeeping around them.
//
// Compiled with -DCOST_VOLUME_COUNT_LOADS, the kernel also counts the tap
// rows its warps load (each warp adds its count once, at the end of its
// walk) and cost_volume_take_row_loads reads the count: a separate
// library that measures the row window, never the one that is timed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC> struct RawVec;
template <> struct RawVec<2> { using T = unsigned int; };
template <> struct RawVec<8> { using T = uint4; };

// VEC consecutive bf16 channels: one vector load, then fp32.
template <int VEC>
__device__ __forceinline__ typename RawVec<VEC>::T load_raw(
    const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const typename RawVec<VEC>::T*>(p));
}

template <int VEC>
__device__ __forceinline__ void to_f32(const typename RawVec<VEC>::T& raw,
                                       float (&v)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

constexpr int kPlanes = 32;  // planes per round of a walk, one per lane
constexpr int kLoadBits = 0xf << 6;

#ifdef COST_VOLUME_COUNT_LOADS
__device__ unsigned long long g_row_loads;  // tap rows loaded, all launches
#define COUNT_ROW_LOADS(bits) (row_loads += __popc((bits) & kLoadBits))
#else
#define COUNT_ROW_LOADS(bits) ((void)0)
#endif

// What one plane of a pixel's walk needs: the four tap weights
// wy[dy] * wx[dx] in tap order t = dy * 2 + dx; for each row slot s the
// pixel id y * W + x of the plane's tap in s; and in `bits` which taps
// lie in the image (bit t), the parity class Q = (y0 & 1) * 2 + (x0 & 1)
// of the top-left tap (bits 4-5) and which slots the plane must load
// (bit 6 + s). Slot s = (y & 1) * 2 + (x & 1) of a tap pixel is Q ^ t.
struct alignas(16) PlaneTaps {
  float w[4];
  int id[4];
  int bits;
  int pad[3];
};

// Which slots plane t must load, given the plane before it: a slot is
// loaded unless the plane before had the same pixel in the image (that
// pixel has the same parity, so its row is still in the slot).
__device__ __forceinline__ void plan_loads(PlaneTaps& t, const int (&prev_id)[4],
                                           int prev_bits) {
  const int Q = (t.bits >> 4) & 3;
  const int Qp = (prev_bits >> 4) & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // slot s holds tap s ^ Q of this plane and tap s ^ Qp of the one before
    const bool held = ((prev_bits >> (s ^ Qp)) & 1) && prev_id[s] == t.id[s];
    if (((t.bits >> (s ^ Q)) & 1) && !held) t.bits |= 1 << (6 + s);
  }
}

// Issue the loads of the rows plane t must load, into raw[slot].
template <int VEC>
__device__ __forceinline__ void issue_loads(
    const __nv_bfloat16* img, const PlaneTaps& t, int bits,
    typename RawVec<VEC>::T (&raw)[4]) {
  constexpr int C = 32 * VEC;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if ((bits >> (6 + s)) & 1)
      raw[s] = load_raw<VEC>(img + (int64_t)t.id[s] * C);
}

// The in-image taps of a plane of parity Q (so every slot index is a
// constant: tap t = dy * 2 + dx lives in slot Q ^ t), added in (dy, dx)
// order. When all four taps are in the image (most planes) the first is a
// plain product: fmaf(w, r, 0) differs from w * r only in the sign of a
// zero, which neither |curr - warp| nor the flag test sees.
template <int VEC, int Q>
__device__ __forceinline__ void plane_taps(const float (&rows)[4][VEC],
                                           const float4& w, int bits,
                                           float (&acc)[VEC]) {
  const float ws[4] = {w.x, w.y, w.z, w.w};
  if ((bits & 15) == 15) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = ws[0] * rows[Q][k];
#pragma unroll
    for (int t = 1; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] = fmaf(ws[t], rows[Q ^ t][k], acc[k]);
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if ((bits >> t) & 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] = fmaf(ws[t], rows[Q ^ t][k], acc[k]);
    }
  }
}

// curr [BN, H*W, C] f32; prev [BN, H*W, C] bf16; coef [BN, H*W, 3]
// (az, a2x, a2y); cam [BN, 3] (bz, b2x, b2y); depths [D];
// out [BN, D, H*W] f32. The flag channel is C - 4.
template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cost_volume_kernel(const float* __restrict__ curr,
                   const __nv_bfloat16* __restrict__ prev,
                   const float* __restrict__ coef,
                   const float* __restrict__ cam,
                   const float* __restrict__ depths,
                   float* __restrict__ out,
                   int BN, int D, int H, int W, float bias) {
  constexpr int C = 32 * VEC;
  constexpr int kInvLane = (C - 4) / VEC;
  constexpr int kInvK = (C - 4) % VEC;
  __shared__ PlaneTaps taps[kWarpsPerBlock][kPlanes];
  // each lane's channel sum of each plane of the round, and the flag
  // channel's warp value (column 32; the extra column also keeps a lane
  // that reads a plane's row off the other lanes' banks)
  __shared__ float sums[kWarpsPerBlock][kPlanes][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t HW = (int64_t)H * W;
  const int64_t pixel = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (pixel >= (int64_t)BN * HW) return;  // uniform across the warp
  const int64_t bn = pixel / HW;
  const int64_t hw = pixel - bn * HW;

  float c[VEC];
  const float* crow = curr + pixel * C + lane * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) c[k] = crow[k];

  const float az = coef[pixel * 3 + 0];
  const float a2x = coef[pixel * 3 + 1];
  const float a2y = coef[pixel * 3 + 2];
  const float bz = cam[bn * 3 + 0];
  const float b2x = cam[bn * 3 + 1];
  const float b2y = cam[bn * 3 + 2];
  const __nv_bfloat16* img = prev + bn * HW * C + lane * VEC;
  float* orow = out + bn * (int64_t)D * HW + hw;

  // the row window: slot (y & 1) * 2 + (x & 1) holds the row of the
  // last pixel of that parity class that a plane loaded
  float rows[4][VEC];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int k = 0; k < VEC; ++k) rows[s][k] = 0.f;
  typename RawVec<VEC>::T raw[4];  // rows in flight, by slot
  int carry_id[4] = {0, 0, 0, 0};  // the last plane of the round before
  int carry_bits = 0;
#ifdef COST_VOLUME_COUNT_LOADS
  int row_loads = 0;
#endif

  for (int d0 = 0; d0 < D; d0 += kPlanes) {
    const int np = D - d0 < kPlanes ? D - d0 : kPlanes;
    // lane j works out the taps of plane d0 + j
    PlaneTaps t = {{0.f, 0.f, 0.f, 0.f}, {0, 0, 0, 0}, 0, {0, 0, 0}};
    if (lane < np) {
      const float dv = depths[d0 + lane];
      const float den = __fadd_rn(__fmul_rn(dv, az), bz);
      if (den >= 1e-3f) {
        const float px = __fdiv_rn(__fadd_rn(__fmul_rn(dv, a2x), b2x), den);
        const float py = __fdiv_rn(__fadd_rn(__fmul_rn(dv, a2y), b2y), den);
        const float fx = floorf(px);
        const float fy = floorf(py);
        // any tap in the image? (also keeps the int conversion in range)
        if (fx >= -1.f && fx <= (float)(W - 1) && fy >= -1.f &&
            fy <= (float)(H - 1)) {
          const float tx = __fsub_rn(px, fx);
          const float ty = __fsub_rn(py, fy);
          const float wxs[2] = {__fsub_rn(1.f, tx), tx};
          const float wys[2] = {__fsub_rn(1.f, ty), ty};
          const int x0 = (int)fx;
          const int y0 = (int)fy;
          const int Q = ((y0 & 1) << 1) | (x0 & 1);
#pragma unroll
          for (int s = 0; s < 4; ++s)  // slot s holds tap s ^ Q
            t.id[s] = (y0 + ((s ^ Q) >> 1)) * W + x0 + ((s ^ Q) & 1);
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              const int xi = x0 + dx;
              const int yi = y0 + dy;
              if (xi >= 0 && xi < W && yi >= 0 && yi < H) {
                t.bits |= 1 << (dy * 2 + dx);
                t.w[dy * 2 + dx] = __fmul_rn(wys[dy], wxs[dx]);
              }
            }
          }
          t.bits |= Q << 4;
        }
      }
    }
    int prev_id[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      prev_id[s] = __shfl_up_sync(kFull, t.id[s], 1);
      if (lane == 0) prev_id[s] = carry_id[s];
    }
    int prev_bits = __shfl_up_sync(kFull, t.bits, 1);
    if (lane == 0) prev_bits = carry_bits;
    plan_loads(t, prev_id, prev_bits);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      carry_id[s] = __shfl_sync(kFull, t.id[s], kPlanes - 1);
    carry_bits = __shfl_sync(kFull, t.bits, kPlanes - 1);
    taps[warp][lane] = t;
    __syncwarp();
    {
      const int bits0 = taps[warp][0].bits;
      if (bits0 & kLoadBits) {
        issue_loads<VEC>(img, taps[warp][0], bits0, raw);
        COUNT_ROW_LOADS(bits0);
      }
    }
    for (int j = 0; j < np; ++j) {
      const PlaneTaps& pt = taps[warp][j];
      const int bits = pt.bits;
      // the rows this plane loaded (issued one plane ago) into their slots
      if (bits & kLoadBits) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if ((bits >> (6 + s)) & 1) to_f32<VEC>(raw[s], rows[s]);
      }
      // the next plane's loads arrive while this one computes
      if (j + 1 < np) {
        const int nbits = taps[warp][j + 1].bits;
        if (nbits & kLoadBits) {
          issue_loads<VEC>(img, taps[warp][j + 1], nbits, raw);
          COUNT_ROW_LOADS(nbits);
        }
      }
      float acc[VEC];
      if (bits & 15) {
        const float4 w = *reinterpret_cast<const float4*>(pt.w);
        if (bits & (2 << 4)) {
          if (bits & (1 << 4)) plane_taps<VEC, 3>(rows, w, bits, acc);
          else plane_taps<VEC, 2>(rows, w, bits, acc);
        } else {
          if (bits & (1 << 4)) plane_taps<VEC, 1>(rows, w, bits, acc);
          else plane_taps<VEC, 0>(rows, w, bits, acc);
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      }
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) s += fabsf(c[k] - acc[k]);
      sums[warp][j][lane] = s;
      // the flag channel's warp value, in the row's spare column
      if (lane == kInvLane) sums[warp][j][32] = acc[kInvK];
    }
    __syncwarp();
    if (lane < np) {
      // plane d0 + lane's channel sum over the 32 lanes' sums, added in the
      // tree of an xor-shuffle butterfly (16, 8, 4, 2, 1)
      const float* row = sums[warp][lane];
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = row[i] + row[i + 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v[i] + v[i + 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = v[i] + v[i + 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) v[i] = v[i] + v[i + 2];
      const float total = v[0] + v[1];
      orow[(int64_t)(d0 + lane) * HW] = row[32] == 0.f ? total + bias : total;
    }
    __syncwarp();
  }
#ifdef COST_VOLUME_COUNT_LOADS
  if (lane == 0) atomicAdd(&g_row_loads, (unsigned long long)row_loads);
#endif
}

template <int VEC>
void launch(const float* curr, const void* prev, const float* coef,
            const float* cam, const float* depths, float* out, int BN, int D,
            int H, int W, float bias, cudaStream_t stream) {
  const int64_t pixels = (int64_t)BN * H * W;
  const unsigned blocks =
      (unsigned)((pixels + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cost_volume_kernel<VEC><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      curr, static_cast<const __nv_bfloat16*>(prev), coef, cam, depths, out,
      BN, D, H, W, bias);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for a channel count the kernel does not take
// (it takes the stem widths: 64 for BasicBlock and 256 for Bottleneck
// ResNets). The flag channel is C - 4.
int cost_volume_forward(const float* curr, const void* prev,
                        const float* coef, const float* cam,
                        const float* depths, float* out, int BN, int D, int H,
                        int W, int C, float bias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: launch<2>(curr, prev, coef, cam, depths, out, BN, D, H, W, bias, s); break;
    case 256: launch<8>(curr, prev, coef, cam, depths, out, BN, D, H, W, bias, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#ifdef COST_VOLUME_COUNT_LOADS
// The tap rows loaded by every launch since the last call, into *rows
// (after the launches are done); resets the count. Returns the CUDA
// error code (0 on success).
int cost_volume_take_row_loads(unsigned long long* rows) {
  const cudaError_t e = cudaMemcpyFromSymbol(rows, g_row_loads, sizeof(*rows));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(g_row_loads, &zero, sizeof(zero));
}
#endif

const char* cost_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
