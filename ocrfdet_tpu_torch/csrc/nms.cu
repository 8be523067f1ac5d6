// The NMS pair tests of every task and sample of a request, as bit rows
// (Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package ran its NMS on the host
// (native/nms.cpp, whose copy is csrc/nms.cpp), and the reference ran
// mmcv's CUDA nms_rotated, which built the suppression mask on the device
// and scanned it on the host. This kernel is that design for the port:
// it builds the mask of every task and sample in one launch after the
// decode, and the host keeps only the greedy scan (nms_scan_rows in
// csrc/nms.cpp), in the reference's own np.argsort order, so that tied
// scores keep the reference's order whatever the device does.
//
//   rows[t, b, i, w] bit k is set iff box i of task t, sample b, if kept,
//   suppresses box j = 64 w + k:
//     rotated task: pair_iou(box_i, box_j) > thr, with csrc/nms.cpp's
//       pair_iou (i kept, j the candidate: the full K x K mask, since the
//       clip is not symmetric in its bits). Each box first gets the
//       Scale-NMS rescale of dx, dy by its class's factor in fp32 (the
//       factor rounded to fp32, one rounded product, as numpy's
//       `scaled[..., 3:6] *= f` on float32; a class without a factor is
//       not scaled), then (cx, cy, dx, dy, yaw) is widened to fp64, and
//       every operation of pair_iou is one fp64 operation rounded to
//       nearest: products through __dmul_rn, so nothing contracts into an
//       FMA, as on the host, which has none.
//     circle task: d2 <= (float)radius, d2 = (x_i - x_j)^2 + (y_i - y_j)^2
//       in fp32 with __fsub_rn / __fmul_rn / __fadd_rn: the arithmetic of
//       circle_nms in numpy float32.
//   Bits past K are 0. Valid and invalid boxes alike get rows: the host
//   reads only the rows and bits of valid ones.
//
// The clip cannot overflow its buffers. A Sutherland-Hodgman pass over an
// n-gon writes a vertex for each vertex inside the edge and one for each
// change between inside and outside around the polygon; the changes are
// twice the runs of inside vertices, and those runs are at most the
// inside vertices and at most the outside ones, so a pass writes at most
// in + 2 min(in, n - in) <= floor(3n / 2) vertices (fewer where a
// crossing's denominator is too small to cut). Four passes from a
// quadrilateral: 4 -> 6 -> 9 -> 13 -> 19 = kPoly.
//
// The trig is not the host's: the corners use CUDA's fp64 sincos (up to
// 2 ulp), the host glibc's std::sin and std::cos. Every other operation
// is the host's, so a bit can differ from csrc/nms.cpp's only where a
// pair's IoU lies within a few ulp of thr.
//
// What bounds it on an H100: the bytes are small (a flagship request
// reads 6 tasks x 500 boxes x 44 B and writes 6 x 500 x 8 words, under
// 1 MB at batch 4), so it is bound by the fp64 work: a distance test of
// 7 operations for every pair, and for the pairs whose circumscribed
// circles meet four Sutherland-Hodgman clips and an area, ~210-225 fp64
// adds, subs, muls and divs on flagship-sized decodes (counted where the
// code branches by ops/nms.py::nms_rows_plain(work=)). Design: a block
// takes one task and sample, a tile of 64 rows and a tile of 64 columns
// (ceil(K/64)^2 x T x B blocks: 384 at b1, enough to fill the card), and
// stages both tiles' boxes in shared memory with
// their rescale, radius, area and corners worked out once; a warp takes a
// row at a time, each lane two columns (lane, lane + 32), and the 64 bits
// are packed with two __ballot_sync into one word that lane 0 writes. A
// lane whose circles do not meet idles through its neighbours' clips;
// the early-out keeps those clips a few percent of the pairs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows and columns of a block's tile
constexpr int kThreads = 256;
constexpr int kMaxTasks = 16;
constexpr int kMaxClasses = 8;   // Scale-NMS factors a task may hold
constexpr int kPoly = 19;        // vertices a clipped polygon can reach

struct Params {
  const float* boxes[kMaxTasks];       // [B, K, 9] each
  const long long* labels[kMaxTasks];  // [B, K] each, task-local classes
  double thr[kMaxTasks];               // IoU threshold, or circle radius
  float fac[kMaxTasks][kMaxClasses];   // Scale-NMS factor of each class
  int nfac[kMaxTasks];                 // classes with a factor; -1: fac[0]
                                       // for every class
  int circle[kMaxTasks];               // 1 for a circle task
};

struct Pt {
  double x, y;
};

// A rotated box as pair_iou sees it: (cx, cy, dx, dy) in fp64, its
// circumscribed radius, its area and its corners.
struct RBox {
  double cx, cy, dx, dy, r, area;
  Pt c[4];
};

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// csrc/nms.cpp::cross
__device__ __forceinline__ double cross(const Pt& o, const Pt& a,
                                        const Pt& b) {
  return sub(mul(sub(a.x, o.x), sub(b.y, o.y)),
             mul(sub(a.y, o.y), sub(b.x, o.x)));
}

// The box's rescale and the parts of pair_iou that depend on it alone:
// csrc/nms.cpp::corners, the radius and the area.
__device__ RBox make_rbox(const float* box, long long label,
                          const Params& p, int t) {
  float dx = box[3], dy = box[4];
  const int nfac = p.nfac[t];
  if (nfac < 0 || (label >= 0 && label < nfac)) {
    const float f = p.fac[t][nfac < 0 ? 0 : (int)label];
    dx = __fmul_rn(dx, f);
    dy = __fmul_rn(dy, f);
  }
  RBox b;
  b.cx = (double)box[0];
  b.cy = (double)box[1];
  b.dx = (double)dx;
  b.dy = (double)dy;
  const double yaw = (double)box[6];
  b.r = mul(0.5, __dsqrt_rn(add(mul(b.dx, b.dx), mul(b.dy, b.dy))));
  b.area = mul(b.dx, b.dy);
  double s, c;
  sincos(yaw, &s, &c);
  const double hx = mul(b.dx, 0.5), hy = mul(b.dy, 0.5);
  const double lx[4] = {hx, -hx, -hx, hx};
  const double ly[4] = {hy, hy, -hy, -hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.c[k].x = sub(add(b.cx, mul(c, lx[k])), mul(s, ly[k]));
    b.c[k].y = add(add(b.cy, mul(s, lx[k])), mul(c, ly[k]));
  }
  return b;
}

// csrc/nms.cpp::inter_area, in two buffers of kPoly vertices.
__device__ double inter_area(const Pt a[4], const Pt b[4]) {
  Pt buf[2][kPoly];
  int n = 4, cur = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) buf[0][k] = a[k];
  for (int i = 0; i < 4 && n > 0; ++i) {
    const Pt e0 = b[i], e1 = b[(i + 1) & 3];
    const double ex = sub(e1.x, e0.x), ey = sub(e1.y, e0.y);
    const Pt* in = buf[cur];
    Pt* out = buf[cur ^ 1];
    int m = 0;
    Pt prev = in[n - 1];
    bool prev_in = cross(e0, e1, prev) >= 0.0;
    for (int k = 0; k < n; ++k) {
      const Pt c = in[k];
      const bool c_in = cross(e0, e1, c) >= 0.0;
      if (c_in != prev_in) {
        const double dx = sub(c.x, prev.x), dy = sub(c.y, prev.y);
        const double den = sub(mul(ex, dy), mul(ey, dx));
        if (fabs(den) > 1e-12) {
          const double t = sub(mul(ex, sub(e0.y, prev.y)),
                               mul(ey, sub(e0.x, prev.x))) / den;
          out[m++] = {add(prev.x, mul(t, dx)), add(prev.y, mul(t, dy))};
        }
      }
      if (c_in) out[m++] = c;
      prev = c;
      prev_in = c_in;
    }
    n = m;
    cur ^= 1;
  }
  if (n < 3) return 0.0;
  const Pt* q = buf[cur];
  double s = 0.0;
  for (int k = 0; k < n; ++k) {
    const Pt& u = q[k];
    const Pt& v = q[k + 1 == n ? 0 : k + 1];
    s = add(s, sub(mul(u.x, v.y), mul(v.x, u.y)));
  }
  return mul(fabs(s), 0.5);
}

// csrc/nms.cpp::pair_iou(a, b) > thr
__device__ bool rotated_bit(const RBox& a, const RBox& b, double thr) {
  const double ex = sub(a.cx, b.cx), ey = sub(a.cy, b.cy);
  const double rr = add(a.r, b.r);
  double iou = 0.0;
  if (!(add(mul(ex, ex), mul(ey, ey)) > mul(rr, rr))) {
    const double inter = inter_area(a.c, b.c);
    const double uni = sub(add(a.area, b.area), inter);
    iou = uni > 1e-12 ? inter / uni : 0.0;
  }
  return iou > thr;
}

__device__ __forceinline__ bool circle_bit(float2 a, float2 b, float r) {
  const float dx = __fsub_rn(a.x, b.x), dy = __fsub_rn(a.y, b.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r;
}

#ifdef NMS_ROWS_FAULT
#define FAULT_POINT() \
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) __trap()
#else
#define FAULT_POINT()
#endif

// grid (row tiles, column tiles, T * B), kThreads threads.
__global__ void __launch_bounds__(kThreads)
nms_rows_kernel(Params p, int B, int K, int words,
                unsigned long long* __restrict__ rows) {
  __shared__ RBox rbox[2][kTile];      // [0]: the row tile, [1]: columns
  __shared__ float2 cpos[2][kTile];
  FAULT_POINT();
  const int t = blockIdx.z / B, b = blockIdx.z % B;
  const int r0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const bool circle = p.circle[t] != 0;
  const float* boxes = p.boxes[t] + (size_t)b * K * 9;
  const long long* labels = p.labels[t] + (size_t)b * K;
  const int tid = threadIdx.x;
  if (tid < 2 * kTile) {
    const int side = tid / kTile, k = tid % kTile;
    const int i = (side ? c0 : r0) + k;
    if (i < K) {
      const float* box = boxes + (size_t)i * 9;
      if (circle)
        cpos[side][k] = make_float2(box[0], box[1]);
      else
        rbox[side][k] = make_rbox(box, labels[i], p, t);
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  const bool in0 = c0 + lane < K, in1 = c0 + 32 + lane < K;
  const double thr = p.thr[t];
  const float radius = (float)thr;
  unsigned long long* out = rows + ((size_t)blockIdx.z * K) * words
                            + blockIdx.y;
  for (int rr = warp; rr < kTile && r0 + rr < K; rr += kThreads / 32) {
    bool bit0 = false, bit1 = false;
    if (circle) {
      const float2 a = cpos[0][rr];
      bit0 = in0 && circle_bit(a, cpos[1][lane], radius);
      bit1 = in1 && circle_bit(a, cpos[1][lane + 32], radius);
    } else {
      const RBox& a = rbox[0][rr];
      bit0 = in0 && rotated_bit(a, rbox[1][lane], thr);
      bit1 = in1 && rotated_bit(a, rbox[1][lane + 32], thr);
    }
    const unsigned lo = __ballot_sync(0xffffffffu, bit0);
    const unsigned hi = __ballot_sync(0xffffffffu, bit1);
    if (lane == 0)
      out[(size_t)(r0 + rr) * words] =
          (unsigned long long)lo | ((unsigned long long)hi << 32);
  }
}

}  // namespace

extern "C" {

// boxes, labels: T device pointers each ([B, K, 9] float32, [B, K]
// int64); circle [T], thr [T] (IoU threshold, or the circle's radius),
// fac [T * 8] and nfac [T] (each task's Scale-NMS factors: nfac classes,
// or -1 for fac[t * 8] on every class): host arrays. rows [T, B, K,
// ceil(K / 64)] uint64 on the device. Returns cudaGetLastError() after
// the launch (0 on success).
int nms_rows(const void* const* boxes, const void* const* labels,
             const int* circle, const double* thr, const float* fac,
             const int* nfac, int T, int B, int K,
             unsigned long long* rows, void* stream) {
  if (T < 1 || T > kMaxTasks || B < 1 || K < 1 || (long long)T * B > 65535
      || K > 64 * 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int t = 0; t < T; ++t) {
    if (nfac[t] > kMaxClasses) return (int)cudaErrorInvalidValue;
    p.boxes[t] = static_cast<const float*>(boxes[t]);
    p.labels[t] = static_cast<const long long*>(labels[t]);
    p.thr[t] = thr[t];
    p.nfac[t] = nfac[t];
    p.circle[t] = circle[t];
    for (int k = 0; k < kMaxClasses; ++k)
      p.fac[t][k] = fac[t * kMaxClasses + k];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (K + kTile - 1) / kTile;
  nms_rows_kernel<<<dim3(words, words, T * B), kThreads, 0, s>>>(
      p, B, K, words, rows);
  return (int)cudaGetLastError();
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
