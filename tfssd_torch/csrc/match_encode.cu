// Anchor matching + target encoding, one thread per (image, anchor).
//
// Replaces the JAX package's Pallas TPU kernel ops/kernels/match_encode.py
// (match_encode_pallas, body _kernel). Semantics, for image b of B and
// anchor n of N:
//   iou(n, g)  = inter / max(area_n + area_g - inter, 1e-8), 0 where the
//                gt's label is 0 (padding)
//   best, k    = max and first index of the maximum over g
//   positive   = best > iou_threshold
//   deltas     = [(gcy - acy) / max(ah, 1e-8), (gcx - acx) / max(aw, 1e-8),
//                 log(gh / max(ah, 1e-8)), log(gw / max(aw, 1e-8))]
//                / variances, for gt k's box; 0 when gt k has a side
//                <= 1e-8 or the anchor is negative
//   labels     = label of gt k when positive, else 0
// The force-match step stays a post-pass in plain PyTorch
// (ops/matching.py:force_match), as in the JAX package.
//
// Design for Hopper. The Pallas kernel tiles 512 anchors per program and
// gathers the matched gt with a one-hot matmul on the MXU; neither carries
// over. Here:
//   1. grid (ceil(N / 256), B), 256 threads; each block loads image b's
//      G <= 256 gt boxes and labels into shared memory once and computes
//      each gt's area there;
//   2. each thread walks the G gts with a strict `>` update, which keeps
//      the first index among equal maxima, as argmax does;
//   3. it reads the matched box and label by index (exact, no matmul),
//      encodes, and writes deltas[b, n, :] as one 16-byte store and
//      labels[b, n];
//   4. the ragged tail of N is masked here; anchors are not padded.
// Bound on the H100 at B = 32, N = 2,268, G = 64: 4.6 M IoUs of ~16 f32
// operations (74 MFLOP, 1.1 us at 67 TFLOP/s) against 1.5 MB of traffic
// (0.46 us at 3.35 TB/s): the operations bound it, and a launch (a few
// microseconds) is above both.
//
// Exactness: labels must equal the plain version's bit for bit, which
// means the same positives and the same argmax on the exact IoU ties that
// the symmetric anchor grids produce. The IoU and the encode follow the
// operation order of the plain version (ops/boxes.py: iou_matrix, encode)
// with explicitly rounded intrinsics, so no multiply-add is contracted into
// an FMA; the build passes -fmad=false and never fast math. The threshold
// arrives as float and is compared in float. logf is not correctly rounded
// on either side, so deltas agree to a few ulps, not bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxG = 256;
constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;

__global__ void __launch_bounds__(kThreads)
match_encode_kernel(const float4* __restrict__ anchors,
                    const float4* __restrict__ gt_boxes,
                    const int32_t* __restrict__ gt_labels,
                    float4* __restrict__ deltas, int32_t* __restrict__ labels,
                    int n, int g, float iou_threshold, float v0, float v1,
                    float v2, float v3) {
  __shared__ float4 s_box[kMaxG];
  __shared__ float s_area[kMaxG];
  __shared__ int32_t s_label[kMaxG];

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  for (int j = t; j < g; j += kThreads) {
    const float4 box = gt_boxes[static_cast<size_t>(b) * g + j];
    s_box[j] = box;
    s_area[j] = __fmul_rn(fmaxf(__fsub_rn(box.z, box.x), 0.0f),
                          fmaxf(__fsub_rn(box.w, box.y), 0.0f));
    s_label[j] = gt_labels[static_cast<size_t>(b) * g + j];
  }
  __syncthreads();

  const int i = blockIdx.x * kThreads + t;
  if (i >= n) return;
  // (y0, x0, y1, x1) in (x, y, z, w)
  const float4 a = anchors[i];
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.0f),
                                 fmaxf(__fsub_rn(a.w, a.y), 0.0f));
  float best = -1.0f;
  int k = 0;
  for (int j = 0; j < g; ++j) {
    const float4 q = s_box[j];
    const float iy0 = fmaxf(a.x, q.x);
    const float ix0 = fmaxf(a.y, q.y);
    const float iy1 = fminf(a.z, q.z);
    const float ix1 = fminf(a.w, q.w);
    const float inter = __fmul_rn(fmaxf(__fsub_rn(iy1, iy0), 0.0f),
                                  fmaxf(__fsub_rn(ix1, ix0), 0.0f));
    const float uni = __fsub_rn(__fadd_rn(area_a, s_area[j]), inter);
    float iou = __fdiv_rn(inter, fmaxf(uni, kEps));
    if (s_label[j] <= 0) iou = 0.0f;
    if (iou > best) {
      best = iou;
      k = j;
    }
  }
  const bool positive = g > 0 && best > iou_threshold;

  float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int32_t label = 0;
  if (positive) {
    const float4 q = s_box[k];
    label = s_label[k];
    // to_centers: h = y1 - y0, cy = y0 + h / 2 (h / 2 is exact)
    const float ah = __fsub_rn(a.z, a.x);
    const float aw = __fsub_rn(a.w, a.y);
    const float acy = __fadd_rn(a.x, __fmul_rn(ah, 0.5f));
    const float acx = __fadd_rn(a.y, __fmul_rn(aw, 0.5f));
    const float gh = __fsub_rn(q.z, q.x);
    const float gw = __fsub_rn(q.w, q.y);
    const float gcy = __fadd_rn(q.x, __fmul_rn(gh, 0.5f));
    const float gcx = __fadd_rn(q.y, __fmul_rn(gw, 0.5f));
    if (gh > kEps && gw > kEps) {
      const float ah_s = fmaxf(ah, kEps);
      const float aw_s = fmaxf(aw, kEps);
      d.x = __fdiv_rn(__fdiv_rn(__fsub_rn(gcy, acy), ah_s), v0);
      d.y = __fdiv_rn(__fdiv_rn(__fsub_rn(gcx, acx), aw_s), v1);
      d.z = __fdiv_rn(logf(__fdiv_rn(gh, ah_s)), v2);
      d.w = __fdiv_rn(logf(__fdiv_rn(gw, aw_s)), v3);
    }
  }
  const size_t out = static_cast<size_t>(b) * n + i;
  deltas[out] = d;
  labels[out] = label;
}

}  // namespace

// anchors (N, 4) f32, gt_boxes (B, G, 4) f32, gt_labels (B, G) i32,
// deltas (B, N, 4) f32, labels (B, N) i32, all contiguous on the current
// device; launches on `stream`. Returns a cudaError_t.
extern "C" int match_encode_launch(const void* anchors, const void* gt_boxes,
                                   const void* gt_labels, void* deltas,
                                   void* labels, int b, int n, int g,
                                   float iou_threshold, float v0, float v1,
                                   float v2, float v3, void* stream) {
  if (b < 0 || n < 0 || g < 0 || g > kMaxG || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  match_encode_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(anchors),
      static_cast<const float4*>(gt_boxes),
      static_cast<const int32_t*>(gt_labels), static_cast<float4*>(deltas),
      static_cast<int32_t*>(labels), n, g, iou_threshold, v0, v1, v2, v3);
  return static_cast<int>(cudaGetLastError());
}
