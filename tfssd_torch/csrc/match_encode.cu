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
// What bounds it on the H100. An image has a few real gts among G padded
// rows (1-6 on the synthetic paths, ~2.4 on VOC, G = 64), so the pairs
// the function needs are ~B*N*3.5, well under a microsecond of float
// operations. The bytes are B*N*(16 + 4) of outputs, written once, plus
// the inputs: 16.15 MB at B = 32, N = 24,564, 4.8 us at 3.35 TB/s. The
// bytes bound it, and at N = 2,268 (1.5 MB) a launch costs more.
//
// Design:
//   1. grid (ceil(N / 128), B), 128 threads, one anchor a thread: 576
//      blocks at N = 2,268, so every SM of the 132 has work, and 6,144 at
//      N = 24,564. Each thread issues its anchor's load first. (256 or 64
//      threads, or 2 or 4 anchors a thread, were slower at N = 2,268, and
//      at most 12% faster at N = 24,564: PERF.md §6, PR 11.)
//   2. warp 0 compacts image b's real gts (label > 0) into shared memory
//      in their original order: it issues the loads of all G labels at
//      once (G <= 256 in 8 chunks of 32), then per chunk one ballot and a
//      popcount of the lanes below give each real row its slot, where the
//      row's lane stores its box and area. One barrier, then every thread
//      scans the R real gts of its image (the same R for the whole block:
//      no divergence in the trip count), not the G rows. Loading the boxes
//      of real rows only, after the labels, costs a second round trip but
//      keeps the kernel at 32 registers, so an SM holds 16 blocks;
//      loading every row's box with its label took 56 and was slower at
//      N = 24,564 (PERF.md §6, PR 11).
//   3. a pair whose intersection is 0 is skipped; only a pair that
//      intersects pays the union and the IEEE divide.
//   4. the matched box and label are read by index (exact, no matmul);
//      deltas[b, n, :] are one 16-byte store and labels[b, n] one 4-byte
//      store, consecutive lanes at consecutive anchors.
//
// Exactness: labels equal the plain version's bit for bit.
//   - The scan starts from best = +0 and k = row 0, and updates with a
//     strict `>` over the real gts in their original order.
//   - Every IoU is >= +0 (inter >= 0, the divisor >= 1e-8), and a padded
//     row's masked IoU is 0. So where the maximum M over all rows is > 0,
//     the first row that reaches M is a real gt, and the scan, which sees
//     the real gts in order, stops on that row: strict `>` keeps the first
//     of equal maxima, as argmax does. Where M is 0 (no real gt, or none
//     that overlaps), argmax over a row of zeros is index 0, and the scan
//     never updates: k stays row 0, whatever its label (a hole that
//     augmentation left with label 0, or a degenerate gt). best is then +0
//     where the plain version's is +-0, which compare alike, so a negative
//     threshold makes the anchor positive on both sides with row 0's
//     label and box.
//   - A pair with inter == 0 has IoU +-0, which can never be > best >= +0:
//     skipping it changes nothing. A pair with inter > 0 gets the
//     correctly rounded quotient, as the plain version computes it.
//   - The IoU and the encode follow the operation order of the plain
//     version (ops/boxes.py: iou_matrix, encode) with explicitly rounded
//     intrinsics, so no multiply-add is contracted into an FMA; the build
//     passes -fmad=false and never fast math. The threshold arrives as
//     float and is compared in float. logf is not correctly rounded on
//     either side, so deltas agree to a few ulps, not bit for bit.
// The crafted cases of ops/kernels/match_encode_cases.py hold each point.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxG = 256;
constexpr int kThreads = 128;
constexpr int kChunks = kMaxG / 32;
constexpr float kEps = 1e-8f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 q) {
  return __fmul_rn(fmaxf(__fsub_rn(q.z, q.x), 0.0f),
                   fmaxf(__fsub_rn(q.w, q.y), 0.0f));
}

__global__ void __launch_bounds__(kThreads)
match_encode_kernel(const float4* __restrict__ anchors,
                    const float4* __restrict__ gt_boxes,
                    const int32_t* __restrict__ gt_labels,
                    float4* __restrict__ deltas, int32_t* __restrict__ labels,
                    int n, int g, float iou_threshold, float v0, float v1,
                    float v2, float v3) {
  // image b's real gts, compacted in their original order
  __shared__ float4 s_box[kMaxG];
  __shared__ float s_area[kMaxG];
  __shared__ int32_t s_label[kMaxG];
  __shared__ int s_real;

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  // (y0, x0, y1, x1) in (x, y, z, w)
  const float4 a = i < n ? anchors[i] : make_float4(0.f, 0.f, 0.f, 0.f);

  if (t < 32) {
    int32_t lab[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = c * 32 + t;
      lab[c] = j < g ? gt_labels[static_cast<size_t>(b) * g + j] : 0;
    }
    const unsigned below = (1u << t) - 1u;
    int base = 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const unsigned real = __ballot_sync(kFull, lab[c] > 0);
      if (lab[c] > 0) {
        const int slot = base + __popc(real & below);
        const float4 q = gt_boxes[static_cast<size_t>(b) * g + c * 32 + t];
        s_box[slot] = q;
        s_area[slot] = box_area(q);
        s_label[slot] = lab[c];
      }
      base += __popc(real);
    }
    if (t == 0) s_real = base;
  }
  __syncthreads();
  if (i >= n) return;

  const float area_a = box_area(a);
  const int real = s_real;
  float best = 0.0f;
  int kc = -1;  // slot of the match among the real gts; -1: row 0
  for (int j = 0; j < real; ++j) {
    const float4 q = s_box[j];
    const float iy0 = fmaxf(a.x, q.x);
    const float ix0 = fmaxf(a.y, q.y);
    const float iy1 = fminf(a.z, q.z);
    const float ix1 = fminf(a.w, q.w);
    const float inter = __fmul_rn(fmaxf(__fsub_rn(iy1, iy0), 0.0f),
                                  fmaxf(__fsub_rn(ix1, ix0), 0.0f));
    if (inter > 0.0f) {
      const float uni = __fsub_rn(__fadd_rn(area_a, s_area[j]), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, kEps));
      if (iou > best) {
        best = iou;
        kc = j;
      }
    }
  }
  const bool positive = g > 0 && best > iou_threshold;

  float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int32_t label = 0;
  if (positive) {
    // kc < 0 only where best is 0, so only below a negative threshold:
    // row 0 is read from device memory there
    const size_t row0 = static_cast<size_t>(b) * g;
    const float4 q = kc >= 0 ? s_box[kc] : gt_boxes[row0];
    label = kc >= 0 ? s_label[kc] : gt_labels[row0];
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
// deltas (B, N, 4) f32, labels (B, N) i32, all contiguous on `device`;
// launches on `stream` (a stream of `device`), switching the current
// device only if it differs. Returns a cudaError_t.
extern "C" int match_encode_launch(const void* anchors, const void* gt_boxes,
                                   const void* gt_labels, void* deltas,
                                   void* labels, int b, int n, int g,
                                   float iou_threshold, float v0, float v1,
                                   float v2, float v3, int device,
                                   void* stream) {
  if (b < 0 || n < 0 || g < 0 || g > kMaxG || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  match_encode_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(anchors),
      static_cast<const float4*>(gt_boxes),
      static_cast<const int32_t*>(gt_labels), static_cast<float4*>(deltas),
      static_cast<int32_t*>(labels), n, g, iou_threshold, v0, v1, v2, v3);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t restored = cudaSetDevice(current);
    if (err == cudaSuccess) err = restored;
  }
  return static_cast<int>(err);
}
