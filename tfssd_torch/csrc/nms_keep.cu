// Exact greedy NMS keep mask, one thread block per (image, class) instance.
//
// Replaces the JAX package's Pallas TPU kernel ops/kernels/nms_keep.py
// (nms_keep_pallas, body _kernel). Semantics, per instance r of R:
//   boxes (K, 4) f32 score-sorted corners, scores (K) f32
//   iou(i, j)   = inter / max(area_i + area_j - inter, 1e-8)
//   suppress    = iou(i, j) > iou_threshold for j > i (strictly later)
//   valid       = score > score_threshold
//   keep        = exact greedy: keep[j] = valid[j] and no kept i < j
//                 suppresses j
//
// Design for Hopper (the Pallas kernel iterated a fixpoint because its grid
// programs run in order on one core; here blocks run in parallel):
//   1. the block loads its K <= 256 boxes into shared memory and computes
//      the areas;
//   2. thread i computes row i of the strict upper-triangular suppression
//      matrix as ceil(K/64) 64-bit words in shared memory (6.4 KB at
//      K = 200); the K x K IoU never leaves registers;
//   3. one warp runs the textbook greedy scan in score order: lane w holds
//      word w of the `removed` bitset, K steps, no data-dependent loop;
//   4. all threads write the K keep bytes.
// Bound on the H100: the bytes are R*K*(16+4+1), well under a microsecond;
// the ~R*K^2/2 IoUs at ~15 f32 operations are ~48 MFLOP at R = 160, also
// under a microsecond at the card's f32 rate. So a launch (a few
// microseconds) and the serial scan of step 3 (K dependent steps of one
// warp) bound it. One block per instance keeps every instance's scan
// running in parallel on its own SM.
//
// Exactness: the keep mask must equal the plain PyTorch version bit for
// bit. The IoU is computed in the operation order of the Pallas kernel
// with explicitly rounded intrinsics, so no multiply-add is contracted
// into an FMA; the build also passes -fmad=false and never fast math.
// Thresholds arrive as float and every comparison is in float.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 256;
constexpr int kWords = kMaxK / 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores,
                uint8_t* __restrict__ keep, int k, float iou_threshold,
                float score_threshold) {
  __shared__ float s_y0[kMaxK], s_x0[kMaxK], s_y1[kMaxK], s_x1[kMaxK];
  __shared__ float s_area[kMaxK];
  __shared__ unsigned long long s_mask[kMaxK * kWords];
  __shared__ uint8_t s_valid[kMaxK];
  __shared__ uint8_t s_keep[kMaxK];

  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int words = (k + 63) >> 6;
  const float* b = boxes + static_cast<size_t>(r) * k * 4;
  const float* s = scores + static_cast<size_t>(r) * k;

  if (t < k) {
    const float y0 = b[4 * t + 0], x0 = b[4 * t + 1];
    const float y1 = b[4 * t + 2], x1 = b[4 * t + 3];
    s_y0[t] = y0;
    s_x0[t] = x0;
    s_y1[t] = y1;
    s_x1[t] = x1;
    s_area[t] = __fmul_rn(fmaxf(__fsub_rn(y1, y0), 0.0f),
                          fmaxf(__fsub_rn(x1, x0), 0.0f));
    s_valid[t] = s[t] > score_threshold;
  }
  __syncthreads();

  if (t < k) {
    const float y0 = s_y0[t], x0 = s_x0[t], y1 = s_y1[t], x1 = s_x1[t];
    const float a = s_area[t];
    for (int w = 0; w < words; ++w) {
      unsigned long long bits = 0ull;
      const int j0 = w * 64;
      for (int jj = 0; jj < 64; ++jj) {
        const int j = j0 + jj;
        if (j <= t || j >= k) continue;
        const float iy0 = fmaxf(y0, s_y0[j]);
        const float ix0 = fmaxf(x0, s_x0[j]);
        const float iy1 = fminf(y1, s_y1[j]);
        const float ix1 = fminf(x1, s_x1[j]);
        const float inter = __fmul_rn(fmaxf(__fsub_rn(iy1, iy0), 0.0f),
                                      fmaxf(__fsub_rn(ix1, ix0), 0.0f));
        const float uni = __fsub_rn(__fadd_rn(a, s_area[j]), inter);
        const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-8f));
        if (iou > iou_threshold) bits |= 1ull << jj;
      }
      s_mask[t * kWords + w] = bits;
    }
  }
  __syncthreads();

  if (t < 32) {
    // Lane w < words holds word w of the removed set.
    unsigned long long removed = 0ull;
    for (int i = 0; i < k; ++i) {
      const unsigned long long word =
          __shfl_sync(0xffffffffu, removed, i >> 6);
      const bool alive = s_valid[i] && !((word >> (i & 63)) & 1ull);
      if (alive && t < words) removed |= s_mask[i * kWords + t];
      if (t == 0) s_keep[i] = alive;
    }
  }
  __syncthreads();

  if (t < k) keep[static_cast<size_t>(r) * k + t] = s_keep[t];
}

}  // namespace

// boxes (R, K, 4) f32, scores (R, K) f32, keep (R, K) bytes, all contiguous
// on the current device; launches on `stream`. Returns a cudaError_t.
extern "C" int nms_keep_launch(const void* boxes, const void* scores,
                               void* keep, int r, int k, float iou_threshold,
                               float score_threshold, void* stream) {
  if (r < 0 || k < 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0 || k == 0) return 0;
  nms_keep_kernel<<<r, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), k, iou_threshold, score_threshold);
  return static_cast<int>(cudaGetLastError());
}
