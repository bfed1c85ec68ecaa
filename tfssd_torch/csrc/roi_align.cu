// Multi-level RoIAlign (torchvision's roi_align forward, aligned=False), one
// thread block per box, all of a call's boxes in one launch.
//
// Replaces no TPU kernel: the JAX package has no Mask R-CNN, and PyTorch has
// no op that computes RoIAlign. Semantics, for box r of image b (r < K) at
// level l = levels[b, r] (clamped into [0, L)) of the L maps (B, C, H_l,
// W_l) float32, with scale s_l, P x P bins of S x S samples:
//   start = box * s_l (x0, y0), end = box * s_l (x1, y1);
//   extent = max(end - start, 1); bin = extent / P;
//   y = start_y + ph * bin_h + (iy + 0.5) * bin_h / S (x likewise);
//   a sample with y < -1, y > H, x < -1 or x > W reads 0; else y <= 0 is
//   taken as 0, the low index is (int) y, and a low index at H - 1 or past
//   it reads row H - 1 alone (x likewise); the four corners are weighted
//   (1 - ly)(1 - lx), (1 - ly) lx, ly (1 - lx), ly lx and summed in that
//   order; out[b, r, c, ph, pw] = (the S x S samples summed in row order)
//   / S^2.
// Every operation is rounded on its own, in torchvision's order (explicit
// intrinsics, and the build passes -fmad=false), so the result equals the
// plain PyTorch version's (ops/kernels/roi_align.py) bit for bit.
//
// What bounds it on the H100. A box's outputs are C * P * P floats (50 KB
// at 256 x 7 x 7, 200 KB at 256 x 14 x 14), written once: Mask R-CNN's
// request at batch 8 writes 401 MB for its 8,000 box-head boxes and 161 MB
// for its 800 mask-head boxes, ~0.17 ms at 3.35 TB/s. Each output reads
// 4 S^2 = 16 map values, but those of one box lie in a window of its level
// a few times the box's size, so after the first read they come from L1
// and L2: the operations (~33 a output) and the writes set the pace.
//
// Design. The block first computes its box's P * P * S * S samples (the
// four corners' offsets in the map and their weights, or all zero where
// the sample lies outside) into shared memory, once for all C channels.
// Then its threads walk the box's C * P * P outputs in order, thread t
// taking outputs t, t + blockDim, ...: a warp's 32 outputs are consecutive
// bins of a channel (coalesced writes), whose samples read neighbouring
// values of one plane of the map.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 784;  // 14 x 14 bins of 2 x 2

struct Levels {
  const float* map[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
  int count;
};

struct Sample {
  int pos[4];
  float w[4];
};

// One axis of a sample: the low and high index and the two weights, or
// `outside`.
__device__ __forceinline__ void axis(float at, int size, int& low, int& high,
                                     float& w_low, float& w_high,
                                     bool& outside) {
  outside = at < -1.0f || at > static_cast<float>(size);
  if (at <= 0.0f) at = 0.0f;
  low = static_cast<int>(at);
  if (low >= size - 1) {
    high = low = size - 1;
    at = static_cast<float>(low);
  } else {
    high = low + 1;
  }
  w_high = __fsub_rn(at, static_cast<float>(low));
  w_low = __fsub_rn(1.0f, w_high);
}

__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Levels levels, const float* __restrict__ boxes,
                 const int64_t* __restrict__ box_levels, int k, int c, int p,
                 int s, float* __restrict__ out) {
  __shared__ Sample samples[kMaxSamples];

  const int r = blockIdx.x;  // b * k + box
  const int b = r / k;
  int64_t lv = box_levels[r];
  lv = lv < 0 ? 0 : (lv >= levels.count ? levels.count - 1 : lv);
  const int l = static_cast<int>(lv);
  const int h = levels.height[l];
  const int w = levels.width[l];
  const float scale = levels.scale[l];
  const float* box = boxes + static_cast<size_t>(r) * 4;
  const float x0 = __fmul_rn(box[0], scale);
  const float y0 = __fmul_rn(box[1], scale);
  const float x1 = __fmul_rn(box[2], scale);
  const float y1 = __fmul_rn(box[3], scale);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x1, x0), 1.0f),
                                static_cast<float>(p));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y1, y0), 1.0f),
                                static_cast<float>(p));
  const float grid = static_cast<float>(s);

  // Sample (ph, iy, pw, ix) at ((ph * s + iy) * p + pw) * s + ix.
  const int n = p * p * s * s;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ix = i % s;
    const int pw = (i / s) % p;
    const int iy = (i / (s * p)) % s;
    const int ph = i / (s * p * s);
    const float yy = __fadd_rn(
        __fadd_rn(y0, __fmul_rn(static_cast<float>(ph), bin_h)),
        __fdiv_rn(__fmul_rn(static_cast<float>(iy) + 0.5f, bin_h), grid));
    const float xx = __fadd_rn(
        __fadd_rn(x0, __fmul_rn(static_cast<float>(pw), bin_w)),
        __fdiv_rn(__fmul_rn(static_cast<float>(ix) + 0.5f, bin_w), grid));
    int y_lo, y_hi, x_lo, x_hi;
    float hy, ly, hx, lx;
    bool y_out, x_out;
    axis(yy, h, y_lo, y_hi, hy, ly, y_out);
    axis(xx, w, x_lo, x_hi, hx, lx, x_out);
    Sample smp;
    if (y_out || x_out) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        smp.pos[q] = 0;
        smp.w[q] = 0.0f;
      }
    } else {
      smp.pos[0] = y_lo * w + x_lo;
      smp.pos[1] = y_lo * w + x_hi;
      smp.pos[2] = y_hi * w + x_lo;
      smp.pos[3] = y_hi * w + x_hi;
      smp.w[0] = __fmul_rn(hy, hx);
      smp.w[1] = __fmul_rn(hy, lx);
      smp.w[2] = __fmul_rn(ly, hx);
      smp.w[3] = __fmul_rn(ly, lx);
    }
    samples[i] = smp;
  }
  __syncthreads();

  const float* map = levels.map[l] + static_cast<size_t>(b) * c * h * w;
  const int bins = p * p;
  const int total = c * bins;
  const float count = static_cast<float>(s * s);
  float* dst = out + static_cast<size_t>(r) * total;
  for (int o = threadIdx.x; o < total; o += kThreads) {
    const int ch = o / bins;
    const int bin = o - ch * bins;
    const int ph = bin / p;
    const int pw = bin - ph * p;
    const float* plane = map + static_cast<size_t>(ch) * h * w;
    float acc = 0.0f;
    for (int iy = 0; iy < s; ++iy) {
      for (int ix = 0; ix < s; ++ix) {
        const Sample& smp = samples[((ph * s + iy) * p + pw) * s + ix];
        float term = __fmul_rn(smp.w[0], __ldg(plane + smp.pos[0]));
        term = __fadd_rn(term, __fmul_rn(smp.w[1], __ldg(plane + smp.pos[1])));
        term = __fadd_rn(term, __fmul_rn(smp.w[2], __ldg(plane + smp.pos[2])));
        term = __fadd_rn(term, __fmul_rn(smp.w[3], __ldg(plane + smp.pos[3])));
        acc = __fadd_rn(acc, term);
      }
    }
    dst[o] = __fdiv_rn(acc, count);
  }
}

}  // namespace

// maps: `n_levels` pointers to (B, C, H_l, W_l) float32 maps of CUDA device
// `device`, with heights, widths and scales (host arrays of n_levels);
// boxes (B, K, 4) float32 and box_levels (B, K) int64 on the device;
// out (B, K, C, P, P) float32. Launches on `stream`, switching the calling
// thread's current device for the launch if it is another. Returns a
// cudaError_t.
extern "C" int roi_align_launch(const void* const* maps, const int* heights,
                                const int* widths, const float* scales,
                                int n_levels, const void* boxes,
                                const void* box_levels, void* out, int b,
                                int k, int c, int p, int s, int device,
                                void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || b < 0 || k < 0 || c < 0 ||
      p < 1 || s < 1 || p * p * s * s > kMaxSamples || device < 0 ||
      static_cast<long long>(b) * k > 0x7fffffffLL ||
      static_cast<long long>(c) * p * p > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  for (int i = 0; i < n_levels; ++i) {
    if (heights[i] < 1 || widths[i] < 1 ||
        static_cast<long long>(heights[i]) * widths[i] > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    lv.map[i] = static_cast<const float*>(maps[i]);
    lv.height[i] = heights[i];
    lv.width[i] = widths[i];
    lv.scale[i] = scales[i];
  }
  lv.count = n_levels;
  if (b == 0 || k == 0 || c == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  roi_align_kernel<<<b * k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(boxes),
      static_cast<const int64_t*>(box_levels), k, c, p, s,
      static_cast<float*>(out));
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t restored = cudaSetDevice(current);
    if (err == cudaSuccess) err = restored;
  }
  return static_cast<int>(err);
}
