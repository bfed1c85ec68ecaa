// Grouped 3x3 convolution, padding 1, stride 1 or 2, in float32 with a
// folded bias and an optional ReLU in the epilogue: the 3x3 convs of
// RetinaNet's ResNeXt bottlenecks (models/retinanet.py:ConvBN).
//
// Replaces no TPU kernel: the JAX package has no RetinaNet. It replaces
// cuDNN's grouped kernels (conv2d_grouped_direct_kernel and
// implicit_convolve_sgemm) and the ReLU that followed them. Semantics, for
// x (N, C, H, W) and y (N, C, Ho, Wo) contiguous float32, C = G * CG
// channels in G groups of CG, weight (C, CG, 3, 3), bias (C):
//   y[n, o, i, j] = act(bias[o] + sum over the taps (kh, kw) in row-major
//     order, and within a tap over the group's input channels ci in order,
//     of x[n, g*CG + ci, S*i + kh - 1, S*j + kw - 1] * weight[o, ci, kh, kw])
// with g = o / CG, x zero outside the image, Ho = (H - 1) / S + 1 (and Wo
// alike), act the identity or ReLU. Each sum is one chain of correctly
// rounded fused multiply-adds (__fmaf_rn; the build passes -fmad=false, so
// nothing is contracted that is not written so), then the bias is added.
// No tensor cores and no TF32.
//
// What bounds it on the H100 (67 TFLOP/s float32, 3.35 TB/s). A conv makes
// 18 * CG operations an output and moves one input value an output at
// S = 1, four at S = 2, besides the output. RetinaNet's 16 at batch 8 do
// 2.949 GFLOP each, 44 us at the float32 peak; moving the input in and the
// output out once takes 98 us at CG = 4 (200x200, 164 + 164 MB), 122 / 49
// us at CG = 8 (200 -> 100 / 100x100) and 61 us at CG = 16, stride 2:
// those are memory-bound, the CG = 16 stride-1 and CG = 32 ones
// compute-bound. Summed over the 16, ~0.98 ms a request.
//
// Design. A block takes one group of one image and a band of output rows
// at full width:
//   1. load: the band's input rows with their halo (zeros outside the
//      image) and the group's weights go to shared memory by cp.async,
//      the input once from device memory (the halo rows again, from L2);
//      a stride-2 input row is stored as its even columns, then its odd
//      ones, so that neighbouring output columns read neighbouring words.
//   2. compute: each thread holds an RO x RP register tile: RO of the
//      group's output channels by RP pixels of the band (the band
//      flattened, a thread's pixels PT apart, so a warp's lanes read
//      neighbouring words and store to neighbouring addresses). For each
//      tap and input channel it reads RP input values and RO weights (one
//      address across the warp: a broadcast, as float4s) and makes RO * RP
//      FMAs; the channel loop is unrolled.
//   3. epilogue: the bias, the ReLU where asked, and coalesced stores of
//      each output channel's pixels; nothing else is written.
// The register tile and the band follow the group width and the stride
// (launch_stride): measured on the H100 at the seven shapes above, over
// register tiles of 2-8 pixels by 4-32 channels, bands of 1-25 rows,
// 32-512 pixel threads, one or two groups a block, launch bounds of 128-512
// threads and channel unrolls of 4 to CG, the best reached 2.6 ms a
// request against cuDNN's 16.3 ms: ~37% of the bound, each conv at 12-24
// TFLOP/s or 1.0-1.8 TB/s. Block-wide load then compute leaves each
// block's load latency to the other blocks on its SM to cover.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // bytes a block can use on sm_90
constexpr int kDevices = 64;      // devices whose attribute is remembered

struct Shape {
  int c, h, w, ho, wo;  // channels; input and output sides
  int th, pt;           // output rows a band; pixel threads an RO chunk
  int relu;
};

// Columns of a band's smem row: padded input columns 0 .. (Wo-1)*S + 2.
template <int S>
__host__ __device__ __forceinline__ int row_columns(int wo) {
  return (wo - 1) * S + 3;
}

// Words of a smem row (S = 2: even columns, then odd ones).
template <int S>
__host__ __device__ __forceinline__ int row_pitch(int wo) {
  const int cols = row_columns<S>(wo);
  return S == 1 ? cols : 2 * ((cols + 1) / 2);
}

template <int S>
__host__ __device__ __forceinline__ int band_rows(int th) {
  return (th - 1) * S + 3;
}

template <int CG, int S>
size_t smem_bytes(const Shape& s) {
  return (static_cast<size_t>(9) * CG * CG +
          static_cast<size_t>(CG) * band_rows<S>(s.th) * row_pitch<S>(s.wo)) *
         sizeof(float);
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes a zero and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

template <int CG, int S, int RO, int RP>
__global__ void __launch_bounds__(kMaxThreads)
    grouped_conv3x3_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ y, Shape s) {
  static_assert(CG % RO == 0 && RO % 4 == 0, "whole float4s of weights");
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.z;
  const int g = blockIdx.y;
  const int h0 = blockIdx.x * s.th;
  const int rows = min(s.th, s.ho - h0);
  const int cols = row_columns<S>(s.wo);
  const int pitch = row_pitch<S>(s.wo);
  const int half = pitch / 2;
  const int brows = band_rows<S>(s.th);
  const int plane = brows * pitch;
  float* ws = smem;                // [tap][ci][o]
  float* xs = smem + 9 * CG * CG;  // [ci][brows][pitch]

  // 1. load
  const float* wg = w + static_cast<size_t>(g) * CG * CG * 9;
  for (int i = threadIdx.x; i < CG * CG * 9; i += blockDim.x) {
    const int t = i % 9;  // global order (o, ci, t)
    const int ci = (i / 9) % CG;
    const int o = i / (9 * CG);
    copy4(ws + (t * CG + ci) * CG + o, wg + i, true);
  }
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const size_t hw = static_cast<size_t>(s.h) * s.w;
  const float* xg = x + (static_cast<size_t>(n) * s.c +
                         static_cast<size_t>(g) * CG) * hw;
  for (int row = threadIdx.x >> 5; row < CG * brows; row += warps) {
    const int ci = row / brows;
    const int r = row - ci * brows;
    const int ih = h0 * S - 1 + r;
    const bool row_ok = ih >= 0 && ih < s.h;
    const float* src = xg + ci * hw + static_cast<size_t>(row_ok ? ih : 0) *
                                          s.w;
    float* dst = xs + ci * plane + r * pitch;
    for (int c = lane; c < cols; c += 32) {
      const int iw = c - 1;
      const bool ok = row_ok && iw >= 0 && iw < s.w;
      copy4(dst + (S == 1 ? c : (c & 1) * half + (c >> 1)), ok ? src + iw : x,
            ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // 2. compute
  const int pl = threadIdx.x % s.pt;
  const int chunk = threadIdx.x / s.pt;
  if (chunk >= CG / RO) return;
  const float* wl = ws + chunk * RO;
  const int pixels = rows * s.wo;
  const int o0 = g * CG + chunk * RO;
  const size_t out_plane = static_cast<size_t>(s.ho) * s.wo;
  float* yb = y + (static_cast<size_t>(n) * s.c + o0) * out_plane +
              static_cast<size_t>(h0) * s.wo;
  for (int base = pl; base < pixels; base += s.pt * RP) {
    int off[RP];
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const int p = base + j * s.pt;
      const int q = p < pixels ? p : base;
      const int oh = q / s.wo;
      off[j] = oh * S * pitch + (q - oh * s.wo);
    }
    float acc[RO][RP];
#pragma unroll
    for (int o = 0; o < RO; ++o) {
#pragma unroll
      for (int j = 0; j < RP; ++j) acc[o][j] = 0.0f;
    }
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int kh = t / 3;
      const int kw = t - 3 * kh;
      const int tap = kh * pitch + (S == 1 ? kw : (kw == 1 ? half : kw >> 1));
      const float* src[RP];
#pragma unroll
      for (int j = 0; j < RP; ++j) src[j] = xs + tap + off[j];
      const float* wt = wl + t * CG * CG;
#pragma unroll
      for (int ci = 0; ci < CG; ++ci) {
        float v[RP];
#pragma unroll
        for (int j = 0; j < RP; ++j) v[j] = src[j][ci * plane];
        float wv[RO];
#pragma unroll
        for (int q = 0; q < RO / 4; ++q) {
          const float4 f =
              *reinterpret_cast<const float4*>(wt + ci * CG + 4 * q);
          wv[4 * q] = f.x;
          wv[4 * q + 1] = f.y;
          wv[4 * q + 2] = f.z;
          wv[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int o = 0; o < RO; ++o) {
#pragma unroll
          for (int j = 0; j < RP; ++j) {
            acc[o][j] = __fmaf_rn(v[j], wv[o], acc[o][j]);
          }
        }
      }
    }
    // 3. epilogue
#pragma unroll
    for (int o = 0; o < RO; ++o) {
      const float b = bias[o0 + o];
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int p = base + j * s.pt;
        if (p < pixels) {
          float r = __fadd_rn(acc[o][j], b);
          // as F.relu: a NaN stays NaN
          if (s.relu && r < 0.0f) r = 0.0f;
          yb[o * out_plane + p] = r;
        }
      }
    }
  }
}

// One launch of the <CG, S, RO, RP> kernel with bands of about `pixels`
// output pixels (whole rows, at least one, fewer where shared memory would
// not hold them) and up to `pt` pixel threads an RO chunk (whole warps, no
// more than one pass of RP pixels each needs); a cudaError_t.
template <int CG, int S, int RO, int RP>
int launch_tile(const float* x, const float* w, const float* b, float* y,
                int n, Shape s, int pixels, int pt, int device,
                cudaStream_t stream) {
  s.th = std::max(1, std::min(s.ho, pixels / s.wo));
  while (s.th > 1 && smem_bytes<CG, S>(s) > static_cast<size_t>(kMaxSmem)) {
    --s.th;
  }
  s.pt = std::min(pt, ((s.th * s.wo + RP - 1) / RP + 31) / 32 * 32);
  const int threads = (CG / RO) * s.pt;
  const size_t smem = smem_bytes<CG, S>(s);
  if (threads > kMaxThreads || smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // Above 48 KB the kernel has to be allowed its dynamic shared memory:
  // once a device for each instantiation, to the largest size.
  static bool allowed[kDevices] = {};
  if (smem > 48 * 1024 && !(device < kDevices && allowed[device])) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_conv3x3_kernel<CG, S, RO, RP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kDevices) allowed[device] = true;
  }
  const dim3 grid((s.ho + s.th - 1) / s.th, s.c / CG, n);
  grouped_conv3x3_kernel<CG, S, RO, RP>
      <<<grid, threads, smem, stream>>>(x, w, b, y, s);
  return static_cast<int>(cudaGetLastError());
}

// The register tile and the band of each group width and stride, the best
// of the measurements in the header (each within 8% of the best tile of
// its shape): at 4, all 4 outputs by 8 pixels, bands of ~2,000 pixels; at
// 8, all 8 by 2 pixels, ~2,000 at stride 1 and ~500 at 2; at 16 and 32, 8
// outputs by 4 pixels, bands of ~500-650 (16) and a whole 25x25 map or
// half of it (32), so that the 25x25 and 50x50 stages still give every SM
// blocks.
template <int S>
int launch_stride(const float* x, const float* w, const float* b, float* y,
                  int n, int cg, const Shape& s, int device,
                  cudaStream_t stream) {
  switch (cg) {
    case 4:
      return launch_tile<4, S, 4, 8>(x, w, b, y, n, s, 2000, 128, device,
                                     stream);
    case 8:
      return launch_tile<8, S, 8, 2>(x, w, b, y, n, s, S == 1 ? 2000 : 500,
                                     S == 1 ? 512 : 256, device, stream);
    case 16:
      return launch_tile<16, S, 8, 4>(x, w, b, y, n, s, S == 1 ? 500 : 650,
                                      192, device, stream);
    case 32:
      return launch_tile<32, S, 8, 4>(x, w, b, y, n, s, S == 1 ? 625 : 325,
                                      96, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (n, c, h, w), w (c, cg, 3, 3), b (c), y (n, c, ho, wo): contiguous
// float32 on `device`; cg 4, 8, 16 or 32; stride 1 or 2. Returns a
// cudaError_t; launches nothing on invalid arguments.
extern "C" int grouped_conv3x3_launch(const void* x, const void* w,
                                      const void* b, void* y, int n, int c,
                                      int h, int wd, int cg, int stride,
                                      int relu, int device, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0 || cg <= 0 || c % cg != 0 ||
      c / cg > 65535 || (stride != 1 && stride != 2) || device < 0 ||
      n > 65535 || static_cast<long long>(n) * c * h * wd > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{c, h, wd, (h - 1) / stride + 1, (wd - 1) / stride + 1,
                0, 0, relu ? 1 : 0};
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code = stride == 1
                 ? launch_stride<1>(xf, wf, bf, yf, n, cg, s, device, st)
                 : launch_stride<2>(xf, wf, bf, yf, n, cg, s, device, st);
  if (current != device) {
    const cudaError_t restored = cudaSetDevice(current);
    if (code == 0) code = static_cast<int>(restored);
  }
  return code;
}
