// Dense (groups 1) 1x1 or 3x3 convolution, padding k / 2, stride 1 or 2,
// NCHW float32, as an implicit GEMM with the folded bias, an optional
// shortcut add and an optional ReLU in the epilogue: the trunk convs of
// ResNet and ResNeXt bottlenecks after the stem (models/retinanet.py:
// ConvBN; 52 a Mask R-CNN predict, 36 a RetinaNet one).
//
// Replaces no TPU kernel: the JAX package has no ResNet trunk. It replaces
// cuDNN's float32 implicit-GEMM and FFT convolutions and the bias, shortcut
// add and ReLU passes that followed them. Semantics, for x (N, C, H, W),
// weight (M, C, KS, KS), bias (M), shortcut and y (N, M, Ho, Wo), all
// contiguous float32:
//   y[n, o, i, j] = act(bias[o] + sum over k = (ci * KS + kh) * KS + kw in
//     ascending order of x[n, ci, S*i + kh - P, S*j + kw - P] *
//     weight[o, ci, kh, kw]  [+ shortcut[n, o, i, j]])
// with P = KS / 2, x zero outside the image, Ho = (H - 1) / S + 1 (Wo
// alike), act the identity or ReLU. Each sum is one chain of correctly
// rounded fused multiply-adds from zero (__fmaf_rn; the build passes
// -fmad=false, so nothing is contracted that is not written so); then the
// bias is added, then the shortcut. No tensor cores, no TF32, no atomics:
// a result is the same from run to run.
//
// What bounds it on the H100 (67 TFLOP/s float32 FMA, 3.35 TB/s). As a
// GEMM, M = output channels, N = output pixels (N x Ho x Wo), K = C KS KS:
// 2 M N K operations against (M K + C H W N + 2 M N) words. Mask R-CNN's
// 52 at batch 8 on 800x1088 frames do 1,101.6 GFLOP (16.4 ms at the peak);
// the layer1 1x1s at 64 channels make ~25 operations a byte, near the
// ridge (~20), every other shape is compute-bound. So the design is a
// float32 GEMM's, and the epilogue takes the elementwise passes with it.
//
// Design. A block of 128 threads computes a 64 x 128 tile of (M, N); the
// K loop runs in steps of 8 through a 4-stage cp.async ring in shared
// memory:
//   A (weights): rows of K, each thread's copies 4 bytes, stored k-major
//     (padded: each 8-row step's stores fall on 32 banks) so that the
//     compute reads 4 channels as one float4.
//   B (the im2col of x, made on the fly): for a 1x1 conv at stride 1 on
//     planes whose size is a multiple of 4, 16-byte copies of 4 pixels;
//     else 4-byte copies, zero-filled (src-size 0) for the halo, the
//     ragged end of N and of K. A thread keeps one pixel (or one group of
//     4) for the whole K loop, so its image, row and column and the taps
//     that fall inside the image (a 9-bit mask) are computed once; a tile
//     may cross images.
//   compute: each thread holds an 8 x 8 register tile (two 4-row by two
//     4-column blocks, half a tile apart), read as float4s from shared
//     memory: 64 FMAs for 4 shared loads a K row.
//   epilogue: the bias, the shortcut, the ReLU, and float4 stores where a
//     plane's size is a multiple of 4 (scalar ones else); nothing else is
//     written.
// One tile serves every shape: the smallest grids (Mask R-CNN's layer4
// convs with 512 outputs, 8 x 54 blocks) are 0.8 of a wave on 132 SMs at
// 4 blocks each, and every other grid is a wave or more. Measured on
// the H100 at the 39 trunk shapes of maskrcnn-serve-b8 and
// retina800-serve-b8 (batch 8): 64 x 128 summed 31.50 ms over Mask
// R-CNN's 52 convs and 19.83 ms over RetinaNet's 36; choosing among
// 128 x 128, 64 x 128 and 128 x 64 by the shape saved at most 0.5 ms and
// 0.0 ms of them. K steps of 16 and rings of 2-5 stages moved the sums by
// under 3%. Splitting K into 2-4 chunks summed by a second pass, for the
// small grids of layer3 and layer4, cost the kernel 40-56 bytes of
// register spills and made every shape slower.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;     // output channels a block
constexpr int kBN = 128;    // output pixels a block
constexpr int kThreads = kBM * kBN / 64;
constexpr int kBK = 8;      // K rows a stage
constexpr int kStages = 4;  // depth of the cp.async ring

struct Shape {
  int n, c, h, w;  // input
  int m, ho, wo;   // output channels and sides
  int k;           // C * KS * KS
  int npix;        // N * Ho * Wo
  int relu;
  int vec_out;     // Ho * Wo a multiple of 4 and y, shortcut 16-byte aligned
};

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes a zero and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float finish(float acc, float b, float r,
                                        bool has_res, int relu) {
  float v = __fadd_rn(acc, b);
  if (has_res) v = __fadd_rn(v, r);
  // as F.relu: a NaN stays NaN
  if (relu && v < 0.0f) v = 0.0f;
  return v;
}

template <int KS, int S, bool VEC>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
    dense_conv_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ res,
                      float* __restrict__ y, Shape s) {
  constexpr int KK = KS * KS;
  constexpr int AP = kBM + 4;             // A's row pitch in shared memory
  constexpr int A_STEP = kThreads / kBK;  // rows between a thread's A copies
  constexpr int A_PER = kBM / A_STEP;
  static_assert(kThreads % kBN == 0 || VEC, "a pixel a thread");
  __shared__ __align__(16) float As[kStages][kBK][AP];
  __shared__ __align__(16) float Bs[kStages][kBK][kBN];

  const int tid = threadIdx.x;
  const int mtiles = (s.m + kBM - 1) / kBM;
  const int m0 = static_cast<int>(blockIdx.x % mtiles) * kBM;
  const int n0 = static_cast<int>(blockIdx.x / mtiles) * kBN;
  const int hw = s.h * s.w;
  const int howo = s.ho * s.wo;

  // A: the thread copies column akk of rows am + i * A_STEP.
  const int akk = tid % kBK;
  const int am = tid / kBK;

  // B: the thread's pixel (VEC: its group of 4) and first row.
  int bcol, brow, bbase;
  unsigned bmask = 0;
  if constexpr (VEC) {
    constexpr int CPR = kBN / 4;
    bcol = (tid % CPR) * 4;
    brow = tid / CPR;
    const int p = n0 + bcol;
    bbase = 0;
    if (p < s.npix) {
      const int img = p / hw;
      bbase = img * s.c * hw + (p - img * hw);
      bmask = 1;
    }
  } else {
    bcol = tid % kBN;
    brow = tid / kBN;
    const int p = n0 + bcol;
    bbase = 0;
    if (p < s.npix) {
      const int img = p / howo;
      const int q = p - img * howo;
      const int oh = q / s.wo;
      const int ih0 = oh * S - KS / 2;
      const int iw0 = (q - oh * s.wo) * S - KS / 2;
      bbase = img * s.c * hw + ih0 * s.w + iw0;
#pragma unroll
      for (int t = 0; t < KK; ++t) {
        const int ih = ih0 + t / KS;
        const int iw = iw0 + t % KS;
        if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w) bmask |= 1u << t;
      }
    }
  }

  auto load = [&](int slot, int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int m = m0 + am + i * A_STEP;
      const int k = k0 + akk;
      const bool ok = m < s.m && k < s.k;
      copy4(&As[slot][akk][am + i * A_STEP],
            ok ? w + static_cast<size_t>(m) * s.k + k : w, ok);
    }
    if constexpr (VEC) {
      constexpr int RSTEP = kThreads / (kBN / 4);
#pragma unroll
      for (int j = 0; j < kBK / RSTEP; ++j) {
        const int r = brow + j * RSTEP;
        const int k = k0 + r;
        const bool ok = bmask && k < s.k;
        copy16(&Bs[slot][r][bcol], ok ? x + (bbase + k * hw) : x, ok);
      }
    } else {
      constexpr int RSTEP = kThreads / kBN;
#pragma unroll
      for (int j = 0; j < kBK / RSTEP; ++j) {
        const int r = brow + j * RSTEP;
        const int k = k0 + r;
        const int ci = k / KK;
        const int t = k - ci * KK;
        const bool ok = k < s.k && ((bmask >> t) & 1u);
        copy4(&Bs[slot][r][bcol],
              ok ? x + (bbase + ci * hw + (t / KS) * s.w + t % KS) : x, ok);
      }
    }
  };

  const int ty = tid / (kBN / 8);
  const int tx = tid % (kBN / 8);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  const int ktiles = (s.k + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) load(st, st * kBK);
    commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < ktiles; ++kt) {
    wait_group<kStages - 2>();
    __syncthreads();
    // the slot computed one step ago: every thread has left it
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next % kStages, next * kBK);
    commit();
    const int slot = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[slot][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[slot][kk][kBM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[slot][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[slot][kk][kBN / 2 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
        }
      }
    }
  }
  wait_group<0>();

  // epilogue
  const bool has_res = res != nullptr;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c0 = n0 + g * (kBN / 2) + tx * 4;
    if (s.vec_out) {
      if (c0 >= s.npix) continue;
      const int img = c0 / howo;
      const int off = img * s.m * howo + (c0 - img * howo);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i < 4 ? ty * 4 + i : kBM / 2 + ty * 4 + i - 4);
        if (m >= s.m) continue;
        const float b = bias[m];
        const int o = off + m * howo;
        float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (has_res) r = __ldg(reinterpret_cast<const float4*>(res + o));
        float4 v;
        v.x = finish(acc[i][g * 4], b, r.x, has_res, s.relu);
        v.y = finish(acc[i][g * 4 + 1], b, r.y, has_res, s.relu);
        v.z = finish(acc[i][g * 4 + 2], b, r.z, has_res, s.relu);
        v.w = finish(acc[i][g * 4 + 3], b, r.w, has_res, s.relu);
        *reinterpret_cast<float4*>(y + o) = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = c0 + j;
        if (p >= s.npix) continue;
        const int img = p / howo;
        const int off = img * s.m * howo + (p - img * howo);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = m0 + (i < 4 ? ty * 4 + i : kBM / 2 + ty * 4 + i - 4);
          if (m >= s.m) continue;
          const int o = off + m * howo;
          y[o] = finish(acc[i][g * 4 + j], bias[m],
                        has_res ? __ldg(res + o) : 0.0f, has_res, s.relu);
        }
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, float*, Shape);

// The kernel for a kernel size, stride and B copy width.
Kernel kernel_for(int ks, int stride, bool vec) {
  if (ks == 1) {
    if (stride == 2) return dense_conv_kernel<1, 2, false>;
    return vec ? dense_conv_kernel<1, 1, true> : dense_conv_kernel<1, 1, false>;
  }
  return stride == 1 ? dense_conv_kernel<3, 1, false>
                     : dense_conv_kernel<3, 2, false>;
}

}  // namespace

// x (n, c, h, w), w (m, c, ks, ks), b (m), res (n, m, ho, wo) or null,
// y (n, m, ho, wo): contiguous float32 on `device`; ks 1 or 3, padding
// ks / 2, stride 1 or 2; relu 0 or 1. Returns a cudaError_t; launches
// nothing on invalid arguments.
extern "C" int dense_conv_launch(const void* x, const void* w, const void* b,
                                 const void* res, void* y, int n, int c,
                                 int h, int wd, int m, int ks, int stride,
                                 int relu, int device, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0 || m <= 0 ||
      (ks != 1 && ks != 3) || (stride != 1 && stride != 2) || device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = (h - 1) / stride + 1;
  const int wo = (wd - 1) / stride + 1;
  const long long in_words = static_cast<long long>(n) * c * h * wd;
  const long long out_words = static_cast<long long>(n) * m * ho * wo;
  if (in_words > INT_MAX || out_words > INT_MAX ||
      static_cast<long long>(c) * ks * ks > INT_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_in = ks == 1 && stride == 1 && (h * wd) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = (ho * wo) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(res) % 16 == 0;
  const Shape s{n, c, h, wd, m, ho, wo, c * ks * ks, n * ho * wo,
                relu ? 1 : 0, vec_out ? 1 : 0};
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>((m + kBM - 1) / kBM) *
                           ((s.npix + kBN - 1) / kBN);
  int code;
  if (blocks > INT_MAX) {
    code = static_cast<int>(cudaErrorInvalidValue);
  } else {
    Kernel fn = kernel_for(ks, stride, vec_in);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* bf = static_cast<const float*>(b);
    const float* rf = static_cast<const float*>(res);
    float* yf = static_cast<float*>(y);
    void* args[] = {&xf, &wf, &bf, &rf, &yf, const_cast<Shape*>(&s)};
    code = static_cast<int>(cudaLaunchKernel(
        reinterpret_cast<const void*>(fn), dim3(static_cast<unsigned>(blocks)),
        dim3(kThreads), args, 0,
        static_cast<cudaStream_t>(stream)));
    if (code == 0) code = static_cast<int>(cudaGetLastError());
  }
  if (current != device) {
    const cudaError_t restored = cudaSetDevice(current);
    if (code == 0) code = static_cast<int>(restored);
  }
  return code;
}
