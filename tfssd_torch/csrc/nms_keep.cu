// Exact greedy NMS keep mask, one thread block per (image, class) instance.
//
// Replaces the JAX package's Pallas TPU kernel ops/kernels/nms_keep.py
// (nms_keep_pallas, body _kernel). Semantics, per instance r of R:
//   boxes (K, 4) f32 score-sorted corners, scores (K) f32, K <= 256
//   iou(i, j)   = inter / max(area_i + area_j - inter, 1e-8)
//   suppress    = iou(i, j) > iou_threshold for j > i (strictly later)
//   valid       = score > score_threshold
//   keep        = exact greedy: keep[j] = valid[j] and no kept i < j
//                 suppresses j
//
// What bounds it on the H100. The bytes, R*K*(16+4+1), take well under a
// microsecond at 3.35 TB/s, and the ~R*K^2/2 pairs at 15 float operations
// 0.7 us at R = 160 and 5.7 us at R = 1280 (K = 200) at 67 TFLOP/s. A pair
// costs more issue slots than float operations: the correctly rounded
// divide alone is a reciprocal, five FMAs, a range check and a branch,
// and the zero test and the selects add more. The mask loop
// issues 31.5-32.5 warp instructions per tile op (32 pairs) on its fast
// path, and an instance at K = 200 is 724 tile ops; at 132 SMs x 4
// schedulers x 1980 MHz that is 28-29 us of issue for R = 1280 and, with
// two of the 160 instances on 28 of the SMs, 5.8-5.9 us for R = 160
// (python -m tfssd_torch.profile_nms_keep, cuobjdump -sass of this build,
// on an NVIDIA H100 80GB HBM3 at 700 W). Instruction issue, not bytes or
// float operations, is the floor of this design.
//
// Design:
//   1. load: a thread per candidate reads its box, computes its area and
//      takes part in a warp ballot of valid bits; boxes past K are zero.
//   2. mask: the strict upper triangle is cut into 32 x 32 tiles (row
//      block bi <= column block bc; 28 at K = 200), dealt round-robin to
//      the block's 8 warps. In a tile, lane l holds column j's box in
//      registers and walks the tile's rows, four independent IoUs a step,
//      setting bit i of its column word where row i suppresses j: no
//      ballot, no store per row, one store per tile. A ragged last column
//      block of <= 16 candidates (8 at K = 200) packs 32 / 2^shift rows
//      into each warp instruction instead of idling lanes, and its lanes
//      OR their column words together by shuffles. Words of a diagonal
//      tile also hold i >= j: the scan never reads those bits.
//   3. scan: one warp solves the greedy recurrence block by block (the
//      forward substitution of the JAX package's ops/nms.py
//      _greedy_keep_blocked, 32-wide blocks). For block c, lane l ANDs
//      candidate 32c + l's column words with the kept bits of each earlier
//      block and one ballot gives the block's removed candidates; the
//      diagonal tile's 32 column words are then in registers, so the 32
//      dependent steps are register bit operations. The warp writes the
//      block's 32 keep bytes and goes on.
//
// Exactness: the keep mask equals the plain PyTorch version's bit for bit
// on finite boxes. The IoU is computed in the Pallas kernel's operation
// order with explicitly rounded intrinsics (__fsub_rn, __fmul_rn,
// __fadd_rn, fmaxf, fminf, and __fdiv_rn for the divide), so no
// multiply-add is contracted into an FMA; the build also passes
// -fmad=false and never fast math. Thresholds arrive as float and every
// comparison is in float. Every pair pays the IEEE divide, but where
// inter == 0 it divides 1 instead (a zero numerator takes the divide's
// slow path) and takes the quotient as 0: the true quotient is +-0 for
// every union, as the divisor is at least 1e-8, and +-0 compares with the
// threshold as 0 does, so the decision is the same.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 256;
constexpr int kBlock = 32;                  // scan block and tile side
constexpr int kMaxBlocks = kMaxK / kBlock;  // row blocks
constexpr int kWarps = 8;
constexpr int kRows = 4;  // independent warp instructions of a step
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % kBlock == 0, "whole warps");

struct Smem {
  float4 box[kMaxK];  // corners [y0, x0, y1, x1] as (x, y, z, w)
  float area[kMaxK];
  // mask[b][j]: bit i - 32b is whether row i of row block b suppresses
  // column j (j > i); bits of j <= i are computed but never read.
  uint32_t mask[kMaxBlocks][kMaxK];
  uint32_t valid[kMaxBlocks];
};

// One tile: the rows of row block bi against the columns of column block
// bc. Lane l owns column bc * 32 + (l mod 2^kShift) and walks rows
// l >> kShift, + 32 / 2^kShift, ... of the block; kShift = 5 is a full
// tile, 4 and 3 pack 2 and 4 rows into each warp instruction for a
// column block of <= 16 and <= 8 candidates.
template <int kShift>
__device__ __forceinline__ void mask_tile(Smem& sm, int bi, int bc, int k,
                                          int lane, float iou_threshold) {
  constexpr int kRowsPerOp = kBlock >> kShift;
  constexpr int kStep = kRows * kRowsPerOp;
  const int col = bc * kBlock + (lane & ((1 << kShift) - 1));
  const int sub = lane >> kShift;
  const float4 cb = sm.box[col];
  const float ca = sm.area[col];
  const int base = bi * kBlock;
  const int rows = min(k - base, kBlock);
  uint32_t bits = 0u;
  for (int i0 = 0; i0 < rows; i0 += kStep) {
    // kRows independent IoUs per step, so their loads and float chains
    // interleave; only the divides' range checks branch.
    bool zero[kRows];
    float num[kRows], den[kRows];
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const int i = base + i0 + g * kRowsPerOp + sub;
      const float4 rb = sm.box[i];
      const float iy0 = fmaxf(rb.x, cb.x);
      const float ix0 = fmaxf(rb.y, cb.y);
      const float iy1 = fminf(rb.z, cb.z);
      const float ix1 = fminf(rb.w, cb.w);
      const float inter = __fmul_rn(fmaxf(__fsub_rn(iy1, iy0), 0.0f),
                                    fmaxf(__fsub_rn(ix1, ix0), 0.0f));
      const float uni = __fsub_rn(__fadd_rn(sm.area[i], ca), inter);
      zero[g] = inter == 0.0f;
      // A zero numerator would take the divide's slow path: divide 1
      // instead and take the quotient as 0 below.
      num[g] = zero[g] ? 1.0f : inter;
      den[g] = fmaxf(uni, 1e-8f);
    }
    float q[kRows];
#pragma unroll
    for (int g = 0; g < kRows; ++g) q[g] = __fdiv_rn(num[g], den[g]);
    uint32_t step = 0u;
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const float iou = zero[g] ? 0.0f : q[g];
      if (iou > iou_threshold) step |= 1u << (g * kRowsPerOp);
    }
    bits |= step << (i0 + sub);
  }
  // The lanes that share a column hold its other rows.
#pragma unroll
  for (int m = 1 << kShift; m < kBlock; m <<= 1) {
    bits |= __shfl_xor_sync(kFull, bits, m);
  }
  if (lane < (1 << kShift)) sm.mask[bi][col] = bits;
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores,
                uint8_t* __restrict__ keep, int k, float iou_threshold,
                float score_threshold) {
  __shared__ __align__(16) Smem sm;

  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nb = (k + kBlock - 1) / kBlock;

  // 1. load
  for (int j = t; j < kMaxK; j += kThreads) {
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool valid = false;
    if (j < k) {
      const float* b = boxes + (static_cast<size_t>(r) * k + j) * 4;
      box = make_float4(b[0], b[1], b[2], b[3]);
      valid = scores[static_cast<size_t>(r) * k + j] > score_threshold;
    }
    sm.box[j] = box;
    sm.area[j] = __fmul_rn(fmaxf(__fsub_rn(box.z, box.x), 0.0f),
                           fmaxf(__fsub_rn(box.w, box.y), 0.0f));
    const uint32_t valid_bits = __ballot_sync(kFull, valid);
    if (lane == 0) sm.valid[j / kBlock] = valid_bits;
  }
  __syncthreads();

  // 2. mask
  const int tiles = nb * (nb + 1) / 2;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    int bi = 0;
    int rest = tile;
    while (rest >= nb - bi) {
      rest -= nb - bi;
      ++bi;
    }
    const int bc = bi + rest;
    const int width = min(k - bc * kBlock, kBlock);
    if (width > 16) {
      mask_tile<5>(sm, bi, bc, k, lane, iou_threshold);
    } else if (width > 8) {
      mask_tile<4>(sm, bi, bc, k, lane, iou_threshold);
    } else {
      mask_tile<3>(sm, bi, bc, k, lane, iou_threshold);
    }
  }
  __syncthreads();

  // 3. scan
  if (warp != 0) return;
  uint8_t* out = keep + static_cast<size_t>(r) * k;
  uint32_t kept[kMaxBlocks];
#pragma unroll
  for (int c = 0; c < kMaxBlocks; ++c) {
    if (c >= nb) break;
    // Lane l: is candidate 32c + l suppressed by a kept candidate of an
    // earlier block? Invalid candidates, and those past K, count as
    // removed.
    const int j = c * kBlock + lane;
    uint32_t hit = 0u;
#pragma unroll
    for (int b = 0; b < c; ++b) hit |= sm.mask[b][j] & kept[b];
    const uint32_t removed = __ballot_sync(kFull, hit != 0u) | ~sm.valid[c];
    // The diagonal tile's columns in registers: 32 dependent steps of
    // register bit operations.
    uint32_t diag[kBlock];
    const uint4* cols = reinterpret_cast<const uint4*>(&sm.mask[c][c * kBlock]);
#pragma unroll
    for (int q = 0; q < kBlock / 4; ++q) {
      const uint4 v = cols[q];
      diag[4 * q + 0] = v.x;
      diag[4 * q + 1] = v.y;
      diag[4 * q + 2] = v.z;
      diag[4 * q + 3] = v.w;
    }
    // alive holds the kept candidates i' < i of this block at step i.
    uint32_t alive = 0u;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) {
      if (!((removed >> i) & 1u) && !(diag[i] & alive)) alive |= 1u << i;
    }
    kept[c] = alive;
    if (j < k) out[j] = (alive >> lane) & 1u;
  }
}

}  // namespace

// boxes (R, K, 4) f32, scores (R, K) f32, keep (R, K) bytes, all
// contiguous on CUDA device `device`; launches on `stream` (a stream of that
// device), switching the calling thread's current device for the launch if
// it is another. Returns a cudaError_t.
extern "C" int nms_keep_launch(const void* boxes, const void* scores,
                               void* keep, int r, int k, float iou_threshold,
                               float score_threshold, int device,
                               void* stream) {
  if (r < 0 || k < 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0 || k == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_keep_kernel<<<r, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), k, iou_threshold, score_threshold);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t restored = cudaSetDevice(current);
    if (err == cudaSuccess) err = restored;
  }
  return static_cast<int>(err);
}
