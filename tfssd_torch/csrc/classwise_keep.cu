// Class-wise exact greedy NMS keep, one thread block per (image, class),
// walking the class's candidates in rows of up to 256.
//
// Replaces no TPU kernel: the JAX package has no RetinaNet. It replaces
// the 20 static passes of ops/nms.py:classwise_nms's first version (each
// pass a gather, an elementwise IoU against the class's earlier rows and
// one tfssd::nms_keep launch), so RetinaNet's keep is one launch whose
// depth follows the request. Semantics, per image b of B and class c of C:
//   boxes (B, T, 4) f32 corners and scores (B, T) f32, each image's
//     candidates ordered class by class, by score within a class;
//   counts, starts (B, C) int64 (row stride `stride`): class c of image b
//     holds positions starts[b, c] .. starts[b, c] + counts[b, c] - 1, of
//     which the first min(count, bound) take part: `bound` is the caller's
//     static bound on a class's count (T where it knows none; Mask R-CNN's
//     box stage has T = 90,000 pairs an image, at most 1,000 in a class);
//   keep (B, T) bytes, zero on entry; for each class's candidate j,
//     keep[j] = valid[j] and no kept candidate i < j of the class has
//     iou(i, j) > iou_threshold; valid = score > score_threshold, iou as in
//     csrc/nms_keep.cu (union clamped at 1e-8).
//
// What bounds it on the H100. The bytes, B*T*(16+4+1) and two int64 a
// class, are under a microsecond; greedy NMS needs at most the class's
// n(n-1)/2 IoUs, 15 float operations each. But a class is one block on
// one SM, and the rows of a class depend on each other, so a class that
// holds most of the T candidates sets the time: one SM running ~42
// warp instructions per 32 IoUs (the correctly rounded divide alone is a
// reciprocal, five FMAs, a range check and a branch, and the four divides
// of a step are serialised by their branches), over the pairs the walk
// computes. At the benchmark's request (B = 8, T = 5,000, C = 264, the
// largest class 807) a launch takes ~74 us; with all 5,000 candidates of
// each image in one class ~1.2 ms, nine tenths of it in step 2 (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md).
//
// Design, for each row of the class in order:
//   1. load: a thread per candidate reads its box and computes its area;
//      warp ballots give the row's valid bits.
//   2. earlier rows: each valid candidate is tested against the boxes kept
//      so far in the class, compacted in dynamic shared memory (16 B a
//      box, at most T - 1). The row's 32-wide blocks are dealt to the
//      block's warps, and where the row has fewer than 16 blocks of 32
//      candidates the warps of a block split the kept list between them.
//      A warp stops as soon as each of its lanes is suppressed.
//   3. compact: the candidates still in play (valid, not suppressed by an
//      earlier row) move to the front of the row, in order, each with its
//      place in the row.
//   4. mask: the strict upper triangle of 32 x 32 tiles over them, as in
//      csrc/nms_keep.cu.
//   5. scan: one warp solves their greedy recurrence block by block, as in
//      csrc/nms_keep.cu, and writes a 1 at each kept candidate's place.
//   6. append: where another row follows, the row's kept boxes go to the
//      end of the kept list, in order.
// Only kept positions are written: the wrapper zeroes the keep first.
//
// Exactness: the keep equals the plain PyTorch version's
// (ops/kernels/classwise_keep.py) bit for bit on finite boxes: every IoU
// in the Pallas kernel's operation order with explicitly rounded
// intrinsics (no multiply-add contraction; the build passes -fmad=false
// too), the union clamped at 1e-8, a strict > against the float
// threshold, and a zero intersection taken as IoU 0 (its divide takes 1
// as the numerator, off the divide's slow path).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 256;                  // candidates judged together
constexpr int kBlock = 32;                 // scan block and tile side
constexpr int kRowBlocks = kRow / kBlock;  // column blocks of a row
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 4;  // independent IoUs of a step
constexpr unsigned kFull = 0xffffffffu;
// Candidates of a class: the kept list (bound - 1 boxes of 16 B) and the
// static shared memory fit the 227 KB a block can use.
constexpr int kMaxT = 12288;
constexpr size_t kMaxDynamic = (kMaxT - 1) * sizeof(float4);
constexpr int kDevices = 64;  // devices whose attribute is remembered
static_assert(kThreads >= kRow, "a thread per candidate of a row");

struct Smem {
  float4 box[kRow];  // the row's corners [y0, x0, y1, x1] as (x, y, z, w)
  float area[kRow];
  // mask[b][j]: bit i - 32b is whether live candidate i (block b of the
  // compacted row) suppresses live candidate j (j > i); bits of j <= i
  // are never read.
  uint32_t mask[kRowBlocks][kRow];
  uint32_t valid[kRowBlocks];  // score above the threshold
  uint32_t hit[kRowBlocks];    // suppressed by an earlier row's kept box
  uint32_t kept[kRowBlocks];
  uint8_t index[kRow];  // a live candidate's place in the row
};

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// The IoU's numerator and clamped denominator for boxes a and b with areas
// aa and ab; `zero` where they do not intersect (the numerator is then 1,
// which keeps the divide off its slow path, and the IoU is taken as 0).
__device__ __forceinline__ void iou_parts(float4 a, float aa, float4 b,
                                          float ab, float& num, float& den,
                                          bool& zero) {
  const float iy0 = fmaxf(a.x, b.x);
  const float ix0 = fmaxf(a.y, b.y);
  const float iy1 = fminf(a.z, b.z);
  const float ix1 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(iy1, iy0), 0.0f),
                                fmaxf(__fsub_rn(ix1, ix0), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(aa, ab), inter);
  zero = inter == 0.0f;
  num = zero ? 1.0f : inter;
  den = fmaxf(uni, 1e-8f);
}

// Step 2 for one warp: lane l judges row candidate 32 * blk + l against
// kept boxes lo .. hi - 1 and ORs the suppressed ones into sm.hit[blk].
__device__ __forceinline__ void check_kept(Smem& sm,
                                           const float4* __restrict__ kept,
                                           int lo, int hi, int blk, int lane,
                                           float iou_threshold) {
  const int j = blk * kBlock + lane;
  const bool active = (sm.valid[blk] >> lane) & 1u;
  const float4 cb = sm.box[j];
  const float ca = sm.area[j];
  bool hit = !active;
  for (int k0 = lo; k0 < hi; k0 += kSteps) {
    if (__all_sync(kFull, hit)) break;
    float num[kSteps], den[kSteps];
    bool zero[kSteps];
#pragma unroll
    for (int g = 0; g < kSteps; ++g) {
      const float4 kb = kept[min(k0 + g, hi - 1)];
      iou_parts(kb, box_area(kb), cb, ca, num[g], den[g], zero[g]);
    }
    float q[kSteps];
#pragma unroll
    for (int g = 0; g < kSteps; ++g) q[g] = __fdiv_rn(num[g], den[g]);
#pragma unroll
    for (int g = 0; g < kSteps; ++g) {
      const float iou = zero[g] ? 0.0f : q[g];
      if (k0 + g < hi && iou > iou_threshold) hit = true;
    }
  }
  const uint32_t bits = __ballot_sync(kFull, hit && active);
  if (lane == 0 && bits != 0u) atomicOr(&sm.hit[blk], bits);
}

// Step 3, one tile: the rows of row block bi against the columns of column
// block bc of a row of k candidates (csrc/nms_keep.cu's mask_tile). Lane l
// owns column bc * 32 + (l mod 2^kShift) and walks rows l >> kShift,
// + 32 / 2^kShift, ... of the block; kShift = 5 is a full tile, 4 and 3
// pack 2 and 4 rows into each warp instruction for a column block of <= 16
// and <= 8 candidates.
template <int kShift>
__device__ __forceinline__ void mask_tile(Smem& sm, int bi, int bc, int k,
                                          int lane, float iou_threshold) {
  constexpr int kRowsPerOp = kBlock >> kShift;
  constexpr int kStep = kSteps * kRowsPerOp;
  const int col = bc * kBlock + (lane & ((1 << kShift) - 1));
  const int sub = lane >> kShift;
  const float4 cb = sm.box[col];
  const float ca = sm.area[col];
  const int base = bi * kBlock;
  const int rows = min(k - base, kBlock);
  uint32_t bits = 0u;
  for (int i0 = 0; i0 < rows; i0 += kStep) {
    bool zero[kSteps];
    float num[kSteps], den[kSteps];
#pragma unroll
    for (int g = 0; g < kSteps; ++g) {
      const int i = base + i0 + g * kRowsPerOp + sub;
      iou_parts(sm.box[i], sm.area[i], cb, ca, num[g], den[g], zero[g]);
    }
    float q[kSteps];
#pragma unroll
    for (int g = 0; g < kSteps; ++g) q[g] = __fdiv_rn(num[g], den[g]);
    uint32_t step = 0u;
#pragma unroll
    for (int g = 0; g < kSteps; ++g) {
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
classwise_keep_kernel(const float* __restrict__ boxes,
                      const float* __restrict__ scores,
                      const int64_t* __restrict__ counts,
                      const int64_t* __restrict__ starts, int64_t stride,
                      uint8_t* __restrict__ keep, int t_len, int classes,
                      int bound, float iou_threshold, float score_threshold) {
  extern __shared__ float4 kept_boxes[];
  __shared__ __align__(16) Smem sm;

  const int b = blockIdx.x / classes;
  const int c = blockIdx.x - b * classes;
  const int64_t count = counts[b * stride + c];
  const int64_t start = starts[b * stride + c];
  if (count <= 0 || start < 0 || start >= t_len) return;
  const int first = static_cast<int>(start);
  int n = static_cast<int>(
      count < t_len - first ? count : static_cast<int64_t>(t_len - first));
  n = min(n, bound);
  const size_t at = static_cast<size_t>(b) * t_len + first;
  const float* seg_boxes = boxes + at * 4;
  const float* seg_scores = scores + at;
  uint8_t* out = keep + at;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int kept_count = 0;  // the same in every thread

  for (int row0 = 0; row0 < n; row0 += kRow) {
    const int rn = min(n - row0, kRow);
    const int nb = (rn + kBlock - 1) / kBlock;
    // The previous row's append has read sm.box and sm.kept.
    __syncthreads();

    // 1. load
    if (t < kRow) {
      float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      bool valid = false;
      if (t < rn) {
        const float* p = seg_boxes + static_cast<size_t>(row0 + t) * 4;
        box = make_float4(p[0], p[1], p[2], p[3]);
        valid = seg_scores[row0 + t] > score_threshold;
      }
      sm.box[t] = box;
      sm.area[t] = box_area(box);
      const uint32_t valid_bits = __ballot_sync(kFull, valid);
      if (lane == 0) {
        sm.valid[warp] = valid_bits;
        sm.hit[warp] = 0u;
      }
    }
    __syncthreads();

    // 2. earlier rows
    if (kept_count > 0) {
      const int slices = kWarps / nb;
      const int blk = warp % nb;
      const int slice = warp / nb;
      if (slice < slices) {
        const int chunk = (kept_count + slices - 1) / slices;
        const int lo = slice * chunk;
        const int hi = min(kept_count, lo + chunk);
        if (lo < hi) {
          check_kept(sm, kept_boxes, lo, hi, blk, lane, iou_threshold);
        }
      }
      __syncthreads();
    }

    // 3. compact
    int live = 0;    // candidates left in play in the row
    int before = 0;  // of them, in the row's blocks before this warp's
    for (int blk = 0; blk < nb; ++blk) {
      const int here = __popc(sm.valid[blk] & ~sm.hit[blk]);
      if (blk < warp) before += here;
      live += here;
    }
    int to = -1;
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float area = 0.0f;
    if (t < rn) {
      const uint32_t word = sm.valid[warp] & ~sm.hit[warp];
      if ((word >> lane) & 1u) {
        to = before + __popc(word & ((1u << lane) - 1u));
        box = sm.box[t];
        area = sm.area[t];
      }
    }
    __syncthreads();
    if (to >= 0) {
      sm.box[to] = box;
      sm.area[to] = area;
      sm.index[to] = static_cast<uint8_t>(t);
    }
    __syncthreads();
    const int lb = (live + kBlock - 1) / kBlock;

    // 4. mask
    const int tiles = lb * (lb + 1) / 2;
    for (int tile = warp; tile < tiles; tile += kWarps) {
      int bi = 0;
      int rest = tile;
      while (rest >= lb - bi) {
        rest -= lb - bi;
        ++bi;
      }
      const int bc = bi + rest;
      const int width = min(live - bc * kBlock, kBlock);
      if (width > 16) {
        mask_tile<5>(sm, bi, bc, live, lane, iou_threshold);
      } else if (width > 8) {
        mask_tile<4>(sm, bi, bc, live, lane, iou_threshold);
      } else {
        mask_tile<3>(sm, bi, bc, live, lane, iou_threshold);
      }
    }
    __syncthreads();

    // 5. scan
    if (warp == 0) {
      uint32_t kept[kRowBlocks];
#pragma unroll
      for (int blk = 0; blk < kRowBlocks; ++blk) {
        if (blk >= lb) break;
        // Lane l: is candidate 32 blk + l suppressed by a kept candidate of
        // an earlier block of the row? Those past the live ones count as
        // removed.
        const int j = blk * kBlock + lane;
        uint32_t hit = 0u;
#pragma unroll
        for (int e = 0; e < blk; ++e) hit |= sm.mask[e][j] & kept[e];
        const uint32_t removed = __ballot_sync(kFull, hit != 0u || j >= live);
        uint32_t diag[kBlock];
        const uint4* cols =
            reinterpret_cast<const uint4*>(&sm.mask[blk][blk * kBlock]);
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
        kept[blk] = alive;
        if ((alive >> lane) & 1u) out[row0 + sm.index[j]] = 1u;
        if (lane == 0) sm.kept[blk] = alive;
      }
    }

    // 6. append
    if (row0 + kRow < n) {
      __syncthreads();
      int kept_before = 0;  // kept candidates of the earlier blocks
      int total = 0;
      for (int blk = 0; blk < lb; ++blk) {
        const int here = __popc(sm.kept[blk]);
        if (blk < warp) kept_before += here;
        total += here;
      }
      if (t < live) {
        const uint32_t word = sm.kept[warp];
        if ((word >> lane) & 1u) {
          kept_boxes[kept_count + kept_before +
                     __popc(word & ((1u << lane) - 1u))] = sm.box[t];
        }
      }
      kept_count += total;
    }
  }
}

}  // namespace

// boxes (B, T, 4) f32, scores (B, T) f32, counts and starts (B, C) int64
// with row stride `stride` and unit column stride, keep (B, T) bytes zeroed,
// `bound` the largest class taken (1 .. min(T, kMaxT)),
// all on CUDA device `device`; launches on `stream` (a stream of that
// device), switching the calling thread's current device for the launch if
// it is another. Returns a cudaError_t.
extern "C" int classwise_keep_launch(const void* boxes, const void* scores,
                                     const void* counts, const void* starts,
                                     long long stride, void* keep, int b,
                                     int t, int c, float iou_threshold,
                                     float score_threshold, int bound,
                                     int device, void* stream) {
  if (b < 0 || t < 0 || c < 0 || bound > kMaxT || bound > t ||
      (t > 0 && bound < 1) || stride < c || device < 0 ||
      static_cast<long long>(b) * c > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || t == 0 || c == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // The kept list holds the kept boxes of every row but a class's last,
  // of a class of at most `bound` candidates.
  // Above 48 KB the kernel has to be allowed its dynamic shared memory:
  // once a device, to the largest size (so concurrent callers agree), and
  // so never inside a stream capture after the first call.
  const size_t dynamic =
      bound > kRow ? static_cast<size_t>(bound - 1) * sizeof(float4) : 0;
  static bool allowed[kDevices] = {};
  if (dynamic > 48 * 1024 && !(device < kDevices && allowed[device])) {
    err = cudaFuncSetAttribute(classwise_keep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxDynamic));
    if (err == cudaSuccess && device < kDevices) allowed[device] = true;
  }
  if (err == cudaSuccess) {
    classwise_keep_kernel<<<b * c, kThreads, dynamic,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const int64_t*>(counts),
        static_cast<const int64_t*>(starts), stride,
        static_cast<uint8_t*>(keep), t, c, bound, iou_threshold,
        score_threshold);
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t restored = cudaSetDevice(current);
    if (err == cudaSuccess) err = restored;
  }
  return static_cast<int>(err);
}
