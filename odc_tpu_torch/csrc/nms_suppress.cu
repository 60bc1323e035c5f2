// Greedy NMS suppression over score-sorted candidates, one CTA per image.
//
// Replaces: odc_tpu/ops/pallas/nms_kernel.py::pallas_suppress (the Pallas
// TPU kernel; the JAX product path runs core/nms.py::_suppress instead).
//
// Computes, for each image b, keep[b, :] over K candidates already sorted by
// descending score: keep starts as valid, and box j is dropped iff a still
// kept box i < j has IoU(i, j) >= iou_thre.  The IoU follows
// odc_tpu/core/boxes.py::iou operation for operation (max/min corners,
// extents clamped at 0, union = area_i + area_j - inter, inter / (union +
// 1e-6)), each op rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn and
// -fmad=false), so the keep mask is bitwise that of the plain PyTorch version.
//
// What bounds it on this card: neither bytes (K boxes in, K flags out: about
// 1.2 KB per image at K = 64) nor arithmetic (K^2/2 IoUs), but latency: the
// launch, then a walk whose steps depend on each other.  The design keeps
// every step short and skips work the answer does not need:
//
// * Loads and stores are coalesced: a box is one float4 a thread (the
//   wrapper checks 16-byte alignment), valid and keep one byte a thread;
//   a warp's ballot packs 32 valid flags into a word.
// * The suppression bitmask (bit j of row i set iff j > i and IoU >= thr)
//   is built by every warp of the CTA: a warp takes kUnroll (row i, word w)
//   items at a time, lane l tests j = 32w + l, and __ballot_sync forms the
//   word (bit l is candidate 32w + l; lanes past K give 0).  A pair with no
//   intersection skips the IEEE division (its quotient is +-0).  Rows of candidates that
//   are not valid are never built: their keep bit is 0 from the start, so
//   they never suppress.  Valid candidates need not be a prefix.  Words
//   below (i+1)/32 hold no later box and are neither built nor read.
// * ONE warp walks the mask with the keep mask in registers, one 32-bit
//   word per lane (K <= 1024), word by word.  Within a word it jumps from
//   kept box to kept box with __ffs, so a step is taken per kept box, not
//   per candidate, and a step is a shuffle: each lane loaded the word-w
//   bits of its own candidate's row beforehand, and the step's box takes
//   them from its lane.  Once the word is resolved, each later word's lane
//   gathers the rows of the word's kept boxes with independent loads.
// * The keep words go through shared memory, and the CTA writes the flags.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 1024;
constexpr int kMaxWords = kMaxK / 32;
constexpr int kUnroll = 4;  // mask items a warp computes at once

// NaN-propagating max/min, as torch.maximum / jnp.maximum (fmaxf drops NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
// clamp(min=0) keeps NaN, as torch.clamp / jnp.clip do.
__device__ __forceinline__ float clamp0(float a) {
  return (a < 0.f) ? 0.f : a;
}

__device__ __forceinline__ float iou(float4 a, float4 b) {
  const float ix1 = max_nan(a.x, b.x);
  const float iy1 = max_nan(a.y, b.y);
  const float ix2 = min_nan(a.z, b.z);
  const float iy2 = min_nan(a.w, b.w);
  const float inter =
      __fmul_rn(clamp0(__fsub_rn(ix2, ix1)), clamp0(__fsub_rn(iy2, iy1)));
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float den = __fadd_rn(uni, 1e-6f);
  // Disjoint boxes, the common pair: the quotient is +-0, which compares
  // as 0 does, without the division's special-operand path.
  if (inter == 0.f && den == den && den != 0.f) return 0.f;
  return __fdiv_rn(inter, den);
}

// First word of row i that can hold a later box j > i.
__device__ __forceinline__ int first_word(int i) { return (i + 1) >> 5; }

__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float4* __restrict__ boxes,  // [B, K]
                    const uint8_t* __restrict__ valid,  // [B, K]
                    uint8_t* __restrict__ keep,         // [B, K]
                    int k, float iou_thre) {
  extern __shared__ float4 smem[];
  __shared__ uint32_t words[kMaxWords];  // valid flags, then keep flags
  const int nw = (k + 31) >> 5;
  float4* box = smem;                                     // [K]
  uint32_t* mask = reinterpret_cast<uint32_t*>(box + k);  // [K, nw]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  const size_t b = blockIdx.x;
  const float4* gbox = boxes + b * k;
  const uint8_t* gvalid = valid + b * k;
  // Whole words per warp, so every lane of a warp takes the same trips.
  for (int j = threadIdx.x; j < 32 * nw; j += blockDim.x) {
    const bool in = j < k;
    if (in) box[j] = gbox[j];
    const uint32_t word = __ballot_sync(0xffffffffu, in && gvalid[j] != 0);
    if (lane == 0) words[j >> 5] = word;
  }
  __syncthreads();

  // Row i, word w: bit l for j = 32w + l.  A warp takes kUnroll items at
  // a time, so that their IoUs overlap.
  const int items = k * nw;
  for (int t0 = warp; t0 < items; t0 += kUnroll * nwarps) {
    bool hit[kUnroll], live[kUnroll];
    int slot[kUnroll];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * nwarps;
      const int i = min(t / nw, k - 1);
      const int w = t - (t / nw) * nw;
      live[u] = t < items && w >= first_word(i) &&
                ((words[i >> 5] >> (i & 31)) & 1u);
      any |= live[u];
    }
    if (!any) continue;  // rows of invalid candidates only
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * nwarps;
      const int i = min(t / nw, k - 1);
      const int w = t - (t / nw) * nw;
      const int j = 32 * w + lane;
      const float v = iou(box[i], box[min(j, k - 1)]);
      hit[u] = live[u] && j > i && j < k && v >= iou_thre;
      slot[u] = i * nw + w;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t bits = __ballot_sync(0xffffffffu, hit[u]);
      if (live[u] && lane == 0) mask[slot[u]] = bits;
    }
  }
  __syncthreads();

  // The walk, by words in order: lane l holds keep word l.  Within word w
  // every lane follows the same jumps from kept box to kept box; box i's
  // bits in word w come from lane i % 32 (which loaded its row's word w),
  // and lanes above w gather the rows of the word's kept boxes, applied
  // once the word is resolved.
  if (warp == 0) {
    uint32_t word = lane < nw ? words[lane] : 0u;
    for (int w = 0; w < nw; ++w) {
      const int i_own = 32 * w + lane;
      const uint32_t own = (lane < 31 && i_own < k &&
                            ((words[w] >> lane) & 1u))
                               ? mask[i_own * nw + w]
                               : 0u;
      uint32_t kw = __shfl_sync(0xffffffffu, word, w);
      uint32_t rest = kw;
      while (rest != 0u) {
        const int bit = __ffs(rest) - 1;
        kw &= ~__shfl_sync(0xffffffffu, own, bit);
        rest = kw & ~((2u << bit) - 1u);  // kept bits above `bit`
      }
      if (lane == w) {
        word = kw;
      } else if (lane > w && lane < nw) {
        // The kept boxes of word w drop what they overlap in word `lane`:
        // independent loads, off the chain above.
        uint32_t drop = 0u;
#pragma unroll
        for (int bit = 0; bit < 32; ++bit) {
          if ((kw >> bit) & 1u) drop |= mask[(32 * w + bit) * nw + lane];
        }
        word &= ~drop;
      }
    }
    if (lane < nw) words[lane] = word;
  }
  __syncthreads();

  uint8_t* gkeep = keep + b * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    gkeep[j] = (words[j >> 5] >> (j & 31)) & 1u;
  }
}

// The launch floor: the same grid, block and shared memory, no work.
__global__ void __launch_bounds__(kThreads) nms_empty_kernel() {}

size_t smem_bytes(int k) {
  const int nw = (k + 31) / 32;
  return sizeof(float4) * k + sizeof(uint32_t) * k * nw;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// boxes: [batch, k, 4] f32, contiguous, 16-byte aligned; valid, keep:
// [batch, k] bool (one byte each), contiguous.  Launches on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int nms_suppress(const void* boxes, const void* valid, void* keep,
                            int batch, int k, float iou_thre, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK ||
      (reinterpret_cast<uintptr_t>(boxes) & 15u) != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(k);
  cudaError_t e = allow_smem(nms_suppress_kernel, smem);
  if (e != cudaSuccess) return e;
  nms_suppress_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, iou_thre);
  return cudaGetLastError();
}

// An empty kernel launched as nms_suppress(batch, k) would be: what a
// launch alone costs, for timing beside it.
extern "C" int nms_launch_floor(int batch, int k, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k);
  cudaError_t e = allow_smem(nms_empty_kernel, smem);
  if (e != cudaSuccess) return e;
  nms_empty_kernel<<<batch, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
