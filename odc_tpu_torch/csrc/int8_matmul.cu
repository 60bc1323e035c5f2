// Tiled matrix product on the tensor cores: C[M, N] = A[M, K] . B[K, N].
//
// Replaces: scripts/probe_int8_mxu.py::pallas_matmul (the Pallas TPU kernel,
// body _mm_kernel), the im2col GEMM that carries every int8 convolution of
// the PTQ engine (odc_tpu_torch/ops/int8_engine.py).  Two element types, as
// the TPU kernel's dtype rule has it:
//   int8 x int8 -> int32, exact (|a| <= 128, |b| <= 127, K <= 131072 keeps
//                  every partial sum inside int32), so the result is bitwise
//                  any other exact int32 product whatever the order;
//   bf16 x bf16 -> f32, products exact, sums in f32.
// A is row-major [M, K]; B comes as Bt, row-major [N, K] (B in column-major
// order), so both operands are K-contiguous.  Any M, N, K: rows, columns
// and K beyond the edges read as zero.
//
// What bounds it on this card.  The engine's 20 GEMMs of one batch-64 call at
// 416x416 do 2.21e12 int8 operations: 1.12 ms at the 1,979 TOPS dense int8
// peak.  Their A operands are im2col matrices that PyTorch writes and this
// kernel reads, about 9.0 GB a call: 2.7 ms at 3.35 TB/s.  So the path is
// bound by bytes until an implicit GEMM that never writes the im2col matrix
// replaces it (a later change, with wgmma and TMA).
//
// Design, simple and right first.  One CTA of 8 warps computes a 128 x 128
// tile of C (128 x 64 when N <= 64).  Per step it stages 64 bytes of K of A (BM rows) and of Bt (BN
// rows) in shared memory, two buffers deep: the next step's tile is loaded
// from global memory into registers (16-byte loads) while the warps run on
// the current one.  Each warp owns a WM x WN sub-tile held in registers as
// mma.sync accumulators: m16n8k32 with s8 operands and s32 sums, or
// m16n8k16 with bf16 operands and f32 sums.  Both read a 32-byte slice of
// K per instruction with the same fragment layout in bytes, so one kernel
// body serves both types.  Shared-memory rows are padded to 80 bytes,
// which makes the fragment loads free of bank conflicts.  The M tiles run on
// grid x (M reaches 11 million rows at batch 64), the N tiles on grid y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kStepBytes = 64;  // bytes of K staged per step and row
constexpr int kRowBytes = kStepBytes + 16;  // padded smem row (80 bytes)
constexpr int kChunks = kStepBytes / 16;  // 16-byte chunks per row and step

struct S8 {
  using Acc = int;
  static constexpr int kElemBytes = 1;
  __device__ static void mma(int* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

struct BF16 {
  using Acc = float;
  static constexpr int kElemBytes = 2;
  __device__ static void mma(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// 16 bytes of row `row` of a [rows, kb]-byte matrix at byte `k`, zero past
// either edge.  `vec`: rows are 16-byte aligned and kb % 16 == 0.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* base, long long rows,
                                            long long row, int kb, int k,
                                            bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || k >= kb) return v;
  const uint8_t* p = base + row * (long long)kb + k;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && k + i < kb; ++i)
    w[i >> 2] |= (uint32_t)p[i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
                  typename T::Acc* __restrict__ c, int m, int n, int k,
                  bool vec) {
  static_assert((BM / WM) * (BN / WN) == kThreads / 32, "8 warps");
  constexpr int MI = WM / 16;  // mma tiles per warp along M
  constexpr int NI = WN / 8;   // and along N
  constexpr int A_LOADS = BM * kChunks / kThreads;
  constexpr int B_LOADS = BN * kChunks / kThreads;
  static_assert(A_LOADS >= 1 && B_LOADS >= 1, "tile too small");

  __shared__ __align__(16) uint8_t sa[2][BM * kRowBytes];
  __shared__ __align__(16) uint8_t sb[2][BN * kRowBytes];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread-in-group
  const int wm0 = (warp / (BN / WN)) * WM;
  const int wn0 = (warp % (BN / WN)) * WN;
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;
  const int kb = k * T::kElemBytes;
  const int steps = (kb + kStepBytes - 1) / kStepBytes;

  typename T::Acc acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  uint4 ra[A_LOADS], rb[B_LOADS];
  auto fetch = [&](int step) {
    const int k0 = step * kStepBytes;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      ra[i] = load_chunk(a, m, m0 + idx / kChunks, kb,
                         k0 + (idx % kChunks) * 16, vec);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      rb[i] = load_chunk(bt, n, n0 + idx / kChunks, kb,
                         k0 + (idx % kChunks) * 16, vec);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&sa[buf][(idx / kChunks) * kRowBytes +
                                         (idx % kChunks) * 16]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&sb[buf][(idx / kChunks) * kRowBytes +
                                         (idx % kChunks) * 16]) = rb[i];
    }
  };

  fetch(0);
  stash(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) fetch(step + 1);
#pragma unroll
    for (int ks = 0; ks < kStepBytes; ks += 32) {
      uint32_t fa[MI][4], fb[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const uint8_t* r0 = &sa[buf][(wm0 + i * 16 + g) * kRowBytes + ks + 4 * t];
        const uint8_t* r8 = r0 + 8 * kRowBytes;
        fa[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        fa[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        fa[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        fa[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const uint8_t* r = &sb[buf][(wn0 + j * 8 + g) * kRowBytes + ks + 4 * t];
        fb[j][0] = *reinterpret_cast<const uint32_t*>(r);
        fb[j][1] = *reinterpret_cast<const uint32_t*>(r + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) T::mma(acc[i][j], fa[i], fb[j]);
    }
    if (step + 1 < steps) {
      // The other buffer was last read in the previous step, before the
      // barrier that closed it.
      stash(buf ^ 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const long long col = n0 + wn0 + j * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + wm0 + i * 16 + g + 8 * half;
        if (row >= m) continue;
        typename T::Acc* out = c + row * n + col;
        if (col < n) out[0] = acc[i][j][2 * half];
        if (col + 1 < n) out[1] = acc[i][j][2 * half + 1];
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* bt, void* c, int m, int n, int k,
           int vec, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(bt);
  auto* pc = static_cast<typename T::Acc*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 64) {
    // Narrow outputs (the 32- and 64-channel convs): a 128 x 64 tile.
    constexpr int BM = 128, BN = 64;
    dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
    matmul_kernel<T, BM, BN, 32, 32><<<grid, kThreads, 0, s>>>(
        pa, pb, pc, m, n, k, vec != 0);
  } else {
    constexpr int BM = 128, BN = 128;
    dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
    matmul_kernel<T, BM, BN, 64, 32><<<grid, kThreads, 0, s>>>(
        pa, pb, pc, m, n, k, vec != 0);
  }
  return cudaGetLastError();
}

}  // namespace

// C[m, n] = A[m, k] . Bt[n, k]^T, row-major, on `stream`; `vec` != 0 when
// both operands' rows are 16-byte aligned (k bytes % 16 == 0 and aligned
// bases).  Returns the cudaError_t of the launch (0 = success).
extern "C" int matmul_s8s8s32(const void* a, const void* bt, void* c, int m,
                              int n, int k, int vec, void* stream) {
  return launch<S8>(a, bt, c, m, n, k, vec, stream);
}

extern "C" int matmul_bf16bf16f32(const void* a, const void* bt, void* c,
                                  int m, int n, int k, int vec, void* stream) {
  return launch<BF16>(a, bt, c, m, n, k, vec, stream);
}
