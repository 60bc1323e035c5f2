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
// order), so both operands are K-contiguous (K-major, as 8-bit wgmma needs).
//
// What bounds it on this card.  The engine's 20 GEMMs of one batch-64 call at
// 416x416 do 2.21e12 int8 operations: 1.12 ms at the 1,979 TOPS dense int8
// peak.  Their operands and results are about 5.9 GB a call, most of it the
// im2col matrices that PyTorch writes and this kernel reads: 1.76 ms at
// 3.35 TB/s.  Taking the larger term per GEMM, the 20 are bound at 2.14 ms,
// by bytes for the wide-M early stages and by operations for the large-K
// late ones (NVIDIA H100 80GB HBM3, 700 W).
//
// Two routes, chosen by shape and alignment in ops/cuda/matmul_kernel.py's
// route() (never by catching a failure):
//
// wgmma (int8 only; K a multiple of 16 and both bases 16-byte aligned, which
// every GEMM of the engine meets since it pads K to a multiple of 32).  The
// full int8 rate needs wgmma fed by TMA, which the mma.sync route below
// cannot reach (it stages through registers and re-reads every fragment
// with ordinary shared loads).  Persistent CTAs of three warpgroups walk
// over 128 x BN output tiles (BN = 64 for N <= 64, 256 where that still
// gives every SM two tiles, else 128), N fastest so that the CTAs in
// flight share their A tiles through L2.
// Warpgroup 0 is the producer: one thread issues TMA tiled loads of A
// [128 rows x 128 B] and Bt [BN rows x 128 B] with the 128-byte swizzle
// into a ring of stages (192 KB in all) guarded by full/empty mbarriers,
// running ahead across tile boundaries.  Warpgroups 1-2 each own 64 rows of
// the tile and run wgmma m64nBNk32 s32.s8.s8, four per stage, both operands
// from shared-memory descriptors, with int32 accumulators in registers and
// one wgmma group left in flight while the next stage is waited for.  TMA's
// out-of-bounds zero fill supplies the ragged M and N edges and the partial
// last K tile (K = 288: 128 + 128 + 32); the epilogue writes int32 C
// straight from the accumulators, masking the ragged edges.
//
// mma.sync (bf16, and int8 shapes TMA cannot describe: K bytes not a
// multiple of 16 or a misaligned base).  One CTA of 8 warps computes a
// 128 x 128 tile of C (128 x 64 when N <= 64).  Per step it stages 64 bytes
// of K of A (BM rows) and of Bt (BN rows) in shared memory, two buffers
// deep: the next step's tile is loaded from global memory into registers
// (16-byte loads) while the warps run on the current one.  Each warp owns a
// WM x WN sub-tile held in registers as mma.sync accumulators: m16n8k32
// with s8 operands and s32 sums, or m16n8k16 with bf16 operands and f32
// sums.  Both read a 32-byte slice of K per instruction with the same
// fragment layout in bytes, so one kernel body serves both types.
// Shared-memory rows are padded to 80 bytes, which makes the fragment loads
// free of bank conflicts.  The M tiles run on grid x (M reaches 11 million
// rows at batch 64), the N tiles on grid y.  Any M, N, K: rows, columns and
// K beyond the edges read as zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// wgmma + TMA route (int8).

namespace wg {

constexpr int kBM = 128;               // tile rows: two consumer warpgroups
constexpr int kBK = 128;               // bytes of K per stage (one swizzle row)
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kRing = 192 * 1024;      // bytes of the stage ring

template <int BN>
struct Cfg {
  static constexpr int kStageBytes = (kBM + BN) * kBK;
  static constexpr int kStages = kRing / kStageBytes;  // 8, 6 or 4
  static constexpr int kSmem = kStages * kStageBytes + 1024 +
                               2 * kStages * static_cast<int>(sizeof(uint64_t));
};

// D[64 x 64] (s32) += A[64 x 32] . B[32 x 64] (s8), both from shared memory;
// scale_d == 0 overwrites D instead.
__device__ __forceinline__ void mma_n64(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (s32) += A[64 x 32] . B[32 x 128] (s8), both from shared memory;
// scale_d == 0 overwrites D instead.
__device__ __forceinline__ void mma_n128(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 256] (s32) += A[64 x 32] . B[32 x 256] (s8), both from shared memory;
// scale_d == 0 overwrites D instead.
__device__ __forceinline__ void mma_n256(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 64) mma_n64(d, da, db, scale_d);
  else if constexpr (BN == 128) mma_n128(d, da, db, scale_d);
  else mma_n256(d, da, db, scale_d);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        int* __restrict__ c, int m, int n, int k) {
  using C = Cfg<BN>;
  constexpr int kStages = C::kStages;
  constexpr int kAcc = BN / 2;  // int32 accumulators per consumer thread
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles must start on 1024-byte boundaries.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tiles = smem;  // stage s: A [128 x 128 B], then Bt [BN x 128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * C::kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg_idx = tid / 128;
  const int m_tiles = (m + kBM - 1) / kBM;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles_total = m_tiles * n_tiles;
  const int k_tiles = (k + kBK - 1) / kBK;

  if (tid == 0) {
    hopper::tma_prefetch_desc(&map_a);
    hopper::tma_prefetch_desc(&map_b);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);  // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg_idx == 0) {
    // Producer warpgroup: gives registers away, one thread issues loads.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles_total; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM;
        const int n0 = (t % n_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sa = tiles + stage * C::kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[stage], C::kStageBytes);
          hopper::tma_load_2d(sa, &map_a, &full[stage], kt * kBK, m0);
          hopper::tma_load_2d(sa + kBM * kBK, &map_b, &full[stage], kt * kBK,
                              n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg_idx - 1;  // this warpgroup's 64 rows of the tile
    const int t128 = tid - 128 * wg_idx;
    const int warp = t128 / 32, lane = t128 % 32;
    const int g = lane / 4, q = lane % 4;
    int acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles_total; t += gridDim.x) {
      const int m0 = (t / n_tiles) * kBM;
      const int n0 = (t % n_tiles) * BN;
      for (int kt = 0; kt < k_tiles; ++kt) {
        hopper::mbar_wait(&full[stage], phase);
        const uint8_t* sa = tiles + stage * C::kStageBytes + cw * 64 * kBK;
        const uint8_t* sb = tiles + stage * C::kStageBytes + kBM * kBK;
        const uint64_t da = hopper::desc_sw128(sa);
        const uint64_t db = hopper::desc_sw128(sb);
        hopper::wgmma_fence();
#pragma unroll
        for (int s = 0; s < kBK / 32; ++s) {
          // +2 per 32-byte K slice: descriptor addresses are 16-byte units.
          mma<BN>(acc, da + 2 * s, db + 2 * s, (kt > 0 || s > 0) ? 1 : 0);
        }
        hopper::wgmma_commit();
        // Keep this stage's group in flight; the previous one is done.
        hopper::wgmma_wait<1>();
        if (kt > 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(&empty[prev]);

      // Accumulator layout of wgmma m64nN: register 4j + 2h + e of thread
      // (warp, g, q) holds row 16 warp + g + 8h, column 8j + 2q + e.
      const long long row0 = m0 + cw * 64 + warp * 16 + g;
      const bool pairs = (n % 2) == 0;  // int2 stores stay 8-byte aligned
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        if (col >= n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + 8 * h;
          if (row >= m) continue;
          int* out = c + row * n + col;
          if (pairs) {
            *reinterpret_cast<int2*>(out) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          } else {
            out[0] = acc[4 * j + 2 * h];
            if (col + 1 < n) out[1] = acc[4 * j + 2 * h + 1];
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has
// already loaded (the library links against libcudart only).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Error codes of this route beyond cudaError_t's range.
constexpr int kErrNoEncodeEntry = 10001;
constexpr int kErrEncodeBase = 20000;  // + CUresult of the encode call

// Row-major int8 [rows, k] as tiles of box_rows x 128 bytes, 128-B swizzle,
// out-of-bounds reads filled with zeros.
int make_map(CUtensorMap* map, const void* base, long long rows, int k,
             int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncodeEntry;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
         strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + static_cast<int>(r);
}

template <int BN>
int launch(const void* a, const void* bt, int* c, int m, int n, int k,
           int sms, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  int err = make_map(&map_a, a, m, k, kBM);
  if (err == 0) err = make_map(&map_b, bt, n, k, BN);
  if (err != 0) return err;
  constexpr int smem = Cfg<BN>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      matmul_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const long long tiles =
      static_cast<long long>((m + kBM - 1) / kBM) * ((n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  matmul_wgmma_kernel<BN><<<grid, kThreads, smem, s>>>(map_a, map_b, c, m, n, k);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// C[m, n] = A[m, k] . Bt[n, k]^T in int8 -> int32 on the wgmma route, on
// `stream`.  Needs k % 16 == 0 and 16-byte aligned bases (route() checks).
// Returns 0, a cudaError_t, or 10001 / 20000 + CUresult when the tensor
// map cannot be made.
extern "C" int matmul_s8s8s32_wgmma(const void* a, const void* bt, void* c,
                                    int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 != 0) return cudaErrorInvalidValue;
  // 128 x 256 tiles read less shared memory per operation, but only pay
  // where they still give every SM two or more tiles; with fewer, the last
  // wave leaves SMs idle.
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles256 =
      static_cast<long long>((m + 127) / 128) * ((n + 255) / 256);
  const int bn = n <= 64 ? 64 : (n > 128 && tiles256 >= 2LL * sms ? 256 : 128);
  auto* pc = static_cast<int*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return wg::launch<64>(a, bt, pc, m, n, k, sms, s);
    case 128: return wg::launch<128>(a, bt, pc, m, n, k, sms, s);
    default: return wg::launch<256>(a, bt, pc, m, n, k, sms, s);
  }
}

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
