// Fused Darknet-19 front ("superstem") for inference.
//
// Replaces: odc_tpu/ops/pallas/superstem_kernel.py::superstem (the Pallas
// TPU kernel, which contracts both convolutions on the MXU with
// dot_general; the JAX product path runs the unfused XLA stem instead).
//
// Computes, from uint8 NHWC RGB [B, H, W, 3]:
//   normalize (x / 255 - mean) / std in f32, rounded to T
//   -> 3x3 conv 3->32, BN folded into w1 [32, 28] (bias = last tap)
//   -> 2x2 max pool (floor) -> leaky 0.1 -> rounded to T
//   -> 3x3 conv 32->64, BN folded into w2 [64, 289] (bias = last tap)
//   -> 2x2 max pool (floor) -> leaky 0.1 -> [B, H/2/2, W/2/2, 64] in T,
// with f32 accumulation and T = bf16 (the main path) or f32.  Tap order in
// w1/w2 is (ky*3 + kx)*Cin + c, as fold_weights lays it out.  The bias is
// added before the max (max(a+b, c+b) = max(a, c) + b) and leaky runs after
// the pool (it is monotone), as in the TPU kernel.  Both convs pad SAME with
// zeros: conv1 reads zeros of the NORMALIZED image, conv2 zeros of the
// post-leaky pooled map (not the folded bias), so pooled-1 positions outside
// the map are stored as 0.  Any H, W >= 4.
//
// What bounds it on this card: arithmetic.  About 1.9 GFLOP per 416x416
// image (conv1 0.30, conv2 1.60) against about 1.9 MB of HBM traffic
// (0.52 MB in, 1.38 MB out): at the 989 TFLOP/s bf16 tensor-core rate a
// batch of 64 takes 0.12 ms, the bytes 0.04 ms.
//
// bf16 (the main path): both convolutions on the tensor cores, as implicit
// GEMMs from shared memory with mma.sync m16n8k16 (bf16 in, f32 sums).
// One CTA of 8 warps per tile of 8 x 16 final outputs of one image, two
// CTAs per SM (91 KB of shared memory each):
//   1. the normalized input tile with its 3-pixel halo, 38 x 70 x 3 bf16;
//   2. conv1 as a GEMM with M = pre-pool positions, N = 32, K = 27 taps + a
//      28th that reads 1.0 against the bias column of w1, padded to 32 with
//      zeros; A fragments gathered from the input tile, w1's fragments held
//      in registers; the pooled-1 tile with its 1-pixel halo (18 x 34
//      positions x 32 channels) stored in shared memory as bf16 NHWC, each
//      position's 64 bytes as four 16-byte chunks XOR-swizzled by position;
//   3. conv2 as a GEMM with M = the tile's 512 pre-pool positions, N = 64,
//      K = 288 (9 taps x 32 channels): each tap's 16 channels are 32
//      contiguous bytes, so ldmatrix feeds the A fragments straight from the
//      pooled-1 tile and the B fragments from w2 (rows padded to 592 bytes);
//      the bias is added in the f32 epilogue.
// Pooling happens in registers: the M rows of each pair of m16 tiles are
// ordered so that the four positions of a 2x2 window land in one thread's
// accumulators (rows g and g+8 of both tiles), and the row order also keeps
// every ldmatrix phase free of bank conflicts.  The pre-pool maps never
// leave the registers; only the uint8 input and the final map cross HBM.
//
// f32 (off the main path; the tensor cores have no full-f32 product): a
// direct convolution on the CUDA cores, one CTA per 8 x 8 tile of outputs,
// the normalized input, conv1's pooled map and both weights in shared
// memory as f32, each thread keeping the 2x2 window of one output in
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 8;                  // final output rows per CTA
constexpr int TC = 8;                  // final output cols per CTA
constexpr int P1R = 2 * TR + 2;        // pooled-1 rows incl. conv2 halo
constexpr int P1C = 2 * TC + 2;
constexpr int IR = 2 * P1R + 2;        // input rows incl. conv1 halo
constexpr int IC = 2 * P1C + 2;
constexpr int C1 = 32;
constexpr int C2 = 64;
constexpr int K1 = 28;                 // 27 taps + bias
constexpr int K2 = 289;                // 288 taps + bias
constexpr int W1S = 29;                // padded smem stride of w1 rows
constexpr int kThreads = 256;

constexpr int kSmemFloats = 3 * IR * IC + P1R * P1C * C1 + C1 * W1S + C2 * K2;

__constant__ float kMean[3] = {0.485f, 0.456f, 0.406f};
__constant__ float kStd[3] = {0.229f, 0.224f, 0.225f};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float leaky(float v) {
  return v > 0.f ? v : 0.1f * v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
superstem_kernel(const uint8_t* __restrict__ x,  // [B, H, W, 3]
                 const T* __restrict__ w1,       // [32, 28]
                 const T* __restrict__ w2,       // [64, 289]
                 T* __restrict__ out,            // [B, H4, W4, 64]
                 int h, int w) {
  extern __shared__ float smem[];
  float* in_s = smem;                     // [3][IR][IC]
  float* p1_s = in_s + 3 * IR * IC;       // [P1R][P1C][32]
  float* w1_s = p1_s + P1R * P1C * C1;    // [32][W1S]
  float* w2_s = w1_s + C1 * W1S;          // [64][289]

  const int h2 = h / 2, w2d = w / 2;
  const int h4 = h2 / 2, w4 = w2d / 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TR;         // first final output row
  const int c0 = blockIdx.x * TC;
  const int p_r0 = 2 * r0 - 1;            // first pooled-1 row in p1_s
  const int p_c0 = 2 * c0 - 1;
  const int i_r0 = 2 * p_r0 - 1;          // first input row in in_s
  const int i_c0 = 2 * p_c0 - 1;
  const int tid = threadIdx.x;

  for (int t = tid; t < C1 * K1; t += kThreads) {
    w1_s[(t / K1) * W1S + t % K1] = to_f<T>(w1[t]);
  }
  for (int t = tid; t < C2 * K2; t += kThreads) w2_s[t] = to_f<T>(w2[t]);

  // Normalized input tile, zero outside the image (conv1's SAME padding).
  const uint8_t* xb = x + static_cast<size_t>(b) * h * w * 3;
  for (int t = tid; t < IR * IC * 3; t += kThreads) {
    const int c = t % 3;
    const int col = (t / 3) % IC;
    const int row = t / (3 * IC);
    const int gy = i_r0 + row, gx = i_c0 + col;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const float px = static_cast<float>(xb[(static_cast<size_t>(gy) * w + gx) * 3 + c]);
      v = round_t<T>((px / 255.f - kMean[c]) / kStd[c]);
    }
    in_s[(c * IR + row) * IC + col] = v;
  }
  __syncthreads();

  // Pooled conv1 map of the tile: channel = tid % 32, 8 positions in flight.
  {
    const int c = tid % C1;
    const float* wc = w1_s + c * W1S;
    for (int pos = tid / C1; pos < P1R * P1C; pos += kThreads / C1) {
      const int pr = pos / P1C, pc = pos % P1C;
      const int gp = p_r0 + pr, gq = p_c0 + pc;
      float v = 0.f;
      if (gp >= 0 && gp < h2 && gq >= 0 && gq < w2d) {
        float acc[2][2];
        const float bias = wc[27];
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) acc[dy][dx] = bias;
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
          float win[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s)
              win[r][s] = in_s[(ci * IR + 2 * pr + r) * IC + 2 * pc + s];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float wt = wc[(ky * 3 + kx) * 3 + ci];
#pragma unroll
              for (int dy = 0; dy < 2; ++dy)
#pragma unroll
                for (int dx = 0; dx < 2; ++dx)
                  acc[dy][dx] += wt * win[dy + ky][dx + kx];
            }
        }
        const float m = fmaxf(fmaxf(acc[0][0], acc[0][1]),
                              fmaxf(acc[1][0], acc[1][1]));
        v = round_t<T>(leaky(m));
      }
      p1_s[pos * C1 + c] = v;
    }
  }
  __syncthreads();

  // conv2 + pool: out channel = tid % 64, 4 output positions in flight.
  {
    const int o = tid % C2;
    const float* wo = w2_s + o * K2;
    for (int pos = tid / C2; pos < TR * TC; pos += kThreads / C2) {
      const int tr = pos / TC, tc = pos % TC;
      const int fr = r0 + tr, fc = c0 + tc;
      if (fr >= h4 || fc >= w4) continue;
      float acc[2][2];
      const float bias = wo[288];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) acc[dy][dx] = bias;
      for (int ci = 0; ci < C1; ++ci) {
        float win[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            win[r][s] = p1_s[((2 * tr + r) * P1C + 2 * tc + s) * C1 + ci];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float wt = wo[(ky * 3 + kx) * C1 + ci];
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
              for (int dx = 0; dx < 2; ++dx)
                acc[dy][dx] += wt * win[dy + ky][dx + kx];
          }
      }
      const float m = fmaxf(fmaxf(acc[0][0], acc[0][1]),
                            fmaxf(acc[1][0], acc[1][1]));
      out[((static_cast<size_t>(b) * h4 + fr) * w4 + fc) * C2 + o] =
          from_f<T>(leaky(m));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, void* out, int b,
           int h, int w, void* stream) {
  if (b <= 0 || h < 4 || w < 4) return cudaErrorInvalidValue;
  // Above the 48 KB default; the attribute is per device, so set it on
  // every launch (the current device may differ from the last call's).
  const size_t smem = sizeof(float) * kSmemFloats;
  cudaError_t e = cudaFuncSetAttribute(
      superstem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int h4 = h / 2 / 2, w4 = w / 2 / 2;
  const dim3 grid((w4 + TC - 1) / TC, (h4 + TR - 1) / TR, b);
  superstem_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<T*>(out), h, w);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 route: tensor cores.

namespace tc {

constexpr int TR = 8;                   // final output rows per CTA
constexpr int TC = 16;                  // final output cols per CTA
constexpr int P1R = 2 * TR + 2;         // pooled-1 rows incl. conv2 halo
constexpr int P1C = 2 * TC + 2;
constexpr int NP1 = P1R * P1C;          // pooled-1 positions (612)
constexpr int IR = 2 * P1R + 2;         // input rows incl. conv1 halo
constexpr int IC = 2 * P1C + 2;
constexpr int C2 = 64;
constexpr int K1 = 28, K2 = 289;        // folded weight row lengths
constexpr int W2S = 296;                // smem row stride of w2 (592 B)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups1 = (NP1 + 7) / 8;  // pool groups of 8 windows, conv1
constexpr int kGroups2 = TR * TC / 8;    // and conv2 (16)

// Shared memory, in bytes: pooled-1 tile [NP1][64 B] (swizzled), w2
// [64][W2S] bf16, the input tile [IR][IC][3] bf16, conv2's bias [64] f32.
constexpr int kP1Bytes = NP1 * 64;
constexpr int kW2Bytes = C2 * W2S * 2;
constexpr int kInBytes = (IR * IC * 3 * 2 + 15) / 16 * 16;
constexpr int kSmem = kP1Bytes + kW2Bytes + kInBytes + C2 * 4;

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Byte offset of 16-byte chunk `c` (8 channels) of pooled-1 position `pos`:
// the chunk index is XORed with bits 1-2 of the position, which spreads the
// 8 rows of every ldmatrix phase over all 32 banks (see the row order).
__device__ __forceinline__ int p1_offset(int pos, int c) {
  return pos * 64 + ((c ^ ((pos >> 1) & 3)) << 4);
}

// Row order of a pair of m16 tiles (dy = 0, 1) covering 8 pool windows:
// row r holds window r % 8 at column offset dx = (r / 8 + (r % 8) / 4) % 2,
// so thread (g, q) holds window g's four positions in rows g and g + 8 of
// both tiles, and the 8 rows of each ldmatrix phase alternate position
// parity in fours.
__device__ __forceinline__ int row_dx(int r) { return (r / 8 + (r % 8) / 4) & 1; }

__device__ __forceinline__ float leaky(float v) {
  return v > 0.f ? v : 0.1f * v;
}

__global__ void __launch_bounds__(kThreads, 2)
superstem_tc_kernel(const uint8_t* __restrict__ x,          // [B, H, W, 3]
                    const __nv_bfloat16* __restrict__ w1,   // [32, 28]
                    const __nv_bfloat16* __restrict__ w2,   // [64, 289]
                    __nv_bfloat16* __restrict__ out,        // [B, H4, W4, 64]
                    int h, int w) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* p1_s = tc_smem;
  uint16_t* w2_s = reinterpret_cast<uint16_t*>(tc_smem + kP1Bytes);
  uint16_t* in_s = reinterpret_cast<uint16_t*>(tc_smem + kP1Bytes + kW2Bytes);
  float* bias2_s =
      reinterpret_cast<float*>(tc_smem + kP1Bytes + kW2Bytes + kInBytes);

  const int h2 = h / 2, w2d = w / 2;
  const int h4 = h2 / 2, w4 = w2d / 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TR;         // first final output row
  const int c0 = blockIdx.x * TC;
  const int p_r0 = 2 * r0 - 1;            // first pooled-1 row in p1_s
  const int p_c0 = 2 * c0 - 1;
  const int i_r0 = 2 * p_r0 - 1;          // first input row in in_s
  const int i_c0 = 2 * p_c0 - 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;

  // w2 without its bias column, rows padded to W2S; the bias apart in f32.
  const uint16_t* w2u = reinterpret_cast<const uint16_t*>(w2);
  for (int t = tid; t < C2 * (K2 - 1); t += kThreads) {
    const int o = t / (K2 - 1), k = t % (K2 - 1);
    w2_s[o * W2S + k] = w2u[o * K2 + k];
  }
  if (tid < C2) bias2_s[tid] = __bfloat162float(w2[tid * K2 + K2 - 1]);

  // Normalized input tile, zero outside the image (conv1's SAME padding).
  const uint8_t* xb = x + static_cast<size_t>(b) * h * w * 3;
  for (int t = tid; t < IR * IC * 3; t += kThreads) {
    const int c = t % 3;
    const int col = (t / 3) % IC;
    const int row = t / (3 * IC);
    const int gy = i_r0 + row, gx = i_c0 + col;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const float px = static_cast<float>(
          xb[(static_cast<size_t>(gy) * w + gx) * 3 + c]);
      v = (px / 255.f - kMean[c]) / kStd[c];
    }
    in_s[t] = bf16_bits(v);
  }

  // conv1's B fragments (w1 rows as columns of B), K padded to 32 with
  // zeros: b[j][s][0] = w1[8j + g][16s + 2q + {0, 1}], [1] at + 8.
  const uint16_t* w1u = reinterpret_cast<const uint16_t*>(w1);
  uint32_t b1f[4][2][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        const int k = 16 * s + 2 * q + 8 * hk;
        const uint16_t* row = w1u + (8 * j + g) * K1;
        b1f[j][s][hk] = pack(k < K1 ? row[k] : 0, k + 1 < K1 ? row[k + 1] : 0);
      }
  // This thread's 8 values of K (16s + 2q + 8hk + e): offsets into the
  // input tile, or -1 for the bias tap (reads 1.0), -2 past it (zero).
  int koff[2][2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * s + 2 * q + 8 * hk + e;
        const int ky = k / 9, kx = (k % 9) / 3, ci = k % 3;
        koff[s][hk][e] = k < 27 ? (ky * IC + kx) * 3 + ci : (k == 27 ? -1 : -2);
      }
  __syncthreads();

  // conv1 + pool + leaky -> pooled-1 tile.  Warp-strided pool groups of 8
  // windows in row-major order over the 18 x 34 tile.
  for (int grp = warp; grp < kGroups1; grp += kWarps) {
    const int wi = grp * 8 + g;             // this thread's window
    const int wc = wi < NP1 ? wi : NP1 - 1;
    const int pr = wc / P1C, pc = wc % P1C;
    float acc[2][4][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[t][j][r] = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {           // t = dy
      int base[2];                           // rows g, g + 8
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        base[hr] = ((2 * pr + t) * IC + 2 * pc + row_dx(g + 8 * hr)) * 3;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t a[4];
#pragma unroll
        for (int hk = 0; hk < 2; ++hk)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            uint16_t v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int off = koff[s][hk][e];
              const uint16_t tap = in_s[base[hr] + (off >= 0 ? off : 0)];
              v[e] = off >= 0 ? tap : (off == -1 ? 0x3F80 : 0);  // 1.0, 0
            }
            a[2 * hk + hr] = pack(v[0], v[1]);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[t][j], a, b1f[j][s][0], b1f[j][s][1]);
      }
    }
    if (wi < NP1) {
      const int gp = p_r0 + pr, gq = p_c0 + pc;
      const bool inside = gp >= 0 && gp < h2 && gq >= 0 && gq < w2d;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint16_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = fmaxf(fmaxf(acc[0][j][e], acc[0][j][2 + e]),
                                fmaxf(acc[1][j][e], acc[1][j][2 + e]));
          v[e] = inside ? bf16_bits(leaky(m)) : 0;
        }
        *reinterpret_cast<uint32_t*>(p1_s + p1_offset(wi, j) + 4 * q) =
            pack(v[0], v[1]);
      }
    }
  }
  __syncthreads();

  // conv2 + pool + bias + leaky -> output.  Pool group grp covers final
  // row grp / 2, columns (grp % 2) * 8 + 0..7 of the tile.
  const uint32_t p1_u = static_cast<uint32_t>(__cvta_generic_to_shared(p1_s));
  const uint32_t w2_u = static_cast<uint32_t>(__cvta_generic_to_shared(w2_s));
  // ldmatrix lanes: A row r = lane % 8 + 8 * (lane / 8 % 2), K half
  // lane / 16; B row n = lane % 8 (+ 8 for lanes 16-31), K half lane / 8 % 2.
  const int ar = lane % 8 + 8 * ((lane / 8) % 2), akh = lane / 16;
  const uint32_t b_lane =
      w2_u + ((lane % 8 + 8 * (lane / 16)) * W2S + 8 * ((lane / 8) % 2)) * 2;
  for (int grp = warp; grp < kGroups2; grp += kWarps) {
    const int fy = grp / 2, fx0 = (grp % 2) * 8;
    int pos0[2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
      pos0[t] = (2 * fy + t) * P1C + 2 * (fx0 + ar % 8) + row_dx(ar);
    float acc[2][8][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[t][j][r] = 0.f;
#pragma unroll
    for (int s = 0; s < 18; ++s) {
      const int tap = s / 2, ky = tap / 3, kx = tap % 3;
      const int chunk = (s % 2) * 2 + akh;
      uint32_t a[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int pos = pos0[t] + ky * P1C + kx;
        ldmatrix_x4(a[t], p1_u + p1_offset(pos, chunk));
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b_lane + (16 * jp * W2S + 16 * s) * 2);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(acc[t][2 * jp], a[t], bf[0], bf[1]);
          mma_bf16(acc[t][2 * jp + 1], a[t], bf[2], bf[3]);
        }
      }
    }
    const int fr = r0 + fy, fc = c0 + fx0 + g;
    if (fr < h4 && fc < w4) {
      __nv_bfloat16* o =
          out + ((static_cast<size_t>(b) * h4 + fr) * w4 + fc) * C2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = 8 * j + 2 * q;
        uint16_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = fmaxf(fmaxf(acc[0][j][e], acc[0][j][2 + e]),
                                fmaxf(acc[1][j][e], acc[1][j][2 + e]));
          v[e] = bf16_bits(leaky(m + bias2_s[ch + e]));
        }
        *reinterpret_cast<uint32_t*>(o + ch) = pack(v[0], v[1]);
      }
    }
  }
}

int launch(const void* x, const void* w1, const void* w2, void* out, int b,
           int h, int w, void* stream) {
  if (b <= 0 || h < 4 || w < 4) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      superstem_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const int h4 = h / 2 / 2, w4 = w / 2 / 2;
  const dim3 grid((w4 + TC - 1) / TC, (h4 + TR - 1) / TR, b);
  superstem_tc_kernel<<<grid, kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<__nv_bfloat16*>(out),
      h, w);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// bf16 runs on the tensor cores, f32 as a direct convolution.
extern "C" int superstem_bf16(const void* x, const void* w1, const void* w2,
                              void* out, int b, int h, int w, void* stream) {
  return tc::launch(x, w1, w2, out, b, h, w, stream);
}

extern "C" int superstem_f32(const void* x, const void* w1, const void* w2,
                             void* out, int b, int h, int w, void* stream) {
  return launch<float>(x, w1, w2, out, b, h, w, stream);
}
