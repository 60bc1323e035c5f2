// Inference epilogue of a Mish conv block (YOLOv4's CBM): conv bias +
// BatchNorm (running statistics) + Mish + the cast to bf16, in one pass over
// the bf16 map.
//
// The twin of bias_bn_leaky.cu with Mish in place of leaky.  Unfused, ATen
// runs the bf16 bias add, four f32 BN passes, Mish and the cast back as
// separate passes, each reading and writing the whole map: about 60-70 bytes
// of HBM traffic per element where the function needs 4 (read the bf16 conv
// output once, write the bf16 result once).
//
// Computes, for x [M, C] bf16 (the conv output WITHOUT its bias, NHWC
// flattened) and f32 [C] vectors conv_bias, mean, var, weight, shift:
//   t = bf16(x + bf16(conv_bias))              ATen's bf16 bias add
//   y = ((t - mean) * rsqrt(var + eps)) * weight + shift    f32, op by op
//   out = bf16(y * tanhf(log1pf(expf(y))))     ATen's CUDA Mish, then the
//                                              cast, round to nearest even
// The bias and BN round op by op with __fadd_rn / __fmul_rn (never
// contracted), and rsqrt(var + eps) is rsqrtf of the f32 sum, as
// torch.rsqrt computes it.  Mish (see mish() below) is a cheaper formula
// whose bf16 result equals ATen's for every f32 input, falling back to
// ATen's formula, from the same CUDA math library functions, near bf16
// rounding midpoints.  This file builds WITHOUT -fmad=false, because ATen
// compiles its Mish kernel with contraction on and the library functions'
// arithmetic contracts alike.  The result is bitwise that of the unfused
// passes and of the plain version
// (ops/cuda/bias_bn_mish_kernel.py::bias_bn_mish_plain).
//
// What bounds it on this card: bytes, 4 per element (2 in, 2 out) at
// 3.35 TB/s.  The arithmetic, about 25 instructions an element, is near the
// bytes' time, so the design keeps the instructions few and many warps in
// flight to overlap the two (ATen's formula alone, several dozen instructions
// more, ran at 52% of the bound).  The layout is bias_bn_leaky.cu's with half
// its vector:
// * 8-byte loads and stores, 4 channels a thread (the launcher checks
//   C % 8 == 0 and 16-byte aligned bases, the leaky kernel's contract);
// * a grid-stride loop whose stride is a multiple of C / 4, so a thread
//   keeps one group of 4 channels for its whole life and computes their
//   constants once, into registers (20, where 8 channels took 40, so
//   kMinCtas CTAs fit an SM);
// * a persistent grid, as many CTAs as fit on the SMs at once, each thread
//   with kUnroll independent 8-byte loads in flight, the bounds tested once
//   an iteration.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // 8-byte loads in flight a thread
constexpr int kMinCtas = 4;  // CTAs an SM at least (caps the registers)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Bit distance, in f32 ulps of the result, within which the fast Mish may
// lie from ATen's; a fast result this close to a bf16 rounding midpoint is
// recomputed by ATen's formula.  Over all 2^32 inputs on an H100 (nvcc
// 12.9), 8 lets 20 inputs round the other way and 16 none; 32 is twice that.
constexpr unsigned kGuard = 32;

// ATen's CUDA Mish (ActivationMishKernel.cu), out of line: it runs only for
// the few inputs the fast formula below cannot settle, and one copy of its
// code keeps the unrolled loop small.
__device__ __noinline__ float mish_aten(float y) {
  return y * tanhf(log1pf(expf(y)));
}

// Hardware 2^x and a / b, flushing denormals: on the fast path's domain
// (|y| <= 20) neither meets one, and the flushing forms are a single
// instruction each where __expf and __fdividef add denormal handling.
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float div_ftz(float a, float b) {
  float r;
  asm("div.approx.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Mish on an f32 value, equal after the cast to bf16 to mish_aten for every
// f32 input.  tanh(log1p(e)) = n / (n + 2) with n = e (e + 2): with
// e = 2^(y log2 e) that costs two hardware approximations (ex2, rcp) and a
// few multiplies and adds instead of expf, log1pf and tanhf.  Where that
// result lies within kGuard ulps of a bf16 rounding midpoint (low 16 bits
// near 0x8000), where |y| > 20 (e * e nears overflow) and for NaN, mish_aten
// decides.  The card checks run this function over all 2^32 f32 inputs
// against F.mish (bias_bn_mish_table).
__device__ __forceinline__ float mish(float y) {
  const float e = ex2_ftz(y * 1.44269504f);
  const float n = e * (e + 2.f);
  const float r = y * div_ftz(n, n + 2.f);
  const unsigned lo = __float_as_uint(r) & 0xFFFFu;
  if (!(fabsf(y) <= 20.f) || (lo + kGuard - 0x8000u) <= 2u * kGuard) {
    return mish_aten(y);
  }
  return r;
}

// The 4 channels of one 8-byte vector: bf16 in, bf16 out.
__device__ __forceinline__ uint2 epilogue4(uint2 in, const float* cb,
                                           const float* mean,
                                           const float* inv, const float* w,
                                           const float* shift) {
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(&in);
  uint2 res;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float t = bf16_round(__fadd_rn(__bfloat162float(xs[j]), cb[j]));
    float y = __fmul_rn(__fadd_rn(t, -mean[j]), inv[j]);
    y = __fadd_rn(__fmul_rn(y, w[j]), shift[j]);
    ys[j] = __float2bfloat16_rn(mish(y));
  }
  return res;
}

__global__ void __launch_bounds__(kThreads, kMinCtas) bias_bn_mish_kernel(
    const uint2* __restrict__ x, uint2* __restrict__ out,
    const float* __restrict__ conv_bias, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ weight,
    const float* __restrict__ shift, long long n_vec, int groups,
    long long stride, float eps) {
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // Threads past the last whole multiple of `groups` have no fixed group.
  if (v >= stride) return;
  const int c0 = static_cast<int>(v % groups) * 4;
  float cb[4], mu[4], inv[4], w[4], sh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cb[j] = bf16_round(conv_bias[c0 + j]);
    mu[j] = mean[c0 + j];
    inv[j] = rsqrtf(__fadd_rn(var[c0 + j], eps));
    w[j] = weight[c0 + j];
    sh[j] = shift[c0 + j];
  }
  uint2 in[kUnroll];
  // Whole iterations: every load in bounds, no per-load test.
  for (; v + (kUnroll - 1) * stride < n_vec; v += kUnroll * stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) in[u] = __ldg(x + v + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      out[v + u * stride] = epilogue4(in[u], cb, mu, inv, w, sh);
    }
  }
  // The last, partial one.
#pragma unroll 1
  for (; v < n_vec; v += stride) {
    out[v] = epilogue4(__ldg(x + v), cb, mu, inv, w, sh);
  }
}

// The bf16 bits of mish() of the f32 inputs start .. start + count - 1.
__global__ void bias_bn_mish_table_kernel(uint32_t start, long long count,
                                          uint16_t* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += step) {
    const float y = __uint_as_float(start + static_cast<uint32_t>(i));
    out[i] = __bfloat16_as_ushort(__float2bfloat16_rn(mish(y)));
  }
}

// CTAs of bias_bn_mish_kernel that fit on one SM of each device, and its SM
// count: asked once a device (0 = not asked yet).
std::atomic<int> g_ctas_per_sm[kMaxDevices];
std::atomic<int> g_sms[kMaxDevices];

cudaError_t grid_limit(int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int ctas = g_ctas_per_sm[dev].load(std::memory_order_relaxed);
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (ctas == 0 || sms == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, bias_bn_mish_kernel, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (ctas < 1) ctas = 1;
    g_ctas_per_sm[dev].store(ctas, std::memory_order_relaxed);
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  *limit = ctas * sms;
  return cudaSuccess;
}

}  // namespace

// out[m, c] from x[m, c] (bf16, the conv output without bias) and the f32
// [c] vectors, on `stream`.  Needs c % 8 == 0 and 16-byte aligned x and
// out.  Returns 0 or a cudaError_t.
extern "C" int bias_bn_mish_bf16(const void* x, void* out,
                                 const void* conv_bias, const void* mean,
                                 const void* var, const void* weight,
                                 const void* shift, long long m, int c,
                                 float eps, void* stream) {
  if (m < 0 || c <= 0 || c % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0) {
    return cudaErrorInvalidValue;
  }
  const int groups = c / 4;
  const long long n_vec = m * groups;
  if (n_vec == 0) return cudaSuccess;
  int limit = 0;
  cudaError_t e = grid_limit(&limit);
  if (e != cudaSuccess) return e;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > limit) blocks = limit;
  // At least `groups` threads, so the stride below is not 0.
  const long long min_blocks = (groups + kThreads - 1) / kThreads;
  if (blocks < min_blocks) blocks = min_blocks;
  const long long stride = (blocks * kThreads / groups) * groups;
  bias_bn_mish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(x), static_cast<uint2*>(out),
      static_cast<const float*>(conv_bias), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(weight),
      static_cast<const float*>(shift), n_vec, groups, stride, eps);
  return cudaGetLastError();
}

// The bf16 bits of the kernel's Mish of the f32 inputs whose bit patterns
// are start .. start + count - 1 (wrapping), into out[count] (uint16), on
// `stream`: the card checks hold them against F.mish for all 2^32 inputs.
extern "C" int bias_bn_mish_table(unsigned int start, long long count,
                                  void* out, void* stream) {
  if (count < 0) return cudaErrorInvalidValue;
  if (count == 0) return cudaSuccess;
  bias_bn_mish_table_kernel<<<1024, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      start, count, static_cast<uint16_t*>(out));
  return cudaGetLastError();
}
