// Inference epilogue of a conv block: conv bias + BatchNorm (running
// statistics) + LeakyReLU + the cast to bf16, in one pass over the bf16 map.
//
// Replaces no TPU kernel: on the TPU, XLA fused these elementwise ops into
// the convolution's epilogue.  On the card, ATen ran them as separate passes
// (the bf16 bias add, four f32 BN passes, leaky, the cast back), each
// reading and writing the whole map: about 60-70 bytes of HBM traffic per
// element where the function needs 4 (read the bf16 conv output once, write
// the bf16 result once).
//
// Computes, for x [M, C] bf16 (the conv output WITHOUT its bias, NHWC
// flattened) and f32 [C] vectors conv_bias, mean, var, weight, shift:
//   t = bf16(x + bf16(conv_bias))              ATen's bf16 bias add
//   y = ((t - mean) * rsqrt(var + eps)) * weight + shift    f32, op by op
//   y = y > 0 ? y : y * slope                  f32
//   out = bf16(y)                              round to nearest even
// Every operation rounds on its own, as ATen's separate kernels do
// (__fadd_rn / __fmul_rn, and the build passes -fmad=false), and
// rsqrt(var + eps) is rsqrtf of the f32 sum, as torch.rsqrt computes it, so
// the result is bitwise that of the unfused passes and of the plain version
// (ops/cuda/bias_bn_leaky_kernel.py::bias_bn_leaky_plain).
//
// What bounds it on this card: bytes, 4 per element (2 in, 2 out) at
// 3.35 TB/s; the arithmetic is 8 f32 operations an element.  The design:
// * 16-byte loads and stores, 8 channels a thread (C % 8 == 0 and 16-byte
//   aligned bases, which the launcher checks);
// * a grid-stride loop whose stride is a multiple of C / 8, so a thread
//   keeps one group of 8 channels for its whole life and computes their
//   constants (the rounded bias, mean, rsqrt(var + eps), weight, shift)
//   once, into registers;
// * a persistent grid, as many CTAs as fit on the SMs at once, each thread
//   with kUnroll independent 16-byte loads in flight, so the small 13 x 13
//   maps are not dominated by launch tails and the large ones keep enough
//   bytes in flight to cover the memory latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The 8 channels of one 16-byte vector: bf16 in, bf16 out.
__device__ __forceinline__ uint4 epilogue8(uint4 in, const float* cb,
                                           const float* mean,
                                           const float* inv, const float* w,
                                           const float* shift, float slope) {
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(&in);
  uint4 res;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t = bf16_round(__fadd_rn(__bfloat162float(xs[j]), cb[j]));
    float y = __fmul_rn(__fadd_rn(t, -mean[j]), inv[j]);
    y = __fadd_rn(__fmul_rn(y, w[j]), shift[j]);
    y = y > 0.f ? y : __fmul_rn(y, slope);
    ys[j] = __float2bfloat16_rn(y);
  }
  return res;
}

__global__ void __launch_bounds__(kThreads) bias_bn_leaky_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ out,
    const float* __restrict__ conv_bias, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ weight,
    const float* __restrict__ shift, long long n_vec, int groups,
    long long stride, float eps, float slope) {
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // Threads past the last whole multiple of `groups` have no fixed group.
  if (v >= stride) return;
  const int c0 = static_cast<int>(v % groups) * 8;
  float cb[8], mu[8], inv[8], w[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cb[j] = bf16_round(conv_bias[c0 + j]);
    mu[j] = mean[c0 + j];
    inv[j] = rsqrtf(__fadd_rn(var[c0 + j], eps));
    w[j] = weight[c0 + j];
    sh[j] = shift[c0 + j];
  }
  for (; v < n_vec; v += kUnroll * stride) {
    uint4 in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * stride;
      if (i < n_vec) in[u] = __ldg(x + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * stride;
      if (i < n_vec) out[i] = epilogue8(in[u], cb, mu, inv, w, sh, slope);
    }
  }
}

// CTAs of bias_bn_leaky_kernel that fit on one SM of each device, and its
// SM count: asked once a device (0 = not asked yet).
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
        &ctas, bias_bn_leaky_kernel, kThreads, 0);
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
extern "C" int bias_bn_leaky_bf16(const void* x, void* out,
                                  const void* conv_bias, const void* mean,
                                  const void* var, const void* weight,
                                  const void* shift, long long m, int c,
                                  float eps, float slope, void* stream) {
  if (m < 0 || c <= 0 || c % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0) {
    return cudaErrorInvalidValue;
  }
  const int groups = c / 8;
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
  bias_bn_leaky_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out),
      static_cast<const float*>(conv_bias), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(weight),
      static_cast<const float*>(shift), n_vec, groups, stride, eps, slope);
  return cudaGetLastError();
}
