// Two-pass affine warp with zero fill over a batch of NHWC f32 images.
//
// Replaces: odc_tpu/ops/pallas/warp_kernel.py::warp_affine_pallas (kernel
// body _warp_kernel, translation _translate_ext), the Pallas TPU kernel of
// the in-step device augmentation.
//
// Computes what odc_tpu/ops/warp.py::warp_affine_twopass computes.  With
// (p, mx0, q1, d, my0, c) = twopass_coeffs(m_inv), kx = shift_kmax(H),
// ky = shift_kmax(W) and V zero outside the plane:
//
//   pass X, row y:     tau = clip(q1*(y - (H-1)/2), +-kx), k = floor(tau),
//                      f = tau - k,
//                      E[j]       = V[y, j-kx+k] + f*(V[y, j-kx+k+1] - V[y, j-kx+k])
//                      s = p*xo + (mx0 + kx), i0 = floor(s),
//                      tmp[y, xo] = (1-|s-i0|)*E[i0] + (1-|s-i0-1|)*E[i0+1]
//   pass Y, column x:  the same along rows of tmp (zero outside [0, H)),
//                      with c*(x - (W-1)/2), ky, slope d, offset my0.
//
// Each pass chains two linear interpolations, so it reads THREE source taps
// (u0, u0+1, u0+2 with u0 = i0 - kmax + k); it collapses to two only when
// the shear is zero.  This is not the one-shot bilinear warp: rotations
// interpolate once per pass.
//
// The TPU kernel built E with a barrel shifter of rolls on a padded canvas
// and resampled with a dense hat-matrix product, because gathers are slow
// there.  None of that carries over: here every output pixel reads its taps
// directly.  Both passes are fused in ONE launch: a thread owns one output
// pixel (all channels), recomputes the three tmp values it needs (rows r0,
// r0+1, r0+2 at its own column, three source taps each, nine taps in all)
// and blends them, so the [H, W] intermediate never exists in memory.
//
// What bounds it on this card: bytes.  Each image is read once and written
// once (2 * B*H*W*C*4 bytes; about 20 flops per byte moved, far below the
// f32 roofline), and the nine taps of neighbouring threads overlap, so the
// re-reads are served by L1/L2.  Threads of a warp walk along x, which keeps
// the stores and, for the slopes of the augmentation family (|p| in
// 0.6..1.7), the loads coalesced.
//
// Arithmetic is f32.  The file is built with -fmad=false (see
// ops/cuda/build.py): a sample position such as p*xo + off reaches several
// hundred, where one f32 ulp is 6e-5 px; a contracted multiply-add rounds it
// differently from the plain PyTorch version (separate multiply and add),
// and on an image with 255-level steps between neighbours that alone would
// move an output by 0.015.  Uncontracted, the pass coefficients (computed
// here from the inverse map, op for op as ops/warp.py::twopass_coeffs),
// the positions and hence tap indices and fractions are bitwise those of
// the plain version, and the outputs differ only by the order of the final
// blends.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kPadMargin = 4;  // ops/warp.py::_PAD_MARGIN
constexpr int kMaxC = 4;

struct Resample {
  int i0;       // first index on the extended axis
  float w0, w1; // hat weights of i0 and i0 + 1
};

// Hat weights at position s = slope*o + offset on an extended axis of n_ext
// lanes.  Positions far outside are pulled to just outside: every tap they
// reach is zero fill either way, and the int conversion stays defined.
__device__ __forceinline__ Resample resample(float slope, float offset, int o,
                                             int n_ext) {
  float s = slope * static_cast<float>(o) + offset;
  s = fminf(fmaxf(s, -4.f), static_cast<float>(n_ext + 4));
  const float fl = floorf(s);
  Resample r;
  r.i0 = static_cast<int>(fl);
  r.w0 = fmaxf(0.f, 1.f - fabsf(s - fl));
  r.w1 = fmaxf(0.f, 1.f - fabsf(s - (fl + 1.f)));
  return r;
}

struct Shift {
  int k;    // integer part of the translation
  float f;  // fractional part, in [0, 1)
};

__device__ __forceinline__ Shift shift(float slope, int r, float center,
                                       int kmax) {
  float tau = slope * (static_cast<float>(r) - center);
  tau = fminf(fmaxf(tau, -static_cast<float>(kmax)), static_cast<float>(kmax));
  const float fl = floorf(tau);
  Shift s;
  s.k = static_cast<int>(fl);
  s.f = tau - fl;
  return s;
}

template <int C>
__global__ void __launch_bounds__(kBlockX* kBlockY)
warp_affine_kernel(const float* __restrict__ images,  // [B, H, W, C]
                   const float* __restrict__ m_invs,  // [B, 3, 3]
                   float* __restrict__ out,           // [B, H, W, C]
                   int h, int w, int kx, int ky) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int yo = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || yo >= h) return;
  const size_t b = blockIdx.z;
  // ops/warp.py::twopass_coeffs, with its clamp of a near-zero d.
  const float* m = m_invs + b * 9;
  const float d = m[4], c = m[3];
  const float d_safe = fabsf(d) < 1e-3f ? (d < 0.f ? -1e-3f : 1e-3f) : d;
  const float q1 = m[1] / d_safe;
  const float p = m[0] - q1 * c;
  const float q0 = m[2] - q1 * m[5];
  const float mx0 = q0 + q1 * ((h - 1) / 2.0f);
  const float my0 = m[5] + c * ((w - 1) / 2.0f);
  const float* img = images + b * static_cast<size_t>(h) * w * C;

  // Pass Y geometry of this output pixel: rows r0, r0+1, r0+2 of tmp.
  const Shift sy = shift(c, x, (w - 1) / 2.0f, ky);
  const Resample ry =
      resample(d, my0 + static_cast<float>(ky), yo, h + 2 * ky + kPadMargin);
  const int r0 = ry.i0 - ky + sy.k;
  // Pass X geometry at column x: the same for every row but for the shift.
  const Resample rx =
      resample(p, mx0 + static_cast<float>(kx), x, w + 2 * kx + kPadMargin);

  float t[3][C];  // tmp[r0 + i, x, :]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int r = r0 + i;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) t[i][ch] = 0.f;
    if (r < 0 || r >= h) continue;  // tmp is zero outside [0, H)
    const Shift sx = shift(q1, r, (h - 1) / 2.0f, kx);
    const int u0 = rx.i0 - kx + sx.k;
    const float* row = img + static_cast<size_t>(r) * w * C;
    float v[3][C];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int u = u0 + j;
      const bool in = (u >= 0) && (u < w);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) v[j][ch] = in ? row[u * C + ch] : 0.f;
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float e0 = v[0][ch] + sx.f * (v[1][ch] - v[0][ch]);
      const float e1 = v[1][ch] + sx.f * (v[2][ch] - v[1][ch]);
      t[i][ch] = rx.w0 * e0 + rx.w1 * e1;
    }
  }

  float* dst = out + ((b * h + yo) * static_cast<size_t>(w) + x) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float e0 = t[0][ch] + sy.f * (t[1][ch] - t[0][ch]);
    const float e1 = t[1][ch] + sy.f * (t[2][ch] - t[1][ch]);
    dst[ch] = ry.w0 * e0 + ry.w1 * e1;
  }
}

template <int C>
cudaError_t launch(const float* images, const float* m_invs, float* out,
                   int batch, int h, int w, int kx, int ky,
                   cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY,
                  batch);
  warp_affine_kernel<C><<<grid, block, 0, stream>>>(images, m_invs, out, h, w,
                                                    kx, ky);
  return cudaGetLastError();
}

}  // namespace

// images, out: [batch, h, w, channels] f32, contiguous; m_invs: [batch, 3, 3]
// f32 inverse maps, contiguous; kx, ky: the static shift bounds for the rows
// and the columns.  Launches on `stream`; returns the cudaError_t of the
// launch (0 = success).
extern "C" int warp_affine(const void* images, const void* m_invs, void* out,
                           int batch, int h, int w, int channels, int kx,
                           int ky, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || kx < 0 || ky < 0 ||
      channels < 1 || channels > kMaxC) {
    return cudaErrorInvalidValue;
  }
  const float* src = static_cast<const float*>(images);
  const float* mi = static_cast<const float*>(m_invs);
  float* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 1: return launch<1>(src, mi, dst, batch, h, w, kx, ky, s);
    case 2: return launch<2>(src, mi, dst, batch, h, w, kx, ky, s);
    case 3: return launch<3>(src, mi, dst, batch, h, w, kx, ky, s);
    default: return launch<4>(src, mi, dst, batch, h, w, kx, ky, s);
  }
}
