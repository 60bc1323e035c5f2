// Native data-loader core: libjpeg decode + bilinear resize.
//
// The port's own copy of the JAX package's loader (same C ABI, same
// arithmetic): the reference decodes with cv2 (C++) and resizes with
// albumentations; this library does both directly against libjpeg so the
// Python hot loop never touches pixel data.  Exposed through a C ABI
// consumed via ctypes (odc_tpu_torch/native/loader.py).
//
// All functions return 0 on success, negative error codes otherwise.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to RGB8. Returns 0 and fills rows on success.
int decode_impl(const char* path, uint8_t* out, int expect_h, int expect_w,
                int* out_h, int* out_w, bool header_only) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (header_only) {
    if (out_h) *out_h = static_cast<int>(cinfo.image_height);
    if (out_w) *out_w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
  }

  jpeg_start_decompress(&cinfo);
  const int h = static_cast<int>(cinfo.output_height);
  const int w = static_cast<int>(cinfo.output_width);
  if (out_h) *out_h = h;
  if (out_w) *out_w = w;
  if (expect_h >= 0 && (h != expect_h || w != expect_w)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }

  const int stride = w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Bilinear resize RGB8, cv2 INTER_LINEAR scalar-reference semantics:
// half-pixel centers, 11-bit fixed-point coefficients
// (INTER_RESIZE_COEF_BITS), separable H-then-V integer passes, final
// rounding (acc + 2^21) >> 22.  Coefficient rounding is round-half-to-even
// (nearbyint), matching numpy's rint — the python oracle in
// tests/cv2_resize_oracle.py reimplements this scheme bit-exactly.  (Real cv2
// SIMD builds use a reduced-precision vertical pass and may differ by
// <= 1 lsb; the float-convention oracle bounds that.)
constexpr int kCoefBits = 11;
constexpr int kCoefScale = 1 << kCoefBits;  // 2048

// Sample position -> (index, 11-bit frac coefficient) with cv2 border
// rule: pos < 0 snaps to (0, 0); floor(pos) >= n-1 snaps to (n-1, 0).
inline void coef_for(double pos, int n, int* idx, int* alpha1) {
  if (pos < 0) pos = 0;
  int i = static_cast<int>(pos);  // pos >= 0: truncation == floor
  double frac = pos - i;
  if (i >= n - 1) {
    i = n - 1;
    frac = 0.0;
  }
  *idx = i;
  *alpha1 = static_cast<int>(nearbyint(frac * kCoefScale));
}

void resize_impl(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                 int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const double scale_y = static_cast<double>(sh) / dh;
  const double scale_x = static_cast<double>(sw) / dw;

  std::vector<int> x0(dw), x1(dw), a0(dw), a1(dw);
  for (int x = 0; x < dw; ++x) {
    int ix, al1;
    coef_for((x + 0.5) * scale_x - 0.5, sw, &ix, &al1);
    x0[x] = ix * 3;
    x1[x] = (ix + 1 < sw ? ix + 1 : sw - 1) * 3;
    a1[x] = al1;
    a0[x] = kCoefScale - al1;
  }

  // Horizontal pass cache: rows resampled to dw, int32 (<= 255 * 2048).
  std::vector<int32_t> hrow0(dw * 3), hrow1(dw * 3);
  int cached0 = -1, cached1 = -1;

  auto hresize = [&](int sy_idx, std::vector<int32_t>& out) {
    const uint8_t* r = src + static_cast<size_t>(sy_idx) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      const int xa = x0[x], xb = x1[x];
      for (int c = 0; c < 3; ++c) {
        out[x * 3 + c] = r[xa + c] * a0[x] + r[xb + c] * a1[x];
      }
    }
  };

  for (int y = 0; y < dh; ++y) {
    int iy, b1;
    coef_for((y + 0.5) * scale_y - 0.5, sh, &iy, &b1);
    const int b0 = kCoefScale - b1;
    const int y1 = iy + 1 < sh ? iy + 1 : sh - 1;

    if (cached0 != iy) {
      hresize(iy, hrow0);
      cached0 = iy;
    }
    if (cached1 != y1) {
      hresize(y1, hrow1);
      cached1 = y1;
    }

    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      const int64_t acc = static_cast<int64_t>(hrow0[x]) * b0 +
                          static_cast<int64_t>(hrow1[x]) * b1 +
                          (1 << (2 * kCoefBits - 1));
      int v = static_cast<int>(acc >> (2 * kCoefBits));
      if (v < 0) v = 0;
      if (v > 255) v = 255;
      drow[x] = static_cast<uint8_t>(v);
    }
  }
}

}  // namespace

extern "C" {

int odc_decode_resize_jpeg(const char* path, uint8_t* out, int out_h,
                           int out_w, int* src_h, int* src_w);

// Threaded batch decode+resize: n JPEGs -> one contiguous
// [n, out_h, out_w, 3] RGB8 buffer. src_hw (optional) receives n (h, w)
// pairs; rcs (optional) receives per-image status. Returns the number of
// failed images (0 = all good). Decode happens off the GIL on a
// std::thread pool while the device computes the previous batch (the
// reference's DataLoader runs num_workers=0, fully serial).
int odc_decode_resize_batch(const char* const* paths, int n, uint8_t* out,
                            int out_h, int out_w, int* src_hw, int* rcs,
                            int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = n;

  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);

  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int h = 0, w = 0;
      const int rc = odc_decode_resize_jpeg(
          paths[i], out + static_cast<size_t>(i) * img_bytes, out_h, out_w,
          &h, &w);
      if (src_hw) {
        src_hw[2 * i] = h;
        src_hw[2 * i + 1] = w;
      }
      if (rcs) rcs[i] = rc;
      if (rc != 0) failed.fetch_add(1);
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return failed.load();
}

int odc_jpeg_dims(const char* path, int* h, int* w) {
  return decode_impl(path, nullptr, -1, -1, h, w, /*header_only=*/true);
}

int odc_decode_jpeg(const char* path, uint8_t* out, int h, int w) {
  return decode_impl(path, out, h, w, nullptr, nullptr, false);
}

int odc_decode_resize_jpeg(const char* path, uint8_t* out, int out_h,
                           int out_w, int* src_h, int* src_w) {
  int h = 0, w = 0;
  if (odc_jpeg_dims(path, &h, &w) != 0) return -1;
  std::vector<uint8_t> buf(static_cast<size_t>(h) * w * 3);
  int rc = decode_impl(path, buf.data(), h, w, nullptr, nullptr, false);
  if (rc != 0) return rc;
  if (src_h) *src_h = h;
  if (src_w) *src_w = w;
  resize_impl(buf.data(), h, w, out, out_h, out_w);
  return 0;
}

int odc_resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                        int dh, int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0) return -1;
  resize_impl(src, sh, sw, dst, dh, dw);
  return 0;
}

}  // extern "C"
