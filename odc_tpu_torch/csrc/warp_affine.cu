// Two-pass affine warp with zero fill over a batch of NHWC images, f32 or
// uint8 in, f32 out.
//
// Replaces: odc_tpu/ops/pallas/warp_kernel.py::warp_affine_pallas (kernel
// body _warp_kernel, translation _translate_ext), the Pallas TPU kernel of
// the in-step device augmentation.  Like it, the kernel takes any input
// type it is given (here f32 or uint8) and computes in f32.
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
// there.  None of that carries over: here the taps are read directly, and
// both passes run in ONE launch with the [H, W] intermediate kept out of
// device memory.
//
// What bounds it on this card: bytes.  Each image is read once and written
// once: (esize + 4) * B*H*W*C bytes against about 20 flops per pixel and
// channel.  The design works on the other costs, memory latency (many
// bytes in flight) and instructions per output (each intermediate value
// computed once):
//
// * Column strips.  A CTA owns 32 output columns x 64 output rows.  Output
//   (yo, x) blends tmp rows r0 .. r0+2 of its column, r0 = i0(yo) - ky +
//   k(x): the row term depends on yo alone and the column term on x alone.
//   So the tmp rows a column needs form a strip that starts at lo - ky +
//   k(x) (lo the least i0 of the tile's rows) and has the same length S =
//   max i0 - min i0 + 3 in every column.  Pass X computes each of those tmp
//   values once into shared memory, slot j = r - (lo - ky + k(x)); pass Y
//   reads slots i0(yo) - lo .. +2 of its columns.  The bounds come from the
//   values the kernel computes (i0 of every row of the tile, k and the
//   pass-X index of every column, reduced over the warp), never from a
//   formula: d < 0 (a vertical flip) runs i0 downwards, k is clipped at
//   +-ky, and the resample positions are clamped.  The strips are built
//   for one half of the tile's rows at a time (32 rows fit kMaxStrip slots
//   while |d| <= 1.4; the augmentation keeps |d| <= 1.25), and a half that
//   needs more is taken in chunks that each fit.
// * Staged source rows.  Every tap pass X reads in tmp row r lies in one
//   window of the source row (the tile's least to greatest pass-X index,
//   shifted by the row's k).  A thread per row stages that window in
//   shared memory: the chunks wholly inside the row as one bulk copy of the
//   TMA, counted on an mbarrier, the chunks at the image's edges assembled
//   with zeros outside the row.  All rows of the tile (both halves) are in
//   flight at once, one wait covers them, few instructions issue them, and
//   no tap needs a bounds test.  A row table in shared memory holds each
//   row's placement and shift.  A tile whose rows exceed the staging area
//   stages each chunk's rows in batches instead.
// * Pass X by columns.  Thread (lane, warp) computes slots warp, warp + 8,
//   ... of column lane's strip from the staged rows: every lane has work,
//   and a tmp value costs its 3C shared-memory reads and the blend.  Rows
//   whose window exceeds the staging area (|p| in the hundreds) are read
//   from device memory instead, tap by tap with bounds tests.
// * Pass Y by groups of 4 columns.  A thread blends 4 adjacent outputs of
//   one row: it reads its 3 strip rows as C float4 each (conflict-free for
//   C = 3, the training shape) and writes the 4 pixels as C 16-byte
//   stores when the row segment is aligned (W*C % 4 == 0), else as scalars.
// * uint8 input is staged as bytes and converted in registers, exactly;
//   the main training path then reads 3 bytes a pixel instead of 12.
//
// Arithmetic is f32 and op for op that of the plain version.  The file is
// built with -fmad=false (see ops/cuda/build.py): a sample position such as
// p*xo + off reaches several hundred, where one f32 ulp is 6e-5 px; a
// contracted multiply-add rounds it differently from the plain PyTorch
// version (separate multiply and add), and on an image with 255-level
// steps between neighbours that alone would move an output by 0.015.
// Uncontracted, the pass coefficients (computed here from the inverse map,
// op for op as ops/warp.py::twopass_coeffs), the positions and hence tap
// indices and fractions are bitwise those of the plain version, and the
// outputs differ only by the order of the final blends.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTileX = 32;    // output columns per CTA, one per lane in pass X
constexpr int kTileY = 64;    // output rows per CTA
constexpr int kGroup = 4;     // adjacent output pixels per pass-Y thread
constexpr int kThreads = 256;  // pass Y: 32 rows x 8 groups at a time
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStrip = 48;  // tmp slots per column in shared memory
constexpr int kStageChunks = 1280;  // 16-byte chunks of staged source rows
constexpr int kMaxRows = 128;       // staged rows at a time
constexpr int kPadMargin = 4;  // ops/warp.py::_PAD_MARGIN
constexpr int kMaxC = 4;
constexpr long long kMaxImageElems = 1ll << 28;  // H * W * C

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

// One bulk copy (the TMA's 1-D form) of `bytes` from device memory to
// shared memory, both 16-byte aligned, `bytes` a multiple of 16; its
// completion is counted on `bar` in transaction bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// Announces `bytes` more of transactions on `bar`'s current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          hopper::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later ones of
// the async proxy (the bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 16-byte chunk of device memory at element a with every element
// outside the row [r0, r1) zero: a chunk that starts before its row.
template <typename T>
__device__ __noinline__ uint4 chunk_of_row(const T* base, long long a,
                                           long long r0, long long r1) {
  constexpr int kPer = 16 / sizeof(T);
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long idx = a + e;
    if (idx >= r0 && idx < r1) {
      uint32_t bits;
      if constexpr (sizeof(T) == 4) {
        bits = __float_as_uint(static_cast<float>(base[idx]));
      } else {
        bits = static_cast<uint32_t>(base[idx]) << (8 * (e % 4));
      }
      wd[(e * sizeof(T)) / 4] |= bits;
    }
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Dynamic shared memory of a CTA: the column strips (f32), then the staged
// source rows of pass X (16-byte chunks, aligned as in device memory).
template <int C>
struct Smem {
  static constexpr int kStripFloats = kMaxStrip * kTileX * C;
  static constexpr int kBytes = 4 * kStripFloats + 16 * kStageChunks;
};

// uint8 to f32, exactly, on the full-rate ALUs: 2^23 + v has v in its low
// mantissa bits.
__device__ __forceinline__ float to_float(uint8_t v) {
  return __uint_as_float(0x4b000000u | v) - 8388608.f;
}
__device__ __forceinline__ float to_float(float v) { return v; }

// Five CTAs an SM (48 registers a thread, 43 KB of shared memory at C = 3):
// each CTA waits on its setup, its staged rows and its barriers in turn,
// and the others' arithmetic fills those waits.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 5)
warp_affine_kernel(const T* __restrict__ images,      // [B, H, W, C]
                   const float* __restrict__ m_invs,  // [B, 3, 3]
                   float* __restrict__ out,           // [B, H, W, C] f32
                   int h, int w, int kx, int ky, int vec_store) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(16) uint4 smem[];
  float* strip = reinterpret_cast<float*>(smem);
  uint4* stage = smem + Smem<C>::kStripFloats / 4;
  const T* staged = reinterpret_cast<const T*>(stage);
  // Per staged row: element of pixel 0 in `staged`, k and f of its shift,
  // whether it is inside the image.
  __shared__ int4 rows[kMaxRows];
  // Per column of the tile: pass-X index and weights, pass-Y shift.
  __shared__ int col_i0[kTileX], col_k[kTileX];
  __shared__ float col_w0[kTileX], col_w1[kTileX];
  __shared__ __align__(16) float col_f[kTileX];
  // Per output row of the tile: pass-Y index and weights; the tile's rows
  // in chunks whose strips fit (ya, yb, lo, hi).
  __shared__ int row_i0[kTileY];
  __shared__ float row_w0[kTileY], row_w1[kTileY];
  __shared__ int4 ychunks[kTileY];
  __shared__ int n_ychunks;
  __shared__ float coef_q1;
  __shared__ int tile_kmin, tile_kmax, tile_imin, tile_imax;
  __shared__ __align__(8) uint64_t bar;  // the staged rows have landed

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int nx = min(kTileX, w - x0);
  const int ny = min(kTileY, h - y0);
  const long long b = blockIdx.z;
  const int plane_elems = h * w * C;
  const T* image = images + b * plane_elems;
  const float cy = (h - 1) / 2.0f;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar, 1);
    hopper::mbar_fence_init();
  }
  if (warp == 0) {
    // ops/warp.py::twopass_coeffs, with its clamp of a near-zero d.
    const float* m = m_invs + b * 9;
    const float d = m[4], c = m[3];
    const float d_safe = fabsf(d) < 1e-3f ? (d < 0.f ? -1e-3f : 1e-3f) : d;
    const float q1 = m[1] / d_safe;
    const float p = m[0] - q1 * c;
    const float q0 = m[2] - q1 * m[5];
    const float mx0 = q0 + q1 * ((h - 1) / 2.0f);
    const float my0 = m[5] + c * ((w - 1) / 2.0f);
    const float cx = (w - 1) / 2.0f;
    // Lane l: column x0 + l, output rows y0 + l and y0 + 32 + l.
    const bool col_in = lane < nx;
    const Resample rx = resample(p, mx0 + static_cast<float>(kx), x0 + lane,
                                 w + 2 * kx + kPadMargin);
    const Shift sy = shift(c, x0 + lane, cx, ky);
    col_i0[lane] = rx.i0;
    col_w0[lane] = rx.w0;
    col_w1[lane] = rx.w1;
    col_k[lane] = sy.k;
    col_f[lane] = sy.f;
    int lo[2], hi[2];  // of each half of the tile's rows
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = 32 * half + lane;
      const Resample ry = resample(d, my0 + static_cast<float>(ky), y0 + t,
                                   h + 2 * ky + kPadMargin);
      row_i0[t] = ry.i0;
      row_w0[t] = ry.w0;
      row_w1[t] = ry.w1;
      lo[half] = __reduce_min_sync(0xffffffffu, t < ny ? ry.i0 : INT_MAX);
      hi[half] = __reduce_max_sync(0xffffffffu, t < ny ? ry.i0 : INT_MIN);
    }
    // True ranges over the tile's columns.
    const int kmin = __reduce_min_sync(0xffffffffu, col_in ? sy.k : INT_MAX);
    const int kmax = __reduce_max_sync(0xffffffffu, col_in ? sy.k : INT_MIN);
    const int imin = __reduce_min_sync(0xffffffffu, col_in ? rx.i0 : INT_MAX);
    const int imax = __reduce_max_sync(0xffffffffu, col_in ? rx.i0 : INT_MIN);
    __syncwarp();
    if (lane == 0) {
      coef_q1 = q1;
      tile_kmin = kmin;
      tile_kmax = kmax;
      tile_imin = imin;
      tile_imax = imax;
      // Each half of the rows is a chunk if its strips fit (|d| <= 1.4),
      // else greedy runs of rows whose i0 span fits.
      int n = 0;
      for (int half = 0; half < 2 && 32 * half < ny; ++half) {
        const int ye = min(ny, 32 * half + 32);
        if (hi[half] - lo[half] + 3 <= kMaxStrip) {
          ychunks[n++] = make_int4(32 * half, ye, lo[half], hi[half]);
          continue;
        }
        for (int ya = 32 * half; ya < ye;) {
          int clo = row_i0[ya], chi = clo, yb = ya + 1;
          for (; yb < ye; ++yb) {
            const int v = row_i0[yb];
            if (max(chi, v) - min(clo, v) + 3 > kMaxStrip) break;
            clo = min(clo, v);
            chi = max(chi, v);
          }
          ychunks[n++] = make_int4(ya, yb, clo, chi);
          ya = yb;
        }
      }
      n_ychunks = n;
    }
  }
  __syncthreads();

  const float q1 = coef_q1;
  const int kmin = tile_kmin, kmax = tile_kmax, imin = tile_imin;
  // Every tap of a tmp row r lies in the window of pixels imin - kx + k(r)
  // .. imax - kx + k(r) + 2; staged, it takes row_chunks chunks at any
  // alignment.  Rows wider than the staging area are read from device
  // memory instead (|p| in the hundreds at this width).
  const int window = tile_imax - imin + 3;
  const int row_chunks = (window * C + 2 * kPer - 2) / kPer;
  const int rows_cap = min(kMaxRows, kStageChunks / row_chunks);
  // The image's first element in the tensor, modulo the chunk size: chunks
  // are aligned to the tensor, which starts on 16 bytes.
  const int phase = static_cast<int>((b * plane_elems) & (kPer - 1));
  uint32_t parity = 0;  // of the barrier's next phase

  // Pass-X thread: column lane, slots warp, warp + 8, ...
  const bool col_in = lane < nx;
  const int cx_i0 = col_i0[lane] - kx;
  const float cx_w0 = col_w0[lane], cx_w1 = col_w1[lane];
  const int kcol = col_k[lane];
  // Pass-Y thread: rows ty and ty + 32 of the tile, columns xg .. xg+3.
  const int ty = threadIdx.x / (kTileX / kGroup);
  const int xg = kGroup * (threadIdx.x % (kTileX / kGroup));

  // Stages tmp rows rb .. rb+nb-1: row rb + s goes to chunk s * row_chunks
  // on, staged by lane s / 8 of warp s % 8 (every warp issues a few): its
  // window, every element outside the row zero.  The chunks wholly inside
  // the row are one bulk copy; the others (at the image's left and right
  // edges, or past them) are assembled here.  Returns when they are in.
  auto stage_rows = [&](int rb, int nb) {
    const int s = lane * kWarps + warp;
    if (lane < kMaxRows / kWarps && s < nb) {
      const int r = rb + s;
      const Shift sx = shift(q1, r, cy, kx);
      const int r0 = r * w * C, r1 = r0 + w * C;  // image-relative
      const int a_first =
          ((phase + r0 + (imin - kx + sx.k) * C) & ~(kPer - 1)) - phase;
      const bool in = r >= 0 && r < h;
      rows[s] = make_int4(s * row_chunks * kPer + r0 - a_first, sx.k,
                          __float_as_int(sx.f), in);
      if (in) {
        uint4* dst = stage + s * row_chunks;
        // Chunks q_lo .. q_hi-1 lie wholly inside the row.
        const int q_lo = min(
            row_chunks, max(0, (r0 - a_first + kPer - 1) / kPer));
        const int q_hi = max(q_lo, min(row_chunks, (r1 - a_first) / kPer));
        if (q_hi > q_lo) {
          const uint32_t bytes = 16u * (q_hi - q_lo);
          mbar_expect_tx(&bar, bytes);
          bulk_copy(dst + q_lo, image + a_first + q_lo * kPer, bytes, &bar);
        }
        for (int q = 0; q < row_chunks; ++q) {
          if (q == q_lo) q = q_hi;
          if (q == row_chunks) break;
          const int a = a_first + q * kPer;
          dst[q] = (a + kPer <= r0 || a >= r1)
                       ? make_uint4(0u, 0u, 0u, 0u)
                       : chunk_of_row<T>(image, a, r0, r1);
        }
        // These writes precede any later bulk copy to the same chunks.
        if (q_lo > 0 || q_hi < row_chunks) fence_proxy_async();
      }
    }
    __syncthreads();  // every expect_tx is in, every assembled chunk too
    if (threadIdx.x == 0) hopper::mbar_arrive(&bar);
    hopper::mbar_wait(&bar, parity);
    parity ^= 1u;
  };

  // The tmp rows of all chunks at once when they fit the staging area: one
  // wait for the whole tile.  Else each chunk stages its own, in batches.
  int u_first = INT_MAX, u_last = INT_MIN;
  for (int yc = 0; yc < n_ychunks; ++yc) {
    const int4 chunk = ychunks[yc];
    u_first = min(u_first, chunk.z - ky + kmin);
    u_last = max(u_last, chunk.w + 2 - ky + kmax);
  }
  const bool whole = rows_cap > 0 && u_last - u_first < rows_cap;
  if (whole) stage_rows(u_first, u_last - u_first + 1);

  for (int yc = 0; yc < n_ychunks; ++yc) {
    const int4 chunk = ychunks[yc];
    const int ya = chunk.x, yb = chunk.y, lo = chunk.z;
    const int slots = chunk.w - lo + 3;  // strip length, alike in every column
    const int rstart = lo - ky + kcol;  // this lane's column strip: first row

    // Pass X: the tmp rows r_first .. r_end - 1 that some column's strip
    // holds, as many at a time as the staging area takes.
    int r_first = lo - ky + kmin, r_end = lo - ky + kmax + slots;
    int batch = rows_cap > 0 ? rows_cap : r_end - r_first;
    if (whole) {
      r_first = u_first;
      r_end = u_last + 1;
      batch = r_end - r_first;
    }
    for (int rb = r_first; rb < r_end; rb += batch) {
      const int nb = min(batch, r_end - rb);
      if (rows_cap > 0 && !whole) stage_rows(rb, nb);

      if (col_in) {
        for (int j = warp; j < slots; j += kWarps) {
          const int r = rstart + j;
          const int s = r - rb;
          if (s < 0 || s >= nb) continue;
          float t[C];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) t[ch] = 0.f;
          float v[3 * C];
          float f = 0.f;
          bool have = false;
          if (rows_cap > 0) {
            const int4 row = rows[s];
            if (row.w) {
              f = __int_as_float(row.z);
              const T* src = staged + row.x + (cx_i0 + row.y) * C;
#pragma unroll
              for (int i = 0; i < 3 * C; ++i) v[i] = to_float(src[i]);
              have = true;
            }
          } else if (r >= 0 && r < h) {
            // A row too wide to stage: taps from device memory.
            const Shift sx = shift(q1, r, cy, kx);
            const int u0 = cx_i0 + sx.k;
            const T* src = image + r * w * C;
            f = sx.f;
#pragma unroll
            for (int tap = 0; tap < 3; ++tap) {
              const int u = u0 + tap;
              const bool in_row = u >= 0 && u < w;
#pragma unroll
              for (int ch = 0; ch < C; ++ch) {
                v[tap * C + ch] = in_row ? to_float(src[u * C + ch]) : 0.f;
              }
            }
            have = true;
          }
          if (have) {
#pragma unroll
            for (int ch = 0; ch < C; ++ch) {
              const float e0 = v[ch] + f * (v[C + ch] - v[ch]);
              const float e1 = v[C + ch] + f * (v[2 * C + ch] - v[C + ch]);
              t[ch] = cx_w0 * e0 + cx_w1 * e1;
            }
          }
          float* dst = strip + (j * kTileX + lane) * C;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) dst[ch] = t[ch];
        }
      }
      __syncthreads();  // strips complete; the staging area is free again
    }

    // Pass Y: blend strip slots i0(yo) - lo .. +2 of 4 adjacent columns.
#pragma unroll 1
    for (int yt = ty; yt < kTileY; yt += kThreads / (kTileX / kGroup)) {
      if (yt < ya || yt >= yb) continue;
      const int j0 = row_i0[yt] - lo;
      const float w0 = row_w0[yt], w1 = row_w1[yt];
      const float4 f4 = *reinterpret_cast<const float4*>(col_f + xg);
      const float fy[kGroup] = {f4.x, f4.y, f4.z, f4.w};
      float tv[3][kGroup * C];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float4* src = reinterpret_cast<const float4*>(
            strip + ((j0 + i) * kTileX + xg) * C);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const float4 s4 = src[q];
          tv[i][4 * q] = s4.x;
          tv[i][4 * q + 1] = s4.y;
          tv[i][4 * q + 2] = s4.z;
          tv[i][4 * q + 3] = s4.w;
        }
      }
      float o[kGroup * C];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const int e = q * C + ch;
          const float e0 = tv[0][e] + fy[q] * (tv[1][e] - tv[0][e]);
          const float e1 = tv[1][e] + fy[q] * (tv[2][e] - tv[1][e]);
          o[e] = w0 * e0 + w1 * e1;
        }
      }
      const int x = x0 + xg;
      float* dst = out + b * plane_elems + ((y0 + yt) * w + x) * C;
      if (vec_store && x + kGroup <= w) {
#pragma unroll
        for (int q = 0; q < C; ++q) {
          reinterpret_cast<float4*>(dst)[q] =
              make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (x + q < w) {
#pragma unroll
            for (int ch = 0; ch < C; ++ch) dst[q * C + ch] = o[q * C + ch];
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the strips
  }
}

template <typename T, int C>
cudaError_t launch(const T* images, const float* m_invs, float* out,
                   int batch, int h, int w, int kx, int ky,
                   cudaStream_t stream) {
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, batch);
  // Every output row segment starts on 16 bytes iff W*C % 4 == 0 (the
  // wrapper's buffers are 16-byte aligned).
  const int vec_store = (w * C) % 4 == 0;
  constexpr int kBytes = Smem<C>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      warp_affine_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (attr != cudaSuccess) return attr;
  warp_affine_kernel<T, C><<<grid, kThreads, kBytes, stream>>>(
      images, m_invs, out, h, w, kx, ky, vec_store);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* images, const void* m_invs, void* out,
                     int batch, int h, int w, int channels, int kx, int ky,
                     void* stream) {
  const T* src = static_cast<const T*>(images);
  const float* mi = static_cast<const float*>(m_invs);
  float* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 1: return launch<T, 1>(src, mi, dst, batch, h, w, kx, ky, s);
    case 2: return launch<T, 2>(src, mi, dst, batch, h, w, kx, ky, s);
    case 3: return launch<T, 3>(src, mi, dst, batch, h, w, kx, ky, s);
    default: return launch<T, 4>(src, mi, dst, batch, h, w, kx, ky, s);
  }
}

}  // namespace

// images: [batch, h, w, channels], f32 (is_uint8 = 0) or uint8 (1),
// contiguous, 16-byte aligned; out: [batch, h, w, channels] f32, contiguous,
// 16-byte aligned; m_invs: [batch, 3, 3] f32 inverse maps, contiguous; kx,
// ky: the static shift bounds for the rows and the columns.  Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int warp_affine(const void* images, const void* m_invs, void* out,
                           int batch, int h, int w, int channels, int kx,
                           int ky, int is_uint8, void* stream) {
  // Element offsets within an image are ints, rows a few image heights
  // past its edges included.
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || kx < 0 || ky < 0 ||
      channels < 1 || channels > kMaxC ||
      static_cast<long long>(h) * w * channels > kMaxImageElems ||
      (reinterpret_cast<uintptr_t>(images) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0) {
    return cudaErrorInvalidValue;
  }
  return is_uint8 ? dispatch<uint8_t>(images, m_invs, out, batch, h, w,
                                      channels, kx, ky, stream)
                  : dispatch<float>(images, m_invs, out, batch, h, w,
                                    channels, kx, ky, stream);
}
