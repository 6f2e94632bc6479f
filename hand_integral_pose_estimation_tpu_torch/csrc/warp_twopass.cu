// Batched homography warp as two 1-D bilinear resamples (Catmull-Smith),
// zero border: the training augmentation's crop + rotation, in one launch
// from the stored frames to the (optionally normalised) patch.
//
// Replaces the TPU kernels hand_integral_pose_estimation_tpu/ops/warp.py:
// _warp_kernel and _warp_kernel_looped (launched by warp_perspective_pallas),
// and fuses the normalisation after it (data/pipeline.py:_normalise). The
// TPU kernels build dense relu(1 - |i - u|) weight blocks in VMEM and
// contract them on the MXU, because gathers are slow on the TPU, and keep
// pass A's result in VMEM for pass B. On Hopper gathers from L1 and L2 are
// cheap, and a batch's frames (4.8 MB of uint8 at 32 x 224^2) sit in the
// 50 MB L2. So each output pixel computes the two-pass filter directly: v*
// at (x', y'); for each of its two row taps s, pass A's value at (s, x')
// (u*(x', s) and its two column taps); then pass B's combination. The
// intermediate (B, Hs, Wo, C) never reaches device memory: a pass-A value
// is recomputed for each output row that reads it (about two), which costs
// arithmetic, not bytes.
//
// Bound: device memory. At B = 32, 224^2 -> 224^2 RGB, 4.8 MB of uint8
// frames in (19.3 MB as float32) and a 19.3 MB float32 patch out: 0.0072
// ms at 3.35 TB/s from uint8, 0.0115 from float32. On the H100 the kernel
// does not reach it: uint8 and float32 frames take the same time, so it is
// paced by its arithmetic and latency (five IEEE divisions per pixel, each
// pass-A value formed about twice), not by bytes. One CTA per (image,
// 32-column strip of kSteps tiles of 8 rows), one thread per output pixel
// and all its channels; a warp is 32 neighbouring output columns, whose
// taps fall on neighbouring source pixels and share L1 lines. For C = 1
// and 3 a pixel issues all its tap loads before its sums. Offsets within a
// frame are 32-bit (the C entry refuses frames of 2^31 elements or more).
//
// Prologue: 8 threads of each CTA form the coefficients a..h of the dst ->
// src map scaled to [2][2] = 1 into shared memory, one each, as
// ops/warp.py:warp_coefficients does: in float64 (the map may arrive as
// float32 or float64), the adjugate's 2x2 minors (the map itself for an
// inverse map), nan where the determinant is exactly 0, divided by the
// [2][2] entry and rounded once to the positions' type.
//
// Numbers: every operation is a round-to-nearest intrinsic in the order of
// the plain version, warp_normalise_twopass / warp_perspective_twopass in
// ops/warp.py, so no multiply-add is contracted and the kernel forms the
// same positions, weights, sums and normalised values: its output equals
// the plain version's bit for bit. Positions are float32 for float32 maps
// and float64 for float64 maps, as the plain version's are. A nan position
// gives a nan pixel, a position at +-inf reads 0, as in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace hipe {
namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
// output tiles per CTA, down its column strip (the prologue's cost shared)
constexpr int kSteps = 4;
constexpr int kMaxNormChannels = 4;

// The epilogue's per-channel constants, passed by value.
struct Epilogue {
  float mean[kMaxNormChannels];
  float std[kMaxNormChannels];
};

// A (B, 3, 3) map of float32 or float64 with strides in elements.
struct MapRef {
  const void* p;
  long long sb, sr, sc;
  int f64;
};

__device__ __forceinline__ float rn_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double rn_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float rn_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double rn_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double rn_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float rn_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double rn_div(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float rn_floor(float a) { return floorf(a); }
__device__ __forceinline__ double rn_floor(double a) { return floor(a); }
__device__ __forceinline__ float round_to(float, double a) {
  return __double2float_rn(a);
}
__device__ __forceinline__ double round_to(double, double a) { return a; }
__device__ __forceinline__ float to_float(float a) { return a; }
__device__ __forceinline__ float to_float(double a) {
  return __double2float_rn(a);
}
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const uint8_t* p) {
  return float(__ldg(p));
}

__device__ __forceinline__ double map_entry(const MapRef& m, int b, int k) {
  const long long off = b * m.sb + (k / 3) * m.sr + (k % 3) * m.sc;
  return m.f64 ? static_cast<const double*>(m.p)[off]
               : double(static_cast<const float*>(m.p)[off]);
}

__device__ __forceinline__ double minor2(const double* h, int p, int q,
                                         int r, int s) {
  return __dsub_rn(__dmul_rn(h[p], h[q]), __dmul_rn(h[r], h[s]));
}

// Coefficient k (0..7) of image b's dst -> src map, [2][2] scaled to 1.
template <typename P>
__device__ P coefficient(const MapRef& m, int b, int inverse, int k) {
  double h[9], n[9];
  for (int i = 0; i < 9; ++i) h[i] = map_entry(m, b, i);
  if (inverse) {
    for (int i = 0; i < 9; ++i) n[i] = h[i];
  } else {
    n[0] = minor2(h, 4, 8, 5, 7);
    n[1] = minor2(h, 2, 7, 1, 8);
    n[2] = minor2(h, 1, 5, 2, 4);
    n[3] = minor2(h, 5, 6, 3, 8);
    n[4] = minor2(h, 0, 8, 2, 6);
    n[5] = minor2(h, 2, 3, 0, 5);
    n[6] = minor2(h, 3, 7, 4, 6);
    n[7] = minor2(h, 1, 6, 0, 7);
    n[8] = minor2(h, 0, 4, 1, 3);
    const double det = __dadd_rn(
        __dadd_rn(__dmul_rn(h[0], n[0]), __dmul_rn(h[1], n[3])),
        __dmul_rn(h[2], n[6]));
    if (det == 0.0) {
      for (int i = 0; i < 9; ++i) n[i] = __longlong_as_double(
          0x7ff8000000000000ll);
    }
  }
  return round_to(P(), __ddiv_rn(n[k], n[8]));
}

// The two taps of a 1-D bilinear sample at `pos` on an axis of n samples:
// i0 = floor(pos), weights 1 - frac and frac (frac formed in the positions'
// type and rounded to float32, the values' type, as the plain version
// does), and whether i0 and i0 + 1 lie on the axis.
template <typename P>
struct Taps {
  P i0;
  float w0, w1;
  bool ok0, ok1, nan;
};

template <typename P>
__device__ __forceinline__ Taps<P> taps(P pos, int n) {
  Taps<P> t;
  t.i0 = rn_floor(pos);
  t.w1 = to_float(rn_sub(pos, t.i0));
  t.w0 = __fsub_rn(1.f, t.w1);
  t.ok0 = t.i0 >= P(0) && t.i0 <= P(n - 1);
  t.ok1 = t.i0 >= P(-1) && t.i0 <= P(n - 2);
  t.nan = isnan(pos);
  return t;
}

// (0 + [ok0] v0 w0) + [ok1] v1 w1, the plain version's sum; nan for a nan
// position.
template <typename P>
__device__ __forceinline__ float combine(const Taps<P>& t, float v0,
                                         float v1) {
  if (t.nan) return __int_as_float(0x7fc00000);
  const float a = t.ok0 ? __fmul_rn(v0, t.w0) : 0.f;
  const float b = t.ok1 ? __fmul_rn(v1, t.w1) : 0.f;
  return __fadd_rn(__fadd_rn(0.f, a), b);
}

// One output pixel (x, y) of image b, all its channels: kC channels when
// kC > 0 (every tap load issued before the sums), else `channels`.
template <typename T, typename P, bool kNorm, int kC>
__device__ __forceinline__ void warp_pixel(
    const T* __restrict__ src, const P* coef, const float* __restrict__ colour,
    const Epilogue& epi, float* __restrict__ out, int b, int x, int y,
    int src_h, int src_w, int out_h, int out_w, int channels) {
  const int C = kC > 0 ? kC : channels;
  const P a = coef[0], bb = coef[1], c = coef[2], d = coef[3], e = coef[4],
          f = coef[5], g = coef[6], h = coef[7];
  const P xo = P(x), yo = P(y), one = P(1);

  // pass B's position: v* = (d x' + e y' + f) / (g x' + h y' + 1)
  const Taps<P> tv = taps(
      rn_div(rn_add(rn_add(rn_mul(d, xo), rn_mul(e, yo)), f),
             rn_add(rn_add(rn_mul(g, xo), rn_mul(h, yo)), one)),
      src_h);
  // pass A at the (up to) two source rows that v* reads; a row off the
  // image gets taps that read nothing
  const int row_len = src_w * C;
  const T* img = src + (long long)b * src_h * src_w * C;
  const T* rows[2];
  Taps<P> tu[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool ok = k == 0 ? tv.ok0 : tv.ok1;
    const int s = ok ? int(tv.i0) + k : 0;
    const P ys = P(s);
    // yA = (ys g x' + ys - d x' - f) / (e - ys h): v(x', yA) = ys
    const P ya = rn_div(
        rn_sub(rn_sub(rn_add(rn_mul(rn_mul(ys, g), xo), ys), rn_mul(d, xo)),
               f),
        rn_sub(e, rn_mul(ys, h)));
    // u* = (a x' + b yA + c) / (g x' + h yA + 1)
    tu[k] = taps(rn_div(rn_add(rn_add(rn_mul(a, xo), rn_mul(bb, ya)), c),
                        rn_add(rn_add(rn_mul(g, xo), rn_mul(h, ya)), one)),
                 src_w);
    tu[k].ok0 = tu[k].ok0 && ok;
    tu[k].ok1 = tu[k].ok1 && ok;
    tu[k].nan = tu[k].nan && ok;
    rows[k] = img + s * row_len;
  }
  float* o = out + (((long long)b * out_h + y) * out_w + x) * C;
  const float* col = kNorm ? colour + (long long)b * C : nullptr;
  auto finish = [&](int ch, float r) {
    if (kNorm) {
      // clamp((p - mean) / std * colour, 0, 255), nan passing the clamp
      r = __fmul_rn(__fdiv_rn(__fsub_rn(r, epi.mean[ch]), epi.std[ch]),
                    __ldg(col + ch));
      r = r < 0.f ? 0.f : (r > 255.f ? 255.f : r);
    }
    o[ch] = r;
  };
  if constexpr (kC > 0) {
    float v[2][2][kC];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int k0 = tu[k].ok0 ? int(tu[k].i0) * kC : 0;
      const int k1 = tu[k].ok1 ? (int(tu[k].i0) + 1) * kC : 0;
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) {
        v[k][0][ch] = tu[k].ok0 ? load(rows[k] + k0 + ch) : 0.f;
        v[k][1][ch] = tu[k].ok1 ? load(rows[k] + k1 + ch) : 0.f;
      }
    }
#pragma unroll
    for (int ch = 0; ch < kC; ++ch)
      finish(ch, combine(tv, combine(tu[0], v[0][0][ch], v[0][1][ch]),
                         combine(tu[1], v[1][0][ch], v[1][1][ch])));
  } else {
    for (int ch = 0; ch < C; ++ch) {
      float pa[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const Taps<P>& t = tu[k];
        const float v0 =
            t.ok0 ? load(rows[k] + int(t.i0) * C + ch) : 0.f;
        const float v1 =
            t.ok1 ? load(rows[k] + (int(t.i0) + 1) * C + ch) : 0.f;
        pa[k] = combine(t, v0, v1);
      }
      finish(ch, combine(tv, pa[0], pa[1]));
    }
  }
}

// One CTA per (image, 32-column strip of kSteps tiles of kTileH rows).
template <typename T, typename P, bool kNorm, int kC>
__global__ void __launch_bounds__(kTileW * kTileH, 4)
    warp_kernel(const T* __restrict__ src, MapRef map, int inverse,
                const float* __restrict__ colour, Epilogue epi,
                float* __restrict__ out, int src_h, int src_w, int out_h,
                int out_w, int channels, int tiles_x, int tiles_per_image) {
  __shared__ P coef[8];
  const int b = blockIdx.x / tiles_per_image;
  const int tile = blockIdx.x - b * tiles_per_image;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int lane = threadIdx.y * kTileW + threadIdx.x;
  if (lane < 8) coef[lane] = coefficient<P>(map, b, inverse, lane);
  __syncthreads();
  const int x = tx * kTileW + threadIdx.x;
  if (x >= out_w) return;
#pragma unroll 1
  for (int step = 0; step < kSteps; ++step) {
    const int y = (ty * kSteps + step) * kTileH + threadIdx.y;
    if (y >= out_h) return;
    warp_pixel<T, P, kNorm, kC>(src, coef, colour, epi, out, b, x, y, src_h,
                                src_w, out_h, out_w, channels);
  }
}

template <typename T, typename P, bool kNorm>
void launch_c(const T* src, const MapRef& map, int inverse,
              const float* colour, const Epilogue& epi, float* out,
              int src_h, int src_w, int out_h, int out_w, int channels,
              int tiles_x, int tiles_per_image, unsigned blocks,
              cudaStream_t st) {
  const dim3 threads(kTileW, kTileH);
#define HIPE_WARP_LAUNCH(KC)                                              \
  warp_kernel<T, P, kNorm, KC><<<blocks, threads, 0, st>>>(               \
      src, map, inverse, colour, epi, out, src_h, src_w, out_h, out_w,    \
      channels, tiles_x, tiles_per_image)
  if (channels == 3) {
    HIPE_WARP_LAUNCH(3);
  } else if (channels == 1) {
    HIPE_WARP_LAUNCH(1);
  } else {
    HIPE_WARP_LAUNCH(0);
  }
#undef HIPE_WARP_LAUNCH
}

template <typename T, typename P>
cudaError_t launch(const void* images, const MapRef& map, int inverse,
                   const float* colour, const Epilogue& epi, bool norm,
                   float* out, int src_h, int src_w, int out_h, int out_w,
                   int channels, int tiles_x, int tiles_per_image,
                   unsigned blocks, cudaStream_t st) {
  const T* src = static_cast<const T*>(images);
  if (norm) {
    launch_c<T, P, true>(src, map, inverse, colour, epi, out, src_h, src_w,
                         out_h, out_w, channels, tiles_x, tiles_per_image,
                         blocks, st);
  } else {
    launch_c<T, P, false>(src, map, inverse, colour, epi, out, src_h, src_w,
                          out_h, out_w, channels, tiles_x, tiles_per_image,
                          blocks, st);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace hipe

// images (B, Hs, Ws, C) contiguous, float32 (image_dtype 0) or uint8 (1);
// maps (B, 3, 3) float32 (map_dtype 0) or float64 (1) with strides
// map_sb, map_sr, map_sc in elements, the forward map or (inverse = 1) the
// dst -> src map; out (B, Ho, Wo, C) float32 contiguous, allocated by the
// caller. mean_std: NULL for the warp alone, or a host array of C means
// then C standard deviations (C <= 4), copied into the kernel's
// parameters, with colour the device's (B, C) float32 colour scale.
// Returns the launch error (cudaErrorInvalidValue for what the kernel does
// not take).
extern "C" int hipe_warp_twopass(const void* images, int image_dtype,
                                 const void* maps, int map_dtype,
                                 long long map_sb, long long map_sr,
                                 long long map_sc, int inverse,
                                 const void* colour, const void* mean_std,
                                 void* out, int batch, int src_h, int src_w,
                                 int out_h, int out_w, int channels,
                                 void* stream) {
  using namespace hipe;
  const bool norm = mean_std != nullptr;
  if ((norm && (channels > kMaxNormChannels || colour == nullptr)) ||
      image_dtype < 0 || image_dtype > 1 || map_dtype < 0 || map_dtype > 1 ||
      (long long)src_h * src_w * channels >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (out_w + kTileW - 1) / kTileW;
  const long long tiles_per_image =
      (long long)tiles_x *
      ((out_h + kTileH * kSteps - 1) / (kTileH * kSteps));
  const long long blocks = tiles_per_image * batch;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  Epilogue epi = {};
  if (norm) {
    const float* ms = static_cast<const float*>(mean_std);
    for (int c = 0; c < channels; ++c) {
      epi.mean[c] = ms[c];
      epi.std[c] = ms[channels + c];
    }
  }
  const MapRef map{maps, map_sb, map_sr, map_sc, map_dtype};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* col = static_cast<const float*>(colour);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  const int tpi = static_cast<int>(tiles_per_image);
  const auto nb = static_cast<unsigned>(blocks);
  if (image_dtype == 0) {
    err = map_dtype == 0
              ? launch<float, float>(images, map, inverse, col, epi, norm, o,
                                     src_h, src_w, out_h, out_w, channels,
                                     tiles_x, tpi, nb, st)
              : launch<float, double>(images, map, inverse, col, epi, norm,
                                      o, src_h, src_w, out_h, out_w,
                                      channels, tiles_x, tpi, nb, st);
  } else {
    err = map_dtype == 0
              ? launch<uint8_t, float>(images, map, inverse, col, epi, norm,
                                       o, src_h, src_w, out_h, out_w,
                                       channels, tiles_x, tpi, nb, st)
              : launch<uint8_t, double>(images, map, inverse, col, epi, norm,
                                        o, src_h, src_w, out_h, out_w,
                                        channels, tiles_x, tpi, nb, st);
  }
  return static_cast<int>(err);
}
