// ROIAlign forward over an NHWC feature map, batched over images: each
// RoI's pooled x pooled bins, each the mean of sampling_ratio^2 bilinear
// samples.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/
// roi_align.py: _ra_kernel (launched by roi_align_batched). The TPU has
// slow gathers, so that kernel builds a dense (G*49, H*W) matrix of
// combined bilinear weights from iotas and runs one MXU matmul against the
// whole feature map held in VMEM; over 99 % of those weights are zero.
// Here the taps are read directly, in the separable form of the plain
// version (row weights, then column weights):
//   * one CTA per (image, RoI, slice of 64 channel vectors), its threads
//     across the channels (four per thread with 16-byte accesses when
//     C % 4 == 0);
//   * the bilinear weights of the sample rows of kBands pooled rows at
//     once (all 7 at the detector's pooled = 7) are summed per distinct
//     tap row, per pooled row; those of a bin column's sample columns per
//     distinct tap column;
//   * a thread walks the bin columns; for each of a bin column's tap
//     columns x it reads the group's tap rows there once and forms every
//     pooled row's R_b[x] = sum_y Wy_b[y] f[y, x] in registers, then adds
//     Wx[x] R_b[x] into the bin column's kBands bins. A tap is read once
//     per RoI (again only where two bin columns share a tap column, from
//     L1 right after), where reading it once per pooled row read it about
//     twice as often on the detector's RoIs, and the L2 reads set the pace;
//   * each bin's mean leaves as a coalesced 16-byte streaming store
//     (__stcs), so the output does not push the feature map out of L2.
//
// Bound: device memory. At the detector's shape (4 images, 38x38x1024
// float32 features, 300 RoIs) the output is 241 MB written once; the 24 MB
// feature map stays in the 50 MB L2 cache while the RoIs read it. Reading
// a tap once per (sample, tap), as a bin-per-CTA kernel does, costs up to
// 16 reads per output element, and the L2 reads then set the pace; here a
// band reads (its tap rows) x (the RoI's tap columns), far fewer whenever
// a half-bin is shorter than a feature cell.
//
// The function is that of the plain version, roi_align in
// ops/roi_align.py (the JAX package's roi_align.py:25-90): coordinates
// scaled by spatial_scale, length max(hi - lo, 1), bins of length /
// pooled, sample centres lo + bin * bsz + (k + 0.5) * bsz / sr, a sample
// outside [-1, size] contributes zero, otherwise it is clamped into
// [0, size - 1] and split bilinearly with the weights 1 - |c - i| of the
// plain version's dense rows, no half-pixel offset. Float32 throughout;
// only the order of the sums differs from the plain version (and taps of
// weight zero are not read).

#include <cuda_runtime.h>

namespace hipe {
namespace {

constexpr int kThreads = 64;        // channel vectors per CTA
constexpr int kMaxSamples = 8;
constexpr int kBands = 7;           // pooled rows formed together
constexpr int kMaxRows = 2 * kMaxSamples * kBands;
constexpr int kColChunk = 64;       // bin columns whose taps are listed at once
constexpr int kRowLoads = 4;        // tap rows whose loads are unrolled

struct Taps {
  int i0, i1;     // tap rows (or columns); i1 < 0 when outside the map
  float w0, w1;   // their weights (zero for a sample outside [-1, size])
};

// Sample centre k of bin `bin` along one axis, and its two taps.
__device__ __forceinline__ Taps axis_taps(float lo, float bsz, int bin,
                                          int k, int sr, int size) {
  const float c = __fadd_rn(__fadd_rn(lo, __fmul_rn(float(bin), bsz)),
                            __fmul_rn(float(k) + 0.5f,
                                      __fdiv_rn(bsz, float(sr))));
  Taps t;
  if (!(c >= -1.f && c <= float(size))) {
    t.i0 = 0;
    t.i1 = -1;
    t.w0 = 0.f;
    t.w1 = 0.f;
    return t;
  }
  const float cc = fminf(fmaxf(c, 0.f), float(size - 1));
  const float f0 = floorf(cc);
  t.i0 = int(f0);
  t.w0 = __fsub_rn(1.f, __fsub_rn(cc, f0));
  if (t.i0 + 1 <= size - 1) {
    t.i1 = t.i0 + 1;
    t.w1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(f0, 1.f), cc));
  } else {
    t.i1 = -1;
    t.w1 = 0.f;
  }
  return t;
}

template <typename V>
__device__ __forceinline__ void fma_tap(V& acc, float w, const V& v);

template <>
__device__ __forceinline__ void fma_tap<float>(float& acc, float w,
                                               const float& v) {
  acc += w * v;
}

template <>
__device__ __forceinline__ void fma_tap<float4>(float4& acc, float w,
                                                const float4& v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename V>
__device__ __forceinline__ V scaled(const V& v, float s);
template <>
__device__ __forceinline__ float scaled<float>(const float& v, float s) {
  return v * s;
}
template <>
__device__ __forceinline__ float4 scaled<float4>(const float4& v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// V = float4 reads and writes four channels at once; `vecs` = C / width.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    roi_align_fwd_kernel(const V* __restrict__ feats,
                         const float* __restrict__ rois, V* __restrict__ out,
                         int rois_per_image, int height, int width, int vecs,
                         int pooled, int sr, float scale) {
  // the band group's distinct tap rows and each band's summed weight on
  // them (zero where a band does not touch the row)
  __shared__ long long row_off[kMaxRows];               // tap row * width
  __shared__ __align__(16) float row_w[kMaxRows][kBands + 1];  // 32-byte rows
  __shared__ int n_rows;
  // per bin column of the chunk: its distinct tap columns, summed weights
  __shared__ int col_x[kColChunk][2 * kMaxSamples];
  __shared__ float col_w[kColChunk][2 * kMaxSamples];
  __shared__ int col_n[kColChunk];

  const long long roi = blockIdx.x;   // image * R + roi
  const long long img = roi / rois_per_image;
  const float* r = rois + roi * 4;
  // per axis: lo, length = max(hi - lo, 1), bin size = length / pooled
  const float x_lo = __fmul_rn(r[0], scale);
  const float y_lo = __fmul_rn(r[1], scale);
  const float x_bsz = __fdiv_rn(
      fmaxf(__fsub_rn(__fmul_rn(r[2], scale), x_lo), 1.f), float(pooled));
  const float y_bsz = __fdiv_rn(
      fmaxf(__fsub_rn(__fmul_rn(r[3], scale), y_lo), 1.f), float(pooled));
  const float inv = 1.f / float(sr * sr);
  const V* f = feats + img * height * width * vecs;
  V* o = out + roi * pooled * pooled * vecs;

  // bin columns q0 .. q0 + count - 1, one per thread: the taps of its sr
  // samples, merged (they come in ascending order) and of nonzero weight
  auto column_lists = [&](int q0, int count) {
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      int nx = 0;
      for (int k = 0; k < sr; ++k) {
        const Taps t = axis_taps(x_lo, x_bsz, q0 + j, k, sr, width);
        const int xs[2] = {t.i0, t.i1};
        const float ws[2] = {t.w0, t.w1};
        for (int e = 0; e < 2; ++e) {
          if (ws[e] == 0.f) continue;   // outside, or a zero-weight tap
          if (nx > 0 && col_x[j][nx - 1] == xs[e]) {
            col_w[j][nx - 1] += ws[e];
          } else if (nx > 1 && col_x[j][nx - 2] == xs[e]) {
            col_w[j][nx - 2] += ws[e];
          } else {
            col_x[j][nx] = xs[e];
            col_w[j][nx++] = ws[e];
          }
        }
      }
      col_n[j] = nx;
    }
  };
  const bool one_chunk = pooled <= kColChunk;
  if (one_chunk) column_lists(0, pooled);

  for (int c0 = blockIdx.y * kThreads; c0 < vecs;
       c0 += gridDim.y * kThreads) {
    const int c = c0 + threadIdx.x;
    const bool active = c < vecs;
    for (int p0 = 0; p0 < pooled; p0 += kBands) {
      const int nb = min(kBands, pooled - p0);
      __syncthreads();   // the previous group's rows are consumed
      if (threadIdx.x == 0) {
        // rows come in ascending order, band after band
        int ny = 0;
        for (int b = 0; b < nb; ++b) {
          for (int k = 0; k < sr; ++k) {
            const Taps t = axis_taps(y_lo, y_bsz, p0 + b, k, sr, height);
            const int ys[2] = {t.i0, t.i1};
            const float ws[2] = {t.w0, t.w1};
            for (int e = 0; e < 2; ++e) {
              if (ws[e] == 0.f) continue;
              const long long off = (long long)ys[e] * width;
              int at = ny;
              if (ny > 0 && row_off[ny - 1] == off) at = ny - 1;
              if (ny > 1 && row_off[ny - 2] == off) at = ny - 2;
              if (at == ny) {
                row_off[ny] = off;
                for (int z = 0; z < kBands; ++z) row_w[ny][z] = 0.f;
                ++ny;
              }
              row_w[at][b] += ws[e];
            }
          }
        }
        n_rows = ny;
      }
      for (int q0 = 0; q0 < pooled; q0 += kColChunk) {
        const int nq = min(kColChunk, pooled - q0);
        if (!one_chunk) {
          __syncthreads();
          column_lists(q0, nq);
        }
        __syncthreads();
        const int ny = n_rows;
        for (int j = 0; j < nq; ++j) {
          V acc[kBands];
#pragma unroll
          for (int b = 0; b < kBands; ++b) acc[b] = zero<V>();
          for (int i = 0; i < col_n[j]; ++i) {
            // R_b = sum_y Wy_b[y] f[y, x] for every band of the group:
            // each tap of this column is read once for all of them
            const V* at = f + (long long)col_x[j][i] * vecs + c;
            V rsum[kBands];
#pragma unroll
            for (int b = 0; b < kBands; ++b) rsum[b] = zero<V>();
            for (int e0 = 0; e0 < ny; e0 += kRowLoads) {
              V v[kRowLoads];
#pragma unroll
              for (int u = 0; u < kRowLoads; ++u) {
                v[u] = active && e0 + u < ny
                           ? __ldg(at + row_off[e0 + u] * vecs)
                           : zero<V>();
              }
#pragma unroll
              for (int u = 0; u < kRowLoads; ++u) {
                if (e0 + u < ny) {
#pragma unroll
                  for (int b = 0; b < kBands; ++b) {
                    fma_tap(rsum[b], row_w[e0 + u][b], v[u]);
                  }
                }
              }
            }
            const float wx = col_w[j][i];
#pragma unroll
            for (int b = 0; b < kBands; ++b) fma_tap(acc[b], wx, rsum[b]);
          }
          if (active) {
#pragma unroll
            for (int b = 0; b < kBands; ++b) {
              if (b < nb) {
                __stcs(o + ((long long)(p0 + b) * pooled + q0 + j) * vecs
                           + c,
                       scaled(acc[b], inv));
              }
            }
          }
        }
      }
    }
  }
}

}  // namespace
}  // namespace hipe

// feats (B, H, W, C), rois (B, R, 4) xyxy in image coordinates and out
// (B, R, pooled, pooled, C), all float32 and contiguous, allocated by the
// caller; 1 <= sampling_ratio <= 8 and B * R * pooled^2 < 2^31. Returns the
// launch error.
extern "C" int hipe_roi_align_fwd(const void* feats, const void* rois,
                                  void* out, int batch, int height, int width,
                                  int channels, int rois_per_image,
                                  int pooled, int sampling_ratio,
                                  float spatial_scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec4 = channels % 4 == 0;
  const int vecs = vec4 ? channels / 4 : channels;
  const int slices = (vecs + hipe::kThreads - 1) / hipe::kThreads;
  const dim3 grid((unsigned)((long long)batch * rois_per_image),
                  (unsigned)(slices < 65535 ? slices : 65535));
  if (vec4) {
    hipe::roi_align_fwd_kernel<float4><<<grid, hipe::kThreads, 0, st>>>(
        static_cast<const float4*>(feats), static_cast<const float*>(rois),
        static_cast<float4*>(out), rois_per_image, height, width, vecs,
        pooled, sampling_ratio, spatial_scale);
  } else {
    hipe::roi_align_fwd_kernel<float><<<grid, hipe::kThreads, 0, st>>>(
        static_cast<const float*>(feats), static_cast<const float*>(rois),
        static_cast<float*>(out), rois_per_image, height, width, vecs,
        pooled, sampling_ratio, spatial_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
