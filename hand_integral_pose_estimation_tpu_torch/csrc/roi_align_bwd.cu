// ROIAlign backward with respect to the features, over an NHWC map,
// batched over images: the VJP of the plain version (roi_align in
// ops/roi_align.py) for a cotangent g of the pooled output,
//
//   grad_f[b, y, x, c] = 1/sr^2 * sum_r sum_{i,j} Wy[b,r,i,y] Wx[b,r,j,x]
//                                               g[b, r, i/sr, j/sr, c],
//
// with Wy, Wx the plain version's dense bilinear weight rows of the sample
// centres (i, j over the pooled * sr samples of each axis).
//
// No TPU kernel of the JAX package computes this: it trains through the
// XLA formulation of ROIAlign (roi_align.py:57-90 and roi_align_batched
// with impl="xla") and takes this gradient from XLA's autodiff, while its
// Pallas kernel (_ra_kernel, roi_align.py:93) is forward only. The
// reference's ROIAlign_cuda.cu scatters each sample's four taps with
// atomicAdd, whose order, and so whose float32 bits, change from run to
// run. This kernel gathers instead, so every launch gives the same bits:
//   * one CTA per (image, feature row y, tile of kTileX feature columns,
//     slice of 64 channel vectors); each thread owns one channel vector
//     (four channels with 16-byte accesses when C % 4 == 0) of the tile's
//     kTileX outputs and keeps their sums in registers;
//   * the CTA walks the image's RoIs in index order, kRoiChunk at a time.
//     For each RoI of a chunk it stages in shared memory the weight of
//     every pooled row p on row y, ay[p] = sum_k Wy[p*sr+k, y], and of
//     every pooled column q on each column of the tile, ax[q][x] (the
//     plain version's weight arithmetic: the +-1 inside test, the clamp
//     into [0, size - 1], 1 - |c - i| floored at 0), with bit masks of the
//     rows and columns whose weights are not all zero. A RoI whose
//     footprint misses the row or the tile has an empty mask and is
//     skipped; a RoI under one feature cell sets many bits of one row;
//   * for each RoI, in order, each live pooled column q in ascending order:
//     h = sum_p ay[p] g[r, p, q] over the live rows p in ascending order
//     (their loads issued kRowLoads at a time), then acc[x] += ax[q][x] h
//     for the tile's columns. The order of every sum is fixed, so the
//     result does not depend on scheduling;
//   * the weight tables take pooled-sized dynamic shared memory (8.8 KB at
//     pooled 7), so register use, not shared memory, bounds the CTAs an SM
//     holds;
//   * each output is written once, scaled by 1/sr^2, zero where no RoI
//     touches it.
//
// Bound: device memory. The work must read g once (at the detector's
// training shape, 4 images x 128 RoIs x 7 x 7 x 1024 float32: 102.8 MB)
// and write grad_f once (4 x 38 x 38 x 1024 float32: 23.7 MB). A g vector
// is read again by each CTA whose row and tile its bin's taps reach (a few
// rows and one or two tiles), mostly from L2: the CTAs of one channel slice
// touch a quarter of g, which fits in the 50 MB L2.
//
// RoIs get no gradient: the detector's training path detaches them, as the
// reference's approximate joint training does.

#include <cuda_runtime.h>

namespace hipe {
namespace {

constexpr int kThreads = 64;     // channel vectors per CTA
constexpr int kTileX = 8;        // feature columns per CTA
constexpr int kRoiChunk = 32;    // RoIs staged at once
constexpr int kMaxPooled = 32;   // pooled rows (columns) per RoI, one bit each
constexpr int kRowLoads = 4;     // cotangent rows loaded at once

// Sample centre of sample k of bin `bin` along one axis: the plain
// version's lo + bin * bsz + (k + 0.5) * (bsz / sr), rounded operation by
// operation.
__device__ __forceinline__ float sample_centre(float lo, float bsz, int bin,
                                               int k, int sr) {
  return __fadd_rn(__fadd_rn(lo, __fmul_rn(float(bin), bsz)),
                   __fmul_rn(float(k) + 0.5f, __fdiv_rn(bsz, float(sr))));
}

// The plain version's weight of grid position i for sample centre c on an
// axis of `size` positions: zero outside [-1, size], else the centre is
// clamped into [0, size - 1] and weighted 1 - |c - i|, floored at 0.
__device__ __forceinline__ float tap_weight(float c, int i, int size) {
  if (!(c >= -1.f && c <= float(size))) return 0.f;
  const float cc = fminf(fmaxf(c, 0.f), float(size - 1));
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(cc, float(i)))));
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
__device__ __forceinline__ void fma_to(V& acc, float w, const V& v);
template <>
__device__ __forceinline__ void fma_to<float>(float& acc, float w,
                                              const float& v) {
  acc += w * v;
}
template <>
__device__ __forceinline__ void fma_to<float4>(float4& acc, float w,
                                               const float4& v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
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

template <typename V>
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_kernel(const V* __restrict__ g,
                         const float* __restrict__ rois, V* __restrict__ grad,
                         int rois_per_image, int height, int width, int vecs,
                         int pooled, int sr, float scale) {
  // ay[rr * pooled + p], then ax[(rr * pooled + q) * kTileX + u]
  extern __shared__ float tables[];
  float* ay = tables;
  float* ax = tables + kRoiChunk * pooled;
  __shared__ unsigned row_bits[kRoiChunk];
  __shared__ unsigned col_bits[kRoiChunk];
  __shared__ float roi_geo[kRoiChunk][4];   // x lo, x bin, y lo, y bin

  const int tiles = (width + kTileX - 1) / kTileX;
  const int tile = blockIdx.x % tiles;
  const int row = (blockIdx.x / tiles) % height;
  const long long img = blockIdx.x / tiles / height;
  const int x0 = tile * kTileX;
  const int nx = min(kTileX, width - x0);
  const float inv = 1.f / float(sr * sr);
  const long long cells = (long long)pooled * pooled;
  const float* roi_base = rois + img * rois_per_image * 4;

  for (int c0 = blockIdx.y * kThreads; c0 < vecs;
       c0 += gridDim.y * kThreads) {
    const int c = c0 + threadIdx.x;
    const bool active = c < vecs;
    V acc[kTileX];
#pragma unroll
    for (int u = 0; u < kTileX; ++u) acc[u] = zero<V>();

    for (int r0 = 0; r0 < rois_per_image; r0 += kRoiChunk) {
      const int nr = min(kRoiChunk, rois_per_image - r0);
      __syncthreads();   // the previous chunk's weights are consumed
      if (threadIdx.x < nr) {
        // per axis: lo, length = max(hi - lo, 1), bin size = length/pooled
        const float* r = roi_base + (long long)(r0 + threadIdx.x) * 4;
        const float xl = __fmul_rn(r[0], scale);
        const float yl = __fmul_rn(r[1], scale);
        roi_geo[threadIdx.x][0] = xl;
        roi_geo[threadIdx.x][1] = __fdiv_rn(
            fmaxf(__fsub_rn(__fmul_rn(r[2], scale), xl), 1.f), float(pooled));
        roi_geo[threadIdx.x][2] = yl;
        roi_geo[threadIdx.x][3] = __fdiv_rn(
            fmaxf(__fsub_rn(__fmul_rn(r[3], scale), yl), 1.f), float(pooled));
        row_bits[threadIdx.x] = 0u;
        col_bits[threadIdx.x] = 0u;
      }
      __syncthreads();
      // ay[rr][p]: items (rr, p); ax[rr][q][u]: items (rr, q, u)
      const int n_rows = nr * pooled;
      const int n_items = n_rows + nr * pooled * kTileX;
      for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
        if (it < n_rows) {
          const int rr = it / pooled, p = it % pooled;
          float w = 0.f;
          for (int k = 0; k < sr; ++k) {
            w += tap_weight(sample_centre(roi_geo[rr][2], roi_geo[rr][3], p,
                                          k, sr), row, height);
          }
          ay[rr * pooled + p] = w;
          if (w != 0.f) atomicOr(&row_bits[rr], 1u << p);
        } else {
          const int j = it - n_rows;
          const int rr = j / (pooled * kTileX);
          const int q = (j / kTileX) % pooled, u = j % kTileX;
          float w = 0.f;
          if (u < nx) {
            for (int k = 0; k < sr; ++k) {
              w += tap_weight(sample_centre(roi_geo[rr][0], roi_geo[rr][1],
                                            q, k, sr), x0 + u, width);
            }
          }
          ax[(rr * pooled + q) * kTileX + u] = w;
          if (w != 0.f) atomicOr(&col_bits[rr], 1u << q);
        }
      }
      __syncthreads();
      if (!active) continue;
      for (int rr = 0; rr < nr; ++rr) {
        const unsigned rows_live = row_bits[rr];
        unsigned cols_live = col_bits[rr];
        if (rows_live == 0u || cols_live == 0u) continue;
        const V* gr = g + (img * rois_per_image + r0 + rr) * cells * vecs + c;
        while (cols_live) {
          const int q = __ffs(cols_live) - 1;
          cols_live &= cols_live - 1u;
          V h = zero<V>();
          unsigned rows = rows_live;
          while (rows) {
            // up to kRowLoads live rows at once: their loads in flight
            // together; missing ones weigh 0 (adding +0 keeps h)
            V v[kRowLoads];
            float w[kRowLoads];
#pragma unroll
            for (int e = 0; e < kRowLoads; ++e) {
              v[e] = zero<V>();
              w[e] = 0.f;
              if (rows) {
                const int p = __ffs(rows) - 1;
                rows &= rows - 1u;
                w[e] = ay[rr * pooled + p];
                v[e] = __ldg(gr + ((long long)p * pooled + q) * vecs);
              }
            }
#pragma unroll
            for (int e = 0; e < kRowLoads; ++e) fma_to(h, w[e], v[e]);
          }
          const float* wx = ax + (rr * pooled + q) * kTileX;
#pragma unroll
          for (int u = 0; u < kTileX; ++u) fma_to(acc[u], wx[u], h);
        }
      }
    }
    if (active) {
      V* out = grad + ((img * height + row) * width + x0) * (long long)vecs
               + c;
#pragma unroll
      for (int u = 0; u < kTileX; ++u) {
        if (u < nx) out[(long long)u * vecs] = scaled(acc[u], inv);
      }
    }
  }
}

}  // namespace
}  // namespace hipe

// g (B, R, pooled, pooled, C) cotangent, rois (B, R, 4) xyxy in image
// coordinates and grad (B, H, W, C), all float32 and contiguous, allocated
// by the caller; every element of grad is written. 1 <= pooled <= 32,
// 1 <= sampling_ratio <= 8. Returns the launch error (cudaErrorInvalidValue
// for a pooled size outside the kernel's range).
extern "C" int hipe_roi_align_bwd(const void* g, const void* rois, void* grad,
                                  int batch, int height, int width,
                                  int channels, int rois_per_image,
                                  int pooled, int sampling_ratio,
                                  float spatial_scale, void* stream) {
  if (pooled < 1 || pooled > hipe::kMaxPooled) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec4 = channels % 4 == 0;
  const int vecs = vec4 ? channels / 4 : channels;
  const int slices = (vecs + hipe::kThreads - 1) / hipe::kThreads;
  const int tiles = (width + hipe::kTileX - 1) / hipe::kTileX;
  const dim3 grid((unsigned)((long long)batch * height * tiles),
                  (unsigned)(slices < 65535 ? slices : 65535));
  const size_t smem =
      sizeof(float) * hipe::kRoiChunk * pooled * (1 + hipe::kTileX);
  if (vec4) {
    hipe::roi_align_bwd_kernel<float4><<<grid, hipe::kThreads, smem, st>>>(
        static_cast<const float4*>(g), static_cast<const float*>(rois),
        static_cast<float4*>(grad), rois_per_image, height, width, vecs,
        pooled, sampling_ratio, spatial_scale);
  } else {
    hipe::roi_align_bwd_kernel<float><<<grid, hipe::kThreads, smem, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(rois),
        static_cast<float*>(grad), rois_per_image, height, width, vecs,
        pooled, sampling_ratio, spatial_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
