// ROIAlign backward with respect to the features, over an NHWC map,
// batched over images: the VJP of the plain version (roi_align in
// ops/roi_align.py) for a cotangent g of the pooled output,
//
//   grad_f[b, y, x, c] = 1/sr^2 * sum_r sum_{p,q} ay[r,p,y] ax[r,q,x]
//                                                  g[b, r, p, q, c],
//
// with ay[r,p,y] = sum_k Wy[r, p*sr+k, y] the weight of pooled row p on
// feature row y (Wy the plain version's dense bilinear weight rows of the
// sample centres), and ax likewise for the columns.
//
// No TPU kernel of the JAX package computes this: it trains through the
// XLA formulation of ROIAlign (roi_align.py:57-90 and roi_align_batched
// with impl="xla") and takes this gradient from XLA's autodiff, while its
// Pallas kernel (_ra_kernel, roi_align.py:93) is forward only. The
// reference's ROIAlign_cuda.cu scatters each sample's four taps with
// atomicAdd, whose order, and so whose float32 bits, change from run to
// run. Here each output has one owner at a time instead:
//   * one CTA per (image, band of feature rows, slice of `lanes` channel
//     vectors: 32 channels as float4 when C % 4 == 0). The CTA holds its
//     band of grad_f for its slice in shared memory (the strip: 38 x 38 x
//     32 float32 = 185 KB at the detector's map, one band) and walks the
//     image's RoIs in index order;
//   * a first, small launch writes each RoI's tables once to a workspace
//     (its footprint, the rows and columns each pooled bin reaches, per
//     row and column the first and last bin reaching it, and the weights
//     ay, ax over the footprint, with the plain version's arithmetic: the
//     sample centre and the +-1 inside test, the clamp into [0, size - 1],
//     1 - |c - i| floored at 0, summed over the bin's samples in order),
//     where every channel slice's CTA would otherwise recompute them;
//   * the RoIs are staged kSlots - 1 ahead of the one in hand: each RoI's
//     cotangent slab (P x P x lanes vectors) and tables by cp.async (the
//     contraction's loads of the tables are on its critical path: read from
//     L1 instead, they doubled the kernel's time on an H100). One barrier
//     per RoI;
//   * per RoI the footprint's columns x lanes are shared out in chunks of
//     kChunkRows rows: the owner of (chunk, column x, lane) loads its
//     cells into registers, contracts the columns first,
//     T[p] = sum_q ax[q][x] g[p][q], for the pooled rows that may reach
//     its chunk (kBlockP at a time), adds ay[p][y] T[p] to each cell, bins
//     in order, and writes the cells back. A strip cell has one owner per
//     RoI and the RoIs come in order, so every launch gives the same bits;
//   * the strip is written once, scaled by 1/sr^2 (zero where no RoI
//     touches it). Where a band does not hold the whole map (larger maps,
//     larger pooled sizes), each CTA takes a band of rows and clips each
//     RoI to it; a RoI across two bands has its slab read by both.
//
// Bound: device memory. The work must read g once (at the detector's
// training shape, 4 images x 128 RoIs x 7 x 7 x 1024 float32: 102.8 MB)
// and write grad_f once (4 x 38 x 38 x 1024 float32: 23.7 MB). With one
// band, every cotangent element is read once, by the CTA of its image and
// slice: 4 x 32 = 128 CTAs, one wave on 132 SMs, each streaming 0.8 MB
// with four RoIs' slabs in flight (the tables, 2.9 KB a RoI, come from
// L2). The contractions are separable (a few FMAs per footprint cell and
// channel), so the stream, the per-RoI barrier and the strip's
// shared-memory traffic are what is left.
//
// RoIs get no gradient: the detector's training path detaches them, as the
// reference's approximate joint training does.

#include <cuda_runtime.h>

#include <algorithm>

namespace hipe {
namespace {

constexpr int kThreads = 512;
constexpr int kTableThreads = 128;
constexpr int kSlots = 5;        // RoIs staged at once (4 ahead)
constexpr int kMaxLanes = 8;     // channel vectors per CTA
constexpr int kBlockP = 4;       // pooled rows contracted at once
constexpr int kChunkRows = 4;    // feature rows an item holds
constexpr int kMinBand = 8;      // fewer lanes before thinner bands
constexpr int kHeader = 8;       // table words before the ranges

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

// Positions [lo, hi] that samples with centres c0 <= ... <= c1 can reach
// on an axis of `size`: a centre inside [-1, size] is clamped into
// [0, size - 1] and reaches floor(cc) and floor(cc) + 1. Conservative where
// an end sample lies outside (the range then runs to the axis' end): extra
// positions weigh 0. When every sample lies outside, the range is empty:
// [0, -1] below the axis, [size, size - 1] beyond it, so that the ranges
// of consecutive bins stay ordered at both ends.
__device__ __forceinline__ void reach(float c0, float c1, int size, int& lo,
                                      int& hi) {
  if (c0 > float(size)) {
    lo = size;
    hi = size - 1;
    return;
  }
  if (!(c1 >= -1.f)) {
    lo = 0;
    hi = -1;
    return;
  }
  const float top = float(size - 1);
  lo = c0 >= -1.f ? int(floorf(fminf(fmaxf(c0, 0.f), top))) : 0;
  hi = c1 <= float(size) ? min(size - 1,
                               int(floorf(fminf(fmaxf(c1, 0.f), top))) + 1)
                         : size - 1;
}

// Words of one RoI's tables: the header (ya, ny, xa, nx: the footprint),
// each bin's rows and columns (rlo, rhi, clo, chi: P each), per row and
// column the first and last bin that may reach it (plo, phi: H each; qlo,
// qhi: W each), then the weights ay[P][H] and ax[P][W] (filled over the
// footprint); a multiple of 4, so that tables copy in 16-byte pieces.
__host__ __device__ __forceinline__ int table_words(int pooled, int height,
                                                    int width) {
  const int n = kHeader + 4 * pooled + (2 + pooled) * (height + width);
  return (n + 3) / 4 * 4;
}

// One CTA per RoI: its tables.
__global__ void __launch_bounds__(kTableThreads)
    roi_align_bwd_tables_kernel(const float* __restrict__ rois,
                                int* __restrict__ tables, int height,
                                int width, int pooled, int sr, float scale) {
  const int P = pooled;
  const float* roi = rois + (long long)blockIdx.x * 4;
  int* t = tables + (long long)blockIdx.x * table_words(P, height, width);
  const float xl = __fmul_rn(roi[0], scale);
  const float yl = __fmul_rn(roi[1], scale);
  const float xb = __fdiv_rn(
      fmaxf(__fsub_rn(__fmul_rn(roi[2], scale), xl), 1.f), float(P));
  const float yb = __fdiv_rn(
      fmaxf(__fsub_rn(__fmul_rn(roi[3], scale), yl), 1.f), float(P));
  int ya, ye, xa, xe;
  reach(sample_centre(yl, yb, 0, 0, sr),
        sample_centre(yl, yb, P - 1, sr - 1, sr), height, ya, ye);
  reach(sample_centre(xl, xb, 0, 0, sr),
        sample_centre(xl, xb, P - 1, sr - 1, sr), width, xa, xe);
  const int ny = max(0, ye - ya + 1);
  const int nx = max(0, xe - xa + 1);
  if (threadIdx.x == 0) {
    t[0] = ya;
    t[1] = nx > 0 ? ny : 0;
    t[2] = xa;
    t[3] = ny > 0 ? nx : 0;
  }
  if (ny == 0 || nx == 0) return;
  int* rlo = t + kHeader;
  int* rhi = rlo + P;
  int* clo = rhi + P;
  int* chi = clo + P;
  int* plo = chi + P;
  int* phi = plo + height;
  int* qlo = phi + height;
  int* qhi = qlo + width;
  float* ay = reinterpret_cast<float*>(qhi + width);
  float* ax = ay + P * height;
  for (int it = threadIdx.x; it < 2 * P; it += blockDim.x) {
    const bool rows = it < P;
    const int p = rows ? it : it - P;
    int lo, hi;
    if (rows)
      reach(sample_centre(yl, yb, p, 0, sr),
            sample_centre(yl, yb, p, sr - 1, sr), height, lo, hi);
    else
      reach(sample_centre(xl, xb, p, 0, sr),
            sample_centre(xl, xb, p, sr - 1, sr), width, lo, hi);
    (rows ? rlo : clo)[p] = lo;
    (rows ? rhi : chi)[p] = hi;
  }
  __syncthreads();
  // per footprint row: the bins whose ranges may meet it, [first bin
  // reaching it or beyond, last bin starting at or before it]; likewise
  // per column; then the weights
  const int n_items = ny + nx + P * (ny + nx);
  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    if (it < ny + nx) {
      const bool rows = it < ny;
      const int i = rows ? ya + it : xa + it - ny;
      const int* lo = rows ? rlo : clo;
      const int* hi = rows ? rhi : chi;
      int first = P, last = -1;
      for (int p = 0; p < P; ++p) {
        if (first == P && hi[p] >= i) first = p;
        if (lo[p] <= i) last = p;
      }
      (rows ? plo : qlo)[i] = first;
      (rows ? phi : qhi)[i] = last;
    } else if (it < ny + nx + P * ny) {
      const int j = it - ny - nx;
      const int p = j / ny, y = ya + j - p * ny;
      float w = 0.f;
      for (int k = 0; k < sr; ++k)
        w += tap_weight(sample_centre(yl, yb, p, k, sr), y, height);
      ay[p * height + y] = w;
    } else {
      const int j = it - ny - nx - P * ny;
      const int q = j / nx, x = xa + j - q * nx;
      float w = 0.f;
      for (int k = 0; k < sr; ++k)
        w += tap_weight(sample_centre(xl, xb, q, k, sr), x, width);
      ax[q * width + x] = w;
    }
  }
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

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A CTA's shared memory: kSlots slabs, the strip, kSlots tables.
struct Layout {
  int lanes, band_rows, pooled, height, width;
  __host__ __device__ int slab_len() const { return pooled * pooled * lanes; }
  __host__ __device__ int strip_len() const {
    return band_rows * width * lanes;
  }
  __host__ __device__ int words() const {
    return table_words(pooled, height, width);
  }
  // the tables start on a 16-byte boundary (they copy in 16-byte pieces)
  template <typename V>
  __host__ __device__ size_t table_offset() const {
    return (sizeof(V) * ((size_t)kSlots * slab_len() + strip_len()) + 15) /
           16 * 16;
  }
  template <typename V>
  __host__ __device__ size_t bytes() const {
    return table_offset<V>() + sizeof(int) * (size_t)kSlots * words();
  }
};

// Add one RoI's contribution into the strip (band rows y_lo .. y_hi - 1)
// from its staged slab and tables. The footprint's columns x lanes are
// shared out in chunks of kChunkRows rows; the owner of (chunk, column x,
// lane) holds its cells in registers, forms T[p] = sum_q ax[q][x] g[p][q]
// for the bins that may reach the chunk (kBlockP at a time, their loads
// issued together), adds ay[p][y] T[p] to each cell, bins in order (ay is
// 0 where bin p does not reach row y), and writes the cells back.
template <typename V, int kLanes>
__device__ __forceinline__ void contract(const Layout& L, const V* slab,
                                         const int* table, V* strip,
                                         int y_lo, int y_hi, int nl) {
  const int ya = table[0], ny = table[1], xa = table[2], nx = table[3];
  const int r0 = max(ya, y_lo);
  const int r1 = min(ya + ny, y_hi) - 1;
  if (r1 < r0 || nx <= 0) return;
  const int P = L.pooled, H = L.height, W = L.width;
  const int* plo = table + kHeader + 4 * P;
  const int* phi = plo + H;
  const int* qlo = phi + H;
  const int* qhi = qlo + W;
  const float* ay = reinterpret_cast<const float*>(qhi + W);
  const float* ax = ay + P * H;
  const int chunks = (r1 - r0 + kChunkRows) / kChunkRows;
  const int per_chunk = nx * kLanes;
  const int row_step = W * kLanes;
  for (int it = threadIdx.x; it < chunks * per_chunk; it += kThreads) {
    const int l = it % kLanes;
    if (l >= nl) continue;
    const int rest = it / kLanes;
    const int chunk = rest / nx;
    const int x = xa + rest - chunk * nx;
    const int y0 = r0 + chunk * kChunkRows;
    const int n = min(kChunkRows, r1 - y0 + 1);
    const int pa = plo[y0], pb = phi[y0 + n - 1];
    const int qa = qlo[x], qb = qhi[x];
    if (pa > pb || qa > qb) continue;
    V* cell = strip + ((y0 - y_lo) * W + x) * kLanes + l;
    V acc[kChunkRows];
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r)
      acc[r] = r < n ? cell[r * row_step] : zero<V>();
    const V* sl = slab + l;
    for (int p0 = pa; p0 <= pb; p0 += kBlockP) {
      V t[kBlockP];
#pragma unroll
      for (int j = 0; j < kBlockP; ++j) t[j] = zero<V>();
      for (int q = qa; q <= qb; ++q) {
        const float w = ax[q * W + x];
#pragma unroll
        for (int j = 0; j < kBlockP; ++j)  // bins past pb: unused
          fma_to(t[j], w, sl[(min(p0 + j, P - 1) * P + q) * kLanes]);
      }
#pragma unroll
      for (int j = 0; j < kBlockP; ++j) {
        if (p0 + j > pb) break;
        const float* wy = ay + (p0 + j) * H + y0;
#pragma unroll
        for (int r = 0; r < kChunkRows; ++r)
          fma_to(acc[r], r < n ? wy[r] : 0.f, t[j]);
      }
    }
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r)
      if (r < n) cell[r * row_step] = acc[r];
  }
}

template <typename V, int kLanes>
__global__ void __launch_bounds__(kThreads)
    roi_align_bwd_kernel(const V* __restrict__ g,
                         const int* __restrict__ tables,
                         V* __restrict__ grad, Layout L, int rois_per_image,
                         int vecs, int sr, int bands) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* slabs = reinterpret_cast<V*>(smem);
  V* strip = slabs + kSlots * L.slab_len();
  int* tab = reinterpret_cast<int*>(smem + L.table_offset<V>());
  const int tw = L.words();

  const long long img = blockIdx.x / bands;
  const int band = blockIdx.x - img * bands;
  const int y_lo = band * L.band_rows;
  const int y_hi = min(L.height, y_lo + L.band_rows);
  const int c0 = blockIdx.y * kLanes;
  const int nl = min(kLanes, vecs - c0);
  const int R = rois_per_image;
  const int cells = L.pooled * L.pooled;
  const V* g_img = g + img * R * cells * (long long)vecs;
  const int* t_img = tables + img * R * (long long)tw;

  for (int i = threadIdx.x; i < L.strip_len(); i += kThreads)
    strip[i] = zero<V>();
  // RoI n's slab and tables into slot n % kSlots
  auto stage = [&](int n) {
    if (n < R) {
      const int s = n % kSlots;
      V* slab = slabs + s * L.slab_len();
      const V* src = g_img + (long long)n * cells * vecs + c0;
      for (int i = threadIdx.x; i < cells * nl; i += kThreads) {
        const int pq = i / nl;
        const int l = i - pq * nl;
        cp_async<sizeof(V)>(slab + pq * kLanes + l,
                            src + (long long)pq * vecs + l);
      }
      const int* ts = t_img + (long long)n * tw;
      for (int i = threadIdx.x; i < tw / 4; i += kThreads)
        cp_async<16>(tab + s * tw + 4 * i, ts + 4 * i);
    }
    cp_async_commit();
  };
  for (int n = 0; n < kSlots - 1; ++n) stage(n);
  for (int r = 0; r < R; ++r) {
    cp_async_wait<kSlots - 2>();  // RoI r has landed
    __syncthreads();              // ... for every thread; slot r - 1 is free
    stage(r + kSlots - 1);
    const int s = r % kSlots;
    contract<V, kLanes>(L, slabs + s * L.slab_len(), tab + s * tw, strip,
                        y_lo, y_hi, nl);
  }
  __syncthreads();

  const float inv = 1.f / float(sr * sr);
  const int n_out = (y_hi - y_lo) * L.width * nl;
  V* out = grad + ((img * L.height + y_lo) * L.width) * (long long)vecs + c0;
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const int cell = i / nl;
    const int l = i - cell * nl;
    out[(long long)cell * vecs + l] = scaled(strip[cell * kLanes + l], inv);
  }
}

// The widest channel slice (a power of two up to kMaxLanes vectors, no
// wider than the channels need) whose band holds kMinBand rows (or the
// whole map), then the most rows its band can hold; lanes = 0 when not
// even one row fits.
template <typename V>
Layout plan(int height, int width, int vecs, int pooled, size_t budget) {
  int lanes = 1;
  while (lanes < std::min(kMaxLanes, vecs)) lanes *= 2;
  Layout L{0, 0, pooled, height, width};
  const int enough = std::min(height, kMinBand);
  for (; lanes >= 1; lanes /= 2) {
    const Layout t{lanes, 1, pooled, height, width};
    const size_t one = t.bytes<V>();
    if (one > budget) continue;
    const size_t per_row = sizeof(V) * (size_t)width * lanes;
    const int rows =
        (int)std::min<size_t>(height, 1 + (budget - one) / per_row);
    if (L.lanes == 0 || rows >= enough) {
      L = Layout{lanes, rows, pooled, height, width};
      if (rows >= enough) break;
    }
  }
  return L;
}

template <typename V, int kLanes>
cudaError_t launch_main(const V* g, const int* tables, V* grad, Layout L,
                        dim3 grid, size_t smem, int rois_per_image, int vecs,
                        int sr, int bands, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      roi_align_bwd_kernel<V, kLanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  roi_align_bwd_kernel<V, kLanes><<<grid, kThreads, smem, stream>>>(
      g, tables, grad, L, rois_per_image, vecs, sr, bands);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch(const V* g, const float* rois, V* grad, int* tables,
                   int batch, int height, int width, int vecs,
                   int rois_per_image, int pooled, int sr, float scale,
                   cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  Layout L = plan<V>(height, width, vecs, pooled, (size_t)optin);
  if (L.lanes == 0) return cudaErrorInvalidValue;
  // bands of even height
  const int bands = (height + L.band_rows - 1) / L.band_rows;
  L.band_rows = (height + bands - 1) / bands;
  const int slices = (vecs + L.lanes - 1) / L.lanes;
  if (slices > 65535) return cudaErrorInvalidValue;

  roi_align_bwd_tables_kernel<<<batch * rois_per_image, kTableThreads, 0,
                                stream>>>(rois, tables, height, width, pooled,
                                          sr, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(batch * bands), slices);
  const size_t smem = L.bytes<V>();
  switch (L.lanes) {
    case 8:
      return launch_main<V, 8>(g, tables, grad, L, grid, smem,
                               rois_per_image, vecs, sr, bands, stream);
    case 4:
      return launch_main<V, 4>(g, tables, grad, L, grid, smem,
                               rois_per_image, vecs, sr, bands, stream);
    case 2:
      return launch_main<V, 2>(g, tables, grad, L, grid, smem,
                               rois_per_image, vecs, sr, bands, stream);
    default:
      return launch_main<V, 1>(g, tables, grad, L, grid, smem,
                               rois_per_image, vecs, sr, bands, stream);
  }
}

}  // namespace
}  // namespace hipe

// Bytes of the workspace hipe_roi_align_bwd needs: each RoI's tables.
extern "C" long long hipe_roi_align_bwd_workspace(int batch,
                                                  int rois_per_image,
                                                  int height, int width,
                                                  int pooled) {
  return (long long)batch * rois_per_image * sizeof(int) *
         hipe::table_words(pooled, height, width);
}

// g (B, R, pooled, pooled, C) cotangent, rois (B, R, 4) xyxy in image
// coordinates and grad (B, H, W, C), all float32 and contiguous, allocated
// by the caller with the workspace ws (hipe_roi_align_bwd_workspace bytes,
// 16-byte aligned); every element of grad is written. 1 <= pooled <= 32,
// 1 <= sampling_ratio <= 8. Launches the tables, then the contraction.
// Returns the first launch error (cudaErrorInvalidValue for a pooled size
// outside the kernel's range or a map too wide for one row of the strip).
extern "C" int hipe_roi_align_bwd(const void* g, const void* rois, void* grad,
                                  void* ws, int batch, int height, int width,
                                  int channels, int rois_per_image,
                                  int pooled, int sampling_ratio,
                                  float spatial_scale, void* stream) {
  if (pooled < 1 || pooled > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rois);
  auto t = static_cast<int*>(ws);
  cudaError_t err;
  if (channels % 4 == 0) {
    err = hipe::launch(static_cast<const float4*>(g), r,
                       static_cast<float4*>(grad), t, batch, height, width,
                       channels / 4, rois_per_image, pooled, sampling_ratio,
                       spatial_scale, st);
  } else {
    err = hipe::launch(static_cast<const float*>(g), r,
                       static_cast<float*>(grad), t, batch, height, width,
                       channels, rois_per_image, pooled, sampling_ratio,
                       spatial_scale, st);
  }
  return static_cast<int>(err);
}
