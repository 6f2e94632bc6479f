// ROIAlign forward over an NHWC feature map, batched over images: each
// RoI's pooled x pooled bins, each the mean of sampling_ratio^2 bilinear
// samples.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/
// roi_align.py: _ra_kernel (launched by roi_align_batched). The TPU has
// slow gathers, so that kernel builds a dense (G*49, H*W) matrix of
// combined bilinear weights from iotas and runs one MXU matmul against the
// whole feature map held in VMEM; over 99 % of those weights are zero.
// Here each sample reads its four taps directly, as the reference's
// ROIAlign_cuda.cu:15-345 does: one CTA per (image, RoI, bin), its threads
// across the channels, so a warp's reads of one tap are contiguous NHWC
// channels (four per thread with 16-byte accesses when C % 4 == 0).
//
// Bound: device memory. At the detector's shape (4 images, 38x38x1024
// float32 features, 300 RoIs) the output is 241 MB written once; the 24 MB
// feature map stays in the 50 MB L2 cache while the RoIs read it again.
//
// The function is that of the plain version, roi_align in
// ops/roi_align.py (the JAX package's roi_align.py:25-90): coordinates
// scaled by spatial_scale, length max(hi - lo, 1), bins of length /
// pooled, sample centres lo + bin * bsz + (k + 0.5) * bsz / sr, a sample
// outside [-1, size] contributes zero, otherwise it is clamped into
// [0, size - 1] and split bilinearly with the weights 1 - |c - i| of the
// plain version's dense rows, no half-pixel offset. Float32 throughout;
// only the order of the sums differs from the plain version.

#include <cuda_runtime.h>

namespace hipe {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxSamples = 8;

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
  const int bins = pooled * pooled;
  const long long cell = blockIdx.x;  // (image * R + roi) * bins + bin
  const int pq = int(cell % bins);
  const long long roi = cell / bins;
  const long long img = roi / rois_per_image;
  const int p = pq / pooled, q = pq % pooled;
  const float* r = rois + roi * 4;

  // per axis: lo, length = max(hi - lo, 1), bin size = length / pooled
  const float x_lo = __fmul_rn(r[0], scale);
  const float y_lo = __fmul_rn(r[1], scale);
  const float x_bsz = __fdiv_rn(
      fmaxf(__fsub_rn(__fmul_rn(r[2], scale), x_lo), 1.f), float(pooled));
  const float y_bsz = __fdiv_rn(
      fmaxf(__fsub_rn(__fmul_rn(r[3], scale), y_lo), 1.f), float(pooled));
  Taps ty[kMaxSamples], tx[kMaxSamples];
  for (int k = 0; k < sr; ++k) {
    ty[k] = axis_taps(y_lo, y_bsz, p, k, sr, height);
    tx[k] = axis_taps(x_lo, x_bsz, q, k, sr, width);
  }
  const float inv = 1.f / float(sr * sr);
  const V* f = feats + img * height * width * vecs;
  V* o = out + cell * vecs;

  for (int c = threadIdx.x; c < vecs; c += blockDim.x) {
    V acc = zero<V>();
    for (int ky = 0; ky < sr; ++ky) {
      const Taps& y = ty[ky];
      for (int kx = 0; kx < sr; ++kx) {
        const Taps& x = tx[kx];
        // rows then columns, zero-weight taps skipped
        const V* row0 = f + (long long)y.i0 * width * vecs;
        V s0 = zero<V>();
        fma_tap(s0, x.w0, row0[(long long)x.i0 * vecs + c]);
        if (x.i1 >= 0) fma_tap(s0, x.w1, row0[(long long)x.i1 * vecs + c]);
        fma_tap(acc, y.w0, s0);
        if (y.i1 >= 0) {
          const V* row1 = f + (long long)y.i1 * width * vecs;
          V s1 = zero<V>();
          fma_tap(s1, x.w0, row1[(long long)x.i0 * vecs + c]);
          if (x.i1 >= 0) {
            fma_tap(s1, x.w1, row1[(long long)x.i1 * vecs + c]);
          }
          fma_tap(acc, y.w1, s1);
        }
      }
    }
    o[c] = scaled(acc, inv);
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
  const unsigned cells =
      (unsigned)((long long)batch * rois_per_image * pooled * pooled);
  if (channels % 4 == 0) {
    hipe::roi_align_fwd_kernel<float4><<<cells, hipe::kThreads, 0, st>>>(
        static_cast<const float4*>(feats), static_cast<const float*>(rois),
        static_cast<float4*>(out), rois_per_image, height, width,
        channels / 4, pooled, sampling_ratio, spatial_scale);
  } else {
    hipe::roi_align_fwd_kernel<float><<<cells, hipe::kThreads, 0, st>>>(
        static_cast<const float*>(feats), static_cast<const float*>(rois),
        static_cast<float*>(out), rois_per_image, height, width, channels,
        pooled, sampling_ratio, spatial_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
