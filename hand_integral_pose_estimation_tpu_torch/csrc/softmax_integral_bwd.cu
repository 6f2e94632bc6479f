// Soft-argmax (softmax integral) backward over an NHWC 3D heatmap.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/integral.py:
// _integral_bwd_kernel (launched by _softmax_integral_bwd_pallas). The
// gradient of the coords with respect to the logits has a closed form,
//   grad[b, hw, c] = exp(h - m_c) * (T_c + A_c * col(hw) + B_c * row(hw)),
// where the per-channel constants fold in the joint's max m and sum s, its
// coords and the incoming cotangent. The wrapper forms m, T, A and B in
// torch as (B, J*D) float32 (integral.py:253-268); this kernel is the one
// elementwise pass over the heatmap.
//
// Layout: heatmap and grad (B, H*W, J*D) in the heatmap's dtype (bf16 on
// the training path); the constants (B, J*D) float32.
//
// Bound: device memory. At B = 32 in bf16 it reads 236 MB and writes
// 236 MB: 0.14 ms at 3.35 TB/s. When J*D is a multiple of 8 (the training
// path's 1176 is), each thread owns one group of 8 consecutive channels
// of one image, keeps that group's 32 constants in registers and walks
// down a set of spatial rows, moving 16 bytes per access (8 bf16, or
// 2 x 4 float32) with two rows in flight; the 32 lanes of a warp cover
// 32 neighbouring groups, 512 contiguous bytes of a row. Otherwise (or on
// a misaligned base) a generic kernel stages the image's constants in
// shared memory and takes one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hipe {
namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // channels per vector access

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 consecutive values <-> float; 16- or 32-byte accesses.
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

constexpr int kGroupLanes = 32;    // channel groups per CTA (blockDim.x)
constexpr int kRowLanes = 8;       // rows walked in parallel (blockDim.y)
constexpr int kRowsPerThread = 16;  // rows each thread walks

// The vectorised path: blockIdx (group block, row block, image).
template <typename T>
__global__ void __launch_bounds__(kGroupLanes * kRowLanes)
    softmax_integral_bwd_vec_kernel(const T* __restrict__ hm,
                                    const float* __restrict__ mvec,
                                    const float* __restrict__ tvec,
                                    const float* __restrict__ avec,
                                    const float* __restrict__ bvec,
                                    T* __restrict__ grad, int hw_total,
                                    int width, int channels) {
  const int cg = blockIdx.x * kGroupLanes + threadIdx.x;
  if (cg * kVec >= channels) return;  // no barrier follows
  const int b = blockIdx.z;
  const long long cb = (long long)b * channels + cg * kVec;
  float m[kVec], t[kVec], a[kVec], bc[kVec];
  load8(mvec + cb, m);
  load8(tvec + cb, t);
  load8(avec + cb, a);
  load8(bvec + cb, bc);
  const long long base = (long long)b * hw_total * channels + cg * kVec;
  const int row0 = blockIdx.y * kRowLanes * kRowsPerThread + threadIdx.y;
#pragma unroll 1
  for (int i = 0; i < kRowsPerThread; i += 2) {
    float x[2][kVec];
    int hw[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      hw[u] = row0 + (i + u) * kRowLanes;
      if (hw[u] < hw_total)
        load8(hm + base + (long long)hw[u] * channels, x[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (hw[u] >= hw_total) continue;
      const int r = hw[u] / width;
      const float row = float(r);
      const float col = float(hw[u] - r * width);
      float g[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        g[k] = expf(x[u][k] - m[k]) * (t[k] + a[k] * col + bc[k] * row);
      store8(grad + base + (long long)hw[u] * channels, g);
    }
  }
}

// The generic path: grid (CTAs per image, B), the image's constants in
// shared memory, a grid-stride loop over single elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    softmax_integral_bwd_kernel(const T* __restrict__ hm,
                                const float* __restrict__ mvec,
                                const float* __restrict__ tvec,
                                const float* __restrict__ avec,
                                const float* __restrict__ bvec,
                                T* __restrict__ grad, int hw_total, int width,
                                int channels) {
  extern __shared__ float consts[];  // [4][channels]: m, T, A, B
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    const long long o = (long long)b * channels + c;
    consts[c] = mvec[o];
    consts[channels + c] = tvec[o];
    consts[2 * channels + c] = avec[o];
    consts[3 * channels + c] = bvec[o];
  }
  __syncthreads();
  const float* m_s = consts;
  const float* t_s = consts + channels;
  const float* a_s = consts + 2 * channels;
  const float* b_s = consts + 3 * channels;

  // the caller guarantees hw_total * channels < 2^31
  const int plane = hw_total * channels;
  const T* src = hm + (long long)b * plane;
  T* dst = grad + (long long)b * plane;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < plane;
       e += gridDim.x * blockDim.x) {
    const int hw = e / channels;
    const int c = e - hw * channels;
    const int r = hw / width;
    const float row = float(r);
    const float col = float(hw - r * width);
    store_f(dst + e, expf(load_f(src + e) - m_s[c]) *
                         (t_s[c] + a_s[c] * col + b_s[c] * row));
  }
}

template <typename T>
cudaError_t launch(const T* hm, const float* m, const float* t,
                   const float* a, const float* bc, T* grad, int batch,
                   int hw_total, int width, int channels,
                   cudaStream_t stream) {
  // 16-byte accesses need 8-channel rows and 16-byte aligned bases
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (channels % kVec == 0 && aligned(hm) && aligned(grad) && aligned(m) &&
      aligned(t) && aligned(a) && aligned(bc)) {
    const int groups = channels / kVec;
    const int rows = kRowLanes * kRowsPerThread;
    const dim3 grid((groups + kGroupLanes - 1) / kGroupLanes,
                    (hw_total + rows - 1) / rows, batch);
    softmax_integral_bwd_vec_kernel<T>
        <<<grid, dim3(kGroupLanes, kRowLanes), 0, stream>>>(
            hm, m, t, a, bc, grad, hw_total, width, channels);
  } else {
    // about eight CTAs per SM over the whole batch, never more than the
    // image has elements for
    const int plane = hw_total * channels;
    int per_image = (8 * 132 + batch - 1) / batch;
    const int needed = (plane + kThreads - 1) / kThreads;
    if (per_image > needed) per_image = needed;
    const size_t smem = sizeof(float) * 4 * (size_t)channels;
    softmax_integral_bwd_kernel<T>
        <<<dim3(per_image, batch), kThreads, smem, stream>>>(
            hm, m, t, a, bc, grad, hw_total, width, channels);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace hipe

// dtype: 0 = float32, 1 = bfloat16, for heatmap and grad alike. The four
// constant vectors are (B, channels) float32. The caller guarantees
// contiguity, 16 * channels bytes <= 48 KB and hw_total * channels < 2^31.
// Returns the launch error.
extern "C" int hipe_softmax_integral_bwd(const void* hm, int dtype,
                                         const void* m, const void* t,
                                         const void* a, const void* bc,
                                         void* grad, int batch, int hw_total,
                                         int width, int channels,
                                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto mm = static_cast<const float*>(m);
  auto tt = static_cast<const float*>(t);
  auto aa = static_cast<const float*>(a);
  auto bb = static_cast<const float*>(bc);
  cudaError_t err;
  if (dtype == 0) {
    err = hipe::launch(static_cast<const float*>(hm), mm, tt, aa, bb,
                       static_cast<float*>(grad), batch, hw_total, width,
                       channels, st);
  } else if (dtype == 1) {
    err = hipe::launch(static_cast<const __nv_bfloat16*>(hm), mm, tt, aa, bb,
                       static_cast<__nv_bfloat16*>(grad), batch, hw_total,
                       width, channels, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
