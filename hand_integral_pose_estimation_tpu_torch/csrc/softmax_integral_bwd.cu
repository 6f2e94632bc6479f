// Soft-argmax (softmax integral) backward over an NHWC 3D heatmap.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/integral.py:
// _integral_bwd_kernel (launched by _softmax_integral_bwd_pallas). The
// gradient of the coords with respect to the logits has a closed form,
//   grad[b, hw, c] = exp(h - m_c) * (T_c + A_c * col(hw) + B_c * row(hw)),
// where, with j = c / D the channel's joint and gz = (c mod D) / D - 0.5,
//   T_c = (cot_x (-0.5 - c_x) + cot_y (-0.5 - c_y) + cot_z (gz - c_z)) / s_j
//   A_c = cot_x / (s_j W),   B_c = cot_y / (s_j H),   m_c = m_j
// fold in the joint's max m_j and sum s_j, its coords c and the incoming
// cotangent (integral.py:246-268). The JAX package forms them in XLA as
// four (B, J*D) vectors. Here each thread forms its own channels' constants
// in registers from the (B, J) statistics, so one call is one launch with
// no tensor glue around it.
//
// Layout: heatmap and grad (B, H*W, J*D) in the heatmap's dtype (bf16 on
// the training path); m, s (B, J), coords and cot (B, J, 3), float32.
//
// Bound: device memory. At B = 32 in bf16 it reads 236 MB and writes
// 236 MB: 0.14 ms at 3.35 TB/s. When J*D is a multiple of 8 (the training
// path's 1176 is), each thread owns one group of 8 consecutive channels
// of one image, keeps that group's 32 constants in registers and walks
// down a set of spatial rows, moving 16 bytes per access (8 bf16, or
// 2 x 4 float32) with kRowsInFlight rows loaded before any is stored; the
// 32 lanes of a warp cover 32 neighbouring groups, 512 contiguous bytes of
// a row. The first rows' loads are issued before the constants are formed,
// so forming them hides under the loads' latency. A group spans two joints
// whenever D is not a multiple of 8, so the constants are indexed per
// channel. Otherwise (or on a misaligned base) a generic kernel stages the
// image's per-joint terms in shared memory (28 bytes a joint) and takes one
// element at a time, forming its channel's constants from them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "vec8.cuh"

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

// 8 consecutive values from float; 16- or 32-byte stores.
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

// A joint's share of its channels' constants: m, s, the cotangent's x and
// y terms of T, its z weight and the joint's z coordinate, A and B.
struct JointTerms {
  float m, s, txy, cot_z, c_z, a, b;
};

// st: m, s, c_x, c_y, c_z, cot_x, cot_y, cot_z of one joint
__device__ __forceinline__ JointTerms joint_terms(const float (&st)[8],
                                                  int height, int width) {
  const float s = st[1];
  return JointTerms{st[0], s,
                    st[5] * (-0.5f - st[2]) + st[6] * (-0.5f - st[3]),
                    st[7], st[4], st[5] / (s * float(width)),
                    st[6] / (s * float(height))};
}

__device__ __forceinline__ JointTerms joint_terms(
    const float* __restrict__ m, const float* __restrict__ s,
    const float* __restrict__ coords, const float* __restrict__ cot, int bj,
    int height, int width) {
  const float st[8] = {__ldg(m + bj),             __ldg(s + bj),
                       __ldg(coords + 3 * bj),     __ldg(coords + 3 * bj + 1),
                       __ldg(coords + 3 * bj + 2), __ldg(cot + 3 * bj),
                       __ldg(cot + 3 * bj + 1),    __ldg(cot + 3 * bj + 2)};
  return joint_terms(st, height, width);
}

// T of depth slot d
__device__ __forceinline__ float channel_t(const JointTerms& jt, int d,
                                           int depth) {
  const float gz = float(d) / float(depth) - 0.5f;
  return (jt.txy + jt.cot_z * (gz - jt.c_z)) / jt.s;
}

constexpr int kGroupLanes = 32;     // channel groups per CTA (blockDim.x)
constexpr int kRowLanes = 8;        // rows walked in parallel (blockDim.y)
constexpr int kRowsPerThread = 16;  // rows each thread walks
constexpr int kRowsInFlight = 4;    // rows loaded before any is stored (2
                                    // ran slower on the H100)
static_assert(kRowsPerThread % kRowsInFlight == 0, "whole steps");

// The vectorised path: blockIdx (group block, row block, image). The rows
// in flight stay packed (16 registers of bf16), so three CTAs fit an SM
// in bf16 (at most 85 registers a thread), two in float32.
template <typename T>
__global__ void __launch_bounds__(kGroupLanes * kRowLanes,
                                  sizeof(T) == 2 ? 3 : 2)
    softmax_integral_bwd_vec_kernel(const T* __restrict__ hm,
                                    const float* __restrict__ m_in,
                                    const float* __restrict__ s_in,
                                    const float* __restrict__ coords,
                                    const float* __restrict__ cot,
                                    T* __restrict__ grad, int hw_total,
                                    int height, int width, int num_joints,
                                    int depth) {
  const int channels = num_joints * depth;
  const int c0 = (blockIdx.x * kGroupLanes + threadIdx.x) * kVec;
  if (c0 >= channels) return;  // no barrier follows
  const int b = blockIdx.z;
  const long long base = (long long)b * hw_total * channels + c0;
  int hw = blockIdx.y * kRowLanes * kRowsPerThread + threadIdx.y;
  // this thread's rows step by kRowLanes: row and column stepped along,
  // one division here and none per row
  int row = hw / width, col = hw - row * width;
  const int step_row = kRowLanes / width;
  const int step_col = kRowLanes - step_row * width;

  Vec8<T> x[kRowsInFlight];
  const auto load_rows = [&](int first) {
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = first + u * kRowLanes;
      if (r < hw_total) x[u].load(hm + base + (long long)r * channels);
    }
  };
  load_rows(hw);

  float mc[kVec], tc[kVec], ac[kVec], bc[kVec];
  {
    int j = c0 / depth, d = c0 - j * depth;
    JointTerms jt = joint_terms(m_in, s_in, coords, cot, b * num_joints + j,
                                height, width);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k > 0 && ++d == depth) {
        d = 0;
        jt = joint_terms(m_in, s_in, coords, cot, b * num_joints + ++j,
                         height, width);
      }
      mc[k] = jt.m;
      tc[k] = channel_t(jt, d, depth);
      ac[k] = jt.a;
      bc[k] = jt.b;
    }
  }

#pragma unroll 1
  for (int i = 0; i < kRowsPerThread; i += kRowsInFlight) {
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = hw + u * kRowLanes;
      if (r < hw_total) {
        const float fr = float(row), fc = float(col);
        float g[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          g[k] = expf(x[u][k] - mc[k]) * (tc[k] + ac[k] * fc + bc[k] * fr);
        store8(grad + base + (long long)r * channels, g);
      }
      col += step_col;
      row += step_row;
      if (col >= width) {
        col -= width;
        ++row;
      }
    }
    hw += kRowsInFlight * kRowLanes;
    if (i + kRowsInFlight < kRowsPerThread) load_rows(hw);
  }
}

// The generic path: grid (CTAs per image, B), the image's joint terms in
// shared memory, a grid-stride loop over single elements that forms each
// element's channel constants from its joint's terms.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    softmax_integral_bwd_kernel(const T* __restrict__ hm,
                                const float* __restrict__ m_in,
                                const float* __restrict__ s_in,
                                const float* __restrict__ coords,
                                const float* __restrict__ cot,
                                T* __restrict__ grad, int hw_total,
                                int height, int width, int num_joints,
                                int depth) {
  extern __shared__ float smem[];  // [J] JointTerms
  JointTerms* terms = reinterpret_cast<JointTerms*>(smem);
  const int channels = num_joints * depth;
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < num_joints; j += blockDim.x)
    terms[j] = joint_terms(m_in, s_in, coords, cot, b * num_joints + j,
                           height, width);
  __syncthreads();

  // the caller guarantees hw_total * channels < 2^31
  const int plane = hw_total * channels;
  const T* src = hm + (long long)b * plane;
  T* dst = grad + (long long)b * plane;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < plane;
       e += gridDim.x * blockDim.x) {
    const int hw = e / channels;
    const int c = e - hw * channels;
    const int j = c / depth;
    const JointTerms jt = terms[j];
    const int r = hw / width;
    const float row = float(r);
    const float col = float(hw - r * width);
    store_f(dst + e, expf(load_f(src + e) - jt.m) *
                         (channel_t(jt, c - j * depth, depth) + jt.a * col +
                          jt.b * row));
  }
}

template <typename T>
cudaError_t launch(const T* hm, const float* m, const float* s,
                   const float* coords, const float* cot, T* grad, int batch,
                   int height, int width, int num_joints, int depth,
                   cudaStream_t stream) {
  const int hw_total = height * width;
  const int channels = num_joints * depth;
  // 16-byte accesses need 8-channel rows and 16-byte aligned bases
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (channels % kVec == 0 && aligned(hm) && aligned(grad)) {
    const int groups = channels / kVec;
    const int rows = kRowLanes * kRowsPerThread;
    const dim3 grid((groups + kGroupLanes - 1) / kGroupLanes,
                    (hw_total + rows - 1) / rows, batch);
    softmax_integral_bwd_vec_kernel<T>
        <<<grid, dim3(kGroupLanes, kRowLanes), 0, stream>>>(
            hm, m, s, coords, cot, grad, hw_total, height, width, num_joints,
            depth);
  } else {
    // about eight CTAs per SM over the whole batch, never more than the
    // image has elements for
    const int plane = hw_total * channels;
    int per_image = (8 * 132 + batch - 1) / batch;
    const int needed = (plane + kThreads - 1) / kThreads;
    if (per_image > needed) per_image = needed;
    const size_t smem = sizeof(JointTerms) * (size_t)num_joints;
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    softmax_integral_bwd_kernel<T>
        <<<dim3(per_image, batch), kThreads, smem, stream>>>(
            hm, m, s, coords, cot, grad, hw_total, height, width, num_joints,
            depth);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace hipe

// dtype: 0 = float32, 1 = bfloat16, for heatmap and grad alike. m and s
// are (B, J), coords and cot (B, J, 3), all float32 and contiguous. The
// caller guarantees contiguity and H * W * J * D < 2^31. The generic path
// refuses (cudaErrorInvalidValue) more joints than its 48 KB of shared
// memory holds (1755). Returns the launch error.
extern "C" int hipe_softmax_integral_bwd(const void* hm, int dtype,
                                         const void* m, const void* s,
                                         const void* coords, const void* cot,
                                         void* grad, int batch, int height,
                                         int width, int num_joints, int depth,
                                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto mm = static_cast<const float*>(m);
  auto ss = static_cast<const float*>(s);
  auto cc = static_cast<const float*>(coords);
  auto tt = static_cast<const float*>(cot);
  cudaError_t err;
  if (dtype == 0) {
    err = hipe::launch(static_cast<const float*>(hm), mm, ss, cc, tt,
                       static_cast<float*>(grad), batch, height, width,
                       num_joints, depth, st);
  } else if (dtype == 1) {
    err = hipe::launch(static_cast<const __nv_bfloat16*>(hm), mm, ss, cc, tt,
                       static_cast<__nv_bfloat16*>(grad), batch, height, width,
                       num_joints, depth, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
