// Soft-argmax (softmax integral) forward over an NHWC 3D heatmap.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/integral.py:
// _integral_kernel (driver _softmax_integral_pallas). That kernel walks the
// spatial tiles of one batch row in grid order, carrying per-channel online
// statistics in VMEM scratch, and combines channels per joint with a mask
// matmul at the last tile. A GPU grid has no order, so here the sequential
// tile loop becomes a loop inside one CTA.
//
// Layout: heatmap (B, H*W, J*D), channel = j*D + d. One CTA per (b, j):
// B*J CTAs (672 at B = 32, J = 21). Each warp takes whole spatial rows; its
// lanes sit on neighbouring depth slots, so a warp reads the joint's D
// contiguous values of a row (224 bytes at D = 56 in f32) in one coalesced
// sweep. Each thread folds what it reads into one online-softmax state for
// the joint; the CTA merges the states at the end (online_softmax.cuh).
//
// Bound: device memory. The kernel reads the heatmap once and writes 5
// floats per joint: 472 MB at B = 32 in f32, 236 MB in bf16. Each warp
// issues the loads of ROWS rows before it folds any of them, to keep enough
// bytes in flight; the exp and the fold are a few instructions per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "online_softmax.cuh"

namespace hipe {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows in flight per warp

// DPL: depth slots per lane, ceil(D / 32).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    softmax_integral_fwd_kernel(const T* __restrict__ hm, int num_joints,
                                int height, int width, int depth,
                                float* __restrict__ coords,
                                float* __restrict__ m_out,
                                float* __restrict__ s_out) {
  const int bj = blockIdx.x;
  const int b = bj / num_joints;
  const int j = bj - b * num_joints;
  const int hw_total = height * width;
  const long long channels = (long long)num_joints * depth;
  const T* base = hm + (long long)b * hw_total * channels + (long long)j * depth;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  OnlineState st = empty_state();
  for (int hw0 = warp; hw0 < hw_total; hw0 += nwarps * kRows) {
    float v[kRows * DPL], x[kRows * DPL], y[kRows * DPL], z[kRows * DPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int hw = hw0 + r * nwarps;
      const bool row_ok = hw < hw_total;
      const T* row = base + (long long)hw * channels;
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int d = lane + 32 * k;
        v[r * DPL + k] = (row_ok && d < depth) ? to_float(row[d]) : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int hw = hw0 + r * nwarps;
      const float row_y = float(hw / width);
      const float col_x = float(hw - (hw / width) * width);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        x[r * DPL + k] = col_x;
        y[r * DPL + k] = row_y;
        z[r * DPL + k] = float(lane + 32 * k);
      }
    }
    fold(st, v, x, y, z);
  }
  finish(st, bj, height, width, depth, coords, m_out, s_out);
}

template <typename T>
void launch(const T* hm, float* coords, float* m, float* s, int batch,
            int height, int width, int num_joints, int depth,
            cudaStream_t stream) {
  const dim3 grid(batch * num_joints);
  const int dpl = (depth + 31) / 32;
  switch (dpl) {
    case 1:
      softmax_integral_fwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
          hm, num_joints, height, width, depth, coords, m, s);
      break;
    case 2:
      softmax_integral_fwd_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
          hm, num_joints, height, width, depth, coords, m, s);
      break;
    case 3:
      softmax_integral_fwd_kernel<T, 3><<<grid, kThreads, 0, stream>>>(
          hm, num_joints, height, width, depth, coords, m, s);
      break;
    default:
      softmax_integral_fwd_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
          hm, num_joints, height, width, depth, coords, m, s);
      break;
  }
}

}  // namespace
}  // namespace hipe

// dtype: 0 = float32, 1 = bfloat16. The caller guarantees contiguity,
// 1 <= depth <= 128 and a non-empty grid. Returns cudaGetLastError() after
// the launch.
extern "C" int hipe_softmax_integral_fwd(const void* hm, int dtype,
                                         void* coords, void* m, void* s,
                                         int batch, int height, int width,
                                         int num_joints, int depth,
                                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    hipe::launch(static_cast<const float*>(hm), static_cast<float*>(coords),
                 static_cast<float*>(m), static_cast<float*>(s), batch, height,
                 width, num_joints, depth, st);
  } else if (dtype == 1) {
    hipe::launch(static_cast<const __nv_bfloat16*>(hm),
                 static_cast<float*>(coords), static_cast<float*>(m),
                 static_cast<float*>(s), batch, height, width, num_joints,
                 depth, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hipe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
