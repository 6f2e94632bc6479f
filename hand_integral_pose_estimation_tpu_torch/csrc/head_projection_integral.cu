// Fused 1x1 heatmap projection + soft-argmax forward: the heatmap never
// reaches device memory. This file holds the C entry points and the
// CUDA-core kernel, which runs float32 features only where the tensor-core
// kernels of head_projection_integral_mma.cu do not take their width (F %
// 4 != 0 or F > 256; every configuration of the repository has F = 256):
// bf16 and float32 features of those widths run on the tensor cores.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _fwd_kernel (driver _forward_pallas). That kernel multiplies one spatial
// tile of features by the whole (F, J*D) projection on the MXU and feeds the
// product to per-channel online statistics carried across the grid in VMEM.
// Here the sequential tile loop is a loop inside one CTA, and the CTA owns
// one (batch row b, joint j) pair, so it only ever forms joint j's D logits.
//
// Layout: feats (B, H*W, F) contiguous, the NHWC head features;
// weight (J*D, F), the final 1x1 conv's weight viewed as a matrix;
// bias (J*D,). One CTA per (b, j): B*J CTAs, 672 at B = 32. At B <= 6
// (126 CTAs at J = 21) the grid has fewer CTAs than the card has SMs.
//
// Per CTA: joint j's D rows of the weight are staged once in shared memory,
// transposed to [f][d] and padded to a multiple of 8 depth slots. The CTA
// then walks spatial tiles of kTile positions; for each it stages the
// feature tile in kChunk-wide slices of F, transposed to [f][p], and each
// thread forms a 2 x 8 block of logits (positions lane and lane + 32, eight
// depth slots of its warp) with f32 FMAs. The logits plus bias fold into
// the same online state as the plain soft-argmax kernel
// (online_softmax.cuh).
//
// Bound: arithmetic. The projection is 2 * 3136 * 256 * 1176 = 1.9 GFLOP per
// image, here on CUDA cores in f32; the feature reads (3.2 MB per image in
// float32) are re-read J times, mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "f32_planes.cuh"
#include "online_softmax.cuh"

namespace hipe {
namespace {

constexpr int kTile = 64;   // spatial positions per tile (2 per lane)
constexpr int kChunk = 64;  // features staged per slice
constexpr int kTileStride = kTile + 1;  // +1 keeps the transposed stores conflict-free

template <typename T>
__global__ void head_projection_integral_fwd_kernel(
    const T* __restrict__ feats, const float* __restrict__ weight,
    const float* __restrict__ bias, int num_joints, int height, int width,
    int num_feats, int depth, int depth_pad, float* __restrict__ coords,
    float* __restrict__ m_out, float* __restrict__ s_out) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);   // [F][depth_pad]
  float* f_s = w_s + num_feats * depth_pad;        // [kChunk][kTileStride]

  const int bj = blockIdx.x;
  const int b = bj / num_joints;
  const int j = bj - b * num_joints;
  const int hw_total = height * width;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int dg = tid >> 5;  // this warp's group of 8 depth slots

  for (int idx = tid; idx < depth_pad * num_feats; idx += nthreads) {
    const int d = idx / num_feats;
    const int f = idx - d * num_feats;
    w_s[f * depth_pad + d] =
        d < depth ? weight[((long long)j * depth + d) * num_feats + f] : 0.f;
  }
  float bias_r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int d = dg * 8 + k;
    bias_r[k] = d < depth ? bias[j * depth + d] : 0.f;
  }

  const T* fb = feats + (long long)b * hw_total * num_feats;
  OnlineState st = empty_state();
  for (int p0 = 0; p0 < hw_total; p0 += kTile) {
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;

    for (int f0 = 0; f0 < num_feats; f0 += kChunk) {
      const int fc = min(kChunk, num_feats - f0);
      __syncthreads();  // the previous slice has been consumed
      for (int idx = tid; idx < kTile * fc; idx += nthreads) {
        const int p = idx / fc;
        const int f = idx - p * fc;
        const int hw = p0 + p;
        f_s[f * kTileStride + p] =
            hw < hw_total ? to_float(fb[(long long)hw * num_feats + f0 + f])
                          : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int f = 0; f < fc; ++f) {
        const float a0 = f_s[f * kTileStride + lane];
        const float a1 = f_s[f * kTileStride + lane + 32];
        const float4* wv =
            reinterpret_cast<const float4*>(w_s + (f0 + f) * depth_pad + dg * 8);
        const float4 w0 = wv[0];
        const float4 w1 = wv[1];
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc[0][k] = fmaf(a0, w[k], acc[0][k]);
          acc[1][k] = fmaf(a1, w[k], acc[1][k]);
        }
      }
    }

    float v[16], x[16], y[16], z[16];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hw = p0 + lane + 32 * i;
      const float row_y = float(hw / width);
      const float col_x = float(hw - (hw / width) * width);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = dg * 8 + k;
        const bool ok = hw < hw_total && d < depth;
        v[i * 8 + k] = ok ? acc[i][k] + bias_r[k] : -CUDART_INF_F;
        x[i * 8 + k] = col_x;
        y[i * 8 + k] = row_y;
        z[i * 8 + k] = float(d);
      }
    }
    fold(st, v, x, y, z);
  }
  finish(st, bj, height, width, depth, coords, m_out, s_out);
}

template <typename T>
cudaError_t launch(const T* feats, const float* weight, const float* bias,
                   float* coords, float* m, float* s, int batch, int height,
                   int width, int num_feats, int num_joints, int depth,
                   cudaStream_t stream) {
  const int depth_pad = (depth + 7) / 8 * 8;
  const int threads = 32 * (depth_pad / 8);
  const size_t smem =
      sizeof(float) * ((size_t)num_feats * depth_pad + kChunk * kTileStride);
  auto kernel = head_projection_integral_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch * num_joints, threads, smem, stream>>>(
      feats, weight, bias, num_joints, height, width, num_feats, depth,
      depth_pad, coords, m, s);
  return cudaGetLastError();
}

}  // namespace

// head_projection_integral_mma.cu: the tensor-core kernels
cudaError_t head_projection_fwd_mma(const __nv_bfloat16* feats,
                                    const float* weight, const float* bias,
                                    float* coords, float* m, float* s,
                                    float* ws, int batch, int height,
                                    int width, int num_feats, int num_joints,
                                    int depth, int chunks,
                                    cudaStream_t stream);
cudaError_t head_projection_fwd_mma_f32(const float* feats,
                                        const float* weight,
                                        const float* bias, float* coords,
                                        float* m, float* s, float* ws,
                                        void* planes, int batch, int height,
                                        int width, int num_feats,
                                        int num_joints, int depth, int chunks,
                                        cudaStream_t stream);

}  // namespace hipe

// One entry point per route, so that each counts its own launches:
// hipe_head_projection_integral_fwd takes bfloat16 feats,
// hipe_head_projection_integral_fwd_f32 float32 ones (both on the tensor
// cores, head_projection_integral_mma.cu), and
// hipe_head_projection_integral_fwd_f32_cuda_cores float32 ones on the
// CUDA-core kernel above. weight and bias are float32. The caller
// guarantees contiguity and 1 <= depth <= 128; for the tensor-core routes
// F % 4 == 0, F <= 256, 16-byte aligned arrays and a workspace ws of batch
// * chunks * J*D * 4 floats (chunks of tiles of 64 positions for
// bfloat16, of 32 for float32), for float32 also one of
// hipe_head_projection_integral_f32_workspace bytes for the split planes
// (the backward's layout); for the CUDA-core route that the staged weight
// fits in shared memory. Returns the first launch's CUDA error code.
extern "C" int hipe_head_projection_integral_fwd(
    const void* feats, const void* weight, const void* bias, void* coords,
    void* m, void* s, void* ws, int batch, int height, int width,
    int num_feats, int num_joints, int depth, int chunks, void* stream) {
  return static_cast<int>(hipe::head_projection_fwd_mma(
      static_cast<const __nv_bfloat16*>(feats),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(coords), static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(ws), batch, height, width,
      num_feats, num_joints, depth, chunks,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int hipe_head_projection_integral_fwd_f32(
    const void* feats, const void* weight, const void* bias, void* coords,
    void* m, void* s, void* ws, void* planes, int batch, int height,
    int width, int num_feats, int num_joints, int depth, int chunks,
    void* stream) {
  return static_cast<int>(hipe::head_projection_fwd_mma_f32(
      static_cast<const float*>(feats), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(coords),
      static_cast<float*>(m), static_cast<float*>(s), static_cast<float*>(ws),
      planes, batch, height, width, num_feats, num_joints, depth, chunks,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int hipe_head_projection_integral_fwd_f32_cuda_cores(
    const void* feats, const void* weight, const void* bias, void* coords,
    void* m, void* s, int batch, int height, int width, int num_feats,
    int num_joints, int depth, void* stream) {
  return static_cast<int>(hipe::launch(
      static_cast<const float*>(feats), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(coords),
      static_cast<float*>(m), static_cast<float*>(s), batch, height, width,
      num_feats, num_joints, depth, static_cast<cudaStream_t>(stream)));
}

// Bytes of the workspace of split planes that the float32 tensor-core
// routes take (forward and backward: one layout).
extern "C" long long hipe_head_projection_integral_f32_workspace(
    int batch, int height, int width, int num_feats, int num_joints,
    int depth) {
  return hipe::mma::head_projection_f32_planes_bytes(
      batch, height * width, num_feats, num_joints * depth);
}
