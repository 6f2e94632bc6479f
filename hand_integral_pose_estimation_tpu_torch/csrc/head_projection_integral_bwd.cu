// Fused 1x1 heatmap projection + soft-argmax backward: the C entry points
// and the shared fixed-order sum (c). Both feature dtypes run on the
// tensor cores, in the kernels (a) and (b) of
// head_projection_integral_bwd_mma.cu.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _bwd_kernel (launched by _hp_bwd). Per spatial tile it recomputes the
// logits x = feats @ W^T + b, forms the soft-argmax cotangent
//   g[hw, c] = exp(x - m_c) * (T_c + A_c * col + B_c * row)
// (the constants as in softmax_integral_bwd.cu, formed by the wrapper) and
// contracts it at once: dfeat = g @ W, dW = sum g^T feats, db = sum g.
// The TPU kernel sums dW and db in its output blocks across the whole grid,
// legal only because the TPU runs the grid in order. Here CTAs run in any
// order, so the work is split into three launches, and every sum is taken
// in a fixed order: the result is the same bits from run to run.
//
//   (s) float32 features only: features and weight split once into bf16
//       planes, in a workspace;
//   (a) dfeat, one CTA per tile (or two) of positions;
//   (b) dW, db partials, one CTA per (channel block, image, chunk of the
//       image's tiles), written to a workspace;
//   (c) here: a reduction adds the chunks' partials in chunk order.
//
// Layout: feats and dfeat (B, H*W, F) in the features' dtype; weight
// (J*D, F) float32 (the final 1x1 conv's weight viewed as a matrix), bias
// (J*D,); the constants (B, J*D) float32; dW (J*D, F) and db (J*D,)
// float32; workspace (chunks, J*D, F) and (chunks, J*D) float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hipe {
namespace {

constexpr int kThreads = 256;

// (c) dW = sum over chunks of ws, db = sum over chunks of ws_db, each
// element's chunks added in chunk order.
__global__ void __launch_bounds__(kThreads)
    hp_bwd_reduce_kernel(const float* __restrict__ ws,
                         const float* __restrict__ ws_db,
                         float* __restrict__ dweight,
                         float* __restrict__ dbias, int chunks,
                         long long channels, int num_feats) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = channels * num_feats;
  if (idx < n) {
    float acc = 0.f;
    for (int k = 0; k < chunks; ++k) acc += ws[(long long)k * n + idx];
    dweight[idx] = acc;
  } else if (idx < n + channels) {
    const long long c = idx - n;
    float acc = 0.f;
    for (int k = 0; k < chunks; ++k) acc += ws_db[(long long)k * channels + c];
    dbias[c] = acc;
  }
}

cudaError_t reduce(const float* ws, const float* ws_db, float* dweight,
                   float* dbias, int partials, long long channels,
                   int num_feats, cudaStream_t stream) {
  const long long n = channels * num_feats + channels;
  hp_bwd_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(ws, ws_db, dweight, dbias, partials,
                                      channels, num_feats);
  return cudaGetLastError();
}

}  // namespace

// head_projection_integral_bwd_mma.cu: (a) and (b) for bf16 and float32
// features
cudaError_t head_projection_bwd_mma(
    const __nv_bfloat16* feats, const float* weight, const float* bias,
    const float* m, const float* t, const float* a, const float* bc,
    __nv_bfloat16* dfeat, float* ws, float* ws_db, int batch, int height,
    int width, int num_feats, int num_joints, int depth, int chunks,
    cudaStream_t stream);
cudaError_t head_projection_bwd_mma_f32(
    const float* feats, const float* weight, const float* bias,
    const float* m, const float* t, const float* a, const float* bc,
    float* dfeat, float* ws, float* ws_db, void* planes, int batch,
    int height, int width, int num_feats, int num_joints, int depth,
    int chunks, cudaStream_t stream);

}  // namespace hipe

namespace {

// (c) after a route's (a) and (b) returned `err`.
int reduce_after(cudaError_t err, void* ws, void* ws_db, void* dweight,
                 void* dbias, int batch, int num_feats, int num_joints,
                 int depth, int chunks_per_image, void* stream) {
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hipe::reduce(
      static_cast<float*>(ws), static_cast<float*>(ws_db),
      static_cast<float*>(dweight), static_cast<float*>(dbias),
      batch * chunks_per_image, (long long)num_joints * depth, num_feats,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// One entry point per route, so that each counts its own launches:
// hipe_head_projection_integral_bwd takes bfloat16 feats and dfeat,
// hipe_head_projection_integral_bwd_f32 float32 ones and a workspace for
// their split planes (hipe_head_projection_integral_f32_workspace bytes,
// head_projection_integral.cu). Every other array is float32. The caller guarantees contiguity,
// 16-byte aligned arrays, F % 4 == 0, F <= 256, 1 <= depth <= 128 and a
// workspace of batch * chunks_per_image chunks (tiles of 64 positions for
// bfloat16, of 32 for float32). Returns the first launch error.
extern "C" int hipe_head_projection_integral_bwd(
    const void* feats, const void* weight, const void* bias, const void* m,
    const void* t, const void* a, const void* bc, void* dfeat, void* dweight,
    void* dbias, void* ws, void* ws_db, int batch, int height, int width,
    int num_feats, int num_joints, int depth, int chunks_per_image,
    void* stream) {
  const cudaError_t err = hipe::head_projection_bwd_mma(
      static_cast<const __nv_bfloat16*>(feats),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<const float*>(m), static_cast<const float*>(t),
      static_cast<const float*>(a), static_cast<const float*>(bc),
      static_cast<__nv_bfloat16*>(dfeat), static_cast<float*>(ws),
      static_cast<float*>(ws_db), batch, height, width, num_feats,
      num_joints, depth, chunks_per_image, static_cast<cudaStream_t>(stream));
  return reduce_after(err, ws, ws_db, dweight, dbias, batch, num_feats,
                      num_joints, depth, chunks_per_image, stream);
}

extern "C" int hipe_head_projection_integral_bwd_f32(
    const void* feats, const void* weight, const void* bias, const void* m,
    const void* t, const void* a, const void* bc, void* dfeat, void* dweight,
    void* dbias, void* ws, void* ws_db, void* planes, int batch, int height,
    int width, int num_feats, int num_joints, int depth,
    int chunks_per_image, void* stream) {
  const cudaError_t err = hipe::head_projection_bwd_mma_f32(
      static_cast<const float*>(feats), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<const float*>(m),
      static_cast<const float*>(t), static_cast<const float*>(a),
      static_cast<const float*>(bc), static_cast<float*>(dfeat),
      static_cast<float*>(ws), static_cast<float*>(ws_db), planes, batch,
      height, width, num_feats, num_joints, depth, chunks_per_image,
      static_cast<cudaStream_t>(stream));
  return reduce_after(err, ws, ws_db, dweight, dbias, batch, num_feats,
                      num_joints, depth, chunks_per_image, stream);
}
