// Fused 1x1 heatmap projection + soft-argmax forward for bf16 features, on
// the tensor cores: the heatmap never reaches device memory.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _fwd_kernel (driver _forward_pallas), for bf16 features; float32 features
// keep the CUDA-core kernel of head_projection_integral.cu, whose C entry
// point dispatches here.
//
// The product is a GEMM, M = J*D channels, N = positions, K = F, with an
// online-softmax epilogue; the heatmap stays in registers. It runs as
// bf16 x 3 on the tensor cores (wgmma, float32 accumulation): each CTA
// splits its block of the float32 weight into three bf16 planes while it
// stages them in shared memory (bf16x3_mma.cuh), and the bf16 features,
// exact in bf16, multiply each plane, x = hi . f + mid . f + lo . f, which
// is the float32 product.
//
// Grid: (image, position chunk, block of 64 channels), channel block
// fastest, so the channel blocks of one image chunk run together and read
// its features while they sit in L2. Each CTA stages its weight planes
// once (96 KB at F = 256); its three warpgroups take turns on the chunk's
// tiles of 64 positions, each tile in the warpgroup's own buffer, copied
// with cp.async while that warpgroup folds its previous logits and the
// others multiply. A warpgroup's 64 x 64 logits hold two channels by 16
// positions per thread; each thread folds them into one online state per
// channel (max, sum e, sum e col, sum e row). At the end the CTA merges
// its lanes' and warpgroups' states in order and writes one partial state
// per (image, chunk, channel). A second launch merges the chunks of each
// channel in chunk order, then the channels of each joint
// (chunk_merge.cuh `merge_chunks_kernel`, shared with kernel 1): coords,
// m and s. Every sum is taken in a fixed order.
//
// Bound: the products, 3 x 2 x B*H*W x F x J*D flops (181 GFLOP at B = 32)
// at the bf16 tensor-core rate; the features (51 MB at B = 32) are read
// from device memory once and from L2 once per channel block (19 times,
// 0.98 GB at B = 32), and those L2 reads, more than the products, are what
// holds it back. Filling the card: one CTA per SM (200 KB of shared
// memory); the wrapper chooses the chunks per image so the grid's waves
// over the SMs come out nearly whole, e.g. 608 CTAs (19 channel blocks x
// 32 images, one chunk) at B = 32 and 380 (19 x 4 images x 5 chunks of 10
// tiles) at B = 4 on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16x3_mma.cuh"
#include "chunk_merge.cuh"
#include "online_softmax.cuh"

namespace hipe {

using namespace mma;

namespace {

constexpr int kGroups = 3;  // warpgroups taking turns on the tiles

// online_softmax.cuh's fold without the depth sum: the depth slot is the
// same for every logit of a channel, so the merge forms it from s
template <int N>
__device__ __forceinline__ void fold_xy(OnlineState& st, const float (&v)[N],
                                        const float (&x)[N],
                                        const float (&y)[N]) {
  float lm = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < N; ++i) lm = fmaxf(lm, v[i]);
  if (lm == -CUDART_INF_F) return;
  if (lm > st.m) {
    const float c = __expf(st.m - lm);
    st.s *= c;
    st.sx *= c;
    st.sy *= c;
    st.m = lm;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = __expf(v[i] - st.m);
    st.s += e;
    st.sx += e * x[i];
    st.sy += e * y[i];
  }
}

__global__ void __launch_bounds__(kGroups * kGroupThreads, 1)
    hp_fwd_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias, int hw_total, int width,
                      int num_feats, int kpad, int channels, int blocks,
                      int chunks, int tiles_per_chunk,
                      float4* __restrict__ ws) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // 3 planes
  __nv_bfloat16* f_s = w_s + 3 * kBlockC * kpad;  // a tile per warpgroup
  OnlineState* st_s =
      reinterpret_cast<OnlineState*>(f_s + kGroups * kTileP * kpad);

  const int cb = blockIdx.x % blocks;
  const int rest = blockIdx.x / blocks;
  const int q = rest % chunks;
  const int b = rest / chunks;
  const int c0 = cb * kBlockC;
  const int tiles = (hw_total + kTileP - 1) / kTileP;
  const int t0 = q * tiles_per_chunk;
  const int t1 = min(tiles, t0 + tiles_per_chunk);
  const __nv_bfloat16* image = feats + (long long)b * hw_total * num_feats;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the warpgroup, provably the same across a warp (a shuffle from lane
  // 0), so the loop around the products is not divergent and ptxas keeps
  // the wgmma pipeline
  const int group = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;  // the warp's 16 channels in the 64 x 64 product
  const int gtid = threadIdx.x - group * kGroupThreads;
  __nv_bfloat16* tile = f_s + group * kTileP * kpad;
  const uint32_t w_addr = smem_addr(w_s);
  const uint32_t f_addr = smem_addr(tile);
  const uint32_t plane_bytes = kBlockC * kpad * 2;

  // the weight block goes through the feature buffers, not yet in use
  stage_weight(weight, channels, num_feats, kpad, c0,
               reinterpret_cast<float*>(f_s), w_s);
  zero_pad(f_s, kGroups * kTileP, num_feats, kpad);
  // this thread's channels c0 + wq * 16 + lane / 4 + 8 k
  float bias_r[2];
  OnlineState st[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = c0 + wq * 16 + (lane >> 2) + 8 * k;
    bias_r[k] = c < channels ? bias[c] : 0.f;
    st[k] = empty_state();
  }
  fence_async_smem();
  __syncthreads();  // zero padding in place

  // Warpgroup g takes tiles t0 + g, t0 + g + 3, ... into its own buffer and
  // prefetches its next tile while it folds the current one's logits: while
  // one warpgroup waits or folds, another multiplies.
  if (t0 + group < t1)
    stage_features(image, (t0 + group) * kTileP, hw_total, num_feats, kpad,
                   tile, gtid, kGroupThreads);
  for (int t = t0 + group; t < t1; t += kGroups) {
    const int hw0 = t * kTileP;
    cp_async_wait<0>();
    fence_async_smem();
    group_sync(group);
    // logits^T (64 channels x 64 positions) = (W_hi + W_mid + W_lo) f^T
    float acc[32];
    logits(acc, w_addr, plane_bytes, f_addr, 0, kpad);
    group_sync(group);  // the products have read the buffer
    if (t + kGroups < t1)
      stage_features(image, hw0 + kGroups * kTileP, hw_total, num_feats,
                     kpad, tile, gtid, kGroupThreads);

    // positions hw0 + 8 i + 2 (lane % 4) + e of this thread's two
    // channels; row and column stepped along without a division each
    float v[2][16], x[16], y[16];
    int hw = hw0 + 2 * (lane & 3);
    int row = hw / width, col = hw - row * width;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * i + e;
        const bool wrap = col + e >= width;
        x[j] = float(wrap ? col + e - width : col + e);
        y[j] = float(wrap ? row + 1 : row);
#pragma unroll
        for (int k = 0; k < 2; ++k)
          v[k][j] = hw + e < hw_total ? acc[4 * i + 2 * k + e] + bias_r[k]
                                      : -CUDART_INF_F;
      }
      hw += 8;
      for (col += 8; col >= width; col -= width) ++row;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) fold_xy(st[k], v[k], x, y);
  }

  // the four lanes of a row group (lane / 4) hold the same channels: merge
  // them, then the warpgroups in order
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      st[k] = merge(st[k], shfl_xor(st[k], off));
    if ((lane & 3) == 0)
      st_s[group * kBlockC + wq * 16 + (lane >> 2) + 8 * k] = st[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlockC; i += blockDim.x) {
    const int c = c0 + i;
    if (c >= channels) continue;
    OnlineState s = st_s[i];
    for (int k = 1; k < kGroups; ++k) s = merge(s, st_s[k * kBlockC + i]);
    ws[((long long)b * chunks + q) * channels + c] =
        make_float4(s.m, s.s, s.sx, s.sy);
  }
}

}  // namespace

// Both launches; ws holds batch * chunks * J*D float4 partial states.
cudaError_t head_projection_fwd_mma(const __nv_bfloat16* feats,
                                    const float* weight, const float* bias,
                                    float* coords, float* m, float* s,
                                    float* ws, int batch, int height,
                                    int width, int num_feats, int num_joints,
                                    int depth, int chunks,
                                    cudaStream_t stream) {
  const int hw_total = height * width;
  const int channels = num_joints * depth;
  const int kpad = (num_feats + 63) / 64 * 64;
  const int blocks = (channels + kBlockC - 1) / kBlockC;
  const int tiles = (hw_total + kTileP - 1) / kTileP;
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const size_t smem =
      (size_t)(3 * kBlockC + kGroups * kTileP) * kpad * sizeof(__nv_bfloat16) +
      kGroups * kBlockC * sizeof(OnlineState);
  cudaError_t err = cudaFuncSetAttribute(
      hp_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  float4* ws4 = reinterpret_cast<float4*>(ws);
  hp_fwd_mma_kernel<<<batch * chunks * blocks, kGroups * kGroupThreads, smem,
                      stream>>>(
      feats, weight, bias, hw_total, width, num_feats, kpad, channels, blocks,
      chunks, per_chunk, ws4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_chunks_kernel<<<batch * num_joints, kMergeThreads, 0, stream>>>(
      ws4, chunks, num_joints, height, width, depth, coords, m, s);
  return cudaGetLastError();
}

}  // namespace hipe
