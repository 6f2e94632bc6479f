// Fused 1x1 heatmap projection + soft-argmax backward for bf16 features,
// on the tensor cores: the heatmap and its gradient never reach device
// memory.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _bwd_kernel (launched by _hp_bwd), for bf16 features; float32 features
// keep the CUDA-core kernels of head_projection_integral_bwd.cu, whose C
// entry point dispatches here and runs the shared fixed-order sum (c).
//
// Per tile of 64 positions and block of 64 channels it recomputes the
// logits x = f . W^T + b, forms the soft-argmax cotangent
//   g[hw, c] = exp(x - m_c) * (T_c + A_c * col + B_c * row)
// in registers and contracts it at once. Every product is bf16 x bf16 on
// the tensor cores with float32 accumulation (wgmma, one warpgroup per 64
// rows), each float32 operand split into bf16 parts (bf16x3_mma.cuh):
//   logits  x     = f . W_hi + f . W_mid + f . W_lo        (f exact in bf16)
//   dfeat  += g_hi . W_hi + g_hi . W_mid + g_lo . W_hi     (two-part g, W)
//   dW     += g_hi^T f + g_mid^T f + g_lo^T f              (three-part g)
// and db sums the float32 g. The weight is split while it is staged in
// shared memory; g is split in registers, where the logits' accumulator
// already has the layout of the next product's register operand, so it
// never passes through shared memory. Two launches, then the sum (c):
//
//   (a) dfeat: one CTA per two tiles of 64 positions, a warpgroup each.
//       It stages its features once, then for each channel block splits
//       the block's weight rows (fetched with cp.async during the previous
//       block's products) into planes, forms the logits and g, and adds
//       g . W into a 64 x F float32 accumulator per warpgroup.
//   (b) dW, db partials: one CTA per (channel block, image, chunk of the
//       image's tiles). It stages the block's weight planes once; two
//       warpgroups take alternate tiles (each its own feature buffer,
//       loaded with cp.async while the other multiplies), form the logits
//       and g and add g^T f into their own 64 x F accumulators, which are
//       added in warpgroup order at the end and written to the workspace.
//   (c) head_projection_integral_bwd.cu adds the chunks' partials in chunk
//       order.
// No float atomics: the result is the same bits from run to run.
//
// Bound: the products. (a) and (b) each recompute the logits: 6 products
// of 2 x B*H*W x F x J*D flops each (725 GFLOP of bf16 tensor-core work at
// B = 32), against the 3 products (one recompute) of the recorded bound.
// What holds it back: in (a) the split of each of the 19 weight blocks,
// which no product overlaps; in (b) the L2 reads of the features, once per
// channel block. Filling the card, one CTA per SM (227 KB and 161 KB of
// shared memory at F = 256): (a) has B x 49 / 2 CTAs, 784 at B = 32 (5.9
// waves on 132 SMs) and 98 at B = 4; (b) has 19 channel blocks x B x
// chunks CTAs, the chunks chosen by the wrapper so the waves come out
// nearly whole (608 at B = 32, one chunk per image). F is padded to a
// multiple of 64 in shared memory, the N of the products that run along F.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16x3_mma.cuh"

namespace hipe {

using namespace mma;

namespace {

constexpr int kGroups = 2;
constexpr int kMaxBlocksF = 4;      // F <= 4 x 64

// The cotangent at logit x given the channel's bias, m, T, A and B.
__device__ __forceinline__ float cotangent(float x, const float (&c)[5],
                                           float col, float row) {
  return __expf(x + c[0] - c[1]) * (c[2] + c[3] * col + c[4] * row);
}

// The register operands of a product over the 64 columns of accumulator
// x (columns 8 i + 2 (lane % 4) + e), 16 at a time: a[s][p] is part p of
// the kParts-part split of columns 16 s .. 16 s + 15.
template <int kParts>
__device__ __forceinline__ void split_fragments(
    const float (&x)[32], uint32_t (&a)[4][kParts][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      __nv_bfloat16 p0[3], p1[3];
      if constexpr (kParts == 3) {
        split3(x[8 * s + 2 * r], p0[0], p0[1], p0[2]);
        split3(x[8 * s + 2 * r + 1], p1[0], p1[1], p1[2]);
      } else {
        split2(x[8 * s + 2 * r], p0[0], p0[1]);
        split2(x[8 * s + 2 * r + 1], p1[0], p1[1]);
      }
#pragma unroll
      for (int p = 0; p < kParts; ++p) a[s][p][r] = pack(p0[p], p1[p]);
    }
}

// (a) dfeat. The CTA's two warpgroups take 64-position tiles 2 x + g of
// the batch's tiles, numbered image by image. For each channel block the
// CTA splits the weight rows fetched during the previous block's products,
// then fetches the next block's. A warpgroup's logits are positions x
// channels: thread (warp w, lane l) holds positions 16 w + l / 4 + 8 k and
// channels 8 i + 2 (l % 4) + e.
__global__ void __launch_bounds__(kGroups * kGroupThreads, 1)
    hp_bwd_dfeat_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                            const float* __restrict__ weight,
                            const float* __restrict__ bias,
                            const float* __restrict__ mvec,
                            const float* __restrict__ tvec,
                            const float* __restrict__ avec,
                            const float* __restrict__ bvec,
                            __nv_bfloat16* __restrict__ dfeat, int hw_total,
                            int width, int num_feats, int kpad, int channels,
                            int blocks, int tiles, int all_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // 3 planes
  __nv_bfloat16* f_s = w_s + 3 * kBlockC * kpad;  // a tile per warpgroup
  float* raw = reinterpret_cast<float*>(f_s + kGroups * kTileP * kpad);
  float* v_s = raw + kBlockC * kpad;  // [kGroups][kBlockC][5]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;
  const int gtid = threadIdx.x - group * kGroupThreads;
  const int tile = blockIdx.x * kGroups + group;
  const bool active = tile < all_tiles;
  const int b = active ? tile / tiles : 0;
  const int hw0 = (tile - b * tiles) * kTileP;
  const long long image = (long long)b * hw_total * num_feats;
  const uint32_t w_addr = smem_addr(w_s);
  const uint32_t f_addr = smem_addr(f_s + group * kTileP * kpad);
  const uint32_t plane_bytes = kBlockC * kpad * 2;
  const int nblocks_f = kpad / 64;
  float* v_g = v_s + group * kBlockC * 5;

  if (active)
    stage_features(feats + image, hw0, hw_total, num_feats, kpad,
                   f_s + group * kTileP * kpad, gtid, kGroupThreads);
  fetch_weight(weight, channels, num_feats, kpad, 0, raw);
  cp_async_commit();
  zero_pad(f_s, kGroups * kTileP, num_feats, kpad);

  // the constants of block cb for this warpgroup's image: bias, m, T, A, B
  // of channel c0 + gtid, fetched a block ahead by threads gtid < 64
  float cv[5];
  auto fetch_constants = [&](int c0) {
    const int c = c0 + gtid;
    const bool valid = gtid < kBlockC && c < channels;
    const long long bc = (long long)b * channels + c;
    cv[0] = valid ? bias[c] : 0.f;
    cv[1] = valid ? mvec[bc] : 0.f;
    cv[2] = valid ? tvec[bc] : 0.f;
    cv[3] = valid ? avec[bc] : 0.f;
    cv[4] = valid ? bvec[bc] : 0.f;
  };
  fetch_constants(0);

  // this thread's two positions
  bool ok[2];
  float col[2], row[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int hw = hw0 + wq * 16 + (lane >> 2) + 8 * k;
    const int r = hw / width;
    ok[k] = active && hw < hw_total;
    row[k] = float(r);
    col[k] = float(hw - r * width);
  }

  float acc[kMaxBlocksF][32];
#pragma unroll
  for (int n = 0; n < kMaxBlocksF; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

  for (int cb = 0; cb < blocks; ++cb) {
    const int c0 = cb * kBlockC;
    cp_async_wait<0>();
    __syncthreads();  // the block's rows have landed; the planes are free
    split_weight(raw, num_feats, kpad, w_s);
    if (gtid < kBlockC)
#pragma unroll
      for (int i = 0; i < 5; ++i) v_g[5 * gtid + i] = cv[i];
    fence_async_smem();
    __syncthreads();
    if (cb + 1 < blocks) {  // the next block's rows, during the products
      fetch_weight(weight, channels, num_feats, kpad, c0 + kBlockC, raw);
      cp_async_commit();
      fetch_constants(c0 + kBlockC);
    }
    if (!active) continue;

    float x[32];
    logits(x, f_addr, 0, w_addr, plane_bytes, kpad);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = 8 * i + 2 * (lane & 3) + e;
        const float c[5] = {v_g[5 * ch], v_g[5 * ch + 1], v_g[5 * ch + 2],
                            v_g[5 * ch + 3], v_g[5 * ch + 4]};
        const bool valid = c0 + ch < channels;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float& v = x[4 * i + 2 * k + e];
          v = ok[k] && valid ? cotangent(v, c, col[k], row[k]) : 0.f;
        }
      }
    // dfeat += g_hi W_hi + g_hi W_mid + g_lo W_hi over the block's 64
    // channels (K) in steps of 16; W's planes read MN-major (N = F)
    uint32_t a[4][2][4];
    split_fragments<2>(x, a);
#pragma unroll
    for (int n = 0; n < kMaxBlocksF; ++n) fence_operands(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int n = 0; n < kMaxBlocksF; ++n) {
        if (n >= nblocks_f) break;
        const uint32_t hi = w_addr + s * 2 * kpad * 16 + n * 1024;
        wgmma_64x64x16_rs(acc[n], a[s][0], core_desc_mn(hi, kpad));
        wgmma_64x64x16_rs(acc[n], a[s][0],
                          core_desc_mn(hi + plane_bytes, kpad));
        wgmma_64x64x16_rs(acc[n], a[s][1], core_desc_mn(hi, kpad));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kMaxBlocksF; ++n) fence_operands(acc[n]);
  }

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!ok[k]) continue;
    __nv_bfloat16* dst =
        dfeat + image +
        (long long)(hw0 + wq * 16 + (lane >> 2) + 8 * k) * num_feats;
#pragma unroll
    for (int n = 0; n < kMaxBlocksF; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = n * 64 + 8 * i + 2 * (lane & 3);
        if (f < num_feats)
          *reinterpret_cast<__nv_bfloat162*>(dst + f) = __floats2bfloat162_rn(
              acc[n][4 * i + 2 * k], acc[n][4 * i + 2 * k + 1]);
      }
  }
}

// (b) partial dW and db of channel block blockIdx.x over chunk q of image
// b's tiles. The logits are channels x positions: thread (warp w, lane l)
// holds channels 16 w + l / 4 + 8 k and positions 8 i + 2 (l % 4) + e, and
// its dW accumulator holds the same channels by features
// 64 n + 8 i + 2 (l % 4) + e.
__global__ void __launch_bounds__(kGroups * kGroupThreads, 1)
    hp_bwd_dweight_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                              const float* __restrict__ weight,
                              const float* __restrict__ bias,
                              const float* __restrict__ mvec,
                              const float* __restrict__ tvec,
                              const float* __restrict__ avec,
                              const float* __restrict__ bvec,
                              float* __restrict__ ws,
                              float* __restrict__ ws_db, int hw_total,
                              int width, int num_feats, int kpad,
                              int channels, int chunks, int tiles_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // 3 planes
  __nv_bfloat16* f_s = w_s + 3 * kBlockC * kpad;  // a tile per warpgroup
  float* db_s = reinterpret_cast<float*>(f_s + kGroups * kTileP * kpad);

  const int c0 = blockIdx.x * kBlockC;
  const int b = blockIdx.y / chunks;
  const int q = blockIdx.y - b * chunks;
  const int tiles = (hw_total + kTileP - 1) / kTileP;
  const int t0 = q * tiles_per_chunk;
  const int t1 = min(tiles, t0 + tiles_per_chunk);
  const __nv_bfloat16* image = feats + (long long)b * hw_total * num_feats;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;
  const int gtid = threadIdx.x - group * kGroupThreads;
  __nv_bfloat16* tile = f_s + group * kTileP * kpad;
  const uint32_t w_addr = smem_addr(w_s);
  const uint32_t f_addr = smem_addr(tile);
  const uint32_t plane_bytes = kBlockC * kpad * 2;
  const int nblocks_f = kpad / 64;

  // the weight block goes through the feature buffers, not yet in use
  stage_weight(weight, channels, num_feats, kpad, c0,
               reinterpret_cast<float*>(f_s), w_s);
  zero_pad(f_s, kGroups * kTileP, num_feats, kpad);
  // this thread's two channels' bias, m, T, A, B
  float cst[2][5];
  bool valid[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = c0 + wq * 16 + (lane >> 2) + 8 * k;
    const long long bc = (long long)b * channels + c;
    valid[k] = c < channels;
    cst[k][0] = valid[k] ? bias[c] : 0.f;
    cst[k][1] = valid[k] ? mvec[bc] : 0.f;
    cst[k][2] = valid[k] ? tvec[bc] : 0.f;
    cst[k][3] = valid[k] ? avec[bc] : 0.f;
    cst[k][4] = valid[k] ? bvec[bc] : 0.f;
  }
  fence_async_smem();
  __syncthreads();  // zero padding in place

  float acc[kMaxBlocksF][32];
#pragma unroll
  for (int n = 0; n < kMaxBlocksF; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  float db[2] = {0.f, 0.f};

  if (t0 + group < t1)
    stage_features(image, (t0 + group) * kTileP, hw_total, num_feats, kpad,
                   tile, gtid, kGroupThreads);
  for (int t = t0 + group; t < t1; t += kGroups) {
    const int hw0 = t * kTileP;
    cp_async_wait<0>();
    fence_async_smem();
    group_sync(group);
    float x[32];
    logits(x, w_addr, plane_bytes, f_addr, 0, kpad);

    // g at positions hw0 + 8 i + 2 (lane % 4) + e, row and column stepped
    // along without a division each
    int hw = hw0 + 2 * (lane & 3);
    int r = hw / width, cl = hw - r * width;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool wrap = cl + e >= width;
        const float colf = float(wrap ? cl + e - width : cl + e);
        const float rowf = float(wrap ? r + 1 : r);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float& v = x[4 * i + 2 * k + e];
          v = hw + e < hw_total && valid[k]
                  ? cotangent(v, cst[k], colf, rowf)
                  : 0.f;
          db[k] += v;
        }
      }
      hw += 8;
      for (cl += 8; cl >= width; cl -= width) ++r;
    }
    // dW += g_hi^T f + g_mid^T f + g_lo^T f over the tile's 64 positions
    // (K) in steps of 16; the features read MN-major (N = F)
    uint32_t a[4][3][4];
    split_fragments<3>(x, a);
#pragma unroll
    for (int n = 0; n < kMaxBlocksF; ++n) fence_operands(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int n = 0; n < kMaxBlocksF; ++n) {
        if (n >= nblocks_f) break;
        const uint64_t fd =
            core_desc_mn(f_addr + s * 2 * kpad * 16 + n * 1024, kpad);
#pragma unroll
        for (int p = 0; p < 3; ++p) wgmma_64x64x16_rs(acc[n], a[s][p], fd);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kMaxBlocksF; ++n) fence_operands(acc[n]);
    group_sync(group);  // the products have read the buffer
    if (t + kGroups < t1)
      stage_features(image, hw0 + kGroups * kTileP, hw_total, num_feats,
                     kpad, tile, gtid, kGroupThreads);
  }

  // db: the four lanes of a row group (lane / 4) share its channels
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      db[k] += __shfl_xor_sync(0xffffffffu, db[k], off);
    if ((lane & 3) == 0)
      db_s[group * kBlockC + wq * 16 + (lane >> 2) + 8 * k] = db[k];
  }
  // warpgroup 1's dW partial goes through shared memory (the weight
  // planes' place, 64 x F floats) and warpgroup 0 adds it to its own
  __syncthreads();
  float* other = reinterpret_cast<float*>(w_s);
  const long long part = (long long)b * chunks + q;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if ((pass == 0) == (group == 1)) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int rr = wq * 16 + (lane >> 2) + 8 * k;
#pragma unroll
        for (int n = 0; n < kMaxBlocksF; ++n)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int f = n * 64 + 8 * i + 2 * (lane & 3);
            if (f >= num_feats) continue;
            float2 v = make_float2(acc[n][4 * i + 2 * k],
                                   acc[n][4 * i + 2 * k + 1]);
            float2* o = reinterpret_cast<float2*>(other + rr * num_feats + f);
            if (group == 1) {
              *o = v;
            } else if (valid[k]) {
              const float2 u = *o;
              v.x += u.x;
              v.y += u.y;
              *reinterpret_cast<float2*>(
                  ws + (part * channels + c0 + rr) * num_feats + f) = v;
            }
          }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kBlockC; i += blockDim.x)
    if (c0 + i < channels)
      ws_db[part * channels + c0 + i] = db_s[i] + db_s[kBlockC + i];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Launches (a) and (b); the caller runs (c). ws holds batch * chunks
// partial (J*D, F) blocks, ws_db batch * chunks partial (J*D,) rows.
cudaError_t head_projection_bwd_mma(
    const __nv_bfloat16* feats, const float* weight, const float* bias,
    const float* m, const float* t, const float* a, const float* bc,
    __nv_bfloat16* dfeat, float* ws, float* ws_db, int batch, int height,
    int width, int num_feats, int num_joints, int depth, int chunks,
    cudaStream_t stream) {
  const int hw_total = height * width;
  const int channels = num_joints * depth;
  const int kpad = (num_feats + 63) / 64 * 64;
  const int blocks = (channels + kBlockC - 1) / kBlockC;
  const int tiles = (hw_total + kTileP - 1) / kTileP;
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const size_t planes =
      (size_t)(3 * kBlockC + kGroups * kTileP) * kpad * sizeof(__nv_bfloat16);

  const size_t smem_a = planes + (size_t)kBlockC * kpad * sizeof(float) +
                        kGroups * 5 * kBlockC * sizeof(float);
  cudaError_t err = allow_smem(hp_bwd_dfeat_mma_kernel, smem_a);
  if (err != cudaSuccess) return err;
  const int all_tiles = batch * tiles;
  hp_bwd_dfeat_mma_kernel<<<(all_tiles + kGroups - 1) / kGroups,
                            kGroups * kGroupThreads, smem_a, stream>>>(
      feats, weight, bias, m, t, a, bc, dfeat, hw_total, width, num_feats,
      kpad, channels, blocks, tiles, all_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_b = planes + kGroups * kBlockC * sizeof(float);
  err = allow_smem(hp_bwd_dweight_mma_kernel, smem_b);
  if (err != cudaSuccess) return err;
  hp_bwd_dweight_mma_kernel<<<dim3(blocks, batch * chunks),
                              kGroups * kGroupThreads, smem_b, stream>>>(
      feats, weight, bias, m, t, a, bc, ws, ws_db, hw_total, width, num_feats,
      kpad, channels, chunks, per_chunk);
  return cudaGetLastError();
}

}  // namespace hipe
