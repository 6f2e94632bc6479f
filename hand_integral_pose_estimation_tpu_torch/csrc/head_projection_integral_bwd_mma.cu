// Fused 1x1 heatmap projection + soft-argmax backward on the tensor cores,
// for bf16 and for float32 features: the heatmap and its gradient never
// reach device memory.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _bwd_kernel (launched by _hp_bwd). The C entry points of
// head_projection_integral_bwd.cu dispatch here and run the shared
// fixed-order sum (c). The float32-feature route comes after the bf16 one,
// below "---- float32 features", with its own header.
//
// bf16 features:
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

#include <type_traits>

#include "bf16x3_mma.cuh"
#include "f32_planes.cuh"
#include "k_slices.cuh"

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

// The register operands of a product over the 8 kSteps columns of
// accumulator x (columns 8 i + 2 (lane % 4) + e), 16 at a time: a[s][p] is
// part p of the kParts-part split of columns 16 s .. 16 s + 15.
template <int kSteps, int kParts>
__device__ __forceinline__ void split_fragments(
    const float (&x)[8 * kSteps], uint32_t (&a)[kSteps][kParts][4]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
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
    split_fragments<4, 2>(x, a);
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

  with_parity(num_feats, [&](auto even) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!ok[k]) continue;
      __nv_bfloat16* dst =
          dfeat + image +
          (long long)(hw0 + wq * 16 + (lane >> 2) + 8 * k) * num_feats;
#pragma unroll
      for (int n = 0; n < kMaxBlocksF; ++n)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          store_pair<decltype(even)::value>(
              dst, n * 64 + 8 * i + 2 * (lane & 3), num_feats,
              acc[n][4 * i + 2 * k], acc[n][4 * i + 2 * k + 1]);
    }
  });
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
    split_fragments<4, 3>(x, a);
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
  // planes' place, 64 x kpad floats) and warpgroup 0 adds it to its own
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
            if (f >= kpad) continue;
            float2 v = make_float2(acc[n][4 * i + 2 * k],
                                   acc[n][4 * i + 2 * k + 1]);
            float2* o = reinterpret_cast<float2*>(other + rr * kpad + f);
            if (group == 1) {
              *o = v;
            } else if (valid[k]) {
              const float2 u = *o;
              *reinterpret_cast<float2*>(
                  ws + (part * channels + c0 + rr) * kpad + f) =
                  make_float2(v.x + u.x, v.y + u.y);
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

// ---- float32 features
//
// The same three launches with both operands float32, split into three
// bf16 parts each (6 products a pair of operands, the pairs down to 2^-16,
// against 3 with bf16 features). 3xTF32 (wgmma .tf32, 2 x 3 TF32 products)
// was the alternative at the same rate, but TF32 operands in shared memory
// must be K-major, which dW's f (K = positions, N = F) is not without a
// transposed copy; bf16 parts take either major order.
//
// The budget is shared memory. Three bf16 planes of a 64 x 256 float32
// feature tile (96 KB) do not fit beside the weight's planes (96 KB) and a
// staging buffer, and a split in registers or shared memory next to the
// products leaves them waiting on ALU work, each feature tile re-split
// once per channel block. So (s) (f32_planes.cuh, shared with the
// forward) splits the features and the weight once into a workspace of
// bf16 planes, 32-row tiles laid out as the kernels stage them
// (contiguous copies, no ALU work), and then:
//   (a) dfeat: one CTA per 64-position tile (both planes of it, 96 KB)
//       with the block's weight planes (96 KB): 193 KB. Its two warpgroups
//       take the halves of each 64-channel block (N = 32 logits), each
//       copying its own weight half and walking the blocks on its own
//       barrier, so that one copies under the other's products.
//   (b) dW: one warpgroup per (channel block, image, chunk) with the
//       block's weight planes and two buffers of a 32-position tile's
//       planes (48 KB each): 192 KB, the next tile's copy under this
//       one's products.
// ptxas serialises every product group that a runtime branch splits or
// that stays open across a loop's back edge or while ordinary
// instructions define its accumulator (C7514, C7515, C7520 under -Xptxas
// -v): F is a template argument (kBF), and every group is waited inside
// its own iteration.
//
// Accuracy: every output passes through g, so through the logits. A wgmma
// adds its products to its accumulator with an error of about 2^-23 of
// the accumulator, and six pairs into one accumulator made six such errors
// a k-step: on an H100 dfeat, dW and db then took 0.17-0.31 of the check's
// tolerance against the plain float32 version, about twice the bf16
// route's share (three pairs) and four times the plain version's own
// distance from float64. The logits therefore keep the (hi, hi) pair in
// one accumulator and the five smaller pairs in another, 2^-8 its size,
// added once the products are done; that brought the three to 0.04-0.10,
// as close to float64 as the plain version
// (scripts/fused_head_f32_accuracy.py).
//
// Bound: the products. (a) and (b) recompute the logits: 6 + 3 products in
// (a), 6 + 6 in (b), of 2 x B*H*W x F x 32 or 64 channels each (1.27
// TFLOP of bf16 tensor-core work at B = 32, 21 x 56 channels), against
// the 3 float32 products of the recorded bound (989/6 TFLOP/s). What holds
// it back: the logits' N = 32 products, the narrowest of the port.

// x, xs (64 positions x 32 channels) += f . W^T over k-step k0 .. k0 + 15:
// the (hi, hi) pair into x, the five smaller pairs into xs (see Accuracy
// above); f's three parts in registers, W's three planes (K-major, 32
// rows at w_addr).
__device__ __forceinline__ void f32_logit_products(float (&x)[16],
                                                   float (&xs)[16],
                                                   const uint32_t (&f)[3][4],
                                                   uint32_t w_addr,
                                                   uint32_t plane_bytes,
                                                   int k0, int kpad) {
  wgmma_fence();
  wgmma_64x32x16_rs(x, f[0], core_desc(w_addr + k0 * 16, kpad));
#pragma unroll
  for (int q = 1; q < kPairs; ++q)
    wgmma_64x32x16_rs(xs, f[pair_first(q)],
                      core_desc(w_addr + pair_second(q) * plane_bytes +
                                    k0 * 16,
                                kpad));
  wgmma_commit();
}

// (a) dfeat with float32 features. One CTA per tile of 64 positions (two
// tiles of (s)), staged once; for each channel block its two warpgroups
// take the block's halves (32 channels, one tile of (s) each), each
// staging its own half and walking the blocks on its own barrier, so that
// one warpgroup's staging runs under the other's products. A warpgroup's
// logits are positions x channels: thread (warp w, lane l) holds positions
// 16 w + l / 4 + 8 k and channels 32 group + 8 i + 2 (l % 4) + e (i < 4).
// The feature planes are its products' register operand (ldmatrix, a
// k-step ahead of the tensor cores). Each warpgroup adds g . W over its
// 32 channels into its own 64 x F float32 accumulator; the two are added
// in warpgroup order at the end. kBF: F padded to kBF x 64 (kpad), a
// template argument so that no product sits under a runtime branch
// (ptxas serialises wgmma there).
template <int kBF>
__global__ void __launch_bounds__(kGroups * kGroupThreads, 1)
    hp_bwd_dfeat_f32_kernel(const __nv_bfloat16* __restrict__ fplanes,
                            const __nv_bfloat16* __restrict__ wplanes,
                            const float* __restrict__ bias,
                            const float* __restrict__ mvec,
                            const float* __restrict__ tvec,
                            const float* __restrict__ avec,
                            const float* __restrict__ bvec,
                            float* __restrict__ dfeat, int hw_total,
                            int width, int num_feats, int channels,
                            int blocks, int tiles) {
  constexpr int kpad = 64 * kBF;
  constexpr int steps = kpad / 16;
  constexpr int kHalf = kBlockC / kGroups;  // 32 channels a warpgroup
  constexpr int kTile32 = 3 * 32 * kpad;     // elements of a tile of (s)
  constexpr int kPlane32 = 32 * kpad * 2;    // bytes of one of its planes
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // 3 planes
  __nv_bfloat16* f_s = w_s + 3 * kBlockC * kpad;  // 3 planes of the tile
  float* v_s = reinterpret_cast<float*>(f_s + 3 * kTileP * kpad);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;
  const int gtid = threadIdx.x - group * kGroupThreads;
  const int b = blockIdx.x / tiles;
  const int t64 = blockIdx.x - b * tiles;
  const int hw0 = t64 * kTileP;
  const long long image = (long long)b * hw_total * num_feats;
  const uint32_t plane_bytes = kBlockC * kpad * 2;
  // this warpgroup's 32 weight rows and its constants
  const uint32_t w_addr = smem_addr(w_s) + group * kHalf * kpad * 2;
  const uint32_t f_addr = smem_addr(f_s);
  float* v_g = v_s + group * kHalf * 5;

  // the tile: (s)'s tiles 2 t64 and 2 t64 + 1 of image b, plane by plane
  // (a plane of 64 rows is the two tiles' planes one after the other)
  const __nv_bfloat16* ft =
      fplanes + ((long long)b * 2 * tiles + 2 * t64) * kTile32;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 3; ++p)
      copy_async(f_s + p * kTileP * kpad + h * 32 * kpad,
                 ft + h * kTile32 + p * 32 * kpad, kPlane32, threadIdx.x,
                 blockDim.x);
  cp_async_commit();

  bool ok[2];
  float col[2], row[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int hw = hw0 + wq * 16 + (lane >> 2) + 8 * k;
    const int r = hw / width;
    ok[k] = hw < hw_total;
    row[k] = float(r);
    col[k] = float(hw - r * width);
  }

  float acc[kBF][32];
#pragma unroll
  for (int n = 0; n < kBF; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

  for (int cb = 0; cb < blocks; ++cb) {
    const int c0 = cb * kBlockC + group * kHalf;  // this warpgroup's rows
    group_sync(group);  // its previous block's products have read them
    // its 32 weight rows: tile 2 cb + group of (s)'s weight tiles
    const __nv_bfloat16* wt =
        wplanes + ((long long)2 * cb + group) * kTile32;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      copy_async(w_s + p * kBlockC * kpad + group * kHalf * kpad,
                 wt + p * 32 * kpad, kPlane32, gtid, kGroupThreads);
    cp_async_commit();
    if (gtid < kHalf) {
      const int c = c0 + gtid;
      const bool valid = c < channels;
      const long long bc = (long long)b * channels + c;
      v_g[5 * gtid] = valid ? bias[c] : 0.f;
      v_g[5 * gtid + 1] = valid ? mvec[bc] : 0.f;
      v_g[5 * gtid + 2] = valid ? tvec[bc] : 0.f;
      v_g[5 * gtid + 3] = valid ? avec[bc] : 0.f;
      v_g[5 * gtid + 4] = valid ? bvec[bc] : 0.f;
    }
    cp_async_wait<0>();
    fence_async_smem();
    if (cb == 0)
      __syncthreads();  // the tile has landed, copied by both warpgroups
    else
      group_sync(group);

    // logits x = f . W^T over this warpgroup's 32 channels, the feature
    // planes read into the other register set a k-step ahead
    float x[16], xs[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = xs[i] = 0.f;
    uint32_t fa[3][4], fb[3][4];
    fence_operands(x);
    fence_operands(xs);
    plane_fragments(f_addr, plane_bytes, kpad, wq, lane, 0, fa);
#pragma unroll
    for (int s = 0; s < steps; s += 2) {  // steps is even
      f32_logit_products(x, xs, fa, w_addr, plane_bytes, 16 * s, kpad);
      wgmma_wait<1>();  // step s - 1's products have read fb
      plane_fragments(f_addr, plane_bytes, kpad, wq, lane, 16 * (s + 1), fb);
      f32_logit_products(x, xs, fb, w_addr, plane_bytes, 16 * (s + 1), kpad);
      wgmma_wait<1>();  // step s's products have read fa
      if (s + 2 < steps)
        plane_fragments(f_addr, plane_bytes, kpad, wq, lane, 16 * (s + 2),
                        fa);
    }
    wgmma_wait_all();
    fence_operands(x);
    fence_operands(xs);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] += xs[i];

#pragma unroll
    for (int i = 0; i < 4; ++i)
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
    // dfeat += g_hi W_hi + g_hi W_mid + g_lo W_hi over the warpgroup's 32
    // channels (K) in steps of 16; W's planes read MN-major (N = F)
    uint32_t a[2][2][4];
    split_fragments<2, 2>(x, a);
#pragma unroll
    for (int n = 0; n < kBF; ++n) fence_operands(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int n = 0; n < kBF; ++n) {
        const uint32_t hi = w_addr + s * 2 * kpad * 16 + n * 1024;
        wgmma_64x64x16_rs(acc[n], a[s][0], core_desc_mn(hi, kpad));
        wgmma_64x64x16_rs(acc[n], a[s][0],
                          core_desc_mn(hi + plane_bytes, kpad));
        wgmma_64x64x16_rs(acc[n], a[s][1], core_desc_mn(hi, kpad));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kBF; ++n) fence_operands(acc[n]);
  }

  // warpgroup 1's partial goes through the feature planes (64 x kpad
  // floats fit their 3 x 64 x kpad bf16) and warpgroup 0 adds it to its own
  __syncthreads();
  float* other = reinterpret_cast<float*>(f_s);
  with_parity(num_feats, [&](auto even) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      if ((pass == 0) == (group == 1)) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int rr = wq * 16 + (lane >> 2) + 8 * k;
          float* dst = dfeat + image + (long long)(hw0 + rr) * num_feats;
#pragma unroll
          for (int n = 0; n < kBF; ++n)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int f = n * 64 + 8 * i + 2 * (lane & 3);
              float2 v = make_float2(acc[n][4 * i + 2 * k],
                                     acc[n][4 * i + 2 * k + 1]);
              float2* o = reinterpret_cast<float2*>(other + rr * kpad + f);
              if (group == 1) {
                *o = v;
              } else if (ok[k]) {
                const float2 u = *o;
                store_pair<decltype(even)::value>(dst, f, num_feats,
                                                  v.x + u.x, v.y + u.y);
              }
            }
        }
      }
      __syncthreads();
    }
  });
}

// (b)'s logits (64 channels x 32 positions) of the tile of (s) at f_addr
// into x, the (hi, hi) pair's, and xs, the smaller pairs' (as in (a)), the
// first product of each writing it: no other instruction may define an
// accumulator while products run (ptxas would serialise them).
template <int kBF>
__device__ __forceinline__ void dw_logits(float (&x)[16], float (&xs)[16],
                                          uint32_t w_addr, uint32_t f_addr) {
  constexpr int kpad = 64 * kBF;
  constexpr uint32_t kWPlane = kBlockC * kpad * 2;
  constexpr uint32_t kFPlane = 32 * kpad * 2;
  wgmma_fence();
#pragma unroll
  for (int k0 = 0; k0 < kpad; k0 += 16) {
    wgmma_64x32x16(x, core_desc(w_addr + k0 * 16, kpad),
                   core_desc(f_addr + k0 * 16, kpad), k0 > 0);
#pragma unroll
    for (int q = 1; q < kPairs; ++q)
      wgmma_64x32x16(
          xs, core_desc(w_addr + pair_second(q) * kWPlane + k0 * 16, kpad),
          core_desc(f_addr + pair_first(q) * kFPlane + k0 * 16, kpad),
          k0 > 0 || q > 1);
  }
  wgmma_commit();
}

// (b) partial dW and db of channel block blockIdx.x over chunk q of image
// b's tiles of 32 positions, float32 features: one warpgroup. The block's
// weight planes are copied once; each tile's planes (a tile of (s)) are
// copied into one of two buffers while the other is in use. The logits
// are channels x positions (thread (warp w, lane l): channels 16 w + l / 4
// + 8 k, positions 8 i + 2 (l % 4) + e, i < 4), both operands in shared
// memory; g stays in registers as the dW product's operand. kBF as for
// (a). Every product is waited within its tile: a product group left
// running across the loop, under the next tile's copy and logits, made
// ptxas serialise them.
template <int kBF>
__global__ void __launch_bounds__(kGroupThreads, 1)
    hp_bwd_dweight_f32_kernel(const __nv_bfloat16* __restrict__ fplanes,
                              const __nv_bfloat16* __restrict__ wplanes,
                              const float* __restrict__ bias,
                              const float* __restrict__ mvec,
                              const float* __restrict__ tvec,
                              const float* __restrict__ avec,
                              const float* __restrict__ bvec,
                              float* __restrict__ ws,
                              float* __restrict__ ws_db, int hw_total,
                              int width, int num_feats, int channels,
                              int chunks, int tiles_per_chunk,
                              int image_tiles) {
  constexpr int kpad = 64 * kBF;
  constexpr int kRows = 32;  // positions per tile
  constexpr int kTile32 = 3 * kRows * kpad;
  constexpr int kPlane32 = kRows * kpad * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // 3 planes
  __nv_bfloat16* f_p = w_s + 3 * kBlockC * kpad;  // 2 tiles of (s)

  const int c0 = blockIdx.x * kBlockC;
  const int b = blockIdx.y / chunks;
  const int q = blockIdx.y - b * chunks;
  const int tiles = (hw_total + kRows - 1) / kRows;
  const int t0 = q * tiles_per_chunk;
  const int t1 = min(tiles, t0 + tiles_per_chunk);
  const __nv_bfloat16* image =
      fplanes + (long long)b * image_tiles * kTile32;
  const int lane = threadIdx.x & 31;
  const int wq = threadIdx.x >> 5;
  const uint32_t w_addr = smem_addr(w_s);

  // the block's weight rows: (s)'s weight tiles 2 blockIdx.x, + 1
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 3; ++p)
      copy_async(w_s + p * kBlockC * kpad + h * kRows * kpad,
                 wplanes + ((long long)2 * blockIdx.x + h) * kTile32 +
                     p * kRows * kpad,
                 kPlane32, threadIdx.x, kGroupThreads);
  cp_async_commit();
  // tile t's planes into buffer `buf` (past the chunk: its last tile again)
  auto fetch_tile = [&](int t, int buf) {
    copy_async(f_p + buf * kTile32,
               image + (long long)min(t, t1 - 1) * kTile32,
               kTile32 * 2, threadIdx.x, kGroupThreads);
    cp_async_commit();
  };
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

  float acc[kBF][32];
#pragma unroll
  for (int n = 0; n < kBF; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  float db[2] = {0.f, 0.f};
  float x[16], xs[16];

  if (t0 < t1) fetch_tile(t0, 0);
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    const uint32_t f_addr = smem_addr(f_p + buf * kTile32);
    cp_async_wait<0>();  // tile t (and the weight) have landed
    fence_async_smem();
    __syncthreads();     // ... for every thread; the other buffer is free
    fetch_tile(t + 1, buf ^ 1);  // during this tile's products
    dw_logits<kBF>(x, xs, w_addr, f_addr);
    wgmma_wait_all();
    fence_operands(x);
    fence_operands(xs);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] += xs[i];

    int hw = t * kRows + 2 * (lane & 3);
    int r = hw / width, cl = hw - r * width;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
    // dW += g . f over the tile's 32 positions (K) in steps of 16, the six
    // part pairs (g part, f part); f read MN-major (N = F)
    uint32_t a[2][3][4];
    split_fragments<2, 3>(x, a);
#pragma unroll
    for (int n = 0; n < kBF; ++n) fence_operands(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int n = 0; n < kBF; ++n) {
        const uint32_t fo = f_addr + s * 2 * kpad * 16 + n * 1024;
#pragma unroll
        for (int qq = 0; qq < kPairs; ++qq)
          wgmma_64x64x16_rs(acc[n], a[s][pair_first(qq)],
                            core_desc_mn(fo + pair_second(qq) * kPlane32,
                                         kpad));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kBF; ++n) fence_operands(acc[n]);
  }
  cp_async_wait<0>();  // the last tile's repeated copy

  const long long part = (long long)b * chunks + q;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      db[k] += __shfl_xor_sync(0xffffffffu, db[k], off);
    if (!valid[k]) continue;
    const int c = c0 + wq * 16 + (lane >> 2) + 8 * k;
    if ((lane & 3) == 0) ws_db[part * channels + c] = db[k];
    float* dst = ws + (part * channels + c) * kpad;
#pragma unroll
    for (int n = 0; n < kBF; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(dst + n * 64 + 8 * i + 2 * (lane & 3)) =
            make_float2(acc[n][4 * i + 2 * k], acc[n][4 * i + 2 * k + 1]);
  }
}


// ---- F > 256: the ring backward (both feature dtypes)
//
// Past 256 features neither the block's weight planes at the whole F nor
// a 64 x F float32 accumulator a warpgroup fit in a CTA (k_slices.cuh).
// (s2) lays the features and the weight out slice by slice; each CTA
// feeds the slices through a ring of stages by bulk copies (each stage
// refilled by the last warp done with it), and its two warpgroups split
// F: each takes half of the slices of K for the logits, and half of a
// pass's slices (at most 4: passes of 512 features) for the products
// along N = F. A round (a channel block in (a), a tile in (b)) is two
// phases of the ring:
//   L: each warpgroup's partial logits over its half of K, each slice's
//      products in an accumulator of their own, added by float32 adds;
//      the two partials are added through shared memory, warpgroup 0's
//      and 1's (float addition commutes, so both hold the same bits), and
//      both form g;
//   P: each warpgroup's products over its half of the pass's slices, into
//      its own 64 x 64 accumulators, one group in flight while the next
//      slice's is issued.
//   (a) dfeat: one CTA per 64-position tile and pass; rounds are channel
//       blocks. L reads the block's weight slice and the tile's feature
//       slice (bf16 features up to 512: the whole tile, resident in
//       shared memory, copied once), P the block's weight slice again (hi
//       and mid planes). The accumulators hold the tile's dfeat at the
//       pass's columns across every block and are stored at the end: no
//       partial in device memory.
//   (b) dW, db partials: one CTA per (channel block, image and chunk of
//       its 64-position tiles, pass); rounds are tiles. L reads the
//       block's weight slice and the tile's feature slice, P the feature
//       slice again. Each warpgroup writes its columns of the partial,
//       warpgroup 0 in pass 0 the db partial.
// Up to 512 features there is one pass: the logits and g are formed once
// a tile and channel block in each of (a) and (b). Every sum is taken in a
// fixed order: the same bits from run to run.

// Shared memory of a ring CTA: the barriers (kMaxStages, and one for
// resident features) and the stages' counts of warps done, the channel
// constants of a block (64 x 5 floats), the two warpgroups' partial logits (64 x 64 floats each),
// then resident features, then the ring.
constexpr size_t kRingBars = 256;
constexpr size_t kRingHead = kRingBars + kBlockC * 5 * sizeof(float) +
                             kSliceGroups * kTileP * kBlockC * sizeof(float);

struct RingSmem {
  uint64_t* full;
  uint64_t* feat;
  int* done;
  float* consts;
  float* logits;
  __nv_bfloat16* resident;
  __nv_bfloat16* ring;
  __device__ RingSmem(unsigned char* smem, int resident_elems)
      : full(reinterpret_cast<uint64_t*>(smem)),
        feat(full + kMaxStages),
        done(reinterpret_cast<int*>(feat + 1)),
        consts(reinterpret_cast<float*>(smem + kRingBars)),
        logits(consts + kBlockC * 5),
        resident(reinterpret_cast<__nv_bfloat16*>(smem + kRingHead)),
        ring(resident + resident_elems) {}
};

// One thread initialises the ring's barriers and counts; the CTA then
// synchronises.
__device__ __forceinline__ void init_ring(const RingSmem& sm, int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(sm.full + i, 1);
      sm.done[i] = 0;
    }
    mbar_init(sm.feat, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Add the other warpgroup's partial logits to x, each element in the
// accumulator's own layout (element i of thread gtid at i * 128 + gtid:
// the two warpgroups' threads hold the same rows and columns).
__device__ __forceinline__ void add_partial_logits(float (&x)[32],
                                                   const RingSmem& sm,
                                                   int group, int gtid) {
  float* mine = sm.logits + group * kTileP * kBlockC;
  const float* other = sm.logits + (1 - group) * kTileP * kBlockC;
#pragma unroll
  for (int i = 0; i < 32; ++i) mine[i * kGroupThreads + gtid] = x[i];
  consumer_sync();
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] += other[i * kGroupThreads + gtid];
}

// (a) dfeat. A consumer warpgroup's logits are positions x channels:
// thread (warp w, lane l) holds positions 16 w + l / 4 + 8 k and channels
// 8 j + 2 (l % 4) + e; its dfeat accumulators the same positions by
// features 64 (d0 + n) + 8 j + 2 (l % 4) + e.
template <int kParts>
__global__ void __launch_bounds__(kRingThreads, 1)
    hp_bwd_dfeat_ring_kernel(
        const __nv_bfloat16* __restrict__ fslices,
        const __nv_bfloat16* __restrict__ wslices,
        const float* __restrict__ bias, const float* __restrict__ mvec,
        const float* __restrict__ tvec, const float* __restrict__ avec,
        const float* __restrict__ bvec,
        std::conditional_t<kParts == 1, __nv_bfloat16, float>* __restrict__
            dfeat,
        int hw_total, int width, int num_feats, int slices, int channels,
        int blocks, int tiles, int stages, int resident) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RingSmem sm(smem, resident ? slices * kParts * kSlicePlane : 0);
  const int tile = blockIdx.x;
  const int b = tile / tiles;
  const int hw0 = (tile - b * tiles) * kTileP;
  const int p0 = blockIdx.y * kPassSlices;  // the pass's first slice
  const int np = min(kPassSlices, slices - p0);
  const int per_round = slices + np;
  const Ring ring{sm.ring, (3 + (resident ? 0 : kParts)) * kSlicePlane,
                  stages, blocks * per_round, sm.full, sm.done};
  const __nv_bfloat16* ftile =
      fslices + (long long)tile * slices * kParts * kSlicePlane;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Issue item j (one thread): in block j / per_round, L items the
  // weight slice and (unless resident) the feature slice, P items the
  // weight slice's hi and mid planes, for the owning warpgroup.
  auto issue = [&](int j) {
    const int cb = j / per_round;
    const int i = j - cb * per_round;
    const __nv_bfloat16* wb =
        wslices + (long long)cb * slices * 3 * kSlicePlane;
    int group, k;
    if (i < slices) {
      item_owner(i, slices, 0, group, k);
      const int s = half_first(slices, group, 0) + k;
      const uint32_t fbytes = resident ? 0 : kParts * kSlicePlaneBytes;
      __nv_bfloat16* st = ring.expect(j, 3 * kSlicePlaneBytes + fbytes);
      bulk_copy(st, wb + (long long)s * 3 * kSlicePlane,
                3 * kSlicePlaneBytes, ring.bar(j));
      if (fbytes)
        bulk_copy(st + 3 * kSlicePlane,
                  ftile + (long long)s * kParts * kSlicePlane, fbytes,
                  ring.bar(j));
    } else {
      item_owner(i - slices, np, 1, group, k);
      const int s = p0 + half_first(np, group, 1) + k;
      bulk_copy(ring.expect(j, 2 * kSlicePlaneBytes),
                wb + (long long)s * 3 * kSlicePlane, 2 * kSlicePlaneBytes,
                ring.bar(j));
    }
  };
  init_ring(sm, stages);
  if (threadIdx.x == 0) {
    if (resident) {
      const uint32_t bytes = slices * kParts * kSlicePlaneBytes;
      mbar_expect_tx(sm.feat, bytes);
      bulk_copy(sm.resident, ftile, bytes, sm.feat);
    }
    for (int j = 0; j < min(stages, ring.items); ++j) issue(j);
  }

  const int group = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;
  const int gtid = threadIdx.x - group * kGroupThreads;
  const int nl = half_count(slices, group, 0);
  const int l0 = half_first(slices, group, 0);
  const int nd = half_count(np, group, 1);
  const int d0 = p0 + half_first(np, group, 1);
  const uint32_t res_addr = smem_addr(sm.resident);

  bool ok[2];
  float col[2], row[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int hw = hw0 + wq * 16 + (lane >> 2) + 8 * k;
    const int r = hw / width;
    ok[k] = hw < hw_total;
    row[k] = float(r);
    col[k] = float(hw - r * width);
  }

  float acc[kHalfSlices][32];
#pragma unroll
  for (int n = 0; n < kHalfSlices; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  if (resident) mbar_wait(sm.feat, 0);

  for (int cb = 0; cb < blocks; ++cb) {
    const int base = cb * per_round;
    if (group == 0 && gtid < kBlockC) {  // read after the next sync
      const int c = cb * kBlockC + gtid;
      const bool valid = c < channels;
      const long long bc = (long long)b * channels + c;
      float* v = sm.consts + 5 * gtid;
      v[0] = valid ? bias[c] : 0.f;
      v[1] = valid ? mvec[bc] : 0.f;
      v[2] = valid ? tvec[bc] : 0.f;
      v[3] = valid ? avec[bc] : 0.f;
      v[4] = valid ? bvec[bc] : 0.f;
    }
    float x[32], xs[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    // each slice's products in xs, added to x once done
    for (int i = 0; i < nl; ++i) {
      const int j = base + item_slot(i, group, slices);
      const uint32_t st = ring.wait(j);
      issue_logits<kParts, false>(
          xs, st,
          resident ? res_addr + (l0 + i) * kParts * kSlicePlaneBytes
                   : st + 3 * kSlicePlaneBytes);
      wgmma_wait_all();
      fence_operands(xs);
      ring.release(j, lane, issue);
#pragma unroll
      for (int q = 0; q < 32; ++q) x[q] += xs[q];
    }
    add_partial_logits(x, sm, group, gtid);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = 8 * j + 2 * (lane & 3) + e;
        const float* v = sm.consts + 5 * ch;
        const float cv[5] = {v[0], v[1], v[2], v[3], v[4]};
        const bool valid = cb * kBlockC + ch < channels;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float& g = x[4 * j + 2 * k + e];
          g = ok[k] && valid ? cotangent(g, cv, col[k], row[k]) : 0.f;
        }
      }
    consumer_sync();  // the partials and the constants have been read
    uint32_t a[4][2][4];
    split_fragments<4, 2>(x, a);
    int prev = 0;
#pragma unroll
    for (int n = 0; n < kHalfSlices; ++n) {
      if (n < nd) {
        const int j = base + slices + item_slot(n, group, np);
        issue_dfeat(acc[n], a, ring.wait(j));
        if (n > 0) {
          wgmma_wait<1>();  // the previous slice's products are done
          ring.release(prev, lane, issue);
        }
        prev = j;
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kHalfSlices; ++n) fence_operands(acc[n]);
    if (nd > 0) ring.release(prev, lane, issue);
  }

  with_parity(num_feats, [&](auto even) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!ok[k]) continue;
      auto* dst = dfeat + ((long long)b * hw_total + hw0 + wq * 16 +
                           (lane >> 2) + 8 * k) *
                              num_feats;
#pragma unroll
      for (int n = 0; n < kHalfSlices; ++n) {
        if (n >= nd) break;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store_pair<decltype(even)::value>(
              dst, (d0 + n) * kSlice + 8 * j + 2 * (lane & 3), num_feats,
              acc[n][4 * j + 2 * k], acc[n][4 * j + 2 * k + 1]);
      }
    }
  });
}

// (b) dW, db partials of channel block blockIdx.x over chunk q of image
// b's 64-position tiles, pass blockIdx.z. A consumer warpgroup's logits
// are channels x positions: thread (warp w, lane l) holds channels 16 w +
// l / 4 + 8 k and positions 8 j + 2 (l % 4) + e; its dW accumulators the
// same channels by features 64 (d0 + n) + 8 j + 2 (l % 4) + e.
template <int kParts>
__global__ void __launch_bounds__(kRingThreads, 1)
    hp_bwd_dweight_ring_kernel(
        const __nv_bfloat16* __restrict__ fslices,
        const __nv_bfloat16* __restrict__ wslices,
        const float* __restrict__ bias, const float* __restrict__ mvec,
        const float* __restrict__ tvec, const float* __restrict__ avec,
        const float* __restrict__ bvec, float* __restrict__ ws,
        float* __restrict__ ws_db, int hw_total, int width, int slices,
        int channels, int chunks, int tiles_per_chunk, int tiles,
        int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RingSmem sm(smem, 0);
  const int c0 = blockIdx.x * kBlockC;
  const int b = blockIdx.y / chunks;
  const int q = blockIdx.y - b * chunks;
  const int t0 = q * tiles_per_chunk;
  const int rounds = max(0, min(tiles, t0 + tiles_per_chunk) - t0);
  const int p0 = blockIdx.z * kPassSlices;  // the pass's first slice
  const int np = min(kPassSlices, slices - p0);
  const int per_round = slices + np;
  const Ring ring{sm.ring, (3 + kParts) * kSlicePlane, stages,
                  rounds * per_round, sm.full, sm.done};
  const __nv_bfloat16* wb =
      wslices + (long long)blockIdx.x * slices * 3 * kSlicePlane;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kBlockC) {  // the block's constants for image b
    const int c = c0 + threadIdx.x;
    const bool valid = c < channels;
    const long long bc = (long long)b * channels + c;
    float* v = sm.consts + 5 * threadIdx.x;
    v[0] = valid ? bias[c] : 0.f;
    v[1] = valid ? mvec[bc] : 0.f;
    v[2] = valid ? tvec[bc] : 0.f;
    v[3] = valid ? avec[bc] : 0.f;
    v[4] = valid ? bvec[bc] : 0.f;
  }

  // Issue item j (one thread): in tile t0 + j / per_round, L items the
  // weight slice and the feature slice, P items the feature slice again,
  // for the owning warpgroup.
  auto issue = [&](int j) {
    const int r = j / per_round;
    const int i = j - r * per_round;
    const __nv_bfloat16* ft =
        fslices +
        ((long long)b * tiles + t0 + r) * slices * kParts * kSlicePlane;
    int group, k;
    if (i < slices) {
      item_owner(i, slices, 0, group, k);
      const int s = half_first(slices, group, 0) + k;
      __nv_bfloat16* st = ring.expect(j, (3 + kParts) * kSlicePlaneBytes);
      bulk_copy(st, wb + (long long)s * 3 * kSlicePlane,
                3 * kSlicePlaneBytes, ring.bar(j));
      bulk_copy(st + 3 * kSlicePlane,
                ft + (long long)s * kParts * kSlicePlane,
                kParts * kSlicePlaneBytes, ring.bar(j));
    } else {
      item_owner(i - slices, np, 1, group, k);
      const int s = p0 + half_first(np, group, 1) + k;
      bulk_copy(ring.expect(j, kParts * kSlicePlaneBytes) + 3 * kSlicePlane,
                ft + (long long)s * kParts * kSlicePlane,
                kParts * kSlicePlaneBytes, ring.bar(j));
    }
  };
  init_ring(sm, stages);
  if (threadIdx.x == 0)
    for (int j = 0; j < min(stages, ring.items); ++j) issue(j);

  const int group = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;
  const int gtid = threadIdx.x - group * kGroupThreads;
  const int nl = half_count(slices, group, 0);
  const int nd = half_count(np, group, 1);
  const int d0 = p0 + half_first(np, group, 1);
  bool valid[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    valid[k] = c0 + wq * 16 + (lane >> 2) + 8 * k < channels;

  float acc[kHalfSlices][32];
#pragma unroll
  for (int n = 0; n < kHalfSlices; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  float db[2] = {0.f, 0.f};

  for (int r = 0; r < rounds; ++r) {
    const int base = r * per_round;
    float x[32], xs[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    // each slice's products in xs, added to x once done
    for (int i = 0; i < nl; ++i) {
      const int j = base + item_slot(i, group, slices);
      const uint32_t st = ring.wait(j);
      issue_logits<kParts, true>(xs, st, st + 3 * kSlicePlaneBytes);
      wgmma_wait_all();
      fence_operands(xs);
      ring.release(j, lane, issue);
#pragma unroll
      for (int q = 0; q < 32; ++q) x[q] += xs[q];
    }
    add_partial_logits(x, sm, group, gtid);
    // g at positions t * 64 + 8 j + 2 (lane % 4) + e, row and column
    // stepped along without a division each; db summed by warpgroup 0
    int hw = (t0 + r) * kTileP + 2 * (lane & 3);
    int rw = hw / width, cl = hw - rw * width;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool wrap = cl + e >= width;
        const float colf = float(wrap ? cl + e - width : cl + e);
        const float rowf = float(wrap ? rw + 1 : rw);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* v = sm.consts + 5 * (wq * 16 + (lane >> 2) + 8 * k);
          const float cv[5] = {v[0], v[1], v[2], v[3], v[4]};
          float& g = x[4 * j + 2 * k + e];
          g = hw + e < hw_total && valid[k] ? cotangent(g, cv, colf, rowf)
                                            : 0.f;
          if (group == 0) db[k] += g;
        }
      }
      hw += 8;
      for (cl += 8; cl >= width; cl -= width) ++rw;
    }
    consumer_sync();  // the partials have been read
    uint32_t a[4][3][4];
    split_fragments<4, 3>(x, a);
    int prev = 0;
#pragma unroll
    for (int n = 0; n < kHalfSlices; ++n) {
      if (n < nd) {
        const int j = base + slices + item_slot(n, group, np);
        issue_dweight<kParts>(acc[n], a,
                              ring.wait(j) + 3 * kSlicePlaneBytes);
        if (n > 0) {
          wgmma_wait<1>();  // the previous slice's products are done
          ring.release(prev, lane, issue);
        }
        prev = j;
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kHalfSlices; ++n) fence_operands(acc[n]);
    if (nd > 0) ring.release(prev, lane, issue);
  }

  const long long part = (long long)b * chunks + q;
  const int kpad = slices * kSlice;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int rr = wq * 16 + (lane >> 2) + 8 * k;
    if (group == 0 && blockIdx.z == 0) {
      // db: the four lanes of a row group (lane / 4) share its channels
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        db[k] += __shfl_xor_sync(0xffffffffu, db[k], off);
      if ((lane & 3) == 0 && valid[k])
        ws_db[part * channels + c0 + rr] = db[k];
    }
    if (!valid[k]) continue;
    float* dst = ws + (part * channels + c0 + rr) * kpad;
#pragma unroll
    for (int n = 0; n < kHalfSlices; ++n) {
      if (n >= nd) break;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + (d0 + n) * kSlice + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[n][4 * j + 2 * k], acc[n][4 * j + 2 * k + 1]);
    }
  }
}

// (s2), (a) and (b) at F > 256: feats are bf16 (kParts 1) or float32
// (kParts 3) rows; planes holds (s2)'s layout (SlicePlanes: the features'
// slices, then the weight's).
template <int kParts>
cudaError_t launch_bwd_ring(
    const void* feats, const float* weight, const float* bias,
    const float* m, const float* t, const float* a, const float* bc,
    std::conditional_t<kParts == 1, __nv_bfloat16, float>* dfeat, float* ws,
    float* ws_db, __nv_bfloat16* planes, int batch, int hw_total, int width,
    int num_feats, int channels, int chunks, cudaStream_t stream) {
  const SlicePlanes sp(batch, hw_total, num_feats, channels);
  __nv_bfloat16* fslices = planes;
  __nv_bfloat16* wslices = planes + sp.feature_elems(kParts);
  cudaError_t err = split_slices<kParts>(feats, batch, hw_total, num_feats,
                                         fslices, stream);
  if (err != cudaSuccess) return err;
  err = split_slices<3>(weight, 1, channels, num_feats, wslices, stream);
  if (err != cudaSuccess) return err;

  const int resident = kParts == 1 && sp.slices <= kPassSlices;
  const size_t head_a =
      kRingHead + (resident ? (size_t)sp.slices * kSlicePlaneBytes : 0);
  const size_t stage_a =
      (size_t)(3 + (resident ? 0 : kParts)) * kSlicePlaneBytes;
  const int stages_a = ring_stages(head_a, stage_a);
  const size_t smem_a = head_a + stages_a * stage_a;
  err = allow_smem(hp_bwd_dfeat_ring_kernel<kParts>, smem_a);
  if (err != cudaSuccess) return err;
  hp_bwd_dfeat_ring_kernel<kParts>
      <<<dim3(batch * sp.tiles64, sp.passes()), kRingThreads, smem_a,
         stream>>>(fslices, wslices, bias, m, t, a, bc, dfeat, hw_total,
                   width, num_feats, sp.slices, channels, sp.blocks,
                   sp.tiles64, stages_a, resident);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t stage_b = (size_t)(3 + kParts) * kSlicePlaneBytes;
  const int stages_b = ring_stages(kRingHead, stage_b);
  const size_t smem_b = kRingHead + stages_b * stage_b;
  err = allow_smem(hp_bwd_dweight_ring_kernel<kParts>, smem_b);
  if (err != cudaSuccess) return err;
  hp_bwd_dweight_ring_kernel<kParts>
      <<<dim3(sp.blocks, batch * chunks, sp.passes()), kRingThreads, smem_b,
         stream>>>(fslices, wslices, bias, m, t, a, bc, ws, ws_db, hw_total,
                   width, sp.slices, channels, chunks,
                   (sp.tiles64 + chunks - 1) / chunks, sp.tiles64, stages_b);
  return cudaGetLastError();
}
}  // namespace

// bf16 features: launches (a) and (b), or at F > 256 (s2) over the
// features and the weight into `planes` (head_projection_planes_bytes)
// and the ring's (a) and (b); the caller runs (c).
// ws holds batch * chunks partial (J*D, kpad) blocks (F rounded up to 64:
// aligned paired stores at any F), ws_db batch * chunks partial (J*D,)
// rows.
cudaError_t head_projection_bwd_mma(
    const __nv_bfloat16* feats, const float* weight, const float* bias,
    const float* m, const float* t, const float* a, const float* bc,
    __nv_bfloat16* dfeat, float* ws, float* ws_db, __nv_bfloat16* planes,
    int batch, int height, int width, int num_feats, int num_joints,
    int depth, int chunks, cudaStream_t stream) {
  const int hw_total = height * width;
  const int channels = num_joints * depth;
  const F32Planes pl(batch, hw_total, num_feats, channels);
  if (pl.kpad > kResidentBlocks * 64)
    return launch_bwd_ring<1>(feats, weight, bias, m, t, a, bc, dfeat, ws,
                              ws_db, planes, batch, hw_total, width,
                              num_feats, channels, chunks, stream);
  const int kpad = pl.kpad;
  const int blocks = pl.blocks;
  const int tiles = pl.tiles64;
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const size_t planes_bytes =
      (size_t)(3 * kBlockC + kGroups * kTileP) * kpad * sizeof(__nv_bfloat16);

  const size_t smem_a = planes_bytes + (size_t)kBlockC * kpad * sizeof(float) +
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

  const size_t smem_b = planes_bytes + kGroups * kBlockC * sizeof(float);
  err = allow_smem(hp_bwd_dweight_mma_kernel, smem_b);
  if (err != cudaSuccess) return err;
  hp_bwd_dweight_mma_kernel<<<dim3(blocks, batch * chunks),
                              kGroups * kGroupThreads, smem_b, stream>>>(
      feats, weight, bias, m, t, a, bc, ws, ws_db, hw_total, width, num_feats,
      kpad, channels, chunks, per_chunk);
  return cudaGetLastError();
}

namespace {

// float32 features at F padded to kBF x 64: (a) and (b) on (s)'s planes.
template <int kBF>
cudaError_t launch_f32_resident(const __nv_bfloat16* planes,
                                const float* bias, const float* m,
                                const float* t, const float* a,
                                const float* bc, float* dfeat, float* ws,
                                float* ws_db, const F32Planes& pl,
                                int hw_total, int width, int num_feats,
                                int channels, int chunks,
                                cudaStream_t stream) {
  constexpr int kpad = 64 * kBF;
  const __nv_bfloat16* fplanes = planes;
  const __nv_bfloat16* wplanes = planes + pl.feature_elems();
  const int tiles32 = (hw_total + kRows32 - 1) / kRows32;
  const int per_chunk = (tiles32 + chunks - 1) / chunks;
  const size_t planes_w = (size_t)3 * kBlockC * kpad * sizeof(__nv_bfloat16);

  const size_t smem_a = planes_w +
                        (size_t)3 * kTileP * kpad * sizeof(__nv_bfloat16) +
                        5 * kBlockC * sizeof(float);
  cudaError_t err = allow_smem(hp_bwd_dfeat_f32_kernel<kBF>, smem_a);
  if (err != cudaSuccess) return err;
  hp_bwd_dfeat_f32_kernel<kBF><<<pl.batch * pl.tiles64,
                                 kGroups * kGroupThreads, smem_a, stream>>>(
      fplanes, wplanes, bias, m, t, a, bc, dfeat, hw_total, width, num_feats,
      channels, pl.blocks, pl.tiles64);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_b =
      planes_w + (size_t)2 * 3 * 32 * kpad * sizeof(__nv_bfloat16);
  err = allow_smem(hp_bwd_dweight_f32_kernel<kBF>, smem_b);
  if (err != cudaSuccess) return err;
  hp_bwd_dweight_f32_kernel<kBF><<<dim3(pl.blocks, pl.batch * chunks),
                                   kGroupThreads, smem_b, stream>>>(
      fplanes, wplanes, bias, m, t, a, bc, ws, ws_db, hw_total, width,
      num_feats, channels, chunks, per_chunk, pl.image_tiles);
  return cudaGetLastError();
}

// float32 features: (s), then (a) and (b), resident (kBF 1 .. 4), or
// (s2) and the ring's (a) and (b) (kBF 0, F > 256).
template <int kBF>
cudaError_t launch_f32(const float* feats, const float* weight,
                       const float* bias, const float* m, const float* t,
                       const float* a, const float* bc, float* dfeat,
                       float* ws, float* ws_db, __nv_bfloat16* planes,
                       int batch, int height, int width, int num_feats,
                       int channels, int chunks, cudaStream_t stream) {
  const int hw_total = height * width;
  if constexpr (kBF == 0) {
    return launch_bwd_ring<3>(feats, weight, bias, m, t, a, bc, dfeat, ws,
                              ws_db, planes, batch, hw_total, width,
                              num_feats, channels, chunks, stream);
  } else {
    const F32Planes pl(batch, hw_total, num_feats, channels);
    const cudaError_t err = split_f32_planes(feats, weight, pl, hw_total,
                                             num_feats, channels, planes,
                                             stream);
    if (err != cudaSuccess) return err;
    return launch_f32_resident<kBF>(planes, bias, m, t, a, bc, dfeat, ws,
                                    ws_db, pl, hw_total, width, num_feats,
                                    channels, chunks, stream);
  }
}

}  // namespace

// The float32-feature route: (s) or (s2), (a) and (b) above; the caller
// runs (c). ws holds batch * chunks partial (J*D, kpad) blocks over tiles
// of 32 positions (64 at F > 256), planes head_projection_planes_bytes
// bytes (f32_planes.cuh; at F > 256 (s2)'s layout, k_slices.cuh).
cudaError_t head_projection_bwd_mma_f32(
    const float* feats, const float* weight, const float* bias,
    const float* m, const float* t, const float* a, const float* bc,
    float* dfeat, float* ws, float* ws_db, void* planes, int batch,
    int height, int width, int num_feats, int num_joints, int depth,
    int chunks, cudaStream_t stream) {
  return with_feature_blocks(num_feats, [&](auto bf) {
    return launch_f32<decltype(bf)::value>(
        feats, weight, bias, m, t, a, bc, dfeat, ws, ws_db,
        static_cast<__nv_bfloat16*>(planes), batch, height, width, num_feats,
        num_joints * depth, chunks, stream);
  });
}

}  // namespace hipe
