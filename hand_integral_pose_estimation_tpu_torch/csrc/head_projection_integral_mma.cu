// Fused 1x1 heatmap projection + soft-argmax forward on the tensor cores,
// for bf16 and for float32 features: the heatmap never reaches device
// memory.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _fwd_kernel (launched by _forward_pallas), for every width F and depth
// D it takes. The C entry points are at the end of this file. The
// float32-feature route comes after the bf16 one, below "---- float32
// features", and the kernel for F > 256 (both routes) below "---- F >
// 256", each with its own header.
//
// bf16 features:
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
#include "f32_planes.cuh"
#include "k_slices.cuh"
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

// Fold a warpgroup's logits (64 channels x 8 kI positions) into this
// thread's two channel states: acc[4 i + 2 k + e] is channel wq * 16 +
// lane / 4 + 8 k at position hw0 + 8 i + 2 (lane % 4) + e, positions past
// hw_total left out. Row and column are stepped along without a division
// each.
template <int kI>
__device__ __forceinline__ void fold_tile(OnlineState (&st)[2],
                                          const float (&acc)[4 * kI],
                                          const float (&bias_r)[2], int hw0,
                                          int hw_total, int width, int lane) {
  float v[2][2 * kI], x[2 * kI], y[2 * kI];
  int hw = hw0 + 2 * (lane & 3);
  int row = hw / width, col = hw - row * width;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
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

// The CTA's partial state per channel of its block: the four lanes of a
// row group (lane / 4) hold the same channels, merged first, then the
// warpgroups' states in order (through st_s, kWarpgroups x kBlockC
// states), written to ws[part * channels + c]. Every thread calls it.
template <int kWarpgroups>
__device__ __forceinline__ void store_states(OnlineState (&st)[2],
                                             OnlineState* st_s, int group,
                                             int wq, int lane, int c0,
                                             int channels, long long part,
                                             float4* __restrict__ ws) {
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
    for (int k = 1; k < kWarpgroups; ++k) s = merge(s, st_s[k * kBlockC + i]);
    ws[part * channels + c] = make_float4(s.m, s.s, s.sx, s.sy);
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
    fold_tile<8>(st, acc, bias_r, hw0, hw_total, width, lane);
  }
  store_states<kGroups>(st, st_s, group, wq, lane, c0, channels,
                        (long long)b * chunks + q, ws);
}

// ---- float32 features
//
// Both operands float32, each split into three bf16 parts, and the six
// part pairs of f32_planes.cuh multiplied on the tensor cores with float32
// accumulation (against three pairs with bf16 features): x = sum over the
// pairs (i, j) of f_i . W_j, float32 accuracy at the bf16 rate over six,
// as kernel 4's float32 route does.
//
// The budget is shared memory. Three bf16 planes of a 64-position x 256
// feature tile (96 KB) beside the block's three weight planes (96 KB)
// leave no room for the bf16 kernel's three tile buffers, and splitting in
// the kernel would re-split each feature tile once per channel block, ALU
// work the products would wait on. So the forward reuses kernel 4's (s)
// (f32_planes.cuh): the features and the weight are split once a call
// into a workspace of bf16 planes in 32-row tiles laid out as the kernel
// stages them. Then one CTA per (image, position chunk, block of 64
// channels), channel block fastest, as for bf16: it copies the block's
// weight planes once (96 KB) and its two warpgroups take turns on the
// chunk's 32-position tiles, each tile's three planes (48 KB) copied into
// the warpgroup's own buffer once its previous products are done, while
// it folds and the other warpgroup multiplies: 195 KB in all. The logits
// are 64 channels x 32 positions (wgmma m64n32k16), the weight's parts the
// register operand (ldmatrix a k-step ahead: each part feeds up to three
// pairs, so shared memory serves 12 KB a k-step rather than the 18 KB of
// six products with both operands in shared memory), the tile's planes
// the shared one. The epilogue, the partial states and the chunk merge
// are the bf16 kernel's. Alternatives: 64-position tiles would leave one
// buffer, with every copy exposed; 3xTF32 runs at the same rate (495/3
// TFLOP/s) but its operands are 4 bytes a part, so a tile of two TF32
// planes is a third larger than three bf16 ones.
//
// Accuracy: the (hi, hi) pair's products go to one accumulator and the
// five smaller pairs' to another, added once the products are done, before
// the fold: with one shared accumulator kernel 4's logits took twice the
// error (a wgmma adds into its accumulator with an error of about 2^-23
// of it, six times a k-step).
//
// Bound: the products, 6 x 2 x B*H*W x F x J*D flops (362 GFLOP at B =
// 32), 0.37 ms at the bf16 tensor-core rate. Besides: (s) reads the
// float32 features once and writes their planes (103 + 154 MB at B = 32),
// and each channel block reads an image's planes from L2 (19 blocks: 2.9
// GB at B = 32). One CTA per SM; the wrapper's chunks (tiles of 32
// positions) make the waves nearly whole, as for bf16. What holds it
// back on an H100 is the N = 32 products, about half the bf16 rate among
// themselves: without its later tiles' copies the kernel is barely
// faster, without its products it takes well under half its time. Wider
// products need wider tiles, which shared memory does not hold beside
// the weight's planes.

constexpr int kF32Groups = 2;

// x, xs (64 channels x 32 positions) = W . f^T over the whole of F for the
// tile of (s) at f_addr (three planes, K-major): the (hi, hi) pair into x,
// the five smaller pairs into xs. The weight's three planes at w_addr
// (kBlockC rows) are read into registers a k-step ahead of the products.
// The first product of each accumulator writes it: no other instruction
// defines an accumulator while products run (ptxas would serialise them).
template <int kBF>
__device__ __forceinline__ void f32_step(float (&x)[16], float (&xs)[16],
                                         const uint32_t (&w)[3][4],
                                         uint32_t f_addr, int k0) {
  constexpr int kpad = 64 * kBF;
  constexpr uint32_t kFPlane = kRows32 * kpad * 2;
  wgmma_fence();
  wgmma_64x32x16_rs(x, w[0], core_desc(f_addr + k0 * 16, kpad), k0 > 0);
#pragma unroll
  for (int q = 1; q < kPairs; ++q)
    wgmma_64x32x16_rs(
        xs, w[pair_second(q)],
        core_desc(f_addr + pair_first(q) * kFPlane + k0 * 16, kpad),
        k0 > 0 || q > 1);
  wgmma_commit();
}

template <int kBF>
__device__ __forceinline__ void f32_logits(float (&x)[16], float (&xs)[16],
                                           uint32_t w_addr, uint32_t f_addr,
                                           int wq, int lane) {
  constexpr int kpad = 64 * kBF;
  constexpr int kSteps = kpad / 16;  // even
  constexpr uint32_t kWPlane = kBlockC * kpad * 2;
  uint32_t wa[3][4], wb[3][4];
  plane_fragments(w_addr, kWPlane, kpad, wq, lane, 0, wa);
#pragma unroll
  for (int s = 0; s < kSteps; s += 2) {
    f32_step<kBF>(x, xs, wa, f_addr, 16 * s);
    wgmma_wait<1>();  // step s - 1's products have read wb
    plane_fragments(w_addr, kWPlane, kpad, wq, lane, 16 * (s + 1), wb);
    f32_step<kBF>(x, xs, wb, f_addr, 16 * (s + 1));
    wgmma_wait<1>();  // step s's products have read wa
    if (s + 2 < kSteps)
      plane_fragments(w_addr, kWPlane, kpad, wq, lane, 16 * (s + 2), wa);
  }
  wgmma_wait_all();
  fence_operands(x);
  fence_operands(xs);
}

// One CTA per (image b, chunk q of its tiles of 32 positions, channel
// block cb), channel block fastest; warpgroup g takes tiles t0 + g, t0 + g
// + 2, ... The logits are channels x positions: thread (warp w, lane l)
// holds channels 16 w + l / 4 + 8 k, positions 8 i + 2 (l % 4) + e, i < 4.
// kBF: F padded to kBF x 64 (kpad), a template argument so that no product
// sits under a runtime branch.
template <int kBF>
__global__ void __launch_bounds__(kF32Groups * kGroupThreads, 1)
    hp_fwd_f32_kernel(const __nv_bfloat16* __restrict__ fplanes,
                      const __nv_bfloat16* __restrict__ wplanes,
                      const float* __restrict__ bias, int hw_total, int width,
                      int channels, int blocks, int chunks,
                      int tiles_per_chunk, int image_tiles,
                      float4* __restrict__ ws) {
  constexpr int kpad = 64 * kBF;
  constexpr int kTile32 = 3 * kRows32 * kpad;  // elements of a tile of (s)
  constexpr int kPlane32 = kRows32 * kpad * 2;  // bytes of one of its planes
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // 3 planes
  __nv_bfloat16* f_s = w_s + 3 * kBlockC * kpad;  // a tile per warpgroup
  OnlineState* st_s =
      reinterpret_cast<OnlineState*>(f_s + kF32Groups * kTile32);

  const int cb = blockIdx.x % blocks;
  const int rest = blockIdx.x / blocks;
  const int q = rest % chunks;
  const int b = rest / chunks;
  const int c0 = cb * kBlockC;
  const int tiles = (hw_total + kRows32 - 1) / kRows32;
  const int t0 = q * tiles_per_chunk;
  const int t1 = min(tiles, t0 + tiles_per_chunk);
  const __nv_bfloat16* image = fplanes + (long long)b * image_tiles * kTile32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the warpgroup, provably warp-uniform (see the bf16 kernel)
  const int group = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;
  const int gtid = threadIdx.x - group * kGroupThreads;
  __nv_bfloat16* tile = f_s + group * kTile32;
  const uint32_t w_addr = smem_addr(w_s);
  const uint32_t f_addr = smem_addr(tile);

  // the block's weight rows, (s)'s weight tiles 2 cb and 2 cb + 1, by the
  // whole CTA; each warpgroup's first tile by its own threads
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 3; ++p)
      copy_async(w_s + p * kBlockC * kpad + h * kRows32 * kpad,
                 wplanes + ((long long)2 * cb + h) * kTile32 +
                     p * kRows32 * kpad,
                 kPlane32, threadIdx.x, blockDim.x);
  if (t0 + group < t1)
    copy_async(tile, image + (long long)(t0 + group) * kTile32, kTile32 * 2,
               gtid, kGroupThreads);
  cp_async_commit();
  float bias_r[2];
  OnlineState st[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = c0 + wq * 16 + (lane >> 2) + 8 * k;
    bias_r[k] = c < channels ? bias[c] : 0.f;
    st[k] = empty_state();
  }
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();  // the weight and the first tiles have landed

  for (int t = t0 + group; t < t1; t += kF32Groups) {
    if (t != t0 + group) {  // this warpgroup's copy of tile t
      cp_async_wait<0>();
      fence_async_smem();
      group_sync(group);
    }
    float x[16], xs[16];
    f32_logits<kBF>(x, xs, w_addr, f_addr, wq, lane);
    group_sync(group);  // the products have read the buffer
    if (t + kF32Groups < t1) {
      copy_async(tile, image + (long long)(t + kF32Groups) * kTile32,
                 kTile32 * 2, gtid, kGroupThreads);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] += xs[i];
    fold_tile<4>(st, x, bias_r, t * kRows32, hw_total, width, lane);
  }
  store_states<kF32Groups>(st, st_s, group, wq, lane, c0, channels,
                           (long long)b * chunks + q, ws);
}


// ---- F > 256: the slice-walking forward (both feature dtypes)
//
// Past 256 features the block's weight planes no longer fit in shared
// memory beside the feature tiles, so the CTA walks K = F in slices of 64
// (k_slices.cuh). One CTA per (image, position chunk, block of 64
// channels), channel block fastest, as above; its two warpgroups take the
// chunk's 64-position tiles two at a time, tile t0 + 2 r + g in round r,
// and share each slice of the block's weight planes: a stage of the ring
// holds the weight slice and both warpgroups' feature slices (40 KB for
// bf16 features, 72 KB for float32 ones' three planes), the next stage's
// copies running under the products. The 64 x 64 logits accumulate in
// registers across the slices; then the tile's online-softmax fold, the
// partial states and the chunk merge are the resident kernels'. The
// weight's planes come from (s) (f32_planes.cuh) for both dtypes, so no
// CTA splits. A warpgroup whose round has no tile multiplies zeros (bf16)
// or the chunk's last tile again (float32) and folds nothing.
//
// Bound: the products, 3 (bf16) or 6 (float32) x 2 x B*H*W x F x J*D
// flops, as at F <= 256. What it pays beyond the resident kernels: the
// weight slices are read from L2 once per round of two tiles (at F = 512,
// B = 32: 19 blocks x 32 images x 25 rounds x 8 slices x 24 KB, 2.9 GB)
// beside the features' slices, and each slice's products wait on their
// copies at a barrier.
template <int kParts>
__global__ void __launch_bounds__(kSliceGroups * kGroupThreads, 1)
    hp_fwd_slices_kernel(const __nv_bfloat16* __restrict__ feats,
                         const __nv_bfloat16* __restrict__ wplanes,
                         const float* __restrict__ bias, int hw_total,
                         int width, int num_feats, int kpad, int channels,
                         int blocks, int chunks, int tiles_per_chunk,
                         int image_tiles, float4* __restrict__ ws) {
  using Stage = SliceStage<kParts>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 stages
  OnlineState* st_s = reinterpret_cast<OnlineState*>(ring + 2 * Stage::kElems);

  const int cb = blockIdx.x % blocks;
  const int rest = blockIdx.x / blocks;
  const int q = rest % chunks;
  const int b = rest / chunks;
  const int c0 = cb * kBlockC;
  const int tiles = (hw_total + kTileP - 1) / kTileP;
  const int t0 = q * tiles_per_chunk;
  const int t1 = min(tiles, t0 + tiles_per_chunk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the warpgroup, provably warp-uniform (see the bf16 kernel)
  const int group = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wq = warp & 3;
  const int gtid = threadIdx.x - group * kGroupThreads;
  const int slices = kpad / kSlice;
  const int items =
      max(0, (t1 - t0 + kSliceGroups - 1) / kSliceGroups) * slices;
  const __nv_bfloat16* wblock =
      wplanes + (long long)2 * cb * 3 * kRows32 * kpad;

  // item = round r x slices + slice s: the weight slice by the whole CTA,
  // each warpgroup's feature slice by its own threads
  auto stage = [&](int item) {
    const int r = item / slices;
    const int sl = item - r * slices;
    const int t = t0 + kSliceGroups * r + group;
    __nv_bfloat16* st = ring + (item & 1) * Stage::kElems;
    copy_plane_slice(st, wblock, kpad, sl * kSlice, threadIdx.x, blockDim.x);
    copy_tile_slice<kParts>(feats, b, min(t, t1 - 1), hw_total,
                            t < t1 ? hw_total : 0, num_feats, kpad,
                            image_tiles, sl * kSlice,
                            st + Stage::kWeight + group * Stage::kFeature,
                            gtid, kGroupThreads);
    cp_async_commit();
  };

  float bias_r[2];
  OnlineState st[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = c0 + wq * 16 + (lane >> 2) + 8 * k;
    bias_r[k] = c < channels ? bias[c] : 0.f;
    st[k] = empty_state();
  }
  // wait for the ring's next stage, start the copy of the one after it
  // and return the address of its weight slice
  int item = 0;
  auto advance = [&]() {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // stage `item` has landed; the other one is free
    if (item + 1 < items) stage(item + 1);
    return smem_addr(ring + (item++ & 1) * Stage::kElems);
  };
  const uint32_t f_off = 2 * (Stage::kWeight + group * Stage::kFeature);
  if (items > 0) stage(0);
  for (int r = 0; r < items / slices; ++r) {
    const int t = t0 + kSliceGroups * r + group;
    float x[32], xs[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    for (int sl = 0; sl < slices; ++sl) {
      const uint32_t w_addr = advance();
      slice_logits<kParts, true>(x, xs, w_addr, w_addr + f_off);
    }
    fold_tile<8>(st, x, bias_r, t * kTileP, t < t1 ? hw_total : 0, width,
                 lane);
  }
  store_states<kSliceGroups>(st, st_s, group, wq, lane, c0, channels,
                             (long long)b * chunks + q, ws);
}

// The slice-walking forward and the merge: feats are bf16 rows (kParts 1)
// or (s)'s feature planes (kParts 3), wplanes (s)'s weight planes; chunks
// of tiles of 64 positions.
template <int kParts>
cudaError_t launch_fwd_slices(const __nv_bfloat16* feats,
                              const __nv_bfloat16* wplanes, const float* bias,
                              float* coords, float* m, float* s, float4* ws,
                              const F32Planes& pl, int height, int width,
                              int num_feats, int num_joints, int depth,
                              int chunks, cudaStream_t stream) {
  const int hw_total = height * width;
  const int channels = num_joints * depth;
  const int tiles = (hw_total + kTileP - 1) / kTileP;
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const size_t smem = (size_t)2 * SliceStage<kParts>::kElems *
                          sizeof(__nv_bfloat16) +
                      kSliceGroups * kBlockC * sizeof(OnlineState);
  cudaError_t err = allow_smem(hp_fwd_slices_kernel<kParts>, smem);
  if (err != cudaSuccess) return err;
  hp_fwd_slices_kernel<kParts><<<pl.batch * chunks * pl.blocks,
                                 kSliceGroups * kGroupThreads, smem,
                                 stream>>>(
      feats, wplanes, bias, hw_total, width, num_feats, pl.kpad, channels,
      pl.blocks, chunks, per_chunk, pl.image_tiles, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_chunks_kernel<<<pl.batch * num_joints, kMergeThreads, 0, stream>>>(
      ws, chunks, num_joints, height, width, depth, coords, m, s);
  return cudaGetLastError();
}

// The resident kernel at F padded to kBF x 64 and the merge.
template <int kBF>
cudaError_t launch_fwd_f32_resident(const __nv_bfloat16* planes,
                                    const float* bias, float* coords,
                                    float* m, float* s, float4* ws,
                                    const F32Planes& pl, int height,
                                    int width, int num_joints, int depth,
                                    int chunks, cudaStream_t stream) {
  constexpr int kpad = 64 * kBF;
  const int hw_total = height * width;
  const int tiles = (hw_total + kRows32 - 1) / kRows32;
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const size_t smem =
      (size_t)(3 * kBlockC + kF32Groups * 3 * kRows32) * kpad *
          sizeof(__nv_bfloat16) +
      kF32Groups * kBlockC * sizeof(OnlineState);
  cudaError_t err = allow_smem(hp_fwd_f32_kernel<kBF>, smem);
  if (err != cudaSuccess) return err;
  hp_fwd_f32_kernel<kBF><<<pl.batch * chunks * pl.blocks,
                           kF32Groups * kGroupThreads, smem, stream>>>(
      planes, planes + pl.feature_elems(), bias, hw_total, width,
      num_joints * depth, pl.blocks, chunks, per_chunk, pl.image_tiles, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_chunks_kernel<<<pl.batch * num_joints, kMergeThreads, 0, stream>>>(
      ws, chunks, num_joints, height, width, depth, coords, m, s);
  return cudaGetLastError();
}

// float32 features: (s), then the resident kernel (kBF 1 .. 4) or the
// slice-walking one (kBF 0, F > 256), and the merge.
template <int kBF>
cudaError_t launch_fwd_f32(const float* feats, const float* weight,
                           const float* bias, float* coords, float* m,
                           float* s, float4* ws, __nv_bfloat16* planes,
                           int batch, int height, int width, int num_feats,
                           int num_joints, int depth, int chunks,
                           cudaStream_t stream) {
  const int hw_total = height * width;
  const int channels = num_joints * depth;
  const F32Planes pl(batch, hw_total, num_feats, channels);
  const cudaError_t err = split_f32_planes(feats, weight, pl, hw_total,
                                           num_feats, channels, planes,
                                           stream);
  if (err != cudaSuccess) return err;
  if constexpr (kBF == 0)
    return launch_fwd_slices<3>(planes, planes + pl.feature_elems(), bias,
                                coords, m, s, ws, pl, height, width,
                                num_feats, num_joints, depth, chunks, stream);
  else
    return launch_fwd_f32_resident<kBF>(planes, bias, coords, m, s, ws, pl,
                                        height, width, num_joints, depth,
                                        chunks, stream);
}

// bf16 features: both launches (F <= 256), or (s) over the weight into
// `planes`, the slice-walking kernel and the merge (F > 256); ws holds
// batch * chunks * J*D float4 partial states.
cudaError_t head_projection_fwd_mma(const __nv_bfloat16* feats,
                                    const float* weight, const float* bias,
                                    float* coords, float* m, float* s,
                                    float* ws, __nv_bfloat16* planes,
                                    int batch, int height, int width,
                                    int num_feats, int num_joints, int depth,
                                    int chunks, cudaStream_t stream) {
  const int hw_total = height * width;
  const int channels = num_joints * depth;
  float4* ws4 = reinterpret_cast<float4*>(ws);
  const F32Planes pl(batch, hw_total, num_feats, channels);
  if (pl.kpad > kResidentBlocks * 64) {
    const cudaError_t err = split_weight_planes(weight, pl, num_feats,
                                                channels, planes, stream);
    if (err != cudaSuccess) return err;
    return launch_fwd_slices<1>(feats, planes, bias, coords, m, s, ws4, pl,
                                height, width, num_feats, num_joints, depth,
                                chunks, stream);
  }
  const int kpad = pl.kpad;
  const int tiles = (hw_total + kTileP - 1) / kTileP;
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const size_t smem =
      (size_t)(3 * kBlockC + kGroups * kTileP) * kpad * sizeof(__nv_bfloat16) +
      kGroups * kBlockC * sizeof(OnlineState);
  cudaError_t err = allow_smem(hp_fwd_mma_kernel, smem);
  if (err != cudaSuccess) return err;
  hp_fwd_mma_kernel<<<batch * chunks * pl.blocks, kGroups * kGroupThreads,
                      smem, stream>>>(
      feats, weight, bias, hw_total, width, num_feats, kpad, channels,
      pl.blocks, chunks, per_chunk, ws4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_chunks_kernel<<<batch * num_joints, kMergeThreads, 0, stream>>>(
      ws4, chunks, num_joints, height, width, depth, coords, m, s);
  return cudaGetLastError();
}

}  // namespace

}  // namespace hipe

// One entry point per route, so that each counts its own launches:
// hipe_head_projection_integral_fwd takes bfloat16 feats,
// hipe_head_projection_integral_fwd_f32 float32 ones; weight and bias are
// float32. The caller guarantees contiguity, 16-byte aligned arrays, depth
// >= 1, a workspace ws of batch * chunks * J*D * 4 floats (chunks of tiles
// of 64 positions, or of 32 for float32 features at F <= 256) and one of
// hipe_head_projection_integral_workspace bytes for the split planes
// (the backward's layout; none for bf16 features at F <= 256). Returns
// the first launch's CUDA error code.
extern "C" int hipe_head_projection_integral_fwd(
    const void* feats, const void* weight, const void* bias, void* coords,
    void* m, void* s, void* ws, void* planes, int batch, int height,
    int width, int num_feats, int num_joints, int depth, int chunks,
    void* stream) {
  return static_cast<int>(hipe::head_projection_fwd_mma(
      static_cast<const __nv_bfloat16*>(feats),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(coords), static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(ws),
      static_cast<__nv_bfloat16*>(planes), batch, height, width, num_feats,
      num_joints, depth, chunks, static_cast<cudaStream_t>(stream)));
}

extern "C" int hipe_head_projection_integral_fwd_f32(
    const void* feats, const void* weight, const void* bias, void* coords,
    void* m, void* s, void* ws, void* planes, int batch, int height,
    int width, int num_feats, int num_joints, int depth, int chunks,
    void* stream) {
  return static_cast<int>(hipe::mma::with_feature_blocks(
      num_feats, [&](auto bf) {
        return hipe::launch_fwd_f32<decltype(bf)::value>(
            static_cast<const float*>(feats),
            static_cast<const float*>(weight),
            static_cast<const float*>(bias), static_cast<float*>(coords),
            static_cast<float*>(m), static_cast<float*>(s),
            static_cast<float4*>(ws), static_cast<__nv_bfloat16*>(planes),
            batch, height, width, num_feats, num_joints, depth, chunks,
            static_cast<cudaStream_t>(stream));
      }));
}

// Bytes of the workspace of split planes that a route takes (forward and
// backward: one layout; past 256 features the backward's is longer): f32
// non-zero for float32 features, backward non-zero for kernel 4's.
extern "C" long long hipe_head_projection_integral_workspace(
    int f32, int backward, int batch, int height, int width, int num_feats,
    int num_joints, int depth) {
  return hipe::mma::head_projection_planes_bytes(
      f32 != 0, backward != 0, batch, height * width, num_feats,
      num_joints * depth);
}
