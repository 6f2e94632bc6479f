// The fused head's tensor-core kernels for F wider than the resident
// kernels take (F > kResidentBlocks x 64 = 256; kernels 3, 3f, 4 and 4f):
// they walk K = F in slices of 64 features instead of keeping a channel
// block's weight planes at the whole F in shared memory.
//
// A slice is 64 rows x 64 columns in core-matrix layout (kpad 64): the
// weight's three bf16 planes of a block of 64 channels, taken from (s)'s
// weight tiles (f32_planes.cuh; for bf16 features the wrapper's workspace
// holds those alone), and a 64-position tile's features, bf16 rows copied
// at the widest width F's alignment allows (columns past F and rows past
// the image zero-filled), or float32 features' three planes from (s)'s
// feature tiles. Slices pass through a ring of two stages in shared
// memory: while the tensor cores multiply one, the next is copied with
// cp.async. The logits accumulate in registers across the slices (each
// slice's products in an accumulator of their own, `slice_logits`); only
// then does the epilogue (the online softmax, or the cotangent g) run, as
// in the resident kernels. In the backward, dfeat = g . W forms g once a
// tile and channel block, then walks the block's weight slices, adding
// each slice's products to a float32 partial in device memory; dW = g^T f
// takes one pass of at most kSlicesPerPass slices (256 features) a CTA,
// so that its accumulators stay in registers, and a grid dimension walks
// the passes, each recomputing the logits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16x3_mma.cuh"
#include "f32_planes.cuh"

namespace hipe {
namespace mma {
namespace {

constexpr int kSlice = 64;           // features per slice of K = F
constexpr int kSlicesPerPass = 4;    // a pass of the N = F products: 256
constexpr int kSliceGroups = 2;      // warpgroups of a slice-walking CTA
constexpr int kSlicePlane = kTileP * kSlice;  // elements of a slice's plane
constexpr uint32_t kSlicePlaneBytes = kSlicePlane * 2;
// bytes between the k-steps of 16 rows of a slice read MN-major
constexpr uint32_t kSliceStep16 = 2 * kSlice * 16;

// A stage of the ring: the weight slice's three planes, then one feature
// slice (kParts planes) for each of the CTA's warpgroups.
template <int kParts>
struct SliceStage {
  static constexpr int kWeight = 3 * kSlicePlane;
  static constexpr int kFeature = kParts * kSlicePlane;
  static constexpr int kElems = kWeight + kSliceGroups * kFeature;
};

// Copy columns k0 .. k0 + 63 of the three planes of two consecutive tiles
// of (s) (64 rows; `tiles` points at the first, whose rows are kpad
// wide) into a slice: each plane's row group of 8 rows is 1 KB contiguous
// on both sides. Threads tid = 0 .. nthreads - 1; the caller commits.
__device__ __forceinline__ void copy_plane_slice(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ tiles, int kpad,
    int k0, int tid, int nthreads) {
  constexpr int kPieces = 2 * 3 * 4 * 64;  // 16-byte pieces
  for (int i = tid; i < kPieces; i += nthreads) {
    const int e = i & 63;
    const int c = i >> 6;  // (tile h, plane p, row group rg), rg fastest
    const int rg = c & 3;
    const int p = (c >> 2) % 3;
    const int h = (c >> 2) / 3;
    const __nv_bfloat16* src = tiles +
                               (long long)(3 * h + p) * kRows32 * kpad +
                               (long long)rg * 8 * kpad + k0 * 8 + e * 8;
    cp_async<16>(
        smem_addr(dst + p * kSlicePlane + (4 * h + rg) * 512 + e * 8), src,
        true);
  }
}

// Copy columns k0 .. k0 + 63 of 64-position tile t of image b into a
// feature slice: bf16 rows (kParts 1; positions at or past hw_limit
// zero-filled: the image's end, or 0 for a tile the CTA only pads with)
// or (s)'s two tiles of it (kParts 3; the caller keeps t in range).
// Threads tid = 0 .. nthreads - 1; the caller commits (the bf16 rows'
// copies commit a group of their own as well).
template <int kParts>
__device__ __forceinline__ void copy_tile_slice(
    const __nv_bfloat16* __restrict__ feats, int b, int t, int hw_total,
    int hw_limit, int num_feats, int kpad, int image_tiles, int k0,
    __nv_bfloat16* dst, int tid, int nthreads) {
  if constexpr (kParts == 1) {
    stage_feature_cols<true>(feats + (long long)b * hw_total * num_feats,
                             t * kTileP, hw_limit, num_feats, k0,
                             k0 + kSlice, kSlice, dst, tid, nthreads);
  } else {
    copy_plane_slice(
        dst, feats + ((long long)b * image_tiles + 2 * t) * 3 * kRows32 * kpad,
        kpad, k0, tid, nthreads);
  }
}

// x += one slice's logits, channels x positions (kChannelRows: the weight
// slice is A, M = 64 channels, the feature slice B) or positions x
// channels. kParts 1: the bf16 features times the weight's three planes;
// kParts 3: the six part pairs of f32_planes.cuh. The slice's products go
// to xs, which its first product writes, and xs is added to x by ordinary
// float32 additions once they are done: a wgmma adds into its accumulator
// with an error of about 2^-23 of it, so an accumulator carried across
// every slice would gather one such error a product group, more the wider
// F (at F = 2048, 8 times F = 256's: the coords missed 1e-4 on an H100);
// a slice's 12 or 24 groups stay as few as at F <= 256, and the slices'
// sums add with one rounding each. Both operands K-major at shared
// addresses w and f.
template <int kParts, bool kChannelRows>
__device__ __forceinline__ void slice_logits(float (&x)[32], float (&xs)[32],
                                             uint32_t w, uint32_t f) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kSlice; k += 16)
#pragma unroll
    for (int q = 0; q < (kParts == 1 ? 3 : kPairs); ++q) {
      const uint32_t wq =
          w + (kParts == 1 ? q : pair_second(q)) * kSlicePlaneBytes + k * 16;
      const uint32_t fq =
          f + (kParts == 1 ? 0 : pair_first(q)) * kSlicePlaneBytes + k * 16;
      wgmma_64x64x16(xs, core_desc(kChannelRows ? wq : fq, kSlice),
                     core_desc(kChannelRows ? fq : wq, kSlice),
                     k > 0 || q > 0);
    }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(xs);
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] += xs[i];
}

// acc (64 channels x 64 features) += g^T f over a tile's 64 positions (K)
// in steps of 16: g's three parts in registers (a), the feature slice at
// f read MN-major; the bf16 route's three products a step, the float32
// route's six part pairs (g part, f part).
template <int kParts>
__device__ __forceinline__ void slice_dweight(float (&acc)[32],
                                              const uint32_t (&a)[4][3][4],
                                              uint32_t f) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int q = 0; q < (kParts == 1 ? 3 : kPairs); ++q)
      wgmma_64x64x16_rs(
          acc, a[s][kParts == 1 ? q : pair_first(q)],
          core_desc_mn(f + (kParts == 1 ? 0 : pair_second(q)) *
                               kSlicePlaneBytes +
                           s * kSliceStep16,
                       kSlice));
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(acc);
}

// acc (64 positions x 64 features) += g_hi W_hi + g_hi W_mid + g_lo W_hi
// over a block's 64 channels (K) in steps of 16: g's two parts in
// registers (a), the weight slice at w read MN-major.
__device__ __forceinline__ void slice_dfeat(float (&acc)[32],
                                            const uint32_t (&a)[4][2][4],
                                            uint32_t w) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t hi = w + s * kSliceStep16;
    wgmma_64x64x16_rs(acc, a[s][0], core_desc_mn(hi, kSlice));
    wgmma_64x64x16_rs(acc, a[s][0],
                      core_desc_mn(hi + kSlicePlaneBytes, kSlice));
    wgmma_64x64x16_rs(acc, a[s][1], core_desc_mn(hi, kSlice));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(acc);
}

}  // namespace
}  // namespace mma
}  // namespace hipe
