// The fused head's float32-feature routes on the tensor cores (kernel 3's
// forward, head_projection_integral_mma.cu; kernel 4's backward,
// head_projection_integral_bwd_mma.cu): the part pairs that carry a
// float32 x float32 product to float32 accuracy, and (s), the split of the
// float32 features and weight into bf16 planes, once a call, into a
// workspace laid out as the kernels stage it (contiguous copies, no ALU
// work in the kernels that multiply).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "bf16x3_mma.cuh"

namespace hipe {
namespace mma {
namespace {

// Products of two float32 operands, each split into three bf16 parts
// (hi, mid, lo: parts 0, 1, 2), kept to float32 accuracy: the pairs of
// parts whose orders add up to at most 2^-16 of the product, q = 0 .. 5:
// (0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1). The dropped pairs weigh
// 2^-24 and less.
constexpr int kPairs = 6;
__host__ __device__ constexpr int pair_first(int q) {
  return q == 2 || q == 5 ? 1 : q == 4 ? 2 : 0;
}
__host__ __device__ constexpr int pair_second(int q) {
  return q == 1 || q == 5 ? 1 : q == 3 ? 2 : 0;
}

// Rows of a tile of (s).
constexpr int kRows32 = 32;

// Copy `bytes` (a multiple of 16) from global to shared memory by threads
// tid = 0 .. nthreads - 1, 16 bytes a cp.async; the caller commits.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes, int tid, int nthreads) {
  for (int i = 16 * tid; i < bytes; i += 16 * nthreads)
    cp_async<16>(smem_addr(static_cast<char*>(dst) + i),
                 static_cast<const char*>(src) + i, true);
}

// (s) The float32 operands split once into three bf16 planes, in tiles of
// 32 rows laid out as the kernels stage them: tile i is 3 planes of 32 x
// kpad core-matrix bf16 (3 x 32 x kpad elements at i x that), rows past
// `rows` and columns past F zero. Group blockIdx.y (an image's features,
// or the weight) has `rows` rows at src + blockIdx.y * rows * F and its
// tiles at gridDim.x * blockIdx.y. Each thread takes 8 columns of a row,
// so that neighbouring threads write neighbouring 16-byte rows of a core
// matrix.
template <int kBF>
__global__ void __launch_bounds__(256)
    hp_split_f32_kernel(const float* __restrict__ src, int rows,
                        int num_feats, __nv_bfloat16* __restrict__ out) {
  constexpr int kpad = 64 * kBF;
  constexpr int kRows = kRows32;
  const float* g = src + (long long)blockIdx.y * rows * num_feats;
  const int r0 = blockIdx.x * kRows;
  __nv_bfloat16* o =
      out + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 3 * kRows *
                kpad;
  for (int idx = threadIdx.x; idx < kRows * kpad / 8; idx += blockDim.x) {
    const int r = idx % kRows;
    const int c = 8 * (idx / kRows);
    float x[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < rows && c + 4 * h < num_feats)
        v = __ldg(reinterpret_cast<const float4*>(
            g + (long long)(r0 + r) * num_feats + c + 4 * h));
      x[4 * h] = v.x;
      x[4 * h + 1] = v.y;
      x[4 * h + 2] = v.z;
      x[4 * h + 3] = v.w;
    }
    __nv_bfloat16 part[3][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      split3(x[i], part[0][i], part[1][i], part[2][i]);
    const int off = core_offset(r, c, kpad);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(o + p * kRows * kpad + off) = make_uint4(
          pack(part[p][0], part[p][1]), pack(part[p][2], part[p][3]),
          pack(part[p][4], part[p][5]), pack(part[p][6], part[p][7]));
  }
}

// The workspace: (s)'s tiles of the features (an even number per image:
// whole 64-row tiles for the backward's dfeat) and of the weight (two per
// channel block of 64), in elements.
struct F32Planes {
  int batch, kpad, tiles64, image_tiles, blocks;
  F32Planes(int batch, int hw_total, int num_feats, int channels)
      : batch(batch),
        kpad((num_feats + 63) / 64 * 64),
        tiles64((hw_total + kTileP - 1) / kTileP),
        image_tiles(2 * tiles64),
        blocks((channels + kBlockC - 1) / kBlockC) {}
  long long tile_elems() const { return 3LL * kRows32 * kpad; }
  long long feature_elems() const {
    return (long long)batch * image_tiles * tile_elems();
  }
  long long elems() const {
    return feature_elems() + 2LL * blocks * tile_elems();
  }
};

// Bytes of the float32 routes' workspace of split planes (the forward's
// and the backward's: one layout).
inline long long head_projection_f32_planes_bytes(int batch, int hw_total,
                                                  int num_feats,
                                                  int channels) {
  return F32Planes(batch, hw_total, num_feats, channels).elems() *
         (long long)sizeof(__nv_bfloat16);
}

// Launch (s) over the features (B, hw_total, F) and the weight (C, F):
// the features' planes at `planes`, the weight's after them.
template <int kBF>
cudaError_t split_f32_planes(const float* feats, const float* weight,
                             const F32Planes& pl, int hw_total,
                             int num_feats, int channels,
                             __nv_bfloat16* planes, cudaStream_t stream) {
  hp_split_f32_kernel<kBF><<<dim3(pl.image_tiles, pl.batch), 256, 0,
                             stream>>>(feats, hw_total, num_feats, planes);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  hp_split_f32_kernel<kBF><<<dim3(2 * pl.blocks, 1), 256, 0, stream>>>(
      weight, channels, num_feats, planes + pl.feature_elems());
  return cudaGetLastError();
}

// fn(std::integral_constant<int, kBF>()) for F padded to kBF x 64, kBF
// 1 .. 4: the kernels take kBF as a template argument, so that no product
// sits under a runtime branch (ptxas serialises wgmma there).
template <typename Fn>
cudaError_t with_feature_blocks(int num_feats, Fn&& fn) {
  switch ((num_feats + 63) / 64) {
    case 1:
      return fn(std::integral_constant<int, 1>());
    case 2:
      return fn(std::integral_constant<int, 2>());
    case 3:
      return fn(std::integral_constant<int, 3>());
    case 4:
      return fn(std::integral_constant<int, 4>());
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
}  // namespace mma
}  // namespace hipe
