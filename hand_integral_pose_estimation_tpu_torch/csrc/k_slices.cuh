// The fused head's tensor-core kernels for F wider than the resident
// kernels take (F > kResidentBlocks x 64 = 256; kernels 3, 3f, 4 and 4f):
// they walk K = F in slices of 64 features instead of keeping a channel
// block's weight planes at the whole F in shared memory. They replace the
// TPU kernels hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _fwd_kernel and _bwd_kernel (ops/fused_head.py:106) at those widths.
//
// A slice is 64 rows x 64 columns in core-matrix layout (kpad 64).
//
// The forward (hp_fwd_slices_kernel) takes the weight's three bf16
// planes from (s)'s weight tiles (f32_planes.cuh) and a 64-position
// tile's features (bf16 rows, or (s)'s three planes of float32 features)
// through a ring of two stages copied with cp.async; the logits
// accumulate across the slices, each slice's products in an accumulator
// of their own (`slice_logits`).
//
// The backward (kernel 4 and 4f, head_projection_integral_bwd_mma.cu) is
// bound by its products: the logits (3 bf16 products, 6 with float32
// features), then dfeat = g . W and dW = g^T f (3 each; 6 for dW with
// float32 features), against the 3 of the recorded bound. Walking F in
// slices, what held it back was the staging: each 64-wide slice copied
// from L2 for each use under one CTA-wide wait, dW's logits recomputed for
// every pass of 256 features, and dfeat's float32 partial taken through
// device memory for every channel block. Its kernels therefore:
//   - split F, not positions, between the CTA's two consumer warpgroups:
//     each forms the logits over its half of K and adds its products into
//     its half of the N = F columns, in a 64 x F / 2 float32 accumulator
//     in registers (passes of 512 features past F = 512); the two
//     partial logits are added through shared memory in a fixed order, so
//     that the logits and g are formed once a tile and channel block;
//   - take their operands from (s2), which lays features and weight out
//     slice by slice (`hp_split_slices_kernel`), so that one bulk copy
//     (cp.async.bulk, completing on an mbarrier) moves a slice;
//   - feed the slices through a ring of stages guarded by mbarriers: the
//     last warp done with a stage issues the copy of the item it holds
//     next; the warps wait only for the stage they read, and keep one
//     product group of dfeat or dW in flight while the next slice's is
//     issued.
// What holds the new kernels back is no longer the bytes (copies that move
// nothing make them less than an eighth faster: scripts/
// fused_head_bwd_probe.py, PERF.md) but the products' issue: N = 64 at
// most (a slice; the logits' 64 positions or channels), each slice's
// logits waited for before the next are issued (one accumulator a slice,
// for accuracy; a second one in turns let ptxas serialise the products,
// C7514), and the two warpgroups' exchange of the partial logits and g's
// arithmetic, duplicated in both, once a round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16x3_mma.cuh"
#include "f32_planes.cuh"

namespace hipe {
namespace mma {
namespace {

constexpr int kSlice = 64;           // features per slice of K = F
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
// addresses w and f. issue_logits issues and commits the slice's products
// into xs as one group; slice_logits waits for them and adds.
template <int kParts, bool kChannelRows>
__device__ __forceinline__ void issue_logits(float (&xs)[32], uint32_t w,
                                             uint32_t f) {
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
}
template <int kParts, bool kChannelRows>
__device__ __forceinline__ void slice_logits(float (&x)[32], float (&xs)[32],
                                             uint32_t w, uint32_t f) {
  issue_logits<kParts, kChannelRows>(xs, w, f);
  wgmma_wait_all();
  fence_operands(xs);
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] += xs[i];
}

// ---- the backward's ring (F > 256)

// Slices of a pass of the N = F products (f32_planes.cuh) that a
// warpgroup owns: 4, 256 features (its accumulator is 4 x 32 registers a
// thread, as the resident kernels' at F = 256).
constexpr int kHalfSlices = kPassSlices / kSliceGroups;
// the ring's stages at most, and shared memory a CTA may take
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;
// threads of a ring CTA: its two warpgroups. No producer warp: ptxas
// counts a CTA's threads in whole warpgroups, so a third (or a 288th
// thread) cuts every thread to 168 registers, setmaxnreg
// notwithstanding, and the consumers' 64 x 256 float32 accumulators
// (128 registers) spilled and serialised their products (C7511, C7512).
constexpr int kRingThreads = kSliceGroups * kGroupThreads;
// named barrier over the two consumer warpgroups (group_sync takes 1, 2)
constexpr int kConsumerBar = 3;

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBar),
               "n"(kSliceGroups * kGroupThreads));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Wait for the phase of `bar` with `parity` to complete. A phase that
// never completes (a fault in a ring's schedule) traps after 2^26 polls,
// a second or more, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long polls = 0;
  do {
    if (++polls > (1LL << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive on `bar`, expecting `bytes` of bulk copies to complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The ring: `stages` stages of `stage_elems` bf16 elements, item j in
// stage j % stages. full[s] completes when the copies of an item have
// landed there (one arrival and their bytes). done[s] counts the warps of
// the consuming warpgroup that have read it: the last of the four refills
// the stage with the item `stages` later, so no warp waits for a free
// stage and no thread waits to issue copies.
struct Ring {
  __nv_bfloat16* base;
  int stage_elems, stages, items;
  uint64_t* full;
  int* done;

  __device__ __nv_bfloat16* stage(int j) const {
    return base + (j % stages) * stage_elems;
  }
  __device__ uint64_t* bar(int j) const { return full + j % stages; }
  // Wait for item j; the shared address of its stage.
  __device__ uint32_t wait(int j) const {
    mbar_wait(full + j % stages, (j / stages) & 1);
    return smem_addr(stage(j));
  }
  // Expect `bytes` of item j's copies; its stage, to copy into.
  __device__ __nv_bfloat16* expect(int j, uint32_t bytes) const {
    mbar_expect_tx(full + j % stages, bytes);
    return stage(j);
  }
  // The warp is done with item j (every lane calls it, after the products
  // that read the stage have completed); the warpgroup's last warp to be
  // done issues item j + stages there: issue(j + stages).
  template <typename Issue>
  __device__ void release(int j, int lane, Issue&& issue) const {
    __syncwarp();
    if (lane == 0) {
      // acquire-release: the other warps' reads of the stage happen
      // before the last one's copy into it
      uint32_t before;
      asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                   : "=r"(before)
                   : "r"(smem_addr(done + j % stages))
                   : "memory");
      if (before == kGroupThreads / 32 - 1) {
        done[j % stages] = 0;
        if (j + stages < items) issue(j + stages);
      }
    }
    __syncwarp();
  }
};

// The two warpgroups' halves of n slices: warpgroup `big` takes (n + 1)
// / 2, the other n / 2; warpgroup 0's come first.
__device__ __forceinline__ int half_count(int n, int group, int big) {
  return group == big ? (n + 1) / 2 : n / 2;
}
__device__ __forceinline__ int half_first(int n, int group, int big) {
  return group == 0 ? 0 : half_count(n, 0, big);
}

// A phase of a round passes the two warpgroups' halves of n slices through
// the ring alternately, warpgroup 0 first, while both have one; then the
// rest of the larger half (of warpgroup `big`). The i-th slice of
// warpgroup `group`'s half is the phase's item item_slot(i, group, n);
// item j of the phase is slice `slice` of warpgroup `group`'s half
// (item_owner).
__device__ __forceinline__ int item_slot(int i, int group, int n) {
  const int m = n / 2;
  return i < m ? 2 * i + group : 2 * m + i - m;
}
__device__ __forceinline__ void item_owner(int j, int n, int big, int& group,
                                           int& slice) {
  const int m = n / 2;
  group = j < 2 * m ? j & 1 : big;
  slice = j < 2 * m ? j >> 1 : j - m;
}

// (s2) Rows x F operands laid out slice by slice for the ring: float32
// split into three bf16 planes (kParts 3: hi, mid, lo), or bf16 copied
// (kParts 1). Slice s of 64-row tile t of group g (an image's features,
// or the weight) is kParts core-matrix planes of 64 x 64 at element
// ((g * tiles + t) * slices + s) * kParts * kSlicePlane, so that a ring
// stage takes it in one bulk copy (two planes, hi and mid, in a shorter
// one); rows past `rows` and columns past F are zero. Grid (tiles *
// slices, groups). Each thread takes 8 columns of a row, neighbouring
// threads neighbouring rows, so that they write neighbouring 16-byte rows
// of a core matrix; it reads them 16 bytes at a time where F's alignment
// allows, else one element at a time.
template <int kParts>
__global__ void __launch_bounds__(256)
    hp_split_slices_kernel(const void* __restrict__ src, int rows,
                           int num_feats, int tiles, int slices,
                           __nv_bfloat16* __restrict__ out) {
  const int t = blockIdx.x / slices;
  const int s = blockIdx.x - t * slices;
  const long long g = blockIdx.y;
  __nv_bfloat16* o =
      out + ((g * tiles + t) * slices + s) * (long long)(kParts * kSlicePlane);
  for (int idx = threadIdx.x; idx < kTileP * kSlice / 8; idx += blockDim.x) {
    const int r = idx % kTileP;
    const int c = 8 * (idx / kTileP);
    const int row = t * kTileP + r;
    const int col = s * kSlice + c;
    const bool in = row < rows;
    const long long at = (g * rows + row) * (long long)num_feats + col;
    const int off = core_offset(r, c, kSlice);
    if constexpr (kParts == 3) {
      const float* x = static_cast<const float*>(src) + at;
      float v[8];
      if (num_feats % 4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in && col + 4 * h < num_feats)
            q = __ldg(reinterpret_cast<const float4*>(x + 4 * h));
          v[4 * h] = q.x;
          v[4 * h + 1] = q.y;
          v[4 * h + 2] = q.z;
          v[4 * h + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = in && col + i < num_feats ? __ldg(x + i) : 0.f;
      }
      __nv_bfloat16 part[3][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        split3(v[i], part[0][i], part[1][i], part[2][i]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint4*>(o + p * kSlicePlane + off) = make_uint4(
            pack(part[p][0], part[p][1]), pack(part[p][2], part[p][3]),
            pack(part[p][4], part[p][5]), pack(part[p][6], part[p][7]));
    } else {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(src) + at;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (num_feats % 8 == 0) {
        if (in && col < num_feats) q = __ldg(reinterpret_cast<const uint4*>(x));
      } else {
        __nv_bfloat16 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = in && col + i < num_feats ? x[i] : __float2bfloat16_rn(0.f);
        q = make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                       pack(v[6], v[7]));
      }
      *reinterpret_cast<uint4*>(o + off) = q;
    }
  }
}

// Launch (s2) over `groups` x `rows` rows of F (float32 for kParts 3,
// bf16 for 1) into `out`.
template <int kParts>
cudaError_t split_slices(const void* src, int groups, int rows,
                         int num_feats, __nv_bfloat16* out,
                         cudaStream_t stream) {
  const int tiles = (rows + kTileP - 1) / kTileP;
  const int slices = (num_feats + kSlice - 1) / kSlice;
  hp_split_slices_kernel<kParts>
      <<<dim3(tiles * slices, groups), 256, 0, stream>>>(
          src, rows, num_feats, tiles, slices, out);
  return cudaGetLastError();
}

// acc (64 channels x 64 features) += g^T f over a tile's 64 positions (K)
// in steps of 16: g's three parts in registers (a), the feature slice at
// f read MN-major; the bf16 route's three products a step, the float32
// route's six part pairs (g part, f part). Issued and committed as one
// group; the caller waits.
template <int kParts>
__device__ __forceinline__ void issue_dweight(float (&acc)[32],
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
}

// acc (64 positions x 64 features) += g_hi W_hi + g_hi W_mid + g_lo W_hi
// over a block's 64 channels (K) in steps of 16: g's two parts in
// registers (a), the weight slice at w read MN-major. Issued and
// committed as one group; the caller waits.
__device__ __forceinline__ void issue_dfeat(float (&acc)[32],
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
}

}  // namespace
}  // namespace mma
}  // namespace hipe
