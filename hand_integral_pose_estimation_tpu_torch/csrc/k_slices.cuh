// The fused head's tensor-core kernels for F wider than the resident
// kernels take (F > kResidentBlocks x 64 = 256; kernels 3, 3f, 4 and 4f):
// they walk K = F in slices of 64 features instead of keeping a channel
// block's weight planes at the whole F in shared memory. They replace the
// TPU kernels hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _fwd_kernel and _bwd_kernel (ops/fused_head.py:106) at those widths.
//
// A slice is 64 rows x 64 columns in core-matrix layout (kpad 64).
//
// Both directions take their operands from (s2), which lays features and
// weight out slice by slice (`hp_split_slices_kernel`, layout
// `SlicePlanes`), so that one bulk copy (cp.async.bulk, completing on an
// mbarrier) moves a slice, and feed the slices through a ring of stages
// guarded by mbarriers (`Ring`): the last warp done with a stage issues
// the copy of the item it holds next, so no warp waits for a free stage
// and no thread waits to issue copies; the warps wait only for the stage
// they read. Each slice's logits go to an accumulator of their own
// (`issue_logits`), added to the logits by float32 adds.
//
// The forward (kernel 3 and 3f, hp_fwd_ring_kernel in
// head_projection_integral_mma.cu): one CTA per (image, chunk of
// 64-position tiles, block of 64 channels), two warpgroups; a ring item
// is a slice of a round, the block's weight slice and the round's feature
// slices, read by both warpgroups. With bf16 features a warpgroup takes
// two tiles a round, its products N = 128 wide (m64n128k16, the weight
// slice A, the two tiles' slices side by side B), so each weight slice is
// read from L2 once per four tiles; with float32 features one tile (the
// six part pairs at N = 64: a stage of four tiles' three planes would
// leave no room for a ring), once per two. Copies that move nothing make
// it 7-8 % faster at F = 512: the products and the skeleton around them
// hold it back, not the bytes.
//
// The backward (kernel 4 and 4f, head_projection_integral_bwd_mma.cu) is
// bound by its products: the logits (3 bf16 products, 6 with float32
// features), then dfeat = g . W and dW = g^T f (3 each; 6 for dW with
// float32 features), against the 3 of the recorded bound. Its kernels
// split F, not positions, between the CTA's two warpgroups: each forms the
// logits over its half of K and adds its products into its half of the N
// = F columns, in a 64 x F / 2 float32 accumulator in registers (passes of
// 512 features past F = 512); the two partial logits are added through
// shared memory in a fixed order, so that the logits and g are formed once
// a tile and channel block; each warpgroup keeps one product group of
// dfeat or dW in flight while the next slice's is issued. What holds them
// back is not the bytes (copies that move nothing make them less than an
// eighth faster: scripts/fused_head_bwd_probe.py, PERF.md) but the
// products' issue: N = 64 at most (a slice; the logits' 64 positions or
// channels), each slice's logits waited for before the next are issued
// (one accumulator a slice, for accuracy; a second one in turns let ptxas
// serialise the products, C7514), and the two warpgroups' exchange of the
// partial logits and g's arithmetic, duplicated in both, once a round.
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

// xs = one slice's logits, channels x positions (kChannelRows: the weight
// slice is A, M = 64 channels, the feature slice B, kN = 64 or 128
// positions) or positions x channels (kN = 64). kParts 1: the bf16
// features times the weight's three planes; kParts 3: the six part pairs
// of f32_planes.cuh. The slice's products go to xs, which its first
// product writes; the caller waits for them and adds xs to the logits by
// ordinary float32 additions: a wgmma adds into its accumulator with an
// error of about 2^-23 of it, so an accumulator carried across every
// slice would gather one such error a product group, more the wider F (at
// F = 2048, 8 times F = 256's: the coords missed 1e-4 on an H100); a
// slice's 12 or 24 groups stay as few as at F <= 256, and the slices' sums
// add with one rounding each. Both operands K-major at shared addresses w
// and f (kN = 128: the two 64-row slices at f one after the other, 8 KB
// apart, as one 128-row operand). Issues and commits the slice's products
// as one group.
template <int kParts, bool kChannelRows, int kN = 64>
__device__ __forceinline__ void issue_logits(float (&xs)[kN / 2], uint32_t w,
                                             uint32_t f) {
  static_assert(kN == 64 || (kN == 128 && kParts == 1 && kChannelRows),
                "N = 128 takes bf16 features as B");
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kSlice; k += 16)
#pragma unroll
    for (int q = 0; q < (kParts == 1 ? 3 : kPairs); ++q) {
      const uint32_t wq =
          w + (kParts == 1 ? q : pair_second(q)) * kSlicePlaneBytes + k * 16;
      const uint32_t fq =
          f + (kParts == 1 ? 0 : pair_first(q)) * kSlicePlaneBytes + k * 16;
      const uint64_t a = core_desc(kChannelRows ? wq : fq, kSlice);
      const uint64_t b = core_desc(kChannelRows ? fq : wq, kSlice);
      if constexpr (kN == 128) {
        wgmma_64x128x16(xs, a, b, k > 0 || q > 0);
      } else {
        wgmma_64x64x16(xs, a, b, k > 0 || q > 0);
      }
    }
  wgmma_commit();
}

// ---- the rings (F > 256)

// Slices of a pass of the backward's N = F products (f32_planes.cuh) that a
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

// The ring's stages that fit beside `head` bytes of shared memory.
inline int ring_stages(size_t head, size_t stage_bytes) {
  const size_t fit = (kSmemLimit - head) / stage_bytes;
  return fit < kMaxStages ? (int)fit : kMaxStages;
}
// named barrier over a ring CTA's two warpgroups (group_sync takes 1, 2)
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
// landed there (one arrival and their bytes). done[s] counts the warps
// that have read it (`warps`: the consuming warpgroup's four, or both
// warpgroups' eight where both read every item): the last of them refills
// the stage with the item `stages` later, so no warp waits for a free
// stage and no thread waits to issue copies.
struct Ring {
  __nv_bfloat16* base;
  int stage_elems, stages, items;
  uint64_t* full;
  int* done;
  int warps = kGroupThreads / 32;

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
  // that read the stage have completed); the last of the `warps` to be
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
      if (before == warps - 1) {
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
