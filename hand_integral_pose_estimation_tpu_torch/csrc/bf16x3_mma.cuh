// Device code shared by the tensor-core fused-head kernels
// (head_projection_integral_mma.cu, head_projection_integral_bwd_mma.cu):
// the bf16 split of a float32 operand, cp.async staging into core-matrix
// tiles, register operands read from such tiles (ldmatrix), and Hopper's
// warpgroup product (wgmma) with float32 accumulation.
//
// The split. A float32 x is the exact sum of three bf16 parts
//   hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
// (each difference is exact in float32, and 3 x 8 bits cover the 24-bit
// significand), so f . x = f . hi + f . mid + f . lo for bf16 f: three bf16
// products accumulated in float32 give the float32 product. Two parts
// (hi, mid) keep 16 bits, enough where the other operand is split too.
//
// Tiles. An R x kpad tile (kpad: F rounded up to a multiple of 64, which
// split_weight's 8-chunk swizzle and the 64-wide products along F need;
// or 64, one slice of F, in the kernels that walk F in slices) is stored
// as 8 x 8 core matrices of 128 contiguous bytes (8 rows of 16 bytes):
// (r, k) at element (r / 8) * 8 kpad + (k / 8) * 64 + (r % 8) * 8 + k % 8,
// wgmma's layout without swizzle. Read K-major (K along the 16-byte rows)
// the core matrices are 128 bytes apart along K and 16 kpad bytes apart
// along the rows; read MN-major, as the B operand of a product whose K
// runs along the tile's rows, the same two strides swap roles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hipe {
namespace mma {

// blocks of 64 channels, tiles of 64 positions, warpgroups of 128 threads
constexpr int kBlockC = 64;
constexpr int kTileP = 64;
constexpr int kGroupThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

__device__ __forceinline__ void split2(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

__device__ __forceinline__ int core_offset(int r, int k, int kpad) {
  return (r >> 3) * (kpad * 8) + (k >> 3) * 64 + (r & 7) * 8 + (k & 7);
}

// ---- asynchronous copies and barriers

// cp.async of kBytes (4, 8 or 16) from global to shared memory; valid
// false fills the destination with zeros.
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int src_bytes = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Barrier over the kGroupThreads threads of warpgroup `group` (ids 1, 2,
// ...; 0 is __syncthreads), so warpgroups can walk tiles independently.
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kGroupThreads));
}

// Order this thread's earlier shared-memory writes (stores, cp.async)
// before later reads by the tensor cores' asynchronous proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- staging

// fetch_weight where F % 4 != 0: one 4-byte copy a float, the last
// chunk's columns past F zero-filled. Not inlined, so that the loops that
// fetch a block of the weight at each step keep only the 16-byte path.
static __device__ __noinline__ void fetch_weight_ragged(
    const float* __restrict__ weight, int channels, int num_feats, int kpad,
    int c0, float* raw) {
  for (int j = threadIdx.x >> 3; j < (num_feats + 3) / 4;
       j += blockDim.x >> 3)
    for (int r = threadIdx.x & 7; r < kBlockC; r += 8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = c0 + r < channels && 4 * j + e < num_feats;
        cp_async<4>(smem_addr(raw + r * kpad + 4 * (j ^ (r & 7)) + e),
                    weight + (valid ? (long long)(c0 + r) * num_feats +
                                          4 * j + e
                                    : 0),
                    valid);
      }
}

// Copy weight rows c0 .. c0 + kBlockC - 1 (float32, (C, F) row-major) into
// `raw` (kBlockC rows of kpad floats), row r's 16-byte chunk j at chunk
// j ^ (r % 8), so that split_weight's reads of eight rows at one chunk hit
// eight bank groups; rows past C are zero-filled, columns past F are left
// alone. 16-byte copies where F % 4 == 0 (rows 16-byte aligned), else
// fetch_weight_ragged. The caller commits the copies.
__device__ __forceinline__ void fetch_weight(const float* __restrict__ weight,
                                             int channels, int num_feats,
                                             int kpad, int c0, float* raw) {
  if (num_feats % 4 != 0) {
    fetch_weight_ragged(weight, channels, num_feats, kpad, c0, raw);
    return;
  }
  for (int j = threadIdx.x >> 3; j < num_feats / 4; j += blockDim.x >> 3)
    for (int r = threadIdx.x & 7; r < kBlockC; r += 8) {
      const bool valid = c0 + r < channels;
      cp_async<16>(smem_addr(raw + r * kpad + 4 * (j ^ (r & 7))),
                   weight + (long long)(valid ? c0 + r : 0) * num_feats +
                       4 * j,
                   valid);
    }
}

// Split the fetched block into three core-matrix bf16 planes of kBlockC
// rows (hi, mid, lo; hi and mid are also the two-part split), zero past F.
__device__ __forceinline__ void split_weight(const float* raw, int num_feats,
                                             int kpad,
                                             __nv_bfloat16* planes) {
  for (int j = threadIdx.x >> 3; j < kpad / 4; j += blockDim.x >> 3)
    for (int r = threadIdx.x & 7; r < kBlockC; r += 8) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * j < num_feats)
        v = *reinterpret_cast<const float4*>(raw + r * kpad +
                                             4 * (j ^ (r & 7)));
      const float x[4] = {v.x, v.y, v.z, v.w};
      __nv_bfloat16 part[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split3(x[i], part[0][i], part[1][i], part[2][i]);
      const int o = core_offset(r, 4 * j, kpad);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(planes + p * kBlockC * kpad + o) =
            make_uint2(pack(part[p][0], part[p][1]),
                       pack(part[p][2], part[p][3]));
    }
}

// Stage weight block c0 into the planes once, through `raw` (scratch of
// kBlockC * kpad floats that the caller uses for something else later).
// Every thread of the CTA calls it.
__device__ __forceinline__ void stage_weight(const float* __restrict__ weight,
                                             int channels, int num_feats,
                                             int kpad, int c0, float* raw,
                                             __nv_bfloat16* planes) {
  fetch_weight(weight, channels, num_feats, kpad, c0, raw);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_weight(raw, num_feats, kpad, planes);
  fence_async_smem();
  __syncthreads();
}

// Zero the columns num_feats .. kpad - 1 of `rows` rows of a tile (the
// K padding; cp.async never writes there).
__device__ __forceinline__ void zero_pad(__nv_bfloat16* tile, int rows,
                                         int num_feats, int kpad) {
  const int pad = kpad - num_feats;
  for (int idx = threadIdx.x; idx < rows * pad; idx += blockDim.x) {
    const int r = idx / pad;
    tile[core_offset(r, num_feats + idx - r * pad, kpad)] =
        __float2bfloat16_rn(0.f);
  }
}

// Issue the copies of the F columns of positions hw0 .. hw0 + kTileP - 1
// of one image's bf16 features (HW, F) into a tile with kpad columns, by
// threads tid = 0 .. nthreads - 1; rows past hw_total are zero-filled.
// kBytes is the widest copy the rows' alignment allows (F % 8 == 0: 16, F
// % 4 == 0: 8, F even: 4, else 2); 2-byte copies are plain loads and
// stores (cp.async has none), which the caller's fence_async_smem orders
// like the rest. Eight neighbouring threads fill one core matrix, with no
// division per copy.
template <int kBytes>
__device__ __forceinline__ void copy_features(
    const __nv_bfloat16* __restrict__ image, int hw0, int hw_total,
    int num_feats, int kpad, __nv_bfloat16* tile, int tid, int nthreads) {
  constexpr int kVec = kBytes / 2;
  for (int f = (tid >> 3) * kVec; f < num_feats; f += (nthreads >> 3) * kVec)
    for (int p = tid & 7; p < kTileP; p += 8) {
      const int hw = hw0 + p;
      const bool valid = hw < hw_total;
      const __nv_bfloat16* src =
          image + (long long)(valid ? hw : 0) * num_feats + f;
      __nv_bfloat16* dst = tile + core_offset(p, f, kpad);
      if constexpr (kBytes >= 4)
        cp_async<kBytes>(smem_addr(dst), src, valid);
      else
        *dst = valid ? *src : __float2bfloat16_rn(0.f);
    }
}

// All F columns of a tile whose padding past F zero_pad has zeroed, at the
// widest copy F allows, committed as one group.
__device__ __forceinline__ void stage_features(
    const __nv_bfloat16* __restrict__ image, int hw0, int hw_total,
    int num_feats, int kpad, __nv_bfloat16* tile, int tid, int nthreads) {
  if (num_feats % 8 == 0)
    copy_features<16>(image, hw0, hw_total, num_feats, kpad, tile, tid,
                      nthreads);
  else if (num_feats % 4 == 0)
    copy_features<8>(image, hw0, hw_total, num_feats, kpad, tile, tid,
                     nthreads);
  else if (num_feats % 2 == 0)
    copy_features<4>(image, hw0, hw_total, num_feats, kpad, tile, tid,
                     nthreads);
  else
    copy_features<2>(image, hw0, hw_total, num_feats, kpad, tile, tid,
                     nthreads);
  cp_async_commit();
}

// Store two neighbouring outputs, columns f and f + 1 of a row of F
// columns (f even): one paired store where F is even (kEven: then f < F
// implies f + 1 < F, and the pair is aligned), else one store each, in
// bounds. An epilogue picks kEven once (with_parity), not per store.
template <bool kEven>
__device__ __forceinline__ void store_pair(float* row, int f, int num_feats,
                                           float a, float b) {
  if constexpr (kEven) {
    if (f < num_feats) *reinterpret_cast<float2*>(row + f) = make_float2(a, b);
  } else {
    if (f < num_feats) row[f] = a;
    if (f + 1 < num_feats) row[f + 1] = b;
  }
}
template <bool kEven>
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int f,
                                           int num_feats, float a, float b) {
  if constexpr (kEven) {
    if (f < num_feats)
      *reinterpret_cast<__nv_bfloat162*>(row + f) = __floats2bfloat162_rn(a, b);
  } else {
    if (f < num_feats) row[f] = __float2bfloat16_rn(a);
    if (f + 1 < num_feats) row[f + 1] = __float2bfloat16_rn(b);
  }
}

// fn(std::true_type()) where F is even, else fn(std::false_type()).
template <typename Fn>
__device__ __forceinline__ void with_parity(int num_feats, Fn&& fn) {
  if (num_feats % 2 == 0)
    fn(std::true_type());
  else
    fn(std::false_type());
}

// The register operand (the mma.sync m16n8k16 A layout over warp wq's 16
// rows) of columns k0 .. k0 + 15 of a core-matrix bf16 tile at shared
// address `tile`, from each of its three planes (plane step `plane`
// bytes): a[p] is plane p's. One ldmatrix.x4 a plane, lanes 8 m .. 8 m +
// 7 addressing the rows of 8 x 8 matrix m = (rows 0-7 | 8-15) x (columns
// 0-7 | 8-15), which registers 0 .. 3 of the layout hold.
__device__ __forceinline__ void plane_fragments(uint32_t tile,
                                                uint32_t plane, int kpad,
                                                int wq, int lane, int k0,
                                                uint32_t (&a)[3][4]) {
  const int m = lane >> 3;
  const int r = 16 * wq + 8 * (m & 1) + (lane & 7);
  const uint32_t addr = tile + 2 * core_offset(r, k0 + 8 * (m >> 1), kpad);
#pragma unroll
  for (int p = 0; p < 3; ++p)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[p][0]), "=r"(a[p][1]), "=r"(a[p][2]), "=r"(a[p][3])
        : "r"(addr + p * plane));
}

// ---- wgmma

// Matrix descriptor of a no-swizzle operand at shared address `addr`:
// lbo bytes between core matrices along K, sbo bytes between them along
// M or N (base offset 0).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
// A tile read K-major.
__device__ __forceinline__ uint64_t core_desc(uint32_t addr, int kpad) {
  return make_desc(addr, 128, kpad * 16);
}
// A tile read MN-major: K along its rows, N along its 16-byte rows.
__device__ __forceinline__ uint64_t core_desc_mn(uint32_t addr, int kpad) {
  return make_desc(addr, kpad * 16, 128);
}

// d (64 x 64 float32, the warpgroup's fragment) += a . b^T for a 64 x 16
// and b 64 x 16 bf16 tiles read K-major. Warp w of the warpgroup holds
// rows 16 w + l / 4 and 16 w + l / 4 + 8 (lane l), columns 8 i + 2 (l % 4)
// + e: d[4 i + e] and d[4 i + 2 + e]. With accumulate 0, d = a . b^T (its
// old value unread).
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t a,
                                               uint64_t b,
                                               int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128 float32) += a . b^T for a 64 x 16 and b 128 x 16 bf16
// tiles read K-major: the layout of wgmma_64x64x16 over twice the
// columns, d[4 i + 2 k + e] for i < 16 (columns 64 .. 127 from d[32]).
// With accumulate 0, d = a . b^T (its old value unread).
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t a,
                                                uint64_t b,
                                                int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 float32) += a . b for a 64 x 16 bf16 fragment in registers
// (per warp the mma.sync m16n8k16 A layout over its 16 rows) and b a
// 16 x 64 tile read MN-major.
__device__ __forceinline__ void wgmma_64x64x16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32 float32: columns 8 i + 2 (l % 4) + e for i < 4) += a . b^T
// for a 64 x 16 and b 32 x 16 bf16 tiles read K-major; with accumulate 0,
// d = a . b^T (its old value unread).
__device__ __forceinline__ void wgmma_64x32x16(float (&d)[16], uint64_t a,
                                               uint64_t b,
                                               int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32 float32) += a . b^T for a 64 x 16 bf16 fragment in registers
// and b a 32 x 16 tile read K-major; with accumulate 0, d = a . b^T.
__device__ __forceinline__ void wgmma_64x32x16_rs(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b,
                                                  int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }
// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x (64 x 64) = A . B^T summed over the three weight planes: the logits.
// Both operands are tiles read K-major, one the weight planes (plane step
// kBlockC * kpad * 2 bytes), the other the features (plane step 0).
__device__ __forceinline__ void logits(float (&x)[32], uint32_t a_addr,
                                       uint32_t a_plane, uint32_t b_addr,
                                       uint32_t b_plane, int kpad) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
  fence_operands(x);
  wgmma_fence();
  for (int k = 0; k < kpad; k += 16)
#pragma unroll
    for (int p = 0; p < 3; ++p)
      wgmma_64x64x16(x, core_desc(a_addr + p * a_plane + k * 16, kpad),
                     core_desc(b_addr + p * b_plane + k * 16, kpad));
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(x);
}

}  // namespace mma
}  // namespace hipe
