// Greedy NMS over score-sorted boxes, batched over images: the 64-bit
// suppression masks in one parallel launch, then one CTA per image sweeps
// them in score order.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/nms.py:
// _nms_kernel (launched by _alive_pallas_batched). That kernel walks the
// score-sorted 128-box tiles in grid order, keeping the alive vector in a
// revisited output block: it relies on a grid that runs in order. Here the
// shape is the reference's GPU one (lib/model_rcnn/csrc/cuda/nms.cu:23-131),
// with the mask stored block-major:
//   * launch A (mask): word (i, c) holds bit j iff box 64c + j comes later
//     in score order than box i and their IoU is above the threshold. Only
//     the upper triangle (column block c >= row block of i) exists: row
//     block v stores its columns v .. C - 1 (C = ceil(N / 64)) one after
//     another, each as the 64 rows' words (512 bytes), so the words the
//     sweep needs for a row block are one contiguous span. One CTA covers
//     one row block and kGroup column blocks; a warp tests 32 rows against
//     one column block (read by broadcast) and writes 256 contiguous bytes.
//   * launch B (sweep): one CTA per image keeps the `removed` words in
//     shared memory and walks the 64-box row blocks in order. The greedy
//     chain is serial, so this launch is latency, and the design takes
//     every wait it can off the chain:
//       - a row block's span arrives in shared memory ahead of the sweep,
//         kStages deep, each by one 1-D bulk copy (TMA) completing on an
//         mbarrier; a span larger than a stage comes in column chunks;
//       - one warp resolves the block in registers: lane l holds the
//         diagonal words of rows l and l + 32, and the greedy keep set is
//         the fixpoint of  a = cand & ~OR{diag[j] : j in a}  taken with
//         two warp OR-reductions per step, from a = cand (the plain
//         version's fixpoint: it settles in one step more than the
//         longest suppression chain inside the block, at most 65);
//       - the kept rows' words are ORed into the later `removed` words
//         from shared memory, a warp per column (lanes across the rows, a
//         warp OR-reduction, no atomics), between two barriers per block
//         (plus one per further column chunk);
//       - the boxes dead from the start are ballots over coalesced loads.
//     The sweep stops once `stop_after` boxes are kept, also inside a block
//     (exact: later survivors rank past them). The reference does this
//     sweep on the host, which costs a synchronisation and a device-to-host
//     copy per call.
//
// Bound: operations, and few of them: at the RPN shape (4 images x 6000
// boxes) 72 M IoU tests and a 9 MB mask written once and read once. The
// sweep's chain of one resolve per 64-box block is outside any throughput
// bound.
//
// The IoU is the plain version's, inter / max(union, 1e-12) > thr with the
// +1 widths of the reference (box_iou in ops/nms.py), formed with
// round-to-nearest intrinsics in the same order so that no multiply-add is
// contracted: the keep sets are bitwise those of the plain version.

#include <cuda_runtime.h>

#include <cstdint>

namespace hipe {
namespace {

constexpr int kBits = 64;
constexpr int kGroup = 4;                       // column blocks per mask CTA
constexpr int kMaskThreads = kBits * kGroup;
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kStages = 4;

__device__ __forceinline__ float box_area(const float* b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), off),
                   __fadd_rn(__fsub_rn(b[3], b[1]), off));
}

__device__ __forceinline__ bool iou_above(const float* a, const float* b,
                                          float off, float thr) {
  const float ix1 = fmaxf(a[0], b[0]);
  const float iy1 = fmaxf(a[1], b[1]);
  const float ix2 = fminf(a[2], b[2]);
  const float iy2 = fminf(a[3], b[3]);
  const float iw = fmaxf(__fadd_rn(__fsub_rn(ix2, ix1), off), 0.f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(iy2, iy1), off), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      __fsub_rn(__fadd_rn(box_area(a, off), box_area(b, off)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thr;
}

// Mask CTAs of one image, in order of row block, then column group: row
// block rb has the column groups rb / kGroup .. groups - 1. Super-row q
// (row blocks q * kGroup ...) has kGroup * (groups - q) CTAs before the
// last, so the CTAs before super-row q number kGroup * (q * groups -
// q * (q - 1) / 2).
__host__ __device__ inline long long mask_ctas_before(long long q,
                                                      long long groups) {
  return kGroup * (q * groups - q * (q - 1) / 2);
}

// Words before row block rb in the block-major mask of one image (and,
// for rb = col_blocks, the image's words).
__host__ __device__ inline long long block_base(long long rb,
                                                long long col_blocks) {
  return kBits * (rb * col_blocks - rb * (rb - 1) / 2);
}

__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ boxes, int n, int col_blocks,
                    float thr, float off,
                    unsigned long long* __restrict__ mask) {
  const long long groups = (col_blocks + kGroup - 1) / kGroup;
  const long long t = blockIdx.x;
  // invert mask_ctas_before: the root of the quadratic, then exact steps
  const double b2 = 2.0 * groups + 1.0;
  long long q = (long long)((b2 - sqrt(fmax(b2 * b2 - 8.0 * t / kGroup,
                                            0.0))) / 2.0);
  q = max(0LL, min(q, groups - 1));
  while (q > 0 && mask_ctas_before(q, groups) > t) --q;
  while (q + 1 < groups && mask_ctas_before(q + 1, groups) <= t) ++q;
  const long long within = t - mask_ctas_before(q, groups);
  const int row_block = int(q * kGroup + within / (groups - q));
  const int col_group = int(q + within % (groups - q));

  const long long img = blockIdx.y;
  const float* bx = boxes + img * n * 4;
  __shared__ float4 cols[kGroup][kBits];
  {
    const int j = col_group * kGroup * kBits + threadIdx.x;
    if (j < n) {
      cols[threadIdx.x / kBits][threadIdx.x % kBits] =
          reinterpret_cast<const float4*>(bx)[j];
    }
  }
  __syncthreads();

  // a warp: 32 rows against one column block, whose boxes it reads by
  // broadcast; its words of that column are 256 contiguous bytes
  const int r = threadIdx.x % kBits;
  const int cb = col_group * kGroup + threadIdx.x / kBits;
  const int i = row_block * kBits + r;
  if (i >= n || cb < row_block || cb >= col_blocks) return;
  const float4 a4 = reinterpret_cast<const float4*>(bx)[i];
  const float a[4] = {a4.x, a4.y, a4.z, a4.w};
  const int col_size = min(n - cb * kBits, kBits);
  const float4* col = cols[threadIdx.x / kBits];
  unsigned long long bits = 0;
  for (int j = cb == row_block ? r + 1 : 0; j < col_size; ++j) {
    if (iou_above(a, reinterpret_cast<const float*>(col + j), off, thr)) {
      bits |= 1ULL << j;
    }
  }
  mask[img * block_base(col_blocks, col_blocks) +
       block_base(row_block, col_blocks) + (cb - row_block) * kBits + r] =
      bits;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Piece (block, col0) of the sweep: the columns col0 .. col0 + chunk - 1
// (at most) of row block `block`, one contiguous span of 512-byte columns.
struct Piece {
  int block;
  int col0;
};

__device__ __forceinline__ Piece next_piece(Piece p, int chunk,
                                            int col_blocks) {
  p.col0 += chunk;
  if (p.col0 >= col_blocks) {
    ++p.block;
    p.col0 = p.block;
  }
  return p;
}

// One bulk copy (TMA) of piece p into `stage`, completing on `bar`; one
// thread issues it.
__device__ __forceinline__ void stage_piece(Piece p,
                                            unsigned long long* stage,
                                            unsigned long long* bar,
                                            const unsigned long long* m,
                                            int col_blocks, int chunk) {
  const uint32_t bytes = min(chunk, col_blocks - p.col0) * kBits * 8;
  const unsigned long long* src =
      m + block_base(p.block, col_blocks) + (long long)(p.col0 - p.block) *
                                                kBits;
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(stage)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory: kStages stages of chunk x 64 words (column-major: word
// (row r, column c) at (c - col0) * 64 + r), then `removed` (col_blocks
// words), the stages' barriers, the block's kept bits and the kept count.
__global__ void __launch_bounds__(kSweepThreads, 1)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                     const unsigned char* __restrict__ alive0, int n,
                     int col_blocks, int chunk, int stop_after,
                     unsigned char* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned long long smem[];
  const int stage_words = kBits * chunk;
  unsigned long long* removed = smem + kStages * stage_words;
  unsigned long long* bars = removed + col_blocks;
  unsigned long long* kept_bits = bars + kStages;
  int* kept_total = reinterpret_cast<int*>(kept_bits + 1);

  const long long img = blockIdx.x;
  const unsigned char* a0 = alive0 + img * n;
  unsigned char* kp = keep + img * n;
  const unsigned long long* m =
      mask + img * block_base(col_blocks, col_blocks);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool producer = threadIdx.x == kSweepThreads - 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    *kept_total = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // dead from the start (score at or below the threshold), and the bits
  // past n, count as removed
  for (int w = warp; w < col_blocks; w += kSweepWarps) {
    const int i = w * kBits + lane;
    const unsigned lo = __ballot_sync(~0u, i >= n || !a0[i]);
    const unsigned hi = __ballot_sync(~0u, i + 32 >= n || !a0[i + 32]);
    if (lane == 0) removed[w] = (unsigned long long)hi << 32 | lo;
  }
  __syncthreads();

  // the producer's cursor: the next piece to stage and how many are staged
  Piece ahead = {0, 0};
  int staged = 0;
  if (producer) {
    for (; staged < kStages && ahead.block < col_blocks; ++staged) {
      stage_piece(ahead, smem + staged * stage_words, bars + staged, m,
                  col_blocks, chunk);
      ahead = next_piece(ahead, chunk, col_blocks);
    }
  }

  int piece = 0;      // pieces consumed
  int w = 0;
  for (; w < col_blocks && *kept_total < stop_after; ++w) {
    const int rows = min(n - w * kBits, kBits);
    bool stop = false;
    for (int col0 = w; col0 < col_blocks; col0 += chunk, ++piece) {
      const int s = piece % kStages;
      const unsigned long long* st = smem + s * stage_words;
      mbar_wait(bars + s, (piece / kStages) & 1);
      if (col0 == w) {
        if (warp == 0) {
          // diagonal words of rows lane and lane + 32; bit j of row i's
          // word is set only for j > i
          const unsigned long long d0 = lane < rows ? st[lane] : 0;
          const unsigned long long d1 = lane + 32 < rows ? st[lane + 32] : 0;
          const unsigned long long rows_mask =
              rows == kBits ? ~0ULL : (1ULL << rows) - 1;
          const unsigned long long cand = ~removed[w] & rows_mask;
          unsigned long long a = cand;
          while (true) {
            const unsigned long long hit = ((a >> lane) & 1 ? d0 : 0) |
                                           ((a >> (lane + 32)) & 1 ? d1 : 0);
            const unsigned long long sup =
                (unsigned long long)__reduce_or_sync(~0u, unsigned(hit >> 32))
                    << 32 |
                __reduce_or_sync(~0u, unsigned(hit));
            const unsigned long long next = cand & ~sup;
            if (next == a) break;
            a = next;
          }
          // a stop inside the block keeps its first survivors only
          const int total = *kept_total;
          while (__popcll(a) > stop_after - total) {
            a &= ~(1ULL << (63 - __clzll(a)));
          }
          if (lane < rows) kp[w * kBits + lane] = (a >> lane) & 1;
          if (lane + 32 < rows) {
            kp[w * kBits + lane + 32] = (a >> (lane + 32)) & 1;
          }
          if (lane == 0) {
            *kept_bits = a;
            *kept_total = total + __popcll(a);
          }
        }
        __syncthreads();
        if (*kept_total >= stop_after) {  // uniform: read after a barrier
          ++piece;
          stop = true;
          break;
        }
      }
      // the kept rows' words, ORed into the later words of `removed`: a
      // warp per column, lanes across the rows
      const unsigned long long kb = *kept_bits;
      if (kb) {
        const unsigned long long k0 = (kb >> lane) & 1 ? ~0ULL : 0;
        const unsigned long long k1 = (kb >> (lane + 32)) & 1 ? ~0ULL : 0;
        const int c_end = min(col0 + chunk, col_blocks);
        for (int c = max(w + 1, col0) + warp; c < c_end; c += kSweepWarps) {
          const unsigned long long* word = st + (c - col0) * kBits;
          const unsigned long long v =
              (word[lane] & k0) | (word[lane + 32] & k1);
          const unsigned hi = __reduce_or_sync(~0u, unsigned(v >> 32));
          const unsigned lo = __reduce_or_sync(~0u, unsigned(v));
          if (lane == 0) removed[c] |= (unsigned long long)hi << 32 | lo;
        }
      }
      __syncthreads();
      // the stage is free: stage the piece kStages ahead into it
      if (producer && ahead.block < col_blocks) {
        stage_piece(ahead, smem + s * stage_words, bars + s, m, col_blocks,
                    chunk);
        ahead = next_piece(ahead, chunk, col_blocks);
        ++staged;
      }
    }
    if (stop) {
      ++w;
      break;
    }
  }
  // no bulk copy may land after the CTA has left
  if (producer) {
    for (int p = piece; p < staged; ++p) {
      mbar_wait(bars + p % kStages, (p / kStages) & 1);
    }
  }
  // rows the sweep never reached are not kept
  for (int i = w * kBits + threadIdx.x; i < n; i += kSweepThreads) kp[i] = 0;
}

}  // namespace
}  // namespace hipe

// Launch B's shared memory: kStages stages of whole row-block spans when
// they fit, else of column chunks that do; returns 0 or the error.
static int sweep_chunk(int col_blocks, int* chunk, size_t* smem) {
  using hipe::kBits;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t fixed = ((size_t)col_blocks + hipe::kStages + 2) * 8;
  const size_t per_column = (size_t)hipe::kStages * kBits * 8;
  size_t c = col_blocks;
  if (fixed + c * per_column > (size_t)optin) {
    c = (optin - fixed) / per_column;
  }
  *chunk = (int)c;
  *smem = fixed + c * per_column;
  return 0;
}

// boxes (B, N, 4) float32 sorted by descending score, alive (B, N) bool or
// uint8 (0 / 1), mask B * 32 * C * (C + 1) 64-bit words of scratch
// (C = ceil(N / 64)), and keep (B, N) bool or uint8, all contiguous and
// allocated by the caller; (C + 64) * 8 bytes must fit 48 KB. keep[b, i] =
// 1 iff box i is among the first `stop_after` greedy survivors of image b.
// Returns the first launch error.
extern "C" int hipe_nms(const void* boxes, const void* alive, void* mask,
                        void* keep, int batch, int n, float iou_threshold,
                        int plus_one, int stop_after, void* stream) {
  using hipe::kBits;
  auto st = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBits - 1) / kBits;
  auto* m = static_cast<unsigned long long*>(mask);
  // the last super-row may hold fewer than kGroup row blocks, each with
  // one CTA
  const long long groups = (col_blocks + hipe::kGroup - 1) / hipe::kGroup;
  const long long mask_ctas = hipe::mask_ctas_before(groups - 1, groups) +
                              col_blocks - (groups - 1) * hipe::kGroup;
  hipe::nms_mask_kernel<<<dim3((unsigned)mask_ctas, batch),
                          hipe::kMaskThreads, 0, st>>>(
      static_cast<const float*>(boxes), n, col_blocks, iou_threshold,
      plus_one ? 1.f : 0.f, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int chunk = 0;
  size_t smem = 0;
  int rc = sweep_chunk(col_blocks, &chunk, &smem);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(hipe::nms_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hipe::nms_sweep_kernel<<<batch, hipe::kSweepThreads, smem, st>>>(
      m, static_cast<const unsigned char*>(alive), n, col_blocks, chunk,
      stop_after, static_cast<unsigned char*>(keep));
  return static_cast<int>(cudaGetLastError());
}
