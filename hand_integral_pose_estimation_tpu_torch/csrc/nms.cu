// Greedy NMS over score-sorted boxes, batched over images: the 64-bit
// suppression masks in one parallel launch, then one CTA per image sweeps
// them in score order.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/nms.py:
// _nms_kernel (launched by _alive_pallas_batched). That kernel walks the
// score-sorted 128-box tiles in grid order, keeping the alive vector in a
// revisited output block: it relies on a grid that runs in order. Here the
// shape is the reference's GPU one (lib/model_rcnn/csrc/cuda/nms.cu:23-131):
//   * launch A (mask): one CTA per (column block of 64, row block of 64,
//     image) with column block >= row block. Each thread owns one row box
//     and sets bit j of its word iff column box j comes later in score
//     order and their IoU is above the threshold; the column boxes sit in
//     shared memory. Mask (B, N, ceil(N / 64)) uint64.
//   * launch B (sweep): one CTA per image keeps a `removed` bitmask in
//     shared memory, initialised with the boxes that are dead from the
//     start, and walks the 64-box blocks in order: thread 0 resolves the
//     block greedily from its diagonal words, then every thread ORs the
//     kept rows' words into the later words of `removed`. The sweep stops
//     once `stop_after` boxes are kept (exact: later survivors rank past
//     them). The reference does this sweep on the host, which costs a
//     synchronisation and a device-to-host copy per call.
//
// Bound: operations, and few of them: at the RPN shape (4 images x 6000
// boxes) 72 M IoU tests and an 18 MB mask written once and read in part.
// The sweep is a serial chain of one step per 64-box block per image, so
// its time is latency, not throughput.
//
// The IoU is the plain version's, inter / max(union, 1e-12) > thr with the
// +1 widths of the reference (box_iou in ops/nms.py), formed with
// round-to-nearest intrinsics in the same order so that no multiply-add is
// contracted: the keep sets are bitwise those of the plain version.

#include <cuda_runtime.h>

namespace hipe {
namespace {

constexpr int kBits = 64;
constexpr int kSweepThreads = 128;
constexpr int kUnroll = 8;

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

__global__ void __launch_bounds__(kBits)
    nms_mask_kernel(const float* __restrict__ boxes, int n, int col_blocks,
                    float thr, float off,
                    unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (row_block > col_block) return;
  const long long img = blockIdx.z;
  const int row_size = min(n - row_block * kBits, kBits);
  const int col_size = min(n - col_block * kBits, kBits);
  const float* bx = boxes + img * n * 4;

  __shared__ float cols[kBits * 4];
  if (threadIdx.x < col_size) {
    const float* src = bx + (long long)(col_block * kBits + threadIdx.x) * 4;
    for (int k = 0; k < 4; ++k) cols[threadIdx.x * 4 + k] = src[k];
  }
  __syncthreads();
  if (threadIdx.x >= row_size) return;

  const int i = row_block * kBits + threadIdx.x;
  float a[4];
  for (int k = 0; k < 4; ++k) a[k] = bx[(long long)i * 4 + k];
  unsigned long long bits = 0;
  const int start = row_block == col_block ? threadIdx.x + 1 : 0;
  for (int j = start; j < col_size; ++j) {
    if (iou_above(a, cols + j * 4, off, thr)) bits |= 1ULL << j;
  }
  mask[(img * n + i) * col_blocks + col_block] = bits;
}

__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                     const unsigned char* __restrict__ alive0, int n,
                     int col_blocks, int stop_after,
                     unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;             // col_blocks words
  unsigned long long* diag = smem + col_blocks;   // kBits words
  __shared__ unsigned long long kept_bits;
  __shared__ int kept_total;

  const long long img = blockIdx.x;
  const unsigned char* a0 = alive0 + img * n;
  unsigned char* kp = keep + img * n;
  const unsigned long long* m = mask + img * n * col_blocks;

  // dead from the start (score at or below the threshold) and the bits
  // past n count as removed
  for (int w = threadIdx.x; w < col_blocks; w += blockDim.x) {
    unsigned long long dead = 0;
    for (int b = 0; b < kBits; ++b) {
      const int i = w * kBits + b;
      if (i >= n || !a0[i]) dead |= 1ULL << b;
    }
    removed[w] = dead;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) kp[i] = 0;
  if (threadIdx.x == 0) kept_total = 0;
  __syncthreads();

  for (int w = 0; w < col_blocks; ++w) {
    if (kept_total >= stop_after) break;  // uniform: read after a barrier
    const int rows = min(n - w * kBits, kBits);
    if (threadIdx.x < rows) {
      diag[threadIdx.x] = m[(long long)(w * kBits + threadIdx.x) * col_blocks
                            + w];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long rem = removed[w];
      unsigned long long kb = 0;
      int total = kept_total;
      for (int b = 0; b < rows && total < stop_after; ++b) {
        if (!((rem >> b) & 1ULL)) {
          kb |= 1ULL << b;
          rem |= diag[b];
          ++total;
        }
      }
      kept_bits = kb;
      kept_total = total;
    }
    __syncthreads();
    const unsigned long long kb = kept_bits;
    if (threadIdx.x < rows && ((kb >> threadIdx.x) & 1ULL)) {
      kp[w * kBits + threadIdx.x] = 1;
    }
    // the kept rows' words are independent loads: issue them kUnroll at a
    // time so their latencies overlap
    for (int c = w + 1 + threadIdx.x; c < col_blocks; c += blockDim.x) {
      unsigned long long acc = removed[c];
      unsigned long long rest = kb;
      while (rest) {
        unsigned long long v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = 0;
          if (rest) {
            const int b = __ffsll(static_cast<long long>(rest)) - 1;
            rest &= rest - 1;
            v[u] = m[(long long)(w * kBits + b) * col_blocks + c];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc |= v[u];
      }
      removed[c] = acc;
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace hipe

// boxes (B, N, 4) float32 sorted by descending score, alive (B, N) uint8,
// mask (B, N, ceil(N / 64)) 64-bit scratch and keep (B, N) uint8, all
// contiguous and allocated by the caller; (ceil(N / 64) + 64) * 8 bytes of
// shared memory must fit 48 KB. keep[b, i] = 1 iff box i is among the
// first `stop_after` greedy survivors of image b. Returns the first launch
// error.
extern "C" int hipe_nms(const void* boxes, const void* alive, void* mask,
                        void* keep, int batch, int n, float iou_threshold,
                        int plus_one, int stop_after, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + hipe::kBits - 1) / hipe::kBits;
  auto* m = static_cast<unsigned long long*>(mask);
  hipe::nms_mask_kernel<<<dim3(col_blocks, col_blocks, batch), hipe::kBits,
                          0, st>>>(static_cast<const float*>(boxes), n,
                                   col_blocks, iou_threshold,
                                   plus_one ? 1.f : 0.f, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)(col_blocks + hipe::kBits) *
                      sizeof(unsigned long long);
  hipe::nms_sweep_kernel<<<batch, hipe::kSweepThreads, smem, st>>>(
      m, static_cast<const unsigned char*>(alive), n, col_blocks, stop_after,
      static_cast<unsigned char*>(keep));
  return static_cast<int>(cudaGetLastError());
}
