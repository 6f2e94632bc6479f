// Soft-argmax (softmax integral) forward over an NHWC 3D heatmap.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/integral.py:
// _integral_kernel (driver _softmax_integral_pallas). That kernel walks the
// spatial tiles of one batch row in grid order, carrying per-channel online
// statistics in VMEM scratch, and combines channels per joint with a mask
// matmul at the last tile. A GPU grid has no order; here the rows of each
// image are cut into chunks that run side by side, and a second launch
// merges the chunks in order.
//
// Layout: heatmap (B, H*W, J*D), channel = j*D + d.
//
// Bound: device memory. The kernel reads the heatmap once and writes 5
// floats per joint: 236 MB at B = 32 in bf16 (0.070 ms at 3.35 TB/s), 472
// MB in float32.
//
// The vectorised path (J*D a multiple of 8, a 16-byte aligned base, J*D <=
// 3072), two launches behind one C entry:
//  1. partial states, one CTA per (image, chunk of its H*W rows). A thread
//     owns one 8-channel vector of the row (16 bytes of bf16, 32 of
//     float32); the CTA's threads cover whole rows, row_lanes() of them
//     side by side (about 768 threads), so at J*D = 1176 a row is 147
//     vectors, a CTA 5 x 147 threads, and it reads 5 consecutive rows, one
//     contiguous span of 12 KB in bf16, per load of each thread. Each
//     thread keeps an online state per channel (max m, sum e, sum e col,
//     sum e row) in registers and folds 32 bytes of its vector per step
//     (2 rows of bf16, 1 of float32), the next step's loads in flight
//     while it folds: it takes each channel's max over the step's rows
//     first, rescales only when the running max rises, then spends one
//     exp per element. Row and column are stepped along, never divided
//     out per row. The CTA merges its row lanes' states in lane order
//     through shared memory and writes one state per (image, chunk,
//     channel) into the caller's workspace. The chunk count comes from
//     the SM count, the batch and the CTAs an SM holds
//     (hipe_softmax_integral_fwd_chunks; one CTA per SM here), so the grid
//     fills the card at batch 32 (4 chunks, 128 CTAs) and at batch 4 (33).
//  2. merge_chunks_kernel (chunk_merge.cuh, shared with kernel 3):
//     each channel's chunks in chunk order, then the joint's channels.
// Every sum is taken in a fixed order: the same bits on every run.
//
// What holds it back: a development build with the folds taken out takes
// most of this kernel's time, so the pace is set by how fast this
// one-pass read streams, not by the exps. Two smaller CTAs per SM, deeper
// register prefetch, cp.async staging through shared memory and four rows
// per step were each no faster on the H100.
//
// The generic path (other channel counts or a misaligned base): one CTA
// per (image, joint), each warp taking whole rows with its lanes on
// neighbouring depth slots, folded into one state per thread and merged
// by the CTA (online_softmax.cuh `finish`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "chunk_merge.cuh"
#include "online_softmax.cuh"
#include "vec8.cuh"

namespace hipe {
namespace {

constexpr int kVec = 8;                // channels per thread
constexpr int kTargetThreads = 768;    // threads per CTA, about
constexpr int kMaxRowLanes = 8;        // rows side by side in a CTA
constexpr int kMaxChannels = 3072;     // 16 bytes per channel of shared memory
constexpr int kAhead = 1;              // steps in flight beside the current

// The vectorised path's CTA: row lanes and threads for `channels`; at most
// kTargetThreads (channels / 8 <= 384 vectors).
__host__ __device__ inline int row_lanes(int channels) {
  const int lanes = kTargetThreads / (channels / kVec);
  return lanes < 1 ? 1 : (lanes > kMaxRowLanes ? kMaxRowLanes : lanes);
}
inline int vec_threads(int channels) {
  return (row_lanes(channels) * (channels / kVec) + 31) / 32 * 32;
}

// Grid: batch * chunks, image-major. ws: (B, chunks, channels) float4.
template <typename T>
__global__ void __launch_bounds__(kTargetThreads, 1)
    softmax_integral_partial_kernel(const T* __restrict__ hm, int hw_total,
                                    int width, int channels, int chunks,
                                    float4* __restrict__ ws) {
  // rows a thread folds per step: 32 bytes of its vector (2 rows of bf16,
  // 1 of float32); the next kAhead steps' rows are loaded before this step
  // folds
  constexpr int K = sizeof(T) == 2 ? 2 : 1;
  extern __shared__ float4 buf[];  // one state per channel
  const int q = blockIdx.x % chunks;
  const int b = blockIdx.x / chunks;
  const int nvec = channels / kVec;
  const int lanes = row_lanes(channels);
  const int v = threadIdx.x % nvec;
  const int lane = threadIdx.x / nvec;  // >= lanes: padding, idle
  const int per_chunk = (hw_total + chunks - 1) / chunks;
  const int r_begin = min(hw_total, q * per_chunk);
  const int r_end = min(hw_total, r_begin + per_chunk);

  float m[kVec], s[kVec], sx[kVec], sy[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    m[k] = -CUDART_INF_F;
    s[k] = sx[k] = sy[k] = 0.f;
  }

  if (lane < lanes) {
    const T* base = hm + (long long)b * hw_total * channels + v * kVec;
    const int step = K * lanes;
    int hw = r_begin + lane;
    int row = hw / width, col = hw - row * width;
    const int step_row = lanes / width;
    const int step_col = lanes - step_row * width;
    // x[0]: this step's rows; x[a]: step + a's, in flight
    Vec8<T> x[kAhead + 1][K];
    const auto load_step = [&](Vec8<T>(&rows)[K], int first) {
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (first + u * lanes < r_end)
          rows[u].load(base + (long long)(first + u * lanes) * channels);
        else
          rows[u].fill_neg_inf();  // past the chunk: adds nothing
      }
    };
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      if (hw + a * step < r_end) load_step(x[a], hw + a * step);
    for (; hw < r_end; hw += step) {
      if (hw + kAhead * step < r_end)
        load_step(x[kAhead], hw + kAhead * step);
      float fx[K], fy[K];
#pragma unroll
      for (int u = 0; u < K; ++u) {
        fx[u] = float(col);
        fy[u] = float(row);
        col += step_col;
        row += step_row;
        if (col >= width) {
          col -= width;
          ++row;
        }
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        float lm = x[0][0][k];
#pragma unroll
        for (int u = 1; u < K; ++u) lm = fmaxf(lm, x[0][u][k]);
        if (lm == -CUDART_INF_F) continue;  // nothing valid
        if (lm > m[k]) {
          // m == -inf on the first fold: the scale is exp(-inf) = 0
          const float c = __expf(m[k] - lm);
          s[k] *= c;
          sx[k] *= c;
          sy[k] *= c;
          m[k] = lm;
        }
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const float e = __expf(x[0][u][k] - m[k]);  // 0 past the chunk
          s[k] += e;
          sx[k] += e * fx[u];
          sy[k] += e * fy[u];
        }
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
#pragma unroll
        for (int u = 0; u < K; ++u) x[a][u] = x[a + 1][u];
    }
  }

  // merge the row lanes into lane 0 in lane order
  for (int r = 1; r < lanes; ++r) {
    if (lane == r) {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        buf[v * kVec + k] = make_float4(m[k], s[k], sx[k], sy[k]);
    }
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float4 o = buf[v * kVec + k];
        const OnlineState st = merge(OnlineState{m[k], s[k], sx[k], sy[k], 0.f},
                                     OnlineState{o.x, o.y, o.z, o.w, 0.f});
        m[k] = st.m;
        s[k] = st.s;
        sx[k] = st.sx;
        sy[k] = st.sy;
      }
    }
    __syncthreads();
  }
  // lane 0's states out through shared memory, in contiguous stores
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      buf[v * kVec + k] = make_float4(m[k], s[k], sx[k], sy[k]);
  }
  __syncthreads();
  float4* out = ws + (long long)blockIdx.x * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) out[c] = buf[c];
}

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows in flight per warp

// The generic path. DPL: depth slots per lane, ceil(D / 32).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    softmax_integral_fwd_kernel(const T* __restrict__ hm, int num_joints,
                                int height, int width, int depth,
                                float* __restrict__ coords,
                                float* __restrict__ m_out,
                                float* __restrict__ s_out) {
  const int bj = blockIdx.x;
  const int b = bj / num_joints;
  const int j = bj - b * num_joints;
  const int hw_total = height * width;
  const long long channels = (long long)num_joints * depth;
  const T* base = hm + (long long)b * hw_total * channels + (long long)j * depth;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  OnlineState st = empty_state();
  for (int hw0 = warp; hw0 < hw_total; hw0 += nwarps * kRows) {
    float v[kRows * DPL], x[kRows * DPL], y[kRows * DPL], z[kRows * DPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int hw = hw0 + r * nwarps;
      const bool row_ok = hw < hw_total;
      const T* row = base + (long long)hw * channels;
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int d = lane + 32 * k;
        v[r * DPL + k] = (row_ok && d < depth) ? to_float(row[d]) : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int hw = hw0 + r * nwarps;
      const float row_y = float(hw / width);
      const float col_x = float(hw - (hw / width) * width);
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        x[r * DPL + k] = col_x;
        y[r * DPL + k] = row_y;
        z[r * DPL + k] = float(lane + 32 * k);
      }
    }
    fold(st, v, x, y, z);
  }
  finish(st, bj, height, width, depth, coords, m_out, s_out);
}

template <typename T>
cudaError_t launch_generic(const T* hm, float* coords, float* m, float* s,
                           int batch, int height, int width, int num_joints,
                           int depth, cudaStream_t stream) {
  const dim3 grid(batch * num_joints);
  const int dpl = (depth + 31) / 32;
  switch (dpl) {
    case 1:
      softmax_integral_fwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
          hm, num_joints, height, width, depth, coords, m, s);
      break;
    case 2:
      softmax_integral_fwd_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
          hm, num_joints, height, width, depth, coords, m, s);
      break;
    case 3:
      softmax_integral_fwd_kernel<T, 3><<<grid, kThreads, 0, stream>>>(
          hm, num_joints, height, width, depth, coords, m, s);
      break;
    default:
      softmax_integral_fwd_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
          hm, num_joints, height, width, depth, coords, m, s);
      break;
  }
  return cudaGetLastError();
}

bool vectorisable(const void* hm, int channels) {
  return channels % kVec == 0 && channels <= kMaxChannels &&
         reinterpret_cast<uintptr_t>(hm) % 16 == 0;
}

template <typename T>
cudaError_t launch_chunked(const T* hm, float* coords, float* m, float* s,
                           float* ws, int batch, int height, int width,
                           int num_joints, int depth, int chunks,
                           cudaStream_t stream) {
  const int channels = num_joints * depth;
  if (!vectorisable(hm, channels) ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return cudaErrorInvalidValue;
  float4* ws4 = reinterpret_cast<float4*>(ws);
  softmax_integral_partial_kernel<T>
      <<<batch * chunks, vec_threads(channels), channels * sizeof(float4),
         stream>>>(hm, height * width, width, channels, chunks, ws4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_chunks_kernel<<<batch * num_joints, kMergeThreads, 0, stream>>>(
      ws4, chunks, num_joints, height, width, depth, coords, m, s);
  return cudaGetLastError();
}

// The first launch's CTA slots on `device`: its SMs x the CTAs one SM
// holds at once (occupancy calculator), once per (device, dtype,
// channels).
cudaError_t cta_slots(int device, int dtype, int channels, int* slots) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> known;
  const auto key = std::make_tuple(device, dtype, channels);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *slots = it->second;
    return cudaSuccess;
  }
  int current = 0, sms = 0, ctas = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = vec_threads(channels);
  const size_t smem = channels * sizeof(float4);
  if (err == cudaSuccess)
    err = dtype == 0
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &ctas, softmax_integral_partial_kernel<float>, threads,
                    smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &ctas, softmax_integral_partial_kernel<__nv_bfloat16>,
                    threads, smem);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  if (err != cudaSuccess) return err;
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  *slots = known[key] = sms * ctas;
  return cudaSuccess;
}

}  // namespace
}  // namespace hipe

// dtype: 0 = float32, 1 = bfloat16. chunks > 0 takes the vectorised path,
// whose workspace ws holds batch * chunks * J*D float4 states; it refuses
// (cudaErrorInvalidValue) a heatmap the path does not take. chunks = 0
// takes the generic path and ignores ws. The caller guarantees
// contiguity, 1 <= depth <= 128 and a non-empty grid. Returns
// cudaGetLastError() after the launches.
extern "C" int hipe_softmax_integral_fwd(const void* hm, int dtype,
                                         void* coords, void* m, void* s,
                                         void* ws, int batch, int height,
                                         int width, int num_joints, int depth,
                                         int chunks, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(coords);
  auto mm = static_cast<float*>(m);
  auto ss = static_cast<float*>(s);
  auto w = static_cast<float*>(ws);
  if (dtype == 0) {
    auto h = static_cast<const float*>(hm);
    return static_cast<int>(
        chunks > 0 ? hipe::launch_chunked(h, c, mm, ss, w, batch, height,
                                          width, num_joints, depth, chunks, st)
                   : hipe::launch_generic(h, c, mm, ss, batch, height, width,
                                          num_joints, depth, st));
  }
  if (dtype == 1) {
    auto h = static_cast<const __nv_bfloat16*>(hm);
    return static_cast<int>(
        chunks > 0 ? hipe::launch_chunked(h, c, mm, ss, w, batch, height,
                                          width, num_joints, depth, chunks, st)
                   : hipe::launch_generic(h, c, mm, ss, batch, height, width,
                                          num_joints, depth, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The chunks per image of the vectorised path for a heatmap at `hm` of
// (batch, rows, channels) in `dtype` on CUDA device `device`, or 0 where
// it takes the generic path (channels not a multiple of 8 or above 3072,
// a base off 16 bytes). The grid has one CTA per (image, chunk): the
// count that least waves over the device's CTA slots (SMs x the CTAs an
// SM holds, from the occupancy calculator) x (rows per chunk + a chunk's
// state traffic in rows) take, so the last wave is nearly full at any
// batch. The smallest such count wins, so no chunk is left empty.
// Launches nothing.
extern "C" int hipe_softmax_integral_fwd_chunks(const void* hm, int dtype,
                                                int batch, int rows,
                                                int channels, int device,
                                                int* chunks) {
  *chunks = 0;
  if ((dtype != 0 && dtype != 1) || batch < 1 || rows < 1 || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!hipe::vectorisable(hm, channels)) return 0;
  int slots = 0;
  const cudaError_t err = hipe::cta_slots(device, dtype, channels, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a chunk's states, written and read back (2 x 16 bytes per channel)
  const long long overhead = dtype == 0 ? 8 : 16;
  long long best_cost = -1;
  for (long long c = 1; c <= rows && c <= slots; ++c) {
    const long long waves = (batch * c + slots - 1) / slots;
    const long long cost = waves * ((rows + c - 1) / c + overhead);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      *chunks = static_cast<int>(c);
    }
  }
  return 0;
}

extern "C" const char* hipe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
