// Fused 1x1 heatmap projection + soft-argmax backward: the heatmap and its
// gradient never reach device memory. This file holds the CUDA-core path,
// taken for float32 features (compute_dtype="float32"), the C entry point
// and the shared sum (c); bf16 features take the tensor-core kernels of
// head_projection_integral_bwd_mma.cu.
//
// Replaces the TPU kernel hand_integral_pose_estimation_tpu/ops/fused_head.py:
// _bwd_kernel (launched by _hp_bwd). Per spatial tile it recomputes the
// logits x = feats @ W^T + b, forms the soft-argmax cotangent
//   g[hw, c] = exp(x - m_c) * (T_c + A_c * col + B_c * row)
// (the constants as in softmax_integral_bwd.cu, formed by the wrapper) and
// contracts it at once: dfeat = g @ W, dW = sum g^T feats, db = sum g.
// The TPU kernel sums dW and db in its output blocks across the whole grid,
// legal only because the TPU runs the grid in order. Here CTAs run in any
// order, so the work is split into three launches, and every sum is taken
// in a fixed order: the result is the same bits from run to run.
//
//   (a) dfeat: one CTA per (image b, tile of 64 positions). It stages the
//       feature tile once, then for each joint j stages j's D weight rows,
//       recomputes j's 64 x D logits and cotangents and adds g @ W_j into
//       a 64 x F accumulator held in registers.
//   (b) dW, db partials: one CTA per (chunk of one image's tiles, joint j).
//       It stages j's weight rows once, then for each tile recomputes the
//       cotangents and adds g^T @ feats into a D x F accumulator held in
//       registers; it writes the chunk's partial sums to a workspace.
//   (c) a reduction adds the chunks' partials in chunk order.
//
// Layout: feats and dfeat (B, H*W, F) in the features' dtype; weight
// (J*D, F) float32 (the final 1x1 conv's weight viewed as a matrix), bias
// (J*D,); the constants (B, J*D) float32; dW (J*D, F) and db (J*D,)
// float32; workspace (chunks, J*D, F) and (chunks, J*D) float32.
//
// Bound: arithmetic. (a) and (b) each recompute the projection, so the
// kernel does 4 * 2 * B * H*W * F * J*D flops (241 GFLOP at B = 32) on
// CUDA cores in float32.
// Shared memory per CTA: the feature tile [F][65], the joint's weight rows
// [D8][F], the cotangent tile [D8][64] and five constant rows, 140 KB at
// F = 256, D = 56 (D8 is D rounded up to 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "online_softmax.cuh"

namespace hipe {
namespace {

constexpr int kTile = 64;               // spatial positions per tile
// even, so two neighbouring positions load as one aligned 8-byte access;
// 8-byte loads across 16 features then touch 32 distinct banks
constexpr int kTileStride = kTile + 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFeatGroups = 2;       // (a): F <= 4 * 32 * 2 = 256
constexpr int kMaxFeatPerLane = 8;      // (b): F <= 32 * 8 = 256

struct Smem {
  float* f;  // [F][kTileStride] feature tile, transposed
  float* w;  // [dpad][F] joint's weight rows, zero rows past depth
  float* g;  // [dpad][kTile] cotangent tile
  float* v;  // [5][dpad] bias, m, T, A, B of the joint
};

__device__ __forceinline__ Smem carve(float4* base, int num_feats,
                                      int dpad) {
  Smem s;
  s.f = reinterpret_cast<float*>(base);
  s.w = s.f + num_feats * kTileStride;
  s.g = s.w + dpad * num_feats;
  s.v = s.g + dpad * kTile;
  return s;
}

template <typename T>
__device__ __forceinline__ void stage_features(const T* __restrict__ fb,
                                               float* __restrict__ f_s,
                                               int hw0, int hw_total,
                                               int num_feats) {
  for (int idx = threadIdx.x; idx < kTile * num_feats; idx += blockDim.x) {
    const int p = idx / num_feats;
    const int f = idx - p * num_feats;
    const int hw = hw0 + p;
    f_s[f * kTileStride + p] =
        hw < hw_total ? to_float(fb[(long long)hw * num_feats + f]) : 0.f;
  }
}

// Joint j's weight rows and its five constant rows for image b.
__device__ __forceinline__ void stage_joint(
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mvec, const float* __restrict__ tvec,
    const float* __restrict__ avec, const float* __restrict__ bvec,
    const Smem& s, int b, int j, int num_joints, int num_feats, int depth,
    int dpad) {
  const long long channels = (long long)num_joints * depth;
  for (int idx = threadIdx.x; idx < dpad * num_feats; idx += blockDim.x) {
    const int d = idx / num_feats;
    s.w[idx] = d < depth ? weight[((long long)j * depth) * num_feats + idx]
                         : 0.f;
  }
  for (int d = threadIdx.x; d < dpad; d += blockDim.x) {
    const bool ok = d < depth;
    const long long c = (long long)j * depth + d;
    const long long bc = (long long)b * channels + c;
    s.v[d] = ok ? bias[c] : 0.f;
    s.v[dpad + d] = ok ? mvec[bc] : 0.f;
    s.v[2 * dpad + d] = ok ? tvec[bc] : 0.f;
    s.v[3 * dpad + d] = ok ? avec[bc] : 0.f;
    s.v[4 * dpad + d] = ok ? bvec[bc] : 0.f;
  }
}

// g[d][p] for the staged joint at positions hw0 + p: each warp takes
// groups of 8 depth slots, each lane positions lane and lane + 32, and
// forms the logits with float32 FMAs over f in ascending order, as the
// forward kernel does. Slots past the volume get 0.
__device__ __forceinline__ void tile_cotangent(const Smem& s, int num_feats,
                                               int depth, int dpad, int hw0,
                                               int hw_total, int width) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* bias_s = s.v;
  const float* m_s = s.v + dpad;
  const float* t_s = s.v + 2 * dpad;
  const float* a_s = s.v + 3 * dpad;
  const float* b_s = s.v + 4 * dpad;
  for (int dg = warp; dg < dpad / 8; dg += kWarps) {
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
    for (int f0 = 0; f0 < num_feats; f0 += 4) {
      float a[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[0][q] = s.f[(f0 + q) * kTileStride + lane];
        a[1][q] = s.f[(f0 + q) * kTileStride + lane + 32];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            s.w + (dg * 8 + k) * num_feats + f0);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0][k] = fmaf(a[0][q], w[q], acc[0][k]);
          acc[1][k] = fmaf(a[1][q], w[q], acc[1][k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = lane + 32 * i;
      const int hw = hw0 + p;
      const float row = float(hw / width);
      const float col = float(hw - (hw / width) * width);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = dg * 8 + k;
        float g = 0.f;
        if (hw < hw_total && d < depth) {
          const float x = acc[i][k] + bias_s[d];
          g = expf(x - m_s[d]) * (t_s[d] + a_s[d] * col + b_s[d] * row);
        }
        s.g[d * kTile + p] = g;
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// (a) dfeat. Thread (warp, lane) owns positions warp * 8 + r (r < 8) and
// feature groups fg = lane + 32 * i of 4 consecutive features.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hp_bwd_dfeat_kernel(const T* __restrict__ feats,
                        const float* __restrict__ weight,
                        const float* __restrict__ bias,
                        const float* __restrict__ mvec,
                        const float* __restrict__ tvec,
                        const float* __restrict__ avec,
                        const float* __restrict__ bvec,
                        T* __restrict__ dfeat, int hw_total, int width,
                        int num_feats, int num_joints, int depth, int dpad) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(smem4, num_feats, dpad);
  const int b = blockIdx.y;
  const int hw0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ngroups = num_feats / 4;
  const long long image = (long long)b * hw_total * num_feats;

  stage_features(feats + image, s.f, hw0, hw_total, num_feats);
  float acc[8][kMaxFeatGroups][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < kMaxFeatGroups; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][i][q] = 0.f;

  for (int j = 0; j < num_joints; ++j) {
    __syncthreads();  // the previous joint's rows and cotangents are used
    stage_joint(weight, bias, mvec, tvec, avec, bvec, s, b, j, num_joints,
                num_feats, depth, dpad);
    __syncthreads();
    tile_cotangent(s, num_feats, depth, dpad, hw0, hw_total, width);
    __syncthreads();
    for (int d = 0; d < depth; ++d) {
      const float4 g0 =
          *reinterpret_cast<const float4*>(s.g + d * kTile + warp * 8);
      const float4 g1 =
          *reinterpret_cast<const float4*>(s.g + d * kTile + warp * 8 + 4);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < kMaxFeatGroups; ++i) {
        const int fg = lane + 32 * i;
        if (fg >= ngroups) continue;
        const float4 w4 =
            *reinterpret_cast<const float4*>(s.w + d * num_feats + 4 * fg);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][i][q] = fmaf(gv[r], w[q], acc[r][i][q]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int hw = hw0 + warp * 8 + r;
    if (hw >= hw_total) continue;
#pragma unroll
    for (int i = 0; i < kMaxFeatGroups; ++i) {
      const int fg = lane + 32 * i;
      if (fg < ngroups)
        store4(dfeat + image + (long long)hw * num_feats + 4 * fg, acc[r][i]);
    }
  }
}

// (b) partial dW and db of one chunk of image b's tiles for joint j.
// Thread (warp, lane) owns depth slots warp + 8 * k (k < KD) and features
// lane + 32 * i.
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
    hp_bwd_dweight_kernel(const T* __restrict__ feats,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias,
                          const float* __restrict__ mvec,
                          const float* __restrict__ tvec,
                          const float* __restrict__ avec,
                          const float* __restrict__ bvec,
                          float* __restrict__ ws, float* __restrict__ ws_db,
                          int hw_total, int width, int num_feats,
                          int num_joints, int depth, int dpad,
                          int chunks_per_image) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(smem4, num_feats, dpad);
  const int chunk = blockIdx.x;
  const int b = chunk / chunks_per_image;
  const int q = chunk - b * chunks_per_image;
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (hw_total + kTile - 1) / kTile;
  const int per_chunk = (tiles + chunks_per_image - 1) / chunks_per_image;
  const int t_end = min(tiles, (q + 1) * per_chunk);
  const long long image = (long long)b * hw_total * num_feats;

  stage_joint(weight, bias, mvec, tvec, avec, bvec, s, b, j, num_joints,
              num_feats, depth, dpad);
  float acc[KD][kMaxFeatPerLane];
  float dbacc[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    dbacc[k] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxFeatPerLane; ++i) acc[k][i] = 0.f;
  }

  for (int t = q * per_chunk; t < t_end; ++t) {
    const int hw0 = t * kTile;
    __syncthreads();  // the previous tile's features and cotangents are used
    stage_features(feats + image, s.f, hw0, hw_total, num_feats);
    __syncthreads();
    tile_cotangent(s, num_feats, depth, dpad, hw0, hw_total, width);
    __syncthreads();
    for (int p = 0; p < kTile; p += 2) {  // positions p and p + 1
      float2 fv[kMaxFeatPerLane];
#pragma unroll
      for (int i = 0; i < kMaxFeatPerLane; ++i) {
        const int f = lane + 32 * i;
        fv[i] = f < num_feats ? *reinterpret_cast<const float2*>(
                                    s.f + f * kTileStride + p)
                              : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const int d = warp + kWarps * k;
        if (d >= depth) continue;
        const float2 gd =
            *reinterpret_cast<const float2*>(s.g + d * kTile + p);
#pragma unroll
        for (int i = 0; i < kMaxFeatPerLane; ++i) {
          acc[k][i] = fmaf(gd.x, fv[i].x, acc[k][i]);
          acc[k][i] = fmaf(gd.y, fv[i].y, acc[k][i]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      const int d = warp + kWarps * k;
      if (d < depth)
        dbacc[k] += s.g[d * kTile + lane] + s.g[d * kTile + lane + 32];
    }
  }

  const long long channels = (long long)num_joints * depth;
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    const int d = warp + kWarps * k;
    if (d >= depth) continue;  // warp-uniform: the shuffles stay converged
    const long long row =
        (long long)chunk * channels + (long long)j * depth + d;
#pragma unroll
    for (int i = 0; i < kMaxFeatPerLane; ++i) {
      const int f = lane + 32 * i;
      if (f < num_feats) ws[row * num_feats + f] = acc[k][i];
    }
    float v = dbacc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) ws_db[row] = v;
  }
}

// (c) dW = sum over chunks of ws, db = sum over chunks of ws_db, each
// element's chunks added in chunk order.
__global__ void __launch_bounds__(kThreads)
    hp_bwd_reduce_kernel(const float* __restrict__ ws,
                         const float* __restrict__ ws_db,
                         float* __restrict__ dweight,
                         float* __restrict__ dbias, int chunks,
                         long long channels, int num_feats) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = channels * num_feats;
  if (idx < n) {
    float acc = 0.f;
    for (int k = 0; k < chunks; ++k) acc += ws[(long long)k * n + idx];
    dweight[idx] = acc;
  } else if (idx < n + channels) {
    const long long c = idx - n;
    float acc = 0.f;
    for (int k = 0; k < chunks; ++k) acc += ws_db[(long long)k * channels + c];
    dbias[c] = acc;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch(const T* feats, const float* weight, const float* bias,
                   const float* m, const float* t, const float* a,
                   const float* bc, T* dfeat, float* ws, float* ws_db,
                   int batch, int height, int width,
                   int num_feats, int num_joints, int depth,
                   int chunks_per_image, cudaStream_t stream) {
  const int hw_total = height * width;
  const int dpad = (depth + 7) / 8 * 8;
  const size_t smem = sizeof(float) * ((size_t)num_feats * kTileStride +
                                       (size_t)dpad * num_feats +
                                       (size_t)dpad * kTile + 5 * dpad);
  const int tiles = (hw_total + kTile - 1) / kTile;

  auto ka = hp_bwd_dfeat_kernel<T>;
  cudaError_t err = allow_smem(ka, smem);
  if (err != cudaSuccess) return err;
  ka<<<dim3(tiles, batch), kThreads, smem, stream>>>(
      feats, weight, bias, m, t, a, bc, dfeat, hw_total, width, num_feats,
      num_joints, depth, dpad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_b(batch * chunks_per_image, num_joints);
  if (depth <= 8 * kWarps) {
    auto kb = hp_bwd_dweight_kernel<T, 8>;
    err = allow_smem(kb, smem);
    if (err != cudaSuccess) return err;
    kb<<<grid_b, kThreads, smem, stream>>>(
        feats, weight, bias, m, t, a, bc, ws, ws_db, hw_total, width,
        num_feats, num_joints, depth, dpad, chunks_per_image);
  } else {
    auto kb = hp_bwd_dweight_kernel<T, 16>;
    err = allow_smem(kb, smem);
    if (err != cudaSuccess) return err;
    kb<<<grid_b, kThreads, smem, stream>>>(
        feats, weight, bias, m, t, a, bc, ws, ws_db, hw_total, width,
        num_feats, num_joints, depth, dpad, chunks_per_image);
  }
  return cudaGetLastError();
}

// (c), after either path's (a) and (b)
cudaError_t reduce(const float* ws, const float* ws_db, float* dweight,
                   float* dbias, int partials, long long channels,
                   int num_feats, cudaStream_t stream) {
  const long long n = channels * num_feats + channels;
  hp_bwd_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(ws, ws_db, dweight, dbias, partials,
                                      channels, num_feats);
  return cudaGetLastError();
}

}  // namespace

// head_projection_integral_bwd_mma.cu: (a) and (b) on the tensor cores
// for bf16 features
cudaError_t head_projection_bwd_mma(
    const __nv_bfloat16* feats, const float* weight, const float* bias,
    const float* m, const float* t, const float* a, const float* bc,
    __nv_bfloat16* dfeat, float* ws, float* ws_db, int batch, int height,
    int width, int num_feats, int num_joints, int depth, int chunks,
    cudaStream_t stream);

}  // namespace hipe

// feats_dtype: 0 = float32 (the CUDA-core kernels above), 1 = bfloat16
// (the tensor-core kernels of head_projection_integral_bwd_mma.cu), for
// feats and dfeat alike; every other array is float32. Both paths end in
// the fixed-order sum (c). The caller guarantees contiguity, F % 4 == 0,
// F <= 256, 1 <= depth <= 128, for float32 that the shared memory above
// fits, and a workspace of batch * chunks_per_image chunks. Returns the
// first launch error.
extern "C" int hipe_head_projection_integral_bwd(
    const void* feats, int feats_dtype, const void* weight, const void* bias,
    const void* m, const void* t, const void* a, const void* bc, void* dfeat,
    void* dweight, void* dbias, void* ws, void* ws_db, int batch, int height,
    int width, int num_feats, int num_joints, int depth,
    int chunks_per_image, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float*>(weight);
  auto bi = static_cast<const float*>(bias);
  auto mm = static_cast<const float*>(m);
  auto tt = static_cast<const float*>(t);
  auto aa = static_cast<const float*>(a);
  auto bb = static_cast<const float*>(bc);
  auto wk = static_cast<float*>(ws);
  auto wkb = static_cast<float*>(ws_db);
  cudaError_t err;
  if (feats_dtype == 0) {
    err = hipe::launch(static_cast<const float*>(feats), w, bi, mm, tt, aa,
                       bb, static_cast<float*>(dfeat), wk, wkb, batch,
                       height, width, num_feats, num_joints, depth,
                       chunks_per_image, st);
  } else if (feats_dtype == 1) {
    err = hipe::head_projection_bwd_mma(
        static_cast<const __nv_bfloat16*>(feats), w, bi, mm, tt, aa, bb,
        static_cast<__nv_bfloat16*>(dfeat), wk, wkb, batch, height, width,
        num_feats, num_joints, depth, chunks_per_image, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hipe::reduce(
      wk, wkb, static_cast<float*>(dweight), static_cast<float*>(dbias),
      batch * chunks_per_image, (long long)num_joints * depth, num_feats,
      st));
}
