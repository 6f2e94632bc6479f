// Device code shared by the forward kernels: the float32 / bf16 load
// conversion and the online soft-argmax state.
//
// Every thread of a CTA folds the logits it sees into one running state for
// the CTA's joint: the running max m, the sum s = sum exp(h - m) and the
// exp-weighted sums of the three grid coordinates (column x, row y, depth
// d). Merging two states is exact and associative (both sums are rescaled
// to the larger max), so the CTA reduces its threads' states by warp
// shuffles and one pass through shared memory, and thread 0 writes the
// joint's outputs. This replaces the TPU kernels' per-channel statistics
// and (4, C) @ (C, 2J) mask-matmul epilogue, which existed to suit the
// TPU's layout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace hipe {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct OnlineState {
  float m, s, sx, sy, sz;
};

__device__ __forceinline__ OnlineState empty_state() {
  return OnlineState{-CUDART_INF_F, 0.f, 0.f, 0.f, 0.f};
}

// Fold N logits into the state. Logits that are not part of the volume
// (ragged tile edges, padded depth slots) arrive as -inf and add nothing.
template <int N>
__device__ __forceinline__ void fold(OnlineState& st, const float (&v)[N],
                                     const float (&x)[N], const float (&y)[N],
                                     const float (&z)[N]) {
  float lm = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < N; ++i) lm = fmaxf(lm, v[i]);
  if (lm == -CUDART_INF_F) return;  // nothing valid in this group
  if (lm > st.m) {
    // st.m == -inf on the first fold: the scale is exp(-inf) = 0
    const float c = __expf(st.m - lm);
    st.s *= c;
    st.sx *= c;
    st.sy *= c;
    st.sz *= c;
    st.m = lm;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = __expf(v[i] - st.m);  // exp(-inf) = 0 for invalid slots
    st.s += e;
    st.sx += e * x[i];
    st.sy += e * y[i];
    st.sz += e * z[i];
  }
}

__device__ __forceinline__ OnlineState merge(const OnlineState& a,
                                             const OnlineState& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -CUDART_INF_F) return a;  // both empty
  const float ca = __expf(a.m - m);
  const float cb = __expf(b.m - m);
  return OnlineState{m, a.s * ca + b.s * cb, a.sx * ca + b.sx * cb,
                     a.sy * ca + b.sy * cb, a.sz * ca + b.sz * cb};
}

__device__ __forceinline__ OnlineState shfl_xor(const OnlineState& a,
                                                int lane_mask) {
  return OnlineState{__shfl_xor_sync(0xffffffffu, a.m, lane_mask),
                     __shfl_xor_sync(0xffffffffu, a.s, lane_mask),
                     __shfl_xor_sync(0xffffffffu, a.sx, lane_mask),
                     __shfl_xor_sync(0xffffffffu, a.sy, lane_mask),
                     __shfl_xor_sync(0xffffffffu, a.sz, lane_mask)};
}

__device__ __forceinline__ OnlineState warp_merge(OnlineState st) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) st = merge(st, shfl_xor(st, off));
  return st;
}

// Reduce the CTA's states and write joint `bj`'s outputs:
// coords (x/W - 0.5, y/H - 0.5, z/D - 0.5), m_j and s_j = sum exp(h - m_j).
// Every thread of the CTA must call this; blockDim.x is a multiple of 32 and
// at most 1024.
__device__ __forceinline__ void finish(OnlineState st, int bj, int height,
                                       int width, int depth,
                                       float* __restrict__ coords,
                                       float* __restrict__ m_out,
                                       float* __restrict__ s_out) {
  __shared__ OnlineState partial[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  st = warp_merge(st);
  if (lane == 0) partial[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < nwarps ? partial[lane] : empty_state();
    st = warp_merge(st);
    if (lane == 0) {
      coords[bj * 3 + 0] = st.sx / st.s / float(width) - 0.5f;
      coords[bj * 3 + 1] = st.sy / st.s / float(height) - 0.5f;
      coords[bj * 3 + 2] = st.sz / st.s / float(depth) - 0.5f;
      m_out[bj] = st.m;
      s_out[bj] = st.s;
    }
  }
}

}  // namespace hipe
