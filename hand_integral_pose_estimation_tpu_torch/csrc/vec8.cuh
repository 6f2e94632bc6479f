// Eight consecutive heatmap values of one row as the soft-argmax kernels
// (1 and 2) load them: one 16-byte load of bf16, two of float32. The
// values stay packed in registers until each is used, as a float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace hipe {

template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void fill_neg_inf() {
    raw = make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);
  }
  // value k as float: bf16 is the upper half of a float32
  __device__ __forceinline__ float operator[](int k) const {
    const unsigned w = k < 2 ? raw.x : k < 4 ? raw.y : k < 6 ? raw.z : raw.w;
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Vec8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void fill_neg_inf() {
    lo = hi = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                          -CUDART_INF_F);
  }
  __device__ __forceinline__ float operator[](int k) const {
    const float4& q = k < 4 ? lo : hi;
    const int i = k & 3;
    return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
  }
};

}  // namespace hipe
