// The second launch of the chunked soft-argmax forwards (kernel 1's
// vectorised path, kernel 3's tensor-core path): merge the partial states
// that the first launch wrote per (image, chunk, channel) into each
// joint's coords, m and s.
#pragma once

#include <cuda_runtime.h>

#include "online_softmax.cuh"

namespace hipe {

// Partial states from a chunked first launch: ws holds one float4 (m, s,
// sum e col, sum e row) per (image, chunk, channel), a chunk with no rows
// holding the empty state (-inf, 0, 0, 0). merge() never forms
// exp(-inf - (-inf)): two empty states return early, and an empty one
// beside a full one scales by exp(-inf) = 0.
namespace {

constexpr int kMergeThreads = 128;

// One CTA per (image, joint): thread i merges the chunk states of channels
// j * D + d, d = i, i + 128, ..., each in chunk order and the channels in
// that order, then the CTA merges its threads' states in thread order:
// one fixed order for any depth D.
__global__ void __launch_bounds__(kMergeThreads)
    merge_chunks_kernel(const float4* __restrict__ ws, int chunks,
                        int num_joints, int height, int width, int depth,
                        float* __restrict__ coords, float* __restrict__ m_out,
                        float* __restrict__ s_out) {
  const int bj = blockIdx.x;
  const int b = bj / num_joints;
  const int j = bj - b * num_joints;
  const int channels = num_joints * depth;
  OnlineState st = empty_state();
  for (int d = threadIdx.x; d < depth; d += blockDim.x) {
    const int c = j * depth + d;
    OnlineState cs = empty_state();
    for (int k = 0; k < chunks; ++k) {
      const float4 v = ws[((long long)b * chunks + k) * channels + c];
      cs = merge(cs, OnlineState{v.x, v.y, v.z, v.w, 0.f});
    }
    cs.sz = cs.s * float(d);
    st = merge(st, cs);
  }
  finish(st, bj, height, width, depth, coords, m_out, s_out);
}

}  // namespace

}  // namespace hipe
