// Batched homography warp as two 1-D bilinear resamples (Catmull-Smith),
// zero border: the training augmentation's crop + rotation.
//
// Replaces the TPU kernels hand_integral_pose_estimation_tpu/ops/warp.py:
// _warp_kernel and _warp_kernel_looped (launched by warp_perspective_pallas).
// Both build dense relu(1 - |i - u|) weight blocks in VMEM and contract
// them with the image on the MXU, because gathers are slow on the TPU.
// Those weights are nonzero only at the two neighbouring taps, so here
// each output is two loads and two multiplies.
//
// Layout: images (B, Hs, Ws, C) float32 NHWC; coef (B, 8) float32, the
// first eight entries of Hinv / Hinv[2][2] (a, b, c, d, e, f, g, h).
// Pass A: one thread per (b, source row s, output column x'), samples row s
// at u*(x', s) into tmp (B, Hs, Wo, C). Pass B: one thread per (b, y', x'),
// samples column x' of tmp at v*(x', y') into out (B, Ho, Wo, C).
//
// Bound: device memory, and little of it: at B = 32, 224^2 -> 224^2 RGB,
// 19 MB in, 19 MB of intermediate written and read back, 19 MB out. Each
// thread's two taps sit next to its neighbours' in the same row (pass A)
// or in neighbouring columns (pass B), so the loads are nearly coalesced.
//
// The coordinate arithmetic uses round-to-nearest intrinsics in the order
// of the plain version, warp_perspective_twopass in ops/warp.py, so no
// multiply-add is contracted and the kernel forms the same float32
// positions that PyTorch does.

#include <cuda_runtime.h>

namespace hipe {
namespace {

constexpr int kThreads = 256;

// out[c] = p[i0][c] * (1 - frac) + p[i0 + 1][c] * frac, taps outside
// [0, n) reading 0 (nan and inf positions give 0). `stride` is the
// distance between taps in floats.
__device__ __forceinline__ void tap2(const float* __restrict__ p,
                                     long long stride, int n, float pos,
                                     int channels, float* __restrict__ out) {
  const float i0 = floorf(pos);
  const float w1 = __fsub_rn(pos, i0);
  const float w0 = __fsub_rn(1.f, w1);
  const bool ok0 = i0 >= 0.f && i0 <= float(n - 1);
  const bool ok1 = i0 >= -1.f && i0 <= float(n - 2);
  const long long k0 = ok0 ? (long long)i0 * stride : 0;
  const long long k1 = ok1 ? ((long long)i0 + 1) * stride : 0;
  for (int c = 0; c < channels; ++c) {
    const float a = ok0 ? __fmul_rn(p[k0 + c], w0) : 0.f;
    const float b = ok1 ? __fmul_rn(p[k1 + c], w1) : 0.f;
    out[c] = __fadd_rn(a, b);
  }
}

__global__ void __launch_bounds__(kThreads)
    warp_rows_kernel(const float* __restrict__ src,
                     const float* __restrict__ coef, float* __restrict__ tmp,
                     int batch, int src_h, int src_w, int out_w,
                     int channels) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * src_h * out_w) return;
  const int x = idx % out_w;
  const int r = idx / out_w;  // b * src_h + s
  const int s = r % src_h;
  const int b = r / src_h;
  const float* k = coef + 8 * b;
  const float a = k[0], bb = k[1], c = k[2], d = k[3], e = k[4], f = k[5],
              g = k[6], h = k[7];
  const float xo = float(x), ys = float(s);
  // yA = (ys g x' + ys - d x' - f) / (e - ys h): v(x', yA) = ys
  const float ya = __fdiv_rn(
      __fsub_rn(__fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(ys, g), xo), ys),
                          __fmul_rn(d, xo)),
                f),
      __fsub_rn(e, __fmul_rn(ys, h)));
  // u* = (a x' + b yA + c) / (g x' + h yA + 1)
  const float u = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, xo), __fmul_rn(bb, ya)), c),
      __fadd_rn(__fadd_rn(__fmul_rn(g, xo), __fmul_rn(h, ya)), 1.f));
  tap2(src + (long long)r * src_w * channels, channels, src_w, u, channels,
       tmp + (long long)idx * channels);
}

__global__ void __launch_bounds__(kThreads)
    warp_cols_kernel(const float* __restrict__ tmp,
                     const float* __restrict__ coef, float* __restrict__ out,
                     int batch, int src_h, int out_h, int out_w,
                     int channels) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * out_h * out_w) return;
  const int x = idx % out_w;
  const int r = idx / out_w;  // b * out_h + y
  const int y = r % out_h;
  const int b = r / out_h;
  const float* k = coef + 8 * b;
  const float d = k[3], e = k[4], f = k[5], g = k[6], h = k[7];
  const float xo = float(x), yo = float(y);
  // v* = (d x' + e y' + f) / (g x' + h y' + 1)
  const float v = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(d, xo), __fmul_rn(e, yo)), f),
      __fadd_rn(__fadd_rn(__fmul_rn(g, xo), __fmul_rn(h, yo)), 1.f));
  tap2(tmp + ((long long)b * src_h * out_w + x) * channels,
       (long long)out_w * channels, src_h, v, channels,
       out + (long long)idx * channels);
}

}  // namespace
}  // namespace hipe

// images (B, Hs, Ws, C), coef (B, 8), tmp (B, Hs, Wo, C) scratch and out
// (B, Ho, Wo, C), all float32 and contiguous, allocated by the caller, with
// B * max(Hs, Ho) * Wo < 2^31. Returns the first launch error.
extern "C" int hipe_warp_twopass(const void* images, const void* coef,
                                 void* tmp, void* out, int batch, int src_h,
                                 int src_w, int out_h, int out_w,
                                 int channels, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* cf = static_cast<const float*>(coef);
  auto* t = static_cast<float*>(tmp);
  const long long n_a = (long long)batch * src_h * out_w;
  hipe::warp_rows_kernel<<<(unsigned)((n_a + hipe::kThreads - 1) /
                                      hipe::kThreads),
                           hipe::kThreads, 0, st>>>(
      static_cast<const float*>(images), cf, t, batch, src_h, src_w, out_w,
      channels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_b = (long long)batch * out_h * out_w;
  hipe::warp_cols_kernel<<<(unsigned)((n_b + hipe::kThreads - 1) /
                                      hipe::kThreads),
                           hipe::kThreads, 0, st>>>(
      t, cf, static_cast<float*>(out), batch, src_h, out_h, out_w, channels);
  return static_cast<int>(cudaGetLastError());
}
