"""Accuracy of the fused head (kernels 3 and 4) with float32 features on
the tensor cores, against a float64 product: the PyTorch port on one CUDA
card.

`chip_smoke.py` holds the forward's coords and m to its plain version
(cuBLAS float32) within 1e-4 and s within 1e-4 relative, and the
backward's dfeat, dW and db within 1e-4 of the largest entry plus 1e-4 of
each entry. This script prints, per output, the share of that tolerance
taken by

- k-p: the kernel against the plain version (what the check holds),
- k-64: the kernel against the same function in float64,
- p-64: the plain version against float64,

at batch 32 with 21, 7 and 3 joints (1 176, 392 and 168 channels: the
serving shape and the model split's), at batch 4 and, for the forward, at
the teacher sweep's 168 crops, over a few seeds; the forward also on the
CUDA-core kernel that float32 widths outside the tensor-core kernels'
take, here at F = 256 through its entry point; then what isolates the
backward's error: the float32 route on features that are exact in bf16
(their mid and lo parts zero), the bf16 route on the same features, and
the dW partials over 1 to 16 chunks an image. Run from the repo root on a
machine with a CUDA card:

    python3 scripts/fused_head_f32_accuracy.py [--seeds 3]
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hand_integral_pose_estimation_tpu_torch.config import Config  # noqa: E402
from hand_integral_pose_estimation_tpu_torch.ops import (  # noqa: E402
    fused_head as fh,
)
from hand_integral_pose_estimation_tpu_torch.ops import kernels  # noqa: E402


def share(d, want):
    """Largest |d| over (1e-4 max|want| + 1e-4 |want|), entry by entry."""
    want = want.double()
    return float((d.double().abs()
                  / (1e-4 * want.abs().max() + 1e-4 * want.abs())).max())


def fwd_shares(got, want):
    """The forward's outputs' shares of their tolerances: coords and m
    1e-4 absolute, s 1e-4 relative."""
    c, m, s = (t.double() for t in got)
    wc, wm, ws = (t.double() for t in want)
    return (float((c - wc).abs().max()) / 1e-4,
            float((m - wm).abs().max()) / 1e-4,
            float(((s - ws) / ws).abs().max()) / 1e-4)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this study needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    dev = torch.device("cuda", 0)
    model = Config().model
    D, F = model.depth_dim, model.deconv_channels
    H, W = model.output_shape

    def run(B, joints, seed, route, chunks=None):
        g = torch.Generator(device=dev).manual_seed(seed)
        feats = torch.randn(B, H, W, F, device=dev, generator=g)
        w = 0.3 * torch.randn(joints * D, F, device=dev, generator=g)
        b = torch.randn(joints * D, device=dev, generator=g)
        cot = torch.randn(B, joints, 3, device=dev, generator=g)
        if route != "float32":
            feats = feats.bfloat16().float()
        coords, m, s = fh.head_projection_integral_reference(feats, w, b,
                                                             joints, D)
        saved = fh._mma_chunks
        if chunks:
            fh._mma_chunks = lambda *_: chunks
        try:
            got = fh.head_projection_integral_bwd_cuda(
                feats.bfloat16() if route == "bf16" else feats, w, b, m, s,
                coords, cot, joints, D)
        finally:
            fh._mma_chunks = saved
        plain = fh.head_projection_integral_bwd_reference(
            feats, w, b, m, s, coords, cot, joints, D)
        exact = fh.head_projection_integral_bwd_reference(
            *(t.double() for t in (feats, w, b, m, s, coords, cot)), joints,
            D)
        parts = []
        for name, k, p, e in zip(("dfeat", "dW", "db"), got, plain, exact):
            parts.append(f"{name} k-p {share(k.float() - p, p):.3f} k-64 "
                         f"{share(k.double() - e, e):.3f} p-64 "
                         f"{share(p.double() - e, e):.3f}")
        print(f"[accuracy] B {B}, {joints * D} channels, seed {seed}, "
              f"{route} route, chunks {chunks or 'as planned'}: "
              + "; ".join(parts), flush=True)

    def run_fwd(B, joints, seed, route):
        g = torch.Generator(device=dev).manual_seed(seed)
        feats = torch.randn(B, H, W, F, device=dev, generator=g)
        w = 0.3 * torch.randn(joints * D, F, device=dev, generator=g)
        b = torch.randn(joints * D, device=dev, generator=g)
        if route == "tensor cores":
            got = fh.head_projection_integral_cuda(feats, w, b, joints, D)
        else:
            got = [torch.empty(B, joints, 3, device=dev),
                   torch.empty(B, joints, device=dev),
                   torch.empty(B, joints, device=dev)]
            kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32_CUDA_CORES(
                feats.data_ptr(), w.data_ptr(), b.data_ptr(),
                *(t.data_ptr() for t in got), B, H, W, F, joints, D,
                torch.cuda.current_stream().cuda_stream)
        plain = fh.head_projection_integral_reference(feats, w, b, joints, D)
        exact = fh.head_projection_integral_reference(
            feats.double(), w.double(), b.double(), joints, D)
        kp, k64, p64 = (fwd_shares(got, plain), fwd_shares(got, exact),
                        fwd_shares(plain, exact))
        print(f"[accuracy] forward, B {B}, {joints * D} channels, seed "
              f"{seed}, {route}: " + "; ".join(
                  f"{name} k-p {kp[i]:.3f} k-64 {k64[i]:.3f} p-64 "
                  f"{p64[i]:.3f}" for i, name in enumerate(("coords", "m",
                                                            "s"))),
              flush=True)

    for seed in range(args.seeds):
        for B, joints in ((32, 21), (32, 7), (32, 3), (4, 21), (168, 21)):
            run_fwd(B, joints, seed, "tensor cores")
        run_fwd(32, 21, seed, "CUDA cores")
    for seed in range(args.seeds):
        for B, joints in ((32, 21), (32, 7), (32, 3), (4, 21)):
            run(B, joints, seed, "float32")
    for seed in range(2):
        run(32, 21, seed, "float32 on bf16-exact features")
        run(32, 21, seed, "bf16")
    for chunks in (1, 2, 4, 8, 16):
        run(8, 21, 0, "float32", chunks)


if __name__ == "__main__":
    main()
