"""The port's CUDA kernels against their plain PyTorch versions on the card,
forward and backward, and the wrappers' input rules. Every test here needs
a CUDA device: they carry the `gpu` marker and skip without one. On a
machine with a card (`--noconftest`: tests/conftest.py sets up JAX, which
the card's machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu_torch.ops import (
    fused_head,
    integral,
    kernels,
    nms,
    roi_align,
    warp,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

pytestmark = pytest.mark.gpu

# same float32 logits on both sides, only the summation order differs
COORD_TOL = 1e-4
S_REL_TOL = 1e-4
# (B, H, W, J, D): serving shape, ragged small shapes, depth > 32 and > 64
SHAPES = [(32, 56, 56, 21, 56), (1, 8, 8, 3, 4), (3, 7, 5, 2, 40),
          (2, 9, 9, 2, 100)]
# (B, H, W, J, D, F) for the fused head: the shapes above with F = 256 at
# 56 x 56 and 40 (not a multiple of 16) otherwise, the two-stage path's
# pose batch of 4 at full width, and F = 36 (not a multiple of 8: the
# tensor-core kernels' 8-byte copies)
HEAD_SHAPES = ([s + (256 if s[1] == 56 else 40,) for s in SHAPES]
               + [(4, 56, 56, 21, 56, 256), (2, 7, 5, 3, 12, 36)])
# The backward kernels fold the per-channel constants (exp(h - m) times
# T + A col + B row) where the plain versions form p * sum cot (g - c):
# the same float32 numbers combined in another order, so they agree to a
# few float32 ulps of the largest gradient (1e-5 of it). bf16 results
# round those float32 values once more: one bf16 ulp, 2^-8 relative.
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
GRAD_ABS_SCALE = 1e-5
# The fused backward recomputes the logits with float32 FMAs where the
# plain version runs a cuBLAS float32 matmul, and sums dfeat over J*D
# channels and dW over B*H*W rows in another order: 1e-4 of the largest
# entry leaves room for that and still catches an indexing fault.
FUSED_GRAD_ABS_SCALE = 1e-4
# The warp kernel forms the plain version's coefficients, positions,
# weights, sums and normalised values with round-to-nearest intrinsics in
# the plain version's order: its output equals the plain version's bit for
# bit, nan in the same places.
# ROIAlign kernel and plain version weight the same float32 taps and sum
# the 16 products of a bin in another order: a few ulps of the largest
# feature. NMS keep sets are bitwise equal: the kernel forms the plain
# version's float32 IoU with the same rounded operations.
ROI_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype, abs_scale=GRAD_ABS_SCALE):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=GRAD_REL[dtype],
                               atol=abs_scale * float(want.abs().max()))


def _homographies(B, g, dev):
    """Rotation, scale, shear, translation and a little perspective, as the
    augmentation's crop-after-rotation maps are."""
    a = (torch.rand(B, generator=g, device=dev) - 0.5) * 1.0
    sc = 0.7 + 0.6 * torch.rand(B, 2, generator=g, device=dev)
    H = torch.zeros(B, 3, 3, device=dev)
    H[:, 0, 0] = sc[:, 0] * torch.cos(a)
    H[:, 0, 1] = -sc[:, 1] * torch.sin(a)
    H[:, 1, 0] = sc[:, 0] * torch.sin(a)
    H[:, 1, 1] = sc[:, 1] * torch.cos(a)
    H[:, :2, 2] = 6 * torch.randn(B, 2, generator=g, device=dev)
    H[:, 2, :2] = 2e-4 * torch.randn(B, 2, generator=g, device=dev)
    H[:, 2, 2] = 1.0
    return H


def _check(got, want):
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=COORD_TOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=COORD_TOL)
    torch.testing.assert_close(got[2], want[2], rtol=S_REL_TOL, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_softmax_integral_kernel_matches_plain(dev, shape, dtype):
    B, H, W, J, D = shape
    g = torch.Generator(device=dev).manual_seed(0)
    hm = (3 * torch.randn(B, H, W, J * D, device=dev, generator=g)).to(dtype)
    before = kernels.SOFTMAX_INTEGRAL_FWD.launches
    got = integral.softmax_integral_cuda(hm, J, D)
    torch.cuda.synchronize()
    assert kernels.SOFTMAX_INTEGRAL_FWD.launches == before + 1
    _check(got, integral.softmax_integral_reference(hm, J, D))


# each feature dtype's route counts on its own entry point
_HEAD_FWD = {torch.bfloat16: kernels.HEAD_PROJECTION_INTEGRAL_FWD,
             torch.float32: kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32}
_HEAD_BWD = {torch.bfloat16: kernels.HEAD_PROJECTION_INTEGRAL_BWD,
             torch.float32: kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32}


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_projection_kernel_matches_plain(dev, shape, feat_dtype):
    B, H, W, J, D, F = shape
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(B, H, W, F, device=dev, generator=g).to(feat_dtype)
    w = 0.3 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    kernel = _HEAD_FWD[feat_dtype]
    before = kernel.launches
    got = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check(got, fused_head.head_projection_integral_reference(feats, w, b,
                                                              J, D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_softmax_integral_bwd_kernel_matches_plain(dev, shape, dtype):
    B, H, W, J, D = shape
    g = torch.Generator(device=dev).manual_seed(2)
    hm = (3 * torch.randn(B, H, W, J * D, device=dev, generator=g)).to(dtype)
    coords, m, s = integral.softmax_integral_reference(hm, J, D)
    cot = torch.randn(B, J, 3, device=dev, generator=g)
    before = kernels.SOFTMAX_INTEGRAL_BWD.launches
    got = integral.softmax_integral_bwd_cuda(hm, m, s, coords, cot, J, D)
    torch.cuda.synchronize()
    assert kernels.SOFTMAX_INTEGRAL_BWD.launches == before + 1
    assert got.dtype == dtype and got.shape == hm.shape
    _close(got, integral.softmax_integral_bwd_reference(hm, m, s, coords,
                                                        cot, J, D), dtype)


def _forward_with_chunks(hm, J, D, chunks):
    """Kernel 1's C entry with a chunk count of the caller's choosing (the
    planner never leaves a chunk empty): (coords, m, s)."""
    B, H, W, C = hm.shape
    f32 = dict(dtype=torch.float32, device=hm.device)
    coords, m, s = (torch.empty(B, J, 3, **f32), torch.empty(B, J, **f32),
                    torch.empty(B, J, **f32))
    ws = torch.empty(B * chunks * C * 4, **f32)
    kernels.SOFTMAX_INTEGRAL_FWD(
        hm.data_ptr(), integral._DTYPE_CODES[hm.dtype], coords.data_ptr(),
        m.data_ptr(), s.data_ptr(), ws.data_ptr(), B, H, W, J, D, chunks,
        torch.cuda.current_stream().cuda_stream)
    return coords, m, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks", ["planned", "more_than_rows"])
def test_softmax_integral_kernel_at_batch_one_with_the_most_chunks(
        dev, chunks, dtype):
    """Kernel 1's vectorised path at batch 1, where the planner cuts the
    image into the most chunks, and with more chunks than rows, whose
    empty chunks hold the empty state and must add nothing."""
    B, H, W, J, D = 1, 56, 56, 21, 56
    g = torch.Generator(device=dev).manual_seed(7)
    hm = (3 * torch.randn(B, H, W, J * D, device=dev, generator=g)).to(dtype)
    planned = integral.softmax_integral_chunks(hm)
    assert planned >= integral.softmax_integral_chunks(
        hm.expand(32, H, W, J * D).contiguous()) >= 1
    if chunks == "planned":
        got = integral.softmax_integral_cuda(hm, J, D)
    else:
        got = _forward_with_chunks(hm, J, D, H * W + 37)
    _check(got, integral.softmax_integral_reference(hm, J, D))
    small = hm[:, :3, :2].contiguous()   # 6 rows, up to 43 chunks
    _check(_forward_with_chunks(small, J, D, 43),
           integral.softmax_integral_reference(small, J, D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_integral_kernel_on_unaligned_views(dev, dtype):
    """`hm[1:]` of an odd-sized batch starts mid-allocation; a heatmap
    whose base is off 16 bytes (8-channel rows notwithstanding) takes the
    generic path, and the C entry refuses a vectorised launch of it."""
    g = torch.Generator(device=dev).manual_seed(8)
    for (B, H, W, J, D) in ((3, 7, 5, 3, 4), (3, 7, 5, 2, 40)):
        hm = (3 * torch.randn(B, H, W, J * D, device=dev, generator=g)
              ).to(dtype)
        view = hm[1:]
        assert view.is_contiguous()
        _check(integral.softmax_integral_cuda(view, J, D),
               integral.softmax_integral_reference(view, J, D))
    B, H, W, J, D = 3, 7, 5, 2, 40
    flat = (3 * torch.randn(B * H * W * J * D + 1, device=dev, generator=g)
            ).to(dtype)
    off = flat[1:].view(B, H, W, J * D)
    assert off.data_ptr() % 16 and integral.softmax_integral_chunks(off) == 0
    _check(integral.softmax_integral_cuda(off, J, D),
           integral.softmax_integral_reference(off, J, D))
    with pytest.raises(RuntimeError, match="invalid argument"):
        _forward_with_chunks(off, J, D, 4)


def test_softmax_integral_kernel_is_deterministic(dev):
    """Chunks and channels are merged in a fixed order: two calls at the
    serving shape give the same bits."""
    g = torch.Generator(device=dev).manual_seed(9)
    hm = (3 * torch.randn(32, 56, 56, 21 * 56, device=dev, generator=g)
          ).to(torch.bfloat16)
    first = integral.softmax_integral_cuda(hm, 21, 56)
    second = integral.softmax_integral_cuda(hm, 21, 56)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_integral_bwd_is_one_device_kernel(dev, dtype):
    """One call of the backward wrapper issues one device kernel: the
    per-channel constants are formed inside it, with no torch glue."""
    B, H, W, J, D = 4, 56, 56, 21, 56
    g = torch.Generator(device=dev).manual_seed(10)
    hm = (3 * torch.randn(B, H, W, J * D, device=dev, generator=g)).to(dtype)
    coords, m, s = integral.softmax_integral_cuda(hm, J, D)
    cot = torch.randn(B, J, 3, device=dev, generator=g)
    integral.softmax_integral_bwd_cuda(hm, m, s, coords, cot, J, D)
    torch.cuda.synchronize()
    calls = 3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            integral.softmax_integral_bwd_cuda(hm, m, s, coords, cot, J, D)
        torch.cuda.synchronize()
    device_kernels = sum(
        e.count for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))
    assert device_kernels == calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_integral_autograd_round_trip(dev, dtype):
    """`softmax_integral` on CUDA (both kernels, vectorised paths, D not
    a multiple of 8) against autograd through the plain forward."""
    B, H, W, J, D = 3, 9, 7, 4, 6
    g = torch.Generator(device=dev).manual_seed(11)
    hm = (3 * torch.randn(B, H, W, J * D, device=dev, generator=g)
          ).to(dtype).requires_grad_()
    cot = torch.randn(B, J, 3, device=dev, generator=g)
    assert integral.softmax_integral_chunks(hm) > 0
    counts = [k.launches for k in (kernels.SOFTMAX_INTEGRAL_FWD,
                                   kernels.SOFTMAX_INTEGRAL_BWD)]
    coords = integral.softmax_integral(hm, J, D)
    got, = torch.autograd.grad(coords, hm, cot)
    torch.cuda.synchronize()
    assert [k.launches for k in (kernels.SOFTMAX_INTEGRAL_FWD,
                                 kernels.SOFTMAX_INTEGRAL_BWD)] == [
        c + 1 for c in counts]
    want_coords = integral.softmax_integral_reference(hm, J, D)[0]
    want, = torch.autograd.grad(want_coords, hm, cot)
    torch.testing.assert_close(coords, want_coords, rtol=0, atol=COORD_TOL)
    assert got.dtype == dtype
    _close(got, want, dtype)


def test_forward_only_kernels_refuse_inputs_that_require_grad(dev):
    """The warp has no backward kernel, and ROIAlign's gives the RoIs no
    gradient: under grad mode, frames, maps or RoIs that require grad raise
    instead of a detached result; under no_grad, or for inputs that need
    none, they run. Features that require grad take ROIAlign's backward
    kernel."""
    feats = torch.randn(1, 8, 8, 16, device=dev)
    rois = torch.tensor([[[0.0, 0.0, 60.0, 60.0]]], device=dev)
    images = torch.rand(2, 16, 16, 3, device=dev)
    H = torch.eye(3, device=dev).expand(2, 3, 3).contiguous()
    counts = [k.launches for k in kernels.KERNELS]
    for f in (feats, feats.clone().requires_grad_()):
        r = rois.clone().requires_grad_()
        with pytest.raises(RuntimeError, match="impl=\"plain\""):
            roi_align.roi_align_cuda(f, r)
        with pytest.raises(RuntimeError, match="impl=\"plain\""):
            roi_align.roi_align_batched(f, r)
    for im, h in ((images.clone().requires_grad_(), H),
                  (images, H.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="twopass"):
            warp.warp_perspective_cuda(im, h, (16, 16))
        with pytest.raises(RuntimeError, match="twopass"):
            warp.warp_perspective_batch(im, h, (16, 16))
    assert [k.launches for k in kernels.KERNELS] == counts

    with torch.no_grad():
        pooled = roi_align.roi_align_cuda(feats.clone().requires_grad_(),
                                          rois.clone().requires_grad_())
        out = warp.warp_perspective_cuda(images.clone().requires_grad_(), H,
                                         (16, 16))
    pooled_needs_none = roi_align.roi_align_cuda(feats, rois)
    torch.cuda.synchronize()
    assert not pooled.requires_grad and not out.requires_grad
    torch.testing.assert_close(pooled, pooled_needs_none)
    torch.testing.assert_close(out, images, rtol=0, atol=1e-5)
    grad_plain = roi_align.roi_align_batched(
        feats.clone().requires_grad_(), rois, impl="plain")
    assert grad_plain.requires_grad
    f = feats.clone().requires_grad_()
    before = kernels.ROI_ALIGN_BWD.launches
    pooled = roi_align.roi_align_batched(f, rois)
    assert pooled.requires_grad
    pooled.sum().backward()
    torch.cuda.synchronize()
    assert kernels.ROI_ALIGN_BWD.launches == before + 1
    fp = feats.clone().requires_grad_()
    roi_align.roi_align_batched(fp, rois, impl="plain").sum().backward()
    torch.testing.assert_close(f.grad, fp.grad, rtol=0,
                               atol=ROI_TOL * float(fp.grad.abs().max()))


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_projection_bwd_kernel_matches_plain(dev, shape, feat_dtype):
    B, H, W, J, D, F = shape
    g = torch.Generator(device=dev).manual_seed(3)
    feats = torch.randn(B, H, W, F, device=dev, generator=g).to(feat_dtype)
    w = 0.3 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    coords, m, s = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    cot = torch.randn(B, J, 3, device=dev, generator=g)
    kernel = _HEAD_BWD[feat_dtype]
    before = kernel.launches
    got = fused_head.head_projection_integral_bwd_cuda(
        feats, w, b, m, s, coords, cot, J, D)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = fused_head.head_projection_integral_bwd_reference(
        feats, w, b, m, s, coords, cot, J, D)
    assert got[0].dtype == feat_dtype and got[1].dtype == torch.float32
    assert got[1].shape == (J * D, F) and got[2].shape == (J * D,)
    _close(got[0], want[0], feat_dtype, FUSED_GRAD_ABS_SCALE)
    for gk, wk in zip(got[1:], want[1:]):
        _close(gk, wk, torch.float32, FUSED_GRAD_ABS_SCALE)


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
def test_head_projection_bwd_is_deterministic(dev, feat_dtype):
    """dW and db are sums over the whole batch taken across CTAs: partial
    sums per chunk, then a fixed-order pass, so two runs give the same
    bits (no float atomics), on both feature dtypes' routes."""
    B, H, W, J, D, F = 32, 56, 56, 21, 56, 256
    g = torch.Generator(device=dev).manual_seed(4)
    feats = torch.randn(B, H, W, F, device=dev,
                        generator=g).to(feat_dtype)
    w = 0.1 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    coords, m, s = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    cot = torch.randn(B, J, 3, device=dev, generator=g)
    first = fused_head.head_projection_integral_bwd_cuda(
        feats, w, b, m, s, coords, cot, J, D)
    second = fused_head.head_projection_integral_bwd_cuda(
        feats, w, b, m, s, coords, cot, J, D)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_bf16_fused_head_runs_on_tensor_cores(dev):
    """The bf16 path's kernels (fused head forward, both backward
    launches) hold tensor-core products (HMMA / HGMMA) in their SASS."""
    if kernels.cuda_tool("cuobjdump") is None:
        pytest.skip("needs cuobjdump")
    counts = kernels.tensor_core_instructions()
    assert set(counts) == set(kernels.MMA_KERNELS)
    assert all(n > 0 for n in counts.values()), counts


def test_f32_fused_head_bwd_runs_on_tensor_cores(dev):
    """The float32-feature route of kernels 3 and 4 (the forward and both
    backward launches) holds tensor-core products (HMMA / HGMMA) in its
    SASS."""
    if kernels.cuda_tool("cuobjdump") is None:
        pytest.skip("needs cuobjdump")
    counts = kernels.tensor_core_instructions(kernels.F32_MMA_KERNELS)
    assert set(counts) == set(kernels.F32_MMA_KERNELS)
    assert all(n > 0 for n in counts.values()), counts


# kernel 3 on float32 features at the serving batch, the two-stage path's
# pose batch and the teacher sweep's 8 x 21 crops, at 21, 7 and 3 joints
# (1 176, 392 and 168 channels: the model split's)
F32_FWD_SHAPES = [(B, 56, 56, J, 56, 256) for B in (32, 4, 168)
                  for J in (21, 7, 3)]


@pytest.mark.parametrize("shape", F32_FWD_SHAPES)
def test_f32_head_fwd_at_path_shapes(dev, shape):
    """Kernel 3 with float32 features on the tensor cores against its
    plain version (coords and m within COORD_TOL, s within S_REL_TOL), one
    counted launch a call, and two calls bitwise equal."""
    B, H, W, J, D, F = shape
    g = torch.Generator(device=dev).manual_seed(13)
    feats = torch.randn(B, H, W, F, device=dev, generator=g)
    w = 0.3 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    kernel = kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32
    before = kernel.launches
    first = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    second = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    _check(first, fused_head.head_projection_integral_reference(feats, w, b,
                                                                J, D))


# every width and depth the JAX head takes: F odd (7: 2-byte feature
# copies and single stores in the resident kernels; 259 in the slice
# kernels), not a multiple of 4 (6; 258: 4-byte copies past 256) or of 8
# (38), past 256 (260: one slice past the resident kernels, split 3 + 2
# between the backward's warpgroups; 320 and 384: 5 and 6 whole slices;
# 511 and 512: the last width of one pass of the N = F products, 4 + 4
# slices; 513: the first with two passes, the second of one slice, which
# warpgroup 1 sits out; 1024: two whole passes; 2048: four, bf16 features
# streamed in the backward's dfeat), and D = 160 (the chunk merge and
# kernel 1's generic path past 128 depth slots) at F = 256 and 512; and
# ragged rounds of the forward past 256 features (rounds of four 64-position
# tiles with bf16 features, two with float32 ones): 5 x 64 positions (the
# last round holds one tile) and, at batch 1, 7 x 64 (three, or one)
WIDE_HEAD_SHAPES = [(2, 9, 7, 3, 24, f)
                    for f in (6, 7, 38, 258, 259, 260, 320, 384, 511, 512,
                              513, 1024, 2048)] + [
    (2, 9, 7, 3, 160, 256), (2, 9, 7, 2, 160, 512), (3, 56, 56, 21, 56, 512),
    (2, 5, 64, 3, 24, 320), (1, 7, 64, 2, 24, 384)]


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", WIDE_HEAD_SHAPES)
def test_head_at_every_width_and_depth(dev, shape, feat_dtype):
    """Kernels 3 and 4 (3f and 4f with float32 features) at widths and
    depths outside the serving configuration, on the tensor cores: the
    forward within COORD_TOL / S_REL_TOL of its plain version, the
    backward within the fused tolerance, one counted launch of the dtype's
    entry point a call and nothing else, and two calls of each bitwise
    equal (dW and db too)."""
    B, H, W, J, D, F = shape
    g = torch.Generator(device=dev).manual_seed(14)
    feats = torch.randn(B, H, W, F, device=dev, generator=g).to(feat_dtype)
    w = (0.3 * 16 / math.sqrt(F)) * torch.randn(J * D, F, device=dev,
                                                 generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    cot = torch.randn(B, J, 3, device=dev, generator=g)
    counts = [k.launches for k in kernels.KERNELS]
    first = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    second = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    coords, m, s = first
    grads = [fused_head.head_projection_integral_bwd_cuda(
        feats, w, b, m, s, coords, cot, J, D) for _ in range(2)]
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels.KERNELS, counts)] == [
        2 * (k in (_HEAD_FWD[feat_dtype], _HEAD_BWD[feat_dtype]))
        for k in kernels.KERNELS]
    for x, y in zip(first + grads[0], second + grads[1]):
        assert torch.equal(x, y)
    _check(first, fused_head.head_projection_integral_reference(feats, w, b,
                                                                J, D))
    want = fused_head.head_projection_integral_bwd_reference(
        feats, w, b, m, s, coords, cot, J, D)
    assert grads[0][0].dtype == feat_dtype
    assert grads[0][1].shape == (J * D, F) and grads[0][2].shape == (J * D,)
    _close(grads[0][0], want[0], feat_dtype, FUSED_GRAD_ABS_SCALE)
    for gk, wk in zip(grads[0][1:], want[1:]):
        _close(gk, wk, torch.float32, FUSED_GRAD_ABS_SCALE)


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num_feats", [256, 257])
def test_head_device_kernels_by_width(dev, num_feats, feat_dtype):
    """A forward and a backward call launch the resident kernels up to 256
    features and the ring ones past it (`hp_fwd_ring_kernel`, the
    backward's dfeat and dW; the feature dtype's instantiation: <1> bf16,
    <3> float32), one of each, read from a captured graph's kernel nodes:
    the entry points' counts cannot tell the two apart."""
    B, H, W, J, D, F = 2, 9, 7, 3, 24, num_feats
    g = torch.Generator(device=dev).manual_seed(15)
    feats = torch.randn(B, H, W, F, device=dev, generator=g).to(feat_dtype)
    w = (0.3 * 16 / math.sqrt(F)) * torch.randn(J * D, F, device=dev,
                                                 generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    cot = torch.randn(B, J, 3, device=dev, generator=g)

    def call():
        coords, m, s = fused_head.head_projection_integral_cuda(
            feats, w, b, J, D)
        fused_head.head_projection_integral_bwd_cuda(
            feats, w, b, m, s, coords, cot, J, D)

    call()  # warm-up off the capture: builds the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        call()
    names = kernels.graph_kernel_names(graph)
    f32 = feat_dtype == torch.float32
    if F > 256:
        want = [f"{k}<{3 if f32 else 1}>" for k in kernels.SLICE_MMA_KERNELS]
    else:
        want = list(kernels.F32_MMA_KERNELS if f32 else kernels.MMA_KERNELS)
    head = kernels.MMA_KERNELS + kernels.F32_MMA_KERNELS + tuple(
        f"{k}<{p}>" for k in kernels.SLICE_MMA_KERNELS for p in (1, 3))
    launched = {k: sum(kernels.mangled_name(k) in n for n in names)
                for k in head}
    assert launched == {k: int(k in want) for k in head}
    # the forward past 256 features is the ring kernel, and no other
    assert launched[f"hp_fwd_ring_kernel<{3 if f32 else 1}>"] == int(F > 256)
    assert not any("hp_fwd_slices_kernel" in n for n in names)


def test_slice_kernels_run_on_tensor_cores(dev):
    """The kernels that walk F > 256 in slices (both feature dtypes'
    instantiations) hold tensor-core products in their SASS."""
    if kernels.cuda_tool("cuobjdump") is None:
        pytest.skip("needs cuobjdump")
    counts = kernels.tensor_core_instructions(kernels.SLICE_MMA_KERNELS)
    assert set(counts) == set(kernels.SLICE_MMA_KERNELS)
    assert all(n > 0 for n in counts.values()), counts


# float32 features at the model split's channel counts (7 joints: 392
# channels, model=3; 3 joints: 168, model=7; a ragged tail on the blocks of
# 64 channels) and at small ragged shapes (F 40 and 36: K padding, F % 8)
F32_SPLIT_SHAPES = [(32, 56, 56, 7, 56, 256), (32, 56, 56, 3, 56, 256),
                    (1, 8, 8, 3, 4, 40), (2, 7, 5, 3, 12, 36)]


@pytest.mark.parametrize("shape", F32_SPLIT_SHAPES)
def test_f32_head_bwd_at_split_shapes(dev, shape):
    """Kernel 4 with float32 features against its plain version at the
    model split's and small shapes, one counted launch a call, and two
    calls bitwise equal."""
    B, H, W, J, D, F = shape
    g = torch.Generator(device=dev).manual_seed(12)
    feats = torch.randn(B, H, W, F, device=dev, generator=g)
    w = 0.3 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    coords, m, s = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    cot = torch.randn(B, J, 3, device=dev, generator=g)
    before = kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32.launches
    first = fused_head.head_projection_integral_bwd_cuda(
        feats, w, b, m, s, coords, cot, J, D)
    second = fused_head.head_projection_integral_bwd_cuda(
        feats, w, b, m, s, coords, cot, J, D)
    torch.cuda.synchronize()
    assert kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32.launches == before + 2
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    want = fused_head.head_projection_integral_bwd_reference(
        feats, w, b, m, s, coords, cot, J, D)
    assert first[0].dtype == torch.float32
    for gk, wk in zip(first, want):
        _close(gk, wk, torch.float32, FUSED_GRAD_ABS_SCALE)


def _frames(images, frames):
    return images.to(torch.uint8) if frames == "uint8" else images


def _epilogue(B, C, g, dev):
    colour = 0.8 + 0.4 * torch.rand(B, C, device=dev, generator=g)
    return colour, tuple(0.25 * k + 0.4559 for k in range(C)), \
        tuple(1.0 + 0.125 * k for k in range(C))


def _warp_both(images, H, out_hw, normalise, inverse=False):
    """(kernel, plain version) of the warp, with the epilogue or without;
    the kernel's launch counted."""
    before = kernels.WARP_TWOPASS.launches
    if normalise is None:
        got = warp.warp_perspective_cuda(images, H, out_hw, inverse)
    else:
        got = warp.warp_normalise_batch(images, H, out_hw, *normalise,
                                        inverse=inverse)
    torch.cuda.synchronize()
    assert kernels.WARP_TWOPASS.launches == before + 1
    if normalise is None:
        want = warp.warp_perspective_twopass(images, H, out_hw, inverse)
    else:
        want = warp.warp_normalise_twopass(images, H, out_hw, *normalise,
                                           inverse=inverse)
    assert got.shape == want.shape and got.dtype == torch.float32
    return got, want


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("frames", ["float32", "uint8"])
@pytest.mark.parametrize("shape", [(32, 224, 224, 3, 224, 224),
                                   (2, 37, 41, 3, 29, 33),
                                   (3, 30, 20, 1, 17, 23)])
def test_warp_kernel_matches_plain(dev, shape, frames, epilogue):
    """float32 and uint8 frames, with and without the normalising
    epilogue: bit for bit the plain version (the same rounded operations
    in the same order)."""
    B, Hs, Ws, C, Ho, Wo = shape
    g = torch.Generator(device=dev).manual_seed(5)
    images = _frames(255 * torch.rand(B, Hs, Ws, C, device=dev, generator=g),
                     frames)
    H = _homographies(B, g, dev)
    norm = _epilogue(B, C, g, dev) if epilogue else None
    got, want = _warp_both(images, H, (Ho, Wo), norm)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got.abs().sum()) > 0
    if not epilogue:   # the frames as float32 give the same bits
        torch.testing.assert_close(warp.warp_perspective_cuda(
            images.float(), H, (Ho, Wo)), got, rtol=0, atol=0)


def _degenerate_maps(name, dtype, dev):
    """(forward maps, inverse flag) on 16 x 16 -> 16 x 16: a singular map
    and an exact 90-degree turn (all nan), a horizon inside the output
    (some nan) and a dst -> src map whose denominator is 0 on column 8
    (positions at +-inf, that column 0)."""
    if name == "singular":
        H, inverse = [[1.0, 2, 3], [2, 4, 6], [0, 0, 1]], False
    elif name == "rot90":
        H, inverse = [[0.0, -1, 15], [1, 0, 0], [0, 0, 1]], False
    elif name == "horizon":
        H, inverse = [[1.0, 0, 0], [0, 1, 0], [0.2, 0, 1]], False
    else:
        H, inverse = [[1.0, 0.05, 0.5], [0.1, 1, 0.3], [-0.125, 0, 1]], True
    return torch.tensor([H, H], dtype=dtype, device=dev), inverse


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("map_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["singular", "rot90", "horizon", "inf"])
def test_warp_kernel_on_degenerate_maps(dev, name, map_dtype, epilogue):
    """nan where the plain version has nan (all of it for a singular map
    or an exact 90-degree turn, as in the JAX package), 0 where positions
    are at +-inf, and the same bits elsewhere."""
    g = torch.Generator(device=dev).manual_seed(8)
    images = (255 * torch.rand(2, 16, 16, 3, device=dev, generator=g)).to(
        torch.uint8)
    H, inverse = _degenerate_maps(name, map_dtype, dev)
    norm = _epilogue(2, 3, g, dev) if epilogue else None
    got, want = _warp_both(images, H, (16, 16), norm, inverse)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    nan = torch.isnan(want)
    if name in ("singular", "rot90"):
        assert bool(nan.all())
    elif name == "horizon":
        assert bool(nan.any()) and not bool(nan.all())
    else:
        assert not bool(nan.any()) and bool((want[:, :, 8] == 0).all())


def test_warp_kernel_takes_float64_and_strided_maps(dev):
    """float64 maps (positions in float64, as the plain version forms
    them), a transposed view and an expanded map (stride 0 over the batch)
    give the plain version's bits."""
    g = torch.Generator(device=dev).manual_seed(9)
    images = 255 * torch.rand(2, 37, 41, 3, device=dev, generator=g)
    H = _homographies(2, g, dev)
    got, want = _warp_both(images, H.double(), (29, 33), None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    Ht = H.transpose(1, 2).contiguous().transpose(1, 2)
    got, want = _warp_both(images, Ht, (29, 33), None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got, want = _warp_both(images, H[:1].expand(2, 3, 3), (29, 33), None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, warp.warp_perspective_cuda(
        images, H[:1].repeat(2, 1, 1), (29, 33)), rtol=0, atol=0)


def _device_kernels_per_call(fn):
    """Kernel nodes of one call of `fn` captured in a CUDA graph, read
    through libcuda (`kernels.graph_kernel_names`): every device kernel
    the call issues, where a profiler's event buffers may drop some."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return len(kernels.graph_kernel_names(graph))


@pytest.mark.parametrize("epilogue", [False, True])
def test_warp_is_one_device_kernel(dev, epilogue):
    """One call of the warp wrapper issues one device kernel: the map is
    inverted and the frames normalised inside it, with no torch glue,
    where the plain chain issues many (the count sees them)."""
    g = torch.Generator(device=dev).manual_seed(10)
    images = (255 * torch.rand(4, 64, 64, 3, device=dev, generator=g)).to(
        torch.uint8)
    H = _homographies(4, g, dev)
    norm = _epilogue(4, 3, g, dev) if epilogue else None
    if norm is None:
        assert _device_kernels_per_call(
            lambda: warp.warp_perspective_cuda(images, H, (56, 56))) == 1
        plain = _device_kernels_per_call(
            lambda: warp.warp_perspective_twopass(images, H, (56, 56)))
    else:
        assert _device_kernels_per_call(
            lambda: warp.warp_normalise_batch(images, H, (56, 56),
                                              *norm)) == 1
        plain = _device_kernels_per_call(
            lambda: warp.warp_normalise_twopass(images, H, (56, 56), *norm))
    assert plain > 1


def test_autograd_functions_take_the_kernels_both_ways(dev):
    """On CUDA the differentiable entry points launch the forward kernel
    and, on backward, the backward kernel; their gradients equal autograd
    through the plain forwards."""
    B, H, W, J, D, F = 2, 9, 7, 3, 12, 32
    g = torch.Generator(device=dev).manual_seed(6)
    hm = (2 * torch.randn(B, H, W, J * D, device=dev, generator=g)
          ).requires_grad_()
    feats = torch.randn(B, H, W, F, device=dev, generator=g).requires_grad_()
    w = (0.3 * torch.randn(J * D, F, device=dev, generator=g)).requires_grad_()
    b = torch.randn(J * D, device=dev, generator=g).requires_grad_()
    cot = torch.randn(B, J, 3, device=dev, generator=g)

    counts = [k.launches for k in kernels.KERNELS]
    got_hm, = torch.autograd.grad(integral.softmax_integral(hm, J, D), hm,
                                  cot)
    got_hp = torch.autograd.grad(
        fused_head.head_projection_integral(feats, w, b, J, D),
        (feats, w, b), cot)
    torch.cuda.synchronize()
    launched = {k.symbol: k.launches - c
                for k, c in zip(kernels.KERNELS, counts)}
    assert launched == {"hipe_softmax_integral_fwd": 1,
                        "hipe_head_projection_integral_fwd": 0,
                        "hipe_softmax_integral_bwd": 1,
                        "hipe_head_projection_integral_bwd": 0,
                        "hipe_warp_twopass": 0, "hipe_roi_align_fwd": 0,
                        "hipe_nms": 0, "hipe_roi_align_bwd": 0,
                        # float32 features: the float32 route's entries
                        "hipe_head_projection_integral_fwd_f32": 1,
                        "hipe_head_projection_integral_bwd_f32": 1}

    want_hm, = torch.autograd.grad(
        integral.softmax_integral_reference(hm, J, D)[0], hm, cot)
    want_hp = torch.autograd.grad(
        fused_head.head_projection_integral_reference(feats, w, b, J, D)[0],
        (feats, w, b), cot)
    _close(got_hm, want_hm, torch.float32)
    for gk, wk in zip(got_hp, want_hp):
        _close(gk, wk, torch.float32, FUSED_GRAD_ABS_SCALE)


def test_public_entry_points_launch_the_kernels(dev):
    J, D = 3, 4
    hm = torch.randn(2, 8, 8, J * D, device=dev)
    feats = torch.randn(2, 8, 8, 16, device=dev, dtype=torch.bfloat16)
    w, b = torch.randn(J * D, 16, device=dev), torch.randn(J * D, device=dev)
    images = torch.rand(2, 16, 16, 3, device=dev)
    H = torch.eye(3, device=dev).expand(2, 3, 3)
    fwd = (kernels.SOFTMAX_INTEGRAL_FWD, kernels.HEAD_PROJECTION_INTEGRAL_FWD,
           kernels.WARP_TWOPASS)
    counts = [k.launches for k in fwd]
    integral.softmax_integral(hm, J, D)
    fused_head.head_projection_integral(feats, w, b, J, D)
    out = warp.warp_perspective_batch(images, H, (16, 16))   # "auto"
    torch.cuda.synchronize()
    assert [k.launches for k in fwd] == [c + 1 for c in counts]
    torch.testing.assert_close(out, images, rtol=0, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    J, D = 3, 4
    hm = torch.randn(2, 8, 8, J * D, device=dev)
    feats = torch.randn(2, 8, 8, 16, device=dev, dtype=torch.bfloat16)
    w, b = torch.randn(J * D, 16, device=dev), torch.randn(J * D, device=dev)
    counts = [k.launches for k in kernels.KERNELS]

    for bad in (hm.half(), hm.double()):
        with pytest.raises(TypeError):
            integral.softmax_integral_cuda(bad, J, D)
    with pytest.raises(TypeError):
        fused_head.head_projection_integral_cuda(feats.half(), w, b, J, D)
    with pytest.raises(TypeError):
        fused_head.head_projection_integral_cuda(feats, w.bfloat16(), b, J, D)

    nhwc_view = hm.permute(0, 2, 1, 3)          # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        integral.softmax_integral_cuda(nhwc_view, J, D)
    with pytest.raises(ValueError, match="contiguous"):
        fused_head.head_projection_integral_cuda(
            feats.permute(0, 2, 1, 3), w, b, J, D)
    with pytest.raises(ValueError, match="contiguous"):
        fused_head.head_projection_integral_cuda(
            feats, w.t().contiguous().t(), b, J, D)

    with pytest.raises(ValueError):
        integral.softmax_integral_cuda(hm, J, D + 1)
    with pytest.raises(ValueError):
        fused_head.head_projection_integral_cuda(
            feats, w[:, :8].contiguous(), b, J, D)

    coords, m, s = integral.softmax_integral_reference(hm, J, D)
    with pytest.raises(TypeError):
        integral.softmax_integral_bwd_cuda(hm.half(), m, s, coords, coords,
                                           J, D)
    with pytest.raises(ValueError, match="contiguous"):
        integral.softmax_integral_bwd_cuda(nhwc_view, m, s, coords, coords,
                                           J, D)
    with pytest.raises(ValueError):
        integral.softmax_integral_bwd_cuda(hm, m[:1], s, coords, coords, J, D)
    # every width is taken; features off 16 bytes are not
    off16 = feats.reshape(-1)[1:1 + 2 * 8 * 8 * 15].view(2, 8, 8, 15)
    w15 = torch.randn(J * D, 15, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        fused_head.head_projection_integral_cuda(off16, w15, b, J, D)
    with pytest.raises(ValueError, match="16-byte"):
        fused_head.head_projection_integral_bwd_cuda(
            off16, w15, b, m, s, coords, coords, J, D)
    images = torch.rand(2, 16, 16, 3, device=dev)
    H = torch.eye(3, device=dev).expand(2, 3, 3)
    with pytest.raises(TypeError):
        warp.warp_perspective_cuda(images.double(), H, (8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        warp.warp_perspective_cuda(images.permute(0, 2, 1, 3), H, (8, 8))
    with pytest.raises(ValueError):
        warp.warp_perspective_cuda(images.cpu(), H, (8, 8))
    with pytest.raises(TypeError):
        warp.warp_perspective_cuda(images, H.half(), (8, 8))
    colour = torch.ones(2, 3, device=dev)
    mean_std = ((0.5, 0.5, 0.5), (1.0, 1.0, 1.0))
    for bad in (colour.double(), colour[:, :2], colour.t().contiguous().t(),
                colour.cpu()):
        with pytest.raises(ValueError, match="colour"):
            warp.warp_perspective_cuda(images, H, (8, 8),
                                       normalise=(bad, *mean_std))
    with pytest.raises(ValueError, match="channel"):
        warp.warp_perspective_cuda(images, H, (8, 8),
                                   normalise=(colour, (0.5,), (1.0,)))
    images5 = torch.rand(2, 16, 16, 5, device=dev)
    with pytest.raises(ValueError, match="channel"):
        warp.warp_perspective_cuda(
            images5, H, (8, 8), normalise=(torch.ones(2, 5, device=dev),
                                           (0.5,) * 5, (1.0,) * 5))
    assert [k.launches for k in kernels.KERNELS] == counts

    # grad-requiring inputs now launch the forward kernels, and the
    # backward kernels on backward
    hm.requires_grad_()
    w.requires_grad_()
    integral.softmax_integral(hm, J, D).sum().backward()
    fused_head.head_projection_integral(feats, w, b, J, D).sum().backward()
    torch.cuda.synchronize()
    assert [k.launches for k in kernels.KERNELS] == [
        c + (k not in (kernels.WARP_TWOPASS, kernels.ROI_ALIGN_FWD,
                       kernels.NMS, kernels.ROI_ALIGN_BWD,
                       kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32,
                       kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32))
        for k, c in zip(kernels.KERNELS, counts)]  # bf16 features
    assert hm.grad.shape == hm.shape and w.grad.shape == w.shape


def _nms_boxes(mode: str, B: int, N: int, seed: int):
    """(B, N, 4) boxes and (B, N) scores on the host: the alternating chain
    (every other box survives), disjoint boxes (every box survives), random
    boxes, random boxes of which image b has only 12 + 25 b alive (score -1
    for the rest, so the images keep different counts), proposal-like
    clusters of near-duplicates, or clusters with tied scores (a tenth of
    them -1, as the min-size filter leaves them)."""
    rng = np.random.RandomState(seed)
    if mode in ("chain", "disjoint"):
        i = np.arange(N, dtype=np.float64)
        step = 4 if mode == "chain" else 20
        b = np.stack([step * i, 0 * i, step * i + 10, 0 * i + 10], -1)
        return (np.broadcast_to(b, (B, N, 4)).astype(np.float32),
                np.broadcast_to(np.linspace(1.0, 0.5, N), (B, N))
                .astype(np.float32))
    if mode in ("random", "staggered"):
        ctr = rng.rand(B, N, 2) * 600
        wh = rng.rand(B, N, 2) * 120 + 8
    else:
        k = max(N // 60, 1)
        ctr = (rng.rand(B, N, 2) * 60
               + np.repeat(rng.rand(B, k, 2) * 500, -(-N // k), axis=1)[:, :N])
        wh = rng.rand(B, N, 2) * 60 + 40
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.rand(B, N).astype(np.float32)
    if mode == "ties":
        scores = np.round(scores * 8) / 8
        scores[rng.rand(B, N) < 0.1] = -1.0
    if mode == "staggered":
        for b in range(B):
            scores[b, 12 + 25 * b:] = -1.0
    return boxes, scores.astype(np.float32)


# (mode, B, N, IoU threshold, top_k, score threshold): the chain across
# many 64-box blocks, the RPN shape, the class-NMS shape, ties, top_k > N;
# then one box, one block short of full, one full block, one box past it;
# every box dead (score threshold above every score); disjoint boxes, so
# every block keeps all 64 rows (the most words to OR); with early_exit a
# stop inside a block at B = 4 with other kept counts per image (12, 37,
# 37, 37 at most); and B = 1 at N = 20 000, whose 313-word rows the sweep
# stages in column chunks
NMS_CASES = [("chain", 1, 1100, 0.3, 1100, -math.inf),
             ("clustered", 4, 6000, 0.7, 300, 0.0),
             ("random", 4, 6000, 0.7, 300, 0.0),
             ("clustered", 4, 300, 0.3, 100, 0.001),
             ("ties", 2, 700, 0.5, 50, 0.0),
             ("random", 3, 40, 0.5, 100, -math.inf),
             ("random", 2, 1, 0.5, 10, -math.inf),
             ("random", 2, 63, 0.5, 70, 0.0),
             ("clustered", 2, 64, 0.3, 70, 0.0),
             ("random", 2, 65, 0.5, 70, 0.0),
             ("clustered", 2, 500, 0.7, 100, 2.0),
             ("disjoint", 2, 1000, 0.5, 1000, -math.inf),
             ("staggered", 4, 300, 0.5, 37, 0.0),
             ("clustered", 1, 20000, 0.7, 2000, 0.0)]


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_kernel_matches_plain(dev, case, early_exit):
    mode, B, N, thr, top_k, score_thr = case
    boxes, scores = _nms_boxes(mode, B, N, seed=N)
    boxes, scores = torch.from_numpy(boxes).to(dev), torch.from_numpy(
        scores).to(dev)
    before = kernels.NMS.launches
    got = nms.nms(boxes, scores, thr, top_k, score_thr, impl="cuda",
                  early_exit=early_exit)
    torch.cuda.synchronize()
    assert kernels.NMS.launches == before + 1
    want = nms.nms(boxes, scores, thr, top_k, score_thr, impl="plain",
                   early_exit=early_exit)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if mode == "chain":
        assert int(got[2].sum()) == N // 2
        torch.testing.assert_close(got[0][0, :N // 2], boxes[0, ::2],
                                   rtol=0, atol=0)
    if mode == "disjoint":
        assert bool(got[2].all())
    if score_thr > 1.0:
        assert not bool(got[2].any())
    if mode == "staggered":
        assert got[2].sum(1).tolist()[0] <= 12
        assert got[2].sum(1).tolist()[3] == top_k


def test_nms_kernel_takes_and_returns_bool(dev):
    """The wrapper hands the bool pre-alive flags to the kernel as they are
    and returns the kernel's bool keep flags: one counted launch, and the
    keep vector bitwise the plain version's (no early exit)."""
    boxes, scores = _nms_boxes("clustered", 4, 6000, seed=3)
    boxes, scores = torch.from_numpy(boxes).to(dev), torch.from_numpy(
        scores).to(dev)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand_as(boxes))
    alive0 = torch.gather(scores, 1, order) > 0.0
    before = kernels.NMS.launches
    keep = nms._alive_cuda(b, alive0, 0.7, True)
    torch.cuda.synchronize()
    assert kernels.NMS.launches == before + 1
    assert keep.dtype == torch.bool and keep.shape == alive0.shape
    assert torch.equal(keep, nms._alive_plain(b, alive0, 0.7, True))
    with pytest.raises(ValueError, match="too large"):
        nms._alive_cuda(torch.zeros(1, 400000, 4, device=dev),
                        torch.ones(1, 400000, dtype=torch.bool, device=dev),
                        0.5, True)


# RoIs of the edge cases, xyxy in image pixels (stride 16): larger than a
# 38 x 38 map on every side, zero width, zero height, inverted, entirely
# before and entirely beyond the map, and a thin one across a cell border
EDGE_ROIS = [[-500.0, -500.0, 2000.0, 2000.0], [300.0, 40.0, 300.0, 400.0],
             [40.0, 300.0, 400.0, 300.0], [400.0, 420.0, 100.0, 60.0],
             [-300.0, -250.0, -200.0, -100.0], [700.0, 650.0, 900.0, 990.0],
             [100.0, 0.0, 127.9, 16.0]]


def _roi_inputs(shape, g, dev, edge=False):
    """Features and RoIs that cross the border, some thinner than a
    feature cell; with `edge`, EDGE_ROIS replace the first RoIs of every
    image."""
    B, H, W, C, R = shape
    feats = torch.randn(B, H, W, C, device=dev, generator=g)
    lo = torch.rand(B, R, 2, device=dev, generator=g) * torch.tensor(
        [16.0 * W, 16.0 * H], device=dev) - 40
    wh = torch.rand(B, R, 2, device=dev, generator=g) * 300 + 4
    rois = torch.cat([lo, lo + wh], -1)
    if edge:
        rois[:, :len(EDGE_ROIS)] = torch.tensor(EDGE_ROIS, device=dev)
    return feats, rois


# (B, H, W, C, R, pooled, sampling ratio, edge RoIs): the detector's shape,
# then H*W not a multiple of 8 with an odd RoI count, then C not a
# multiple of 4 (the kernel's scalar path); then sampling ratios 1 and 4,
# pooled 14, the edge RoIs, and C = 6 at the detector's 38 x 38
ROI_CASES = [(4, 38, 38, 1024, 300, 7, 2, False),
             (2, 21, 19, 256, 13, 7, 2, False), (3, 9, 11, 6, 7, 7, 2, False),
             (2, 38, 38, 256, 40, 7, 1, False),
             (2, 38, 38, 256, 40, 7, 4, True),
             (2, 38, 38, 128, 30, 14, 2, True),
             (2, 38, 38, 1024, 20, 7, 2, True),
             (3, 38, 38, 6, 50, 7, 2, True)]


@pytest.mark.parametrize("case", ROI_CASES)
def test_roi_align_kernel_matches_plain(dev, case):
    B, H, W, C, R, P, sr, edge = case
    g = torch.Generator(device=dev).manual_seed(7)
    feats, rois = _roi_inputs((B, H, W, C, R), g, dev, edge)
    before = kernels.ROI_ALIGN_FWD.launches
    got = roi_align.roi_align_batched(feats, rois, P, 1 / 16.0, sr)
    torch.cuda.synchronize()
    assert kernels.ROI_ALIGN_FWD.launches == before + 1
    want = roi_align.roi_align_batched(feats, rois, P, 1 / 16.0, sr,
                                       impl="plain")
    assert got.shape == (B, R, P, P, C) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=ROI_TOL * max(
        1.0, float(feats.abs().max())))
    assert float(got.abs().sum()) > 0
    if edge:   # the RoIs outside the map pool zeros
        assert not bool(got[:, 4:6].any())


def _training_rois(B, R, H, W, g, dev):
    """(B, R, 4) RoIs in the training proposal targets' layout: a quarter
    foreground near the image's gt box (the gt box itself among them), the
    rest background anywhere, the last eighth zero padding slots; among
    them RoIs partly off the map and one under a single feature cell."""
    gt = torch.tensor([4.0 * W, 4.0 * H, 12.0 * W, 12.0 * H], device=dev)
    n_fg, n_pad = max(R // 4, 1), R // 8
    n_bg = R - n_fg - n_pad
    fg = gt + (torch.rand(B, n_fg, 4, device=dev, generator=g) - 0.5) * 40
    fg[:, 0] = gt
    lo = torch.rand(B, n_bg, 2, device=dev,
                    generator=g) * torch.tensor([16.0 * W, 16.0 * H],
                                                device=dev) - 40
    bg = torch.cat([lo, lo + torch.rand(B, n_bg, 2, device=dev,
                                        generator=g) * 300 + 2], -1)
    rois = torch.cat([fg, bg, torch.zeros(B, n_pad, 4, device=dev)], 1)
    if n_bg >= 2:
        rois[:, n_fg] = torch.tensor([100.0, 100.0, 108.0, 104.0],
                                     device=dev)
        rois[:, n_fg + 1] = torch.tensor(
            [-60.0, 20.0, 40.0, 16.0 * H + 30.0], device=dev)
    return rois


# (B, H, W, C, R, pooled, sampling ratio): the detector's training shape
# (4 images x 128 sampled RoIs), ragged maps with an odd RoI count, R = 1,
# C not a multiple of 4 (the scalar path), sampling ratios 1 and 4,
# pooled 14 (the kernel cuts the map into bands of rows) and the largest
# pooled size, 32; maps whose 32-channel strip exceeds shared memory
# (bands of rows, RoIs crossing them), one at 1 000 px with 1 024 channels
ROI_BWD_CASES = [(4, 38, 38, 1024, 128, 7, 2), (2, 21, 19, 256, 13, 7, 2),
                 (1, 9, 11, 64, 1, 7, 2), (3, 9, 11, 6, 9, 7, 2),
                 (2, 38, 38, 256, 40, 7, 1), (2, 38, 38, 256, 40, 7, 4),
                 (2, 38, 38, 128, 30, 14, 2), (1, 17, 23, 8, 5, 32, 2),
                 (2, 100, 90, 64, 20, 7, 2), (2, 63, 38, 1024, 64, 7, 2)]


@pytest.mark.parametrize("case", ROI_BWD_CASES)
def test_roi_align_bwd_kernel_matches_plain(dev, case):
    """The backward kernel against autograd's VJP of the plain version:
    the same float32 weights summed in another order, 1e-5 of the largest
    gradient entry; two launches give the same bits."""
    B, H, W, C, R, P, sr = case
    g = torch.Generator(device=dev).manual_seed(11)
    rois = _training_rois(B, R, H, W, g, dev)
    cot = torch.randn(B, R, P, P, C, device=dev, generator=g)
    before = kernels.ROI_ALIGN_BWD.launches
    got = roi_align.roi_align_bwd_cuda(cot, rois, (H, W), 1 / 16.0, sr)
    again = roi_align.roi_align_bwd_cuda(cot, rois, (H, W), 1 / 16.0, sr)
    torch.cuda.synchronize()
    assert kernels.ROI_ALIGN_BWD.launches == before + 2
    want = roi_align.roi_align_bwd_plain(cot, rois, (H, W), 1 / 16.0, sr)
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ROI_TOL * float(want.abs().max()))
    assert float(want.abs().max()) > 0


def test_roi_align_bwd_image_without_rois(dev):
    """An image whose RoIs all lie off the map gets a zero gradient, the
    other images theirs, in a banded launch (100 x 90 map) and in one
    band."""
    g = torch.Generator(device=dev).manual_seed(13)
    for H, W in ((100, 90), (38, 38)):
        rois = _training_rois(3, 16, H, W, g, dev)
        rois[1] = torch.tensor([-900.0, -900.0, -500.0, -600.0], device=dev)
        cot = torch.randn(3, 16, 7, 7, 64, device=dev, generator=g)
        got = roi_align.roi_align_bwd_cuda(cot, rois, (H, W))
        torch.cuda.synchronize()
        want = roi_align.roi_align_bwd_plain(cot, rois, (H, W))
        assert not bool(got[1].any()) and not bool(want[1].any())
        assert bool(got[0].any()) and bool(got[2].any())
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=ROI_TOL * float(want.abs().max()))


def test_roi_align_bwd_through_autograd_and_refusals(dev):
    """A loss through roi_align_batched on the card takes the backward
    kernel once and gives the plain path's feature gradient; the kernel
    refuses a pooled size above 32 and mismatched RoIs."""
    g = torch.Generator(device=dev).manual_seed(5)
    feats = torch.randn(2, 12, 10, 32, device=dev, generator=g)
    rois = _training_rois(2, 16, 12, 10, g, dev)
    w = torch.randn(2, 16, 7, 7, 32, device=dev, generator=g)
    f = feats.clone().requires_grad_()
    counts = {k.symbol: k.launches for k in kernels.KERNELS}
    (roi_align.roi_align_batched(f, rois) * w).sum().backward()
    torch.cuda.synchronize()
    launched = {k.symbol: k.launches - counts[k.symbol]
                for k in kernels.KERNELS}
    assert launched["hipe_roi_align_fwd"] == 1
    assert launched["hipe_roi_align_bwd"] == 1
    fp = feats.clone().requires_grad_()
    (roi_align.roi_align_batched(fp, rois, impl="plain") * w).sum().backward()
    torch.testing.assert_close(f.grad, fp.grad, rtol=0,
                               atol=ROI_TOL * float(fp.grad.abs().max()))
    before = kernels.ROI_ALIGN_BWD.launches
    with pytest.raises(ValueError):
        roi_align.roi_align_bwd_cuda(
            torch.zeros(2, 16, 33, 33, 32, device=dev), rois, (12, 10))
    with pytest.raises(ValueError):
        roi_align.roi_align_bwd_cuda(w, rois[:, :3], (12, 10))
    with pytest.raises(ValueError):
        roi_align.roi_align_bwd_cuda(w, rois.cpu(), (12, 10))
    assert kernels.ROI_ALIGN_BWD.launches == before


def test_detector_kernel_wrappers_refuse_what_they_do_not_take(dev):
    feats = torch.randn(1, 8, 8, 16, device=dev)
    rois = torch.tensor([[[0.0, 0.0, 60.0, 60.0]]], device=dev)
    boxes = torch.rand(1, 10, 4, device=dev)
    counts = [k.launches for k in kernels.KERNELS]
    with pytest.raises(TypeError):
        roi_align.roi_align_cuda(feats.double(), rois)
    with pytest.raises(ValueError, match="contiguous"):
        roi_align.roi_align_cuda(feats.permute(0, 2, 1, 3), rois)
    with pytest.raises(ValueError):
        roi_align.roi_align_cuda(feats, rois.cpu())
    with pytest.raises(ValueError):
        roi_align.roi_align_cuda(feats, rois[:, :, :3])
    with pytest.raises(ValueError):
        nms._alive_cuda(boxes.cpu(), torch.ones(1, 10, dtype=torch.bool),
                        0.5, True)
    with pytest.raises(ValueError):
        nms._alive_cuda(boxes, torch.ones(1, 9, dtype=torch.bool,
                                          device=dev), 0.5, True)
    assert [k.launches for k in kernels.KERNELS] == counts


# ------------------------------------------------ CUDA graphs (scan_steps)


def _graph_config():
    """ResNet-18 at 64x64 with a 16x16 x 8 heatmap, bf16 compute (the
    main path's dtype: the tensor-core fused head) and batch 4."""
    from hand_integral_pose_estimation_tpu_torch.config import (
        Config,
        ModelConfig,
        TrainConfig,
    )
    return Config(model=ModelConfig(resnet_type=18, input_shape=(64, 64),
                                    output_shape=(16, 16), depth_dim=8),
                  train=TrainConfig(batch_size=4, lr=1e-3,
                                    lr_dec_epoch=(1,)))


def _graph_dataset(n=12, seed=1):
    from hand_integral_pose_estimation_tpu_torch.data import (
        SyntheticFreiHand,
    )
    return SyntheticFreiHand(n=n, image_hw=(64, 64), seed=seed)


def _training_state(trainer):
    out = dict(trainer.model.state_dict())
    for i, p in enumerate(trainer.model.parameters()):
        for k, v in trainer.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return out


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms, so two runs of the same steps can
    be compared bit for bit."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


@pytest.mark.parametrize("scan_steps", [1, 2, 4])
@pytest.mark.parametrize("fuse_head", [True, False])
def test_train_graph_replays_equal_eager_steps(dev, deterministic,
                                               fuse_head, scan_steps):
    """Trainer(scan_steps=k) on the card against the same Trainer run
    eagerly (its `graphs` set to None), from the same seed: two epochs of 8
    steps (the first chunk eager as the warm-up, every later chunk a replay
    of the one captured chunk, the generator reseeded between epochs) end
    in the same metrics, parameters, BatchNorm statistics and Adam state,
    bit for bit. The schedule's boundary at step 6 falls inside a replay
    (k = 4) or at its start (k = 1, 2). The captured chunk holds each of
    its kernels once per step."""
    from hand_integral_pose_estimation_tpu_torch.training import Trainer

    kw = dict(cfg=_graph_config(), dataset=_graph_dataset(n=24),
              model_dir="unused", seed=4, device=dev, fuse_head=fuse_head,
              scan_steps=scan_steps)
    eager = Trainer(**kw)
    eager.graphs = None
    graphed = Trainer(**kw)
    assert graphed.steps_per_epoch == 6 and isinstance(
        graphed.optimizer.param_groups[0]["lr"], torch.Tensor)
    for epoch in range(2):
        m_eager = eager.run_epoch(epoch, num_steps=8, log_every=100)
        m_graph = graphed.run_epoch(epoch, num_steps=8, log_every=100)
        assert m_graph == m_eager
    assert list(graphed.graphs.replays.values()) == [16 // scan_steps - 1]
    a, b = _training_state(graphed), _training_state(eager)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert float(graphed.optimizer.param_groups[0]["lr"]) == pytest.approx(
        1e-4, rel=1e-6)

    (graph,) = graphed.graphs.graphs.values()
    nodes = kernels.graph_launches(graph)
    fwd, bwd = ((kernels.HEAD_PROJECTION_INTEGRAL_FWD,
                 kernels.HEAD_PROJECTION_INTEGRAL_BWD) if fuse_head else
                (kernels.SOFTMAX_INTEGRAL_FWD, kernels.SOFTMAX_INTEGRAL_BWD))
    assert nodes == {k.symbol: scan_steps if k in (
        fwd, bwd, kernels.WARP_TWOPASS) else 0 for k in kernels.KERNELS}
    assert graphed.graphs.kernel_launches()[fwd.symbol] == 16 - scan_steps


@pytest.mark.parametrize("fuse_head", [True, False])
def test_tester_replays_equal_eager_coords(dev, fuse_head):
    """Tester.run on the card replays one eval graph per batch after the
    first: against the same Tester with its `graphs` set to None, 10 samples at batch 4 (the last batch padded) give the eager
    sweep's coords and Batch fields bit for bit, and the graph holds one
    forward kernel."""
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.training import Tester

    cfg = _graph_config()
    model = get_pose_net(cfg.model, torch.Generator().manual_seed(2))
    with torch.no_grad():
        model.head.final_layer.weight.normal_(0.0, 0.05)
    data = _graph_dataset(n=10)
    eager = Tester(cfg, data, model, device=dev, fuse_head=fuse_head)
    eager.graphs = None
    graphed = Tester(cfg, data, model, device=dev, fuse_head=fuse_head)
    want, want_batch = eager.run(batch_size=4)
    got, got_batch = graphed.run(batch_size=4)
    assert list(graphed.graphs.replays.values()) == [2]
    assert np.array_equal(got, want) and float(np.std(got)) > 1e-3
    for name, g, w in zip(got_batch._fields, got_batch, want_batch):
        assert (g is None) == (w is None), name
        if g is not None:
            assert np.array_equal(g, w), name
    got_again, _ = graphed.run(batch_size=4)
    assert np.array_equal(got_again, want)
    (graph,) = graphed.graphs.graphs.values()
    fwd = (kernels.HEAD_PROJECTION_INTEGRAL_FWD if fuse_head
           else kernels.SOFTMAX_INTEGRAL_FWD)
    assert kernels.graph_launches(graph) == {
        k.symbol: int(k is fwd) for k in kernels.KERNELS}


def _kernel_calls(dev):
    """One call of each pose kernel's wrapper at a small main-path shape:
    {name: (kernel, fn)}."""
    g = torch.Generator(device=dev).manual_seed(12)
    B, H, W, J, D, F = 4, 16, 16, 21, 8, 256
    hm = (3 * torch.randn(B, H, W, J * D, device=dev, generator=g)).to(
        torch.bfloat16)
    feats = torch.randn(B, H, W, F, device=dev, generator=g).to(
        torch.bfloat16)
    w = 0.1 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    cot = torch.randn(B, J, 3, device=dev, generator=g)
    c1, m1, s1 = integral.softmax_integral_cuda(hm, J, D)
    c3, m3, s3 = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    frames = (255 * torch.rand(B, 96, 96, 3, device=dev, generator=g)).to(
        torch.uint8)
    maps = _homographies(B, g, dev)
    colour = 0.8 + 0.4 * torch.rand(B, 3, device=dev, generator=g)
    return {
        "1": (kernels.SOFTMAX_INTEGRAL_FWD,
              lambda: integral.softmax_integral_cuda(hm, J, D)),
        "2": (kernels.SOFTMAX_INTEGRAL_BWD,
              lambda: (integral.softmax_integral_bwd_cuda(
                  hm, m1, s1, c1, cot, J, D),)),
        "3": (kernels.HEAD_PROJECTION_INTEGRAL_FWD,
              lambda: fused_head.head_projection_integral_cuda(
                  feats, w, b, J, D)),
        "3-float32": (kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32,
                      lambda: fused_head.head_projection_integral_cuda(
                          feats.float(), w, b, J, D)),
        "4": (kernels.HEAD_PROJECTION_INTEGRAL_BWD,
              lambda: fused_head.head_projection_integral_bwd_cuda(
                  feats, w, b, m3, s3, c3, cot, J, D)),
        "4-float32": (kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32,
                      lambda: fused_head.head_projection_integral_bwd_cuda(
                          feats.float(), w, b, m3, s3, c3, cot, J, D)),
        "5": (kernels.WARP_TWOPASS,
              lambda: (warp.warp_normalise_batch(
                  frames, maps, (64, 64), colour, (120.0, 110.0, 100.0),
                  (60.0, 55.0, 50.0)),)),
    }


@pytest.mark.parametrize("name", ["1", "2", "3", "3-float32", "4",
                                  "4-float32", "5"])
def test_kernel_captures_alone(dev, name):
    """Each pose kernel's wrapper captured alone in a CUDA graph, after one
    eager call: the capture counts no launch, the graph holds the kernel
    once, and a replay gives the eager call's bits. (Kernels 3 and 4 set
    their shared-memory attribute and kernel 1 plans its chunks on every
    call; both are allowed under capture.)"""
    kernel, fn = _kernel_calls(dev)[name]
    want = [t.clone() for t in fn()]
    torch.cuda.synchronize()
    launches = kernel.launches
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    assert kernel.launches == launches
    assert kernels.graph_launches(graph) == {
        k.symbol: int(k is kernel) for k in kernels.KERNELS}
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, w in zip(out, want):
        assert torch.equal(got, w)


def test_failed_capture_raises_without_eager_retry(dev):
    """A step that cannot be captured raises on the call that captures it,
    and nothing runs it eagerly instead: an error inside the captured
    function, and (in a child process, since a sync under capture
    invalidates the capture) a read back to the host."""
    import subprocess
    import sys

    from hand_integral_pose_estimation_tpu_torch.training.graphs import (
        CapturedStep,
    )

    calls = []

    def fn(d):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("refused under capture")
        return d["x"] * 2

    step = CapturedStep(fn, dev)
    host = {"x": np.arange(4, dtype=np.float32)}
    assert torch.equal(step(host).cpu(), torch.arange(4.0) * 2)
    with pytest.raises(RuntimeError, match="refused under capture"):
        step(host)
    assert calls == [False, True] and not step.graphs

    code = (
        "import numpy as np, torch\n"
        "from hand_integral_pose_estimation_tpu_torch.training.graphs "
        "import CapturedStep\n"
        "calls = []\n"
        "def fn(d):\n"
        "    calls.append(torch.cuda.is_current_stream_capturing())\n"
        "    return d['x'] * float(d['x'].sum())\n"
        "step = CapturedStep(fn, 'cuda')\n"
        "host = {'x': np.ones(4, np.float32)}\n"
        "step(host)\n"
        "try:\n"
        "    step(host)\n"
        "except RuntimeError as e:\n"
        "    print('raised', calls, len(step.graphs))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert "raised [False, True] 0" in out.stdout, out.stdout + out.stderr


def test_graph_snapshot_resumes_on_the_host_and_back(dev, tmp_path):
    """A snapshot of a graph-replaying Trainer (capturable Adam: device step
    counts, a tensor rate) resumes in a CPU Trainer at the same step, rate,
    parameters and moments, and that Trainer's next snapshot resumes on
    the card again, where the device schedule continues at its step."""
    from hand_integral_pose_estimation_tpu_torch.training import Trainer
    from hand_integral_pose_estimation_tpu_torch.training.state import (
        optimizer_steps,
    )

    cfg = _graph_config()
    kw = dict(cfg=cfg, dataset=_graph_dataset(), model_dir=str(tmp_path),
              seed=0)
    card = Trainer(device=dev, scan_steps=2, **kw)
    card.fit(end_epoch=1, steps_per_epoch=4)
    snap = torch.load(tmp_path / "snapshot_0.pth.tar", weights_only=True)
    assert snap["optimizer"]["param_groups"][0]["capturable"]
    host = Trainer(device="cpu", continue_train=True, **kw)
    group = host.optimizer.param_groups[0]
    assert optimizer_steps(host.optimizer) == 4 and not group["capturable"]
    assert group["lr"] == pytest.approx(cfg.train.lr * 0.1)  # step 4 >= 3
    for p, q in zip(host.model.parameters(), card.model.parameters()):
        assert torch.equal(p, q.cpu())
        a, b = host.optimizer.state[p], card.optimizer.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"].cpu())
        assert a["step"].device.type == "cpu"
    host.fit(end_epoch=2, steps_per_epoch=2)
    back = Trainer(device=dev, continue_train=True, **kw)
    lr = back.optimizer.param_groups[0]["lr"]
    assert back.optimizer.param_groups[0]["capturable"]
    assert lr.device.type == "cuda" and float(lr) == pytest.approx(
        cfg.train.lr * 0.1, rel=1e-6)
    assert optimizer_steps(back.optimizer) == 6
    for p in back.model.parameters():
        assert back.optimizer.state[p]["step"].device.type == "cuda"
    back.run_epoch(2, num_steps=4, log_every=100)
    assert optimizer_steps(back.optimizer) == 10


def _optax_adam(p0, grads, lr_at, weight_decay, b1=0.9, b2=0.999,
                eps=1e-8):
    """The JAX package's optax chain (add_decayed_weights -> scale_by_adam
    -> scale_by_learning_rate with the schedule at the step count before
    the update) written out in float64 numpy: after each gradient, each
    parameter's (value, first moment, second moment)."""
    p = {k: v.copy() for k, v in p0.items()}
    mu = {k: np.zeros_like(v) for k, v in p0.items()}
    nu = {k: np.zeros_like(v) for k, v in p0.items()}
    out = []
    for count, g in enumerate(grads):
        for k in p:
            gk = g[k] + weight_decay * p[k]
            mu[k] = b1 * mu[k] + (1 - b1) * gk
            nu[k] = b2 * nu[k] + (1 - b2) * gk * gk
            mu_hat = mu[k] / (1 - b1 ** (count + 1))
            nu_hat = nu[k] / (1 - b2 ** (count + 1))
            p[k] = p[k] - lr_at(count) * mu_hat / (np.sqrt(nu_hat) + eps)
        out.append({k: (p[k].copy(), mu[k].copy(), nu[k].copy()) for k in p})
    return out


def test_card_adam_and_schedule_match_the_host_and_optax(dev):
    """The card's optimizer (capturable, fused Adam with the device
    schedule), stepped eagerly and as one captured step replayed per
    gradient, over six gradients with decay boundaries at steps 2 and 4
    (both crossed in replays): every step's rate is the JAX schedule's,
    and the parameters and both moments after every step equal the CPU
    form's (held to the JAX package's optax chain by
    tests/test_torch_train.py::test_adam_and_schedule_match_jax) and the
    optax chain written out in float64, to 1e-6. (The gradients are kept
    away from 0, where Adam's first step, about lr * sign(g), would
    amplify rounding.)"""
    from hand_integral_pose_estimation_tpu_torch.config import TrainConfig
    from hand_integral_pose_estimation_tpu_torch.training.state import (
        make_optimizer,
        multistep_factor,
        multistep_schedule,
        optimizer_steps,
    )

    tcfg = TrainConfig(lr=1e-2, lr_dec_epoch=(2, 4), lr_dec_factor=0.1,
                       weight_decay=1e-2)
    rng = np.random.default_rng(10)
    p0 = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(5,))}
    grads = [{k: np.sign(v) * (0.5 + np.abs(v)) for k, v in
              ((k, rng.normal(size=v.shape)) for k, v in p0.items())}
             for _ in range(6)]
    factor = multistep_factor(1, tcfg.lr_dec_epoch, tcfg.lr_dec_factor)
    want = _optax_adam(p0, grads, lambda n: tcfg.lr * factor(n),
                       tcfg.weight_decay)

    def run(device, captured):
        params = {k: torch.nn.Parameter(torch.tensor(
            v, dtype=torch.float32, device=device)) for k, v in p0.items()}
        opt = make_optimizer(params.values(), tcfg)
        schedule = multistep_schedule(opt, 1, tcfg.lr_dec_epoch,
                                      tcfg.lr_dec_factor)
        assert opt.param_groups[0]["capturable"] == (device != "cpu")
        for p in params.values():
            p.grad = torch.zeros_like(p)

        def step():
            opt.step()
            schedule.step()

        graph = None
        trace = []
        for n, g in enumerate(grads):
            lr = float(opt.param_groups[0]["lr"])
            for k, p in params.items():
                p.grad.copy_(torch.from_numpy(g[k]))
            if captured and n > 0:
                if graph is None:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        step()
                graph.replay()
            else:
                step()
            trace.append((lr, {k: tuple(
                t.detach().double().cpu().numpy() for t in (
                    p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]))
                for k, p in params.items()}))
        assert optimizer_steps(opt) == len(grads)
        return trace

    host = run("cpu", False)
    for captured in (False, True):
        card = run(dev, captured)
        for n, ((lr, got), (lr_host, on_host), ref) in enumerate(
                zip(card, host, want)):
            assert lr == pytest.approx(tcfg.lr * factor(n), rel=1e-6)
            assert lr == lr_host
            for k in p0:
                for name, x, y, z in zip(("param", "exp_avg", "exp_avg_sq"),
                                         got[k], on_host[k], ref[k]):
                    msg = f"{k} {name} after step {n}, captured {captured}"
                    np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6,
                                               err_msg=msg + " (host)")
                    np.testing.assert_allclose(x, z, rtol=1e-6, atol=1e-6,
                                               err_msg=msg + " (optax)")


# ------------------------------------------------- the semi-supervised path


def test_panet_on_the_card_matches_the_cpu_at_float64(dev):
    """The full-width PANet (DEFAULT_DICT_SIZES) at batch 500 on the card
    (float32) against the same module on the CPU at float64: the
    reconstruction to 1e-4 of its largest entry, every parameter
    gradient of panet_loss to 1e-3 of its largest entry; the cameras
    orthonormal with det +1 (1e-5). make_orthonormal captures in a CUDA
    graph and its replay equals the eager call bit for bit;
    torch.linalg.svd does not capture (it reads cuSOLVER's status on the
    host): shown in a child process, since a failed capture leaves the
    context unusable for later tests."""
    from hand_integral_pose_estimation_tpu_torch.models import panet

    g = torch.Generator().manual_seed(0)
    cpu = panet.PANet(generator=g).double()
    with torch.no_grad():
        for layer in cpu.sparse_coding_layers:
            layer.bias_encode_with_cam.uniform_(0.0, 0.05, generator=g)
    card = panet.PANet().to(dev)
    card.load_state_dict(cpu.state_dict())
    pts = torch.randn(500, 21, 3, generator=g, dtype=torch.float64) * 0.05
    pts = pts - pts.mean(1, keepdim=True)
    want = cpu(pts)
    got = card(pts.float().to(dev))
    for w, x in zip(want, got):
        torch.testing.assert_close(x.detach().double().cpu(), w.detach(),
                                   rtol=0,
                                   atol=1e-4 * float(w.detach().abs().max()))
    cam = got[2].double()
    torch.testing.assert_close(cam @ cam.mT, torch.eye(
        3, dtype=cam.dtype, device=dev).expand_as(cam), rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.linalg.det(cam), torch.ones(
        500, dtype=cam.dtype, device=dev), rtol=0, atol=1e-5)
    panet.panet_loss(cpu, pts)[0].backward()
    panet.panet_loss(card, pts.float().to(dev))[0].backward()
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        torch.testing.assert_close(pg.grad.double().cpu(), pc.grad, rtol=0,
                                   atol=1e-3 * float(pc.grad.abs().max()),
                                   msg=name)

    M = torch.randn(500, 3, 3, device=dev)
    eager = panet.make_orthonormal(M)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        panet.make_orthonormal(M)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = panet.make_orthonormal(M)
    graph.replay()
    assert torch.equal(out, eager)
    proc = subprocess.run([sys.executable, "-c", SVD_CAPTURE],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode != 0, proc.stdout
    assert "capture" in proc.stderr, proc.stderr[-2000:]


# the closest rotation through torch.linalg.svd (U V^T, U's last column
# times sign(det(U V^T))), as the JAX package forms it
SVD_CAPTURE = """
import torch
def closest_rotation(M):
    U, _, Vh = torch.linalg.svd(M, full_matrices=False)
    sign = torch.sign(torch.linalg.det(U @ Vh))
    one = torch.ones_like(sign)
    return (U * torch.stack([one, one, sign], dim=-1)[..., None, :]) @ Vh
M = torch.randn(500, 3, 3, device="cuda")
closest_rotation(M)
torch.cuda.synchronize()
with torch.cuda.graph(torch.cuda.CUDAGraph()):
    closest_rotation(M)
"""


def _sweep_inputs(dev, B=4, hw=224, seed=0):
    from hand_integral_pose_estimation_tpu_torch.data import (
        SyntheticFreiHand,
    )
    from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels \
        import camera_project
    from hand_integral_pose_estimation_tpu_torch.geometry import bbox as bb

    host = SyntheticFreiHand(n=B, image_hw=(hw, hw), seed=seed,
                             render_joints=True).host_batch(np.arange(B))
    images, K, joints, labelled = (torch.from_numpy(host[k]).to(dev) for k in
                                   ("image", "K", "joint_cam", "labelled"))
    uv, _, _ = camera_project(joints, K)
    box = bb.bbox_from_keypoints(uv, torch.ones_like(uv[..., 0]))
    return images, K, box, labelled, joints


@pytest.mark.parametrize("mode", ["factored", "composed"])
def test_teacher_sweep_kernels_match_plain(dev, mode):
    """The teacher-label sweep of 4 images x 21 rotations with a frozen R18
    teacher at 64²: kernel 5's rotated crops equal the plain two-pass
    chain's bit for bit (float32 320² bases or uint8 frames); the
    kernel-backed filter (kernels 5 and 3, one launch of each per sweep)
    against the plain-backed one (method "twopass", the fused head's plain
    version): per-rotation predictions to 1e-4, keep sets equal at a
    threshold between the two middle variances."""
    from hand_integral_pose_estimation_tpu_torch.config import AugmentConfig
    from hand_integral_pose_estimation_tpu_torch.distill import (
        generate_filtered_labels,
        sweep_patches,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.training.teacher import (
        frozen_teacher,
    )

    cfg = _graph_config()
    images, K, box, labelled, joints = _sweep_inputs(dev)
    thetas = np.linspace(-0.52, 0.52, 21)
    args = (images, K, box, AugmentConfig(), thetas, 0.52, (64, 64), mode)
    fast = sweep_patches(*args)
    plain = sweep_patches(*args, method="twopass")
    assert fast.shape == (84, 64, 64, 3)
    assert torch.equal(fast, plain)

    net = get_pose_net(cfg.model, torch.Generator().manual_seed(3)).to(dev)
    with torch.no_grad():
        net.head.final_layer.weight.normal_(0.0, 0.02)
    teacher = frozen_teacher(net, cfg)

    def plain_teacher(patches):
        feats = net(patches, return_features=True)
        w, b = net.final_projection()
        return fused_head.head_projection_integral_reference(
            feats, w, b, cfg.model.num_joints, cfg.model.depth_dim)[0]

    kw = dict(patch_hw=(64, 64), rotation_mode=mode)
    unl = torch.zeros_like(labelled)
    before = (kernels.WARP_TWOPASS.launches,
              kernels.HEAD_PROJECTION_INTEGRAL_FWD.launches)
    got = generate_filtered_labels(teacher, images, K, box, unl, joints,
                                   **kw)
    assert (kernels.WARP_TWOPASS.launches - before[0],
            kernels.HEAD_PROJECTION_INTEGRAL_FWD.launches - before[1]) == (1,
                                                                           1)
    with torch.no_grad():
        want = generate_filtered_labels(plain_teacher, images, K, box, unl,
                                        joints, method="twopass", **kw)
    torch.testing.assert_close(got.per_rotation, want.per_rotation,
                               rtol=0, atol=1e-4)
    var = want.variance.sort().values
    threshold = float((var[1] * var[2]).sqrt())
    assert torch.equal(got.variance < threshold, want.variance < threshold)


def test_semi_supervised_graph_replays_equal_eager_steps(dev, deterministic):
    """Trainer(scan_steps=2) with a live frozen teacher and the PANet term
    (lam 0.1) on the card against the same Trainer run eagerly: 8 steps end
    in the same metrics, parameters and Adam state bit for bit; the
    teacher's and the PANet's weights and statistics do not move. Each
    captured step holds kernel 3 twice (student and teacher), kernel 4 and
    kernel 5 once."""
    from hand_integral_pose_estimation_tpu_torch.models import (
        get_pose_net,
        panet,
    )
    from hand_integral_pose_estimation_tpu_torch.training import Trainer
    from hand_integral_pose_estimation_tpu_torch.training.teacher import (
        frozen_teacher,
    )

    cfg = _graph_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lam=0.1))
    net = get_pose_net(cfg.model, torch.Generator().manual_seed(7)).to(dev)
    teacher = frozen_teacher(net, cfg)
    prior = panet.PANet(generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        for layer in prior.sparse_coding_layers:
            layer.bias_encode_with_cam.uniform_(0.0, 0.05)
    prior = prior.to(dev).requires_grad_(False)
    frozen = {k: v.clone() for k, v in (*net.state_dict().items(),
                                         *prior.state_dict().items())}
    kw = dict(cfg=cfg, dataset=_graph_dataset(n=24), model_dir="unused",
              seed=4, device=dev, scan_steps=2, teacher_apply=teacher,
              panet_apply=panet.panet_reconstruction_fn(prior))
    eager = Trainer(**kw)
    eager.graphs = None
    graphed = Trainer(**kw)
    m_eager = eager.run_epoch(0, num_steps=8, log_every=100)
    m_graph = graphed.run_epoch(0, num_steps=8, log_every=100)
    assert m_graph == m_eager and math.isfinite(m_graph["loss"])
    a, b = _training_state(graphed), _training_state(eager)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    after = {**net.state_dict(), **prior.state_dict()}
    for k, v in frozen.items():
        assert torch.equal(after[k], v), k
    assert not net.training
    (graph,) = graphed.graphs.graphs.values()
    per_step = {kernels.HEAD_PROJECTION_INTEGRAL_FWD: 2,
                kernels.HEAD_PROJECTION_INTEGRAL_BWD: 1,
                kernels.WARP_TWOPASS: 1}
    assert kernels.graph_launches(graph) == {
        k.symbol: 2 * per_step.get(k, 0) for k in kernels.KERNELS}


# ------------------------------------------- the YUV decode and int8 layers

@pytest.mark.parametrize("shape", [(32, 224, 224), (3, 226, 150),
                                   (3, 120, 88), (3, 2, 2)])
def test_yuv_decode_on_the_card_is_the_cpu_decode(dev, shape):
    """`yuv420_to_rgb` on the card gives the CPU's bytes (which the CPU
    tests hold to libjpeg), eagerly and replayed from a captured CUDA
    graph: no host synchronisation, no data-dependent shape."""
    from hand_integral_pose_estimation_tpu_torch.ops.yuv import (
        planar_sizes,
        yuv420_to_rgb,
    )

    B, H, W = shape
    g = torch.Generator().manual_seed(H * W)
    packed = torch.randint(0, 256, (B, sum(planar_sizes(H, W))),
                           generator=g, dtype=torch.uint8)
    want = yuv420_to_rgb(packed, H, W)
    static = packed.to(dev)
    assert torch.equal(yuv420_to_rgb(static, H, W).cpu(), want)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        yuv420_to_rgb(static, H, W)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = yuv420_to_rgb(static, H, W)
    static.copy_(torch.flip(packed, (0,)).to(dev))
    graph.replay()
    assert torch.equal(out.cpu(), torch.flip(want, (0,)))


INT8_LAYERS = {
    "stem": (lambda: torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False),
             (4, 3, 224, 224)),
    "3x3_s2": (lambda: torch.nn.Conv2d(128, 128, 3, 2, 1, bias=False),
               (4, 128, 56, 56)),
    "1x1_n18": (lambda: torch.nn.Conv2d(512, 18, 1), (4, 512, 38, 38)),
    "deconv": (lambda: torch.nn.ConvTranspose2d(256, 256, 4, 2, 1,
                                                bias=False),
               (4, 256, 28, 28)),
    "linear_n2": (lambda: torch.nn.Linear(2048, 2), (1200, 2048)),
}


@pytest.mark.parametrize("name", list(INT8_LAYERS))
def test_int8_layer_on_the_card_is_exact(dev, name):
    """An int8 layer on the card (im2col views and `torch._int_mm`, the
    operands padded as the card's GEMM demands) at the paths' shapes: with
    unit scales its output is the int32 sums, equal to a float64 product
    of the same int8 values (exact: every sum is below 2^24); with
    calibrated scales the output is bitwise the float64 product's
    epilogue in float32."""
    from hand_integral_pose_estimation_tpu_torch.quantize import (
        Quantized,
        quantize_model,
        quantized_apply,
    )

    make, shape = INT8_LAYERS[name]
    mod = make().to(dev)
    deconv = isinstance(mod, torch.nn.ConvTranspose2d)
    g = torch.Generator(device=dev).manual_seed(7)

    def f64(x, w):
        if isinstance(mod, torch.nn.Linear):
            return x @ w.T
        if deconv:
            return torch.nn.functional.conv_transpose2d(x, w, None, 2, 1)
        return torch.nn.functional.conv2d(x, w, None, mod.stride,
                                          mod.padding)

    kq = torch.randint(-127, 128, mod.weight.shape, device=dev,
                       generator=g).to(torch.int8)
    n = mod.weight.shape[1 if deconv else 0]
    unit = Quantized({"": kq}, {"": torch.ones(n, device=dev)}, {"": 1.0},
                     {})
    xi = torch.randint(-127, 128, shape, device=dev, generator=g).float()
    with torch.no_grad():
        sums = quantized_apply(mod, unit, xi).double()
    want = f64(xi.double(), kq.double())
    assert float(want.abs().max()) < 2 ** 24
    assert torch.equal(sums, want)
    x = torch.randn(shape, device=dev, generator=g)
    q = quantize_model(mod, [x])
    view = (1, -1) if x.ndim == 2 else (1, -1, 1, 1)
    xq = torch.round(x * (1.0 / q.ascales[""])).clamp(-127, 127)
    oracle = f64(xq.double(), q.kernels[""].double()).float() * (
        q.kscales[""] * q.ascales[""]).view(view)
    if "" in q.biases:
        oracle = oracle + q.biases[""].view(view)
    with torch.no_grad():
        assert torch.equal(quantized_apply(mod, q, x), oracle)
