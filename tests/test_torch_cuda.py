"""The port's CUDA kernels against their plain PyTorch versions on the card,
forward and backward, and the wrappers' input rules. Every test here needs
a CUDA device: they carry the `gpu` marker and skip without one. On a
machine with a card (`--noconftest`: tests/conftest.py sets up JAX, which
the card's machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import math

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
# The warp kernel forms the same float32 source positions as the plain
# version (round-to-nearest intrinsics in the plain version's order) and
# the same two taps: pixel values on the 0..255 scale agree to 1e-3.
WARP_TOL = 1e-3
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


@pytest.mark.parametrize("feat_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_projection_kernel_matches_plain(dev, shape, feat_dtype):
    B, H, W, J, D, F = shape
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(B, H, W, F, device=dev, generator=g).to(feat_dtype)
    w = 0.3 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    before = kernels.HEAD_PROJECTION_INTEGRAL_FWD.launches
    got = fused_head.head_projection_integral_cuda(feats, w, b, J, D)
    torch.cuda.synchronize()
    assert kernels.HEAD_PROJECTION_INTEGRAL_FWD.launches == before + 1
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
    before = kernels.HEAD_PROJECTION_INTEGRAL_BWD.launches
    got = fused_head.head_projection_integral_bwd_cuda(
        feats, w, b, m, s, coords, cot, J, D)
    torch.cuda.synchronize()
    assert kernels.HEAD_PROJECTION_INTEGRAL_BWD.launches == before + 1
    want = fused_head.head_projection_integral_bwd_reference(
        feats, w, b, m, s, coords, cot, J, D)
    assert got[0].dtype == feat_dtype and got[1].dtype == torch.float32
    assert got[1].shape == (J * D, F) and got[2].shape == (J * D,)
    _close(got[0], want[0], feat_dtype, FUSED_GRAD_ABS_SCALE)
    for gk, wk in zip(got[1:], want[1:]):
        _close(gk, wk, torch.float32, FUSED_GRAD_ABS_SCALE)


def test_head_projection_bwd_is_deterministic(dev):
    """dW and db are sums over the whole batch taken across CTAs: partial
    sums per chunk, then a fixed-order pass, so two runs give the same
    bits (no float atomics)."""
    B, H, W, J, D, F = 32, 56, 56, 21, 56, 256
    g = torch.Generator(device=dev).manual_seed(4)
    feats = torch.randn(B, H, W, F, device=dev,
                        generator=g).to(torch.bfloat16)
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


@pytest.mark.parametrize("shape", [(32, 224, 224, 3, 224, 224),
                                   (2, 37, 41, 3, 29, 33),
                                   (3, 30, 20, 1, 17, 23)])
def test_warp_kernel_matches_plain(dev, shape):
    B, Hs, Ws, C, Ho, Wo = shape
    g = torch.Generator(device=dev).manual_seed(5)
    images = 255 * torch.rand(B, Hs, Ws, C, device=dev, generator=g)
    H = _homographies(B, g, dev)
    before = kernels.WARP_TWOPASS.launches
    got = warp.warp_perspective_cuda(images, H, (Ho, Wo))
    torch.cuda.synchronize()
    assert kernels.WARP_TWOPASS.launches == before + 1
    want = warp.warp_perspective_twopass(images, H, (Ho, Wo))
    assert got.shape == (B, Ho, Wo, C) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=WARP_TOL)
    assert float(got.abs().sum()) > 0


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
                        "hipe_head_projection_integral_fwd": 1,
                        "hipe_softmax_integral_bwd": 1,
                        "hipe_head_projection_integral_bwd": 1,
                        "hipe_warp_twopass": 0, "hipe_roi_align_fwd": 0,
                        "hipe_nms": 0}

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
    feats18 = torch.randn(2, 8, 8, 18, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_head.head_projection_integral_bwd_cuda(
            feats18, torch.randn(J * D, 18, device=dev), b, m, s, coords,
            coords, J, D)
    images = torch.rand(2, 16, 16, 3, device=dev)
    H = torch.eye(3, device=dev).expand(2, 3, 3)
    with pytest.raises(TypeError):
        warp.warp_perspective_cuda(images.double(), H, (8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        warp.warp_perspective_cuda(images.permute(0, 2, 1, 3), H, (8, 8))
    with pytest.raises(ValueError):
        warp.warp_perspective_cuda(images.cpu(), H, (8, 8))
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
                       kernels.NMS))
        for k, c in zip(kernels.KERNELS, counts)]
    assert hm.grad.shape == hm.shape and w.grad.shape == w.shape


def _nms_boxes(mode: str, B: int, N: int, seed: int):
    """(B, N, 4) boxes and (B, N) scores on the host: the alternating chain
    (every other box survives), random boxes, proposal-like clusters of
    near-duplicates, or clusters with tied scores (a tenth of them -1, as
    the min-size filter leaves them)."""
    rng = np.random.RandomState(seed)
    if mode == "chain":
        i = np.arange(N, dtype=np.float64)
        b = np.stack([4 * i, 0 * i, 4 * i + 10, 0 * i + 10], -1)
        return (np.broadcast_to(b, (B, N, 4)).astype(np.float32),
                np.broadcast_to(np.linspace(1.0, 0.5, N), (B, N))
                .astype(np.float32))
    if mode == "random":
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
    return boxes, scores.astype(np.float32)


# (mode, B, N, IoU threshold, top_k, score threshold): the chain across
# many 64-box blocks, the RPN shape, the class-NMS shape, ties, top_k > N
NMS_CASES = [("chain", 1, 1100, 0.3, 1100, -math.inf),
             ("clustered", 4, 6000, 0.7, 300, 0.0),
             ("random", 4, 6000, 0.7, 300, 0.0),
             ("clustered", 4, 300, 0.3, 100, 0.001),
             ("ties", 2, 700, 0.5, 50, 0.0),
             ("random", 3, 40, 0.5, 100, -math.inf)]


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


@pytest.mark.parametrize("shape", [(4, 38, 38, 1024, 300),
                                   (2, 21, 19, 256, 13), (3, 9, 11, 6, 7)])
def test_roi_align_kernel_matches_plain(dev, shape):
    """The detector's shape, then H*W not a multiple of 8 with an odd RoI
    count, then C not a multiple of 4 (the kernel's scalar path); RoIs
    cross the border and some are thinner than a feature cell."""
    B, H, W, C, R = shape
    g = torch.Generator(device=dev).manual_seed(7)
    feats = torch.randn(B, H, W, C, device=dev, generator=g)
    lo = torch.rand(B, R, 2, device=dev, generator=g) * torch.tensor(
        [16.0 * W, 16.0 * H], device=dev) - 40
    wh = torch.rand(B, R, 2, device=dev, generator=g) * 300 + 4
    rois = torch.cat([lo, lo + wh], -1)
    before = kernels.ROI_ALIGN_FWD.launches
    got = roi_align.roi_align_batched(feats, rois, 7, 1 / 16.0, 2)
    torch.cuda.synchronize()
    assert kernels.ROI_ALIGN_FWD.launches == before + 1
    want = roi_align.roi_align_batched(feats, rois, 7, 1 / 16.0, 2,
                                       impl="plain")
    assert got.shape == (B, R, 7, 7, C) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=ROI_TOL * max(
        1.0, float(feats.abs().max())))
    assert float(got.abs().sum()) > 0


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
