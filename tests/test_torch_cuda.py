"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the wrappers' input rules. Every test here needs a CUDA device: they
carry the `gpu` marker and skip without one. On a machine with a card
(`--noconftest`: tests/conftest.py sets up JAX, which the card's machine
need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from hand_integral_pose_estimation_tpu_torch.ops import (
    fused_head,
    integral,
    kernels,
)

pytestmark = pytest.mark.gpu

# same float32 logits on both sides, only the summation order differs
COORD_TOL = 1e-4
S_REL_TOL = 1e-4
# (B, H, W, J, D): serving shape, ragged small shapes, depth > 32 and > 64
SHAPES = [(32, 56, 56, 21, 56), (1, 8, 8, 3, 4), (3, 7, 5, 2, 40),
          (2, 9, 9, 2, 100)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
@pytest.mark.parametrize("shape", SHAPES)
def test_head_projection_kernel_matches_plain(dev, shape, feat_dtype):
    B, H, W, J, D = shape
    F = 256 if B == 32 else 40
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


def test_public_entry_points_launch_the_kernels(dev):
    J, D = 3, 4
    hm = torch.randn(2, 8, 8, J * D, device=dev)
    feats = torch.randn(2, 8, 8, 16, device=dev, dtype=torch.bfloat16)
    w, b = torch.randn(J * D, 16, device=dev), torch.randn(J * D, device=dev)
    counts = [k.launches for k in kernels.KERNELS]
    integral.softmax_integral(hm, J, D)
    fused_head.head_projection_integral(feats, w, b, J, D)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels.KERNELS] == [c + 1 for c in counts]


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

    # no backward yet: inputs autograd would track are refused on CUDA ...
    with pytest.raises(RuntimeError, match="backward"):
        integral.softmax_integral(hm.requires_grad_(), J, D)
    with pytest.raises(RuntimeError, match="backward"):
        fused_head.head_projection_integral(feats, w.requires_grad_(), b,
                                            J, D)
    assert [k.launches for k in kernels.KERNELS] == counts
    # ... and taken where autograd is off
    with torch.no_grad():
        integral.softmax_integral(hm, J, D)
        fused_head.head_projection_integral(feats, w, b, J, D)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels.KERNELS] == [c + 1 for c in counts]
