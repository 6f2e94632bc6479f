"""The port's ops (hand_integral_pose_estimation_tpu_torch.ops) against the
JAX package on the CPU: soft-argmax and fused head against both the XLA
formulation and the Pallas kernel in interpret mode, the decode statistics,
and the eval-crop warp. Inputs come from numpy seeds and go to both
packages as the same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.ops import fused_head as jfused
from hand_integral_pose_estimation_tpu.ops import integral as jint
from hand_integral_pose_estimation_tpu.ops import warp as jwarp
from hand_integral_pose_estimation_tpu.geometry import transforms as jtf
from hand_integral_pose_estimation_tpu_torch.ops import (
    fused_head,
    integral,
    kernels,
    warp,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

# (B, H, W, J, D): a ragged small case and the serving J x D at 8x8
DECODE_SHAPES = [(2, 8, 8, 3, 4), (1, 8, 8, 21, 56)]


def _jax_integral(hm, J, D, impl):
    if impl == "xla":
        return jint._softmax_integral_xla(jnp.asarray(hm), J, D)
    return jint._softmax_integral_pallas(jnp.asarray(hm), J, D,
                                         interpret=True)


def _assert_stats(got, want):
    """coords and m to atol 1e-5 as tests/test_fused_head.py holds the
    kernels; s = sum exp(h - m) grows with the volume, so it is held to the
    same 1e-5 relatively as well."""
    coords, m, s = (t.numpy() for t in got)
    np.testing.assert_allclose(coords, np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(m, np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(s, np.asarray(want[2]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_softmax_integral_matches_jax(shape, impl):
    B, H, W, J, D = shape
    hm = (np.random.default_rng(1).normal(size=(B, H, W, J * D)) * 2
          ).astype(np.float32)
    got = integral.softmax_integral_reference(torch.from_numpy(hm), J, D)
    _assert_stats(got, _jax_integral(hm, J, D, impl))
    # the public entry takes the plain version for a CPU tensor
    torch.testing.assert_close(
        integral.softmax_integral(torch.from_numpy(hm), J, D), got[0],
        rtol=0, atol=0)


def test_softmax_integral_bf16_heatmap():
    """A bf16 heatmap is decoded in float32 by both packages."""
    J, D = 3, 4
    hm = np.random.default_rng(2).normal(size=(2, 8, 8, J * D)) * 3
    hm_t = torch.from_numpy(hm.astype(np.float32)).to(torch.bfloat16)
    got = integral.softmax_integral_reference(hm_t, J, D)
    want = jint._softmax_integral_xla(
        jnp.asarray(hm_t.float().numpy()).astype(jnp.bfloat16), J, D)
    assert got[0].dtype == torch.float32
    _assert_stats(got, want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape,F", [(DECODE_SHAPES[0], 32),
                                     (DECODE_SHAPES[1], 64)])
def test_head_projection_integral_matches_jax(shape, F, impl):
    B, H, W, J, D = shape
    rng = np.random.default_rng(3)
    feats = (rng.normal(size=(B, H, W, F)) * 0.5).astype(np.float32)
    Wm = (rng.normal(size=(F, J * D)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(J * D,)) * 0.1).astype(np.float32)
    if impl == "xla":
        want = jfused._hp_fwd_dispatch(jnp.asarray(feats), jnp.asarray(Wm),
                                       jnp.asarray(b), J, D, "xla", False)
    else:
        want = jfused._forward_pallas(jnp.asarray(feats), jnp.asarray(Wm),
                                      jnp.asarray(b), J, D, interpret=True)
    # the port takes the projection as torch's (out, in) matrix
    args = (torch.from_numpy(feats), torch.from_numpy(Wm.T.copy()),
            torch.from_numpy(b), J, D)
    got = fused_head.head_projection_integral_reference(*args)
    _assert_stats(got, want)
    torch.testing.assert_close(fused_head.head_projection_integral(*args),
                               got[0], rtol=0, atol=0)


def test_head_projection_integral_bf16_features():
    """bf16 features times the float32 projection are promoted to float32,
    as the JAX einsum promotes them."""
    J, D, F = 3, 4, 32
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.normal(size=(2, 8, 8, F)).astype(
        np.float32)).to(torch.bfloat16)
    Wm = (rng.normal(size=(F, J * D)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(J * D,)) * 0.1).astype(np.float32)
    want = jfused._hp_fwd_dispatch(
        jnp.asarray(feats.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(Wm), jnp.asarray(b), J, D, "xla", False)
    got = fused_head.head_projection_integral_reference(
        feats, torch.from_numpy(Wm.T.copy()), torch.from_numpy(b), J, D)
    _assert_stats(got, want)


@pytest.mark.parametrize("fn", ["softmax_probs", "heatmap_entropy"])
def test_decode_statistics_match_jax(fn):
    J, D = 3, 4
    hm = (np.random.default_rng(5).normal(size=(2, 6, 5, J * D)) * 2
          ).astype(np.float32)
    got = getattr(integral, fn)(torch.from_numpy(hm), J, D).numpy()
    want = np.asarray(getattr(jint, fn)(jnp.asarray(hm), J, D))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    """On the CPU the wrappers take the plain version because the tensors
    lie on the CPU: the kernel library is never built or loaded, and no
    launch is counted."""
    def refuse():
        raise AssertionError("the kernel library was requested on the CPU")

    monkeypatch.setattr(kernels, "library", refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    before = [k.launches for k in kernels.KERNELS]
    J, D = 3, 4
    integral.softmax_integral(torch.randn(1, 4, 4, J * D), J, D)
    fused_head.head_projection_integral(
        torch.randn(1, 4, 4, 8), torch.randn(J * D, 8), torch.randn(J * D),
        J, D)
    assert [k.launches for k in kernels.KERNELS] == before


def test_cuda_wrappers_refuse_cpu_tensors():
    J, D = 3, 4
    with pytest.raises(ValueError, match="CUDA"):
        integral.softmax_integral_cuda(torch.randn(1, 4, 4, J * D), J, D)
    with pytest.raises(ValueError, match="CUDA"):
        fused_head.head_projection_integral_cuda(
            torch.randn(1, 4, 4, 8), torch.randn(J * D, 8),
            torch.randn(J * D), J, D)


def _crop_mats(rng, B, src_hw, dtype):
    """Axis-aligned image -> patch affines of random boxes (eval crops)."""
    Hs, Ws = src_hw
    cx = rng.uniform(0.3, 0.7, B) * Ws
    cy = rng.uniform(0.3, 0.7, B) * Hs
    w = rng.uniform(0.3, 1.2, B) * Ws
    h = rng.uniform(0.3, 1.2, B) * Hs
    return np.array(jtf.trans_from_patch(
        jnp.asarray(cx, dtype), jnp.asarray(cy, dtype), jnp.asarray(w, dtype),
        jnp.asarray(h, dtype), 24, 20))


def test_warp_axis_aligned_batch_matches_jax():
    rng = np.random.default_rng(6)
    images = rng.integers(0, 255, (3, 30, 34, 3)).astype(np.uint8)
    H = _crop_mats(rng, 3, (30, 34), jnp.float64)
    want = jwarp.warp_axis_aligned_batch(jnp.asarray(images).astype(
        jnp.float32), jnp.asarray(H), (20, 24))
    got = warp.warp_axis_aligned_batch(torch.from_numpy(images),
                                       torch.from_numpy(H), (20, 24))
    assert got.dtype == torch.float32 and got.shape == (3, 20, 24, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    # "affine" routes to it
    torch.testing.assert_close(warp.warp_perspective_batch(
        torch.from_numpy(images), torch.from_numpy(H), (20, 24),
        method="affine"), got, rtol=0, atol=0)


def test_warp_gather_matches_jax_for_a_general_homography():
    """Single-pass bilinear with a rotation in the map (not axis-aligned)."""
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 255, (2, 30, 34, 3))
    H = np.stack([
        np.array([[np.cos(a), -np.sin(a), 4.0],
                  [np.sin(a), np.cos(a), -3.0],
                  [1e-4, 2e-4, 1.0]]) for a in (0.2, -0.4)])
    want = jwarp.warp_perspective_batch(jnp.asarray(images), jnp.asarray(H),
                                        (20, 24), method="gather")
    got = warp.warp_perspective_batch(torch.from_numpy(images),
                                      torch.from_numpy(H), (20, 24),
                                      method="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)
    with pytest.raises(ValueError, match="method"):
        warp.warp_perspective_batch(torch.from_numpy(images),
                                    torch.from_numpy(H), (20, 24),
                                    method="pallas")
