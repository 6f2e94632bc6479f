"""Kernel 5's one-launch form, emulated on the CPU and held against the JAX
package, and what degenerate maps give.

The kernel (`csrc/warp_twopass.cu`) computes each output pixel of the
two-pass warp directly: v* at (x', y'); for each of its two row taps s,
pass A's value at (s, x') (yA, u*(x', s) and its two column taps); then
pass B's combination and, on the training path, the normalisation. Its
prologue forms the coefficients from the float64 adjugate of the map.
Here that per-pixel order is emulated with torch operations (vectorised
over pixels, the same rounded operations in the same order) and the
prologue with numpy float64 scalars (one rounding per operation, no
multiply-add), and held bitwise to `warp_perspective_twopass` and
`warp_normalise_twopass`, the plain versions the kernel is checked against
on the card; then to the JAX package's two-pass warp and its Pallas kernel
in interpret mode (as tests/test_torch_train.py runs it).

Inputs come from numpy seeds.
"""

import ctypes
import gc
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.config import (
    AugmentConfig as JaxAugmentConfig,
)
from hand_integral_pose_estimation_tpu.data import pipeline as jpipeline
from hand_integral_pose_estimation_tpu.ops import warp as jwarp
from hand_integral_pose_estimation_tpu_torch.config import AugmentConfig
from hand_integral_pose_estimation_tpu_torch.ops import warp
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

# The Pallas kernel forms its dense weights in float32 and contracts them
# on the (emulated) MXU: 1e-3 on the 0..255 scale, as
# tests/test_warp_pipeline.py holds it.
PALLAS_TOL = 1e-3
# the same filter at float64 in both packages
F64_TOL = 1e-9
# float32 positions formed by XLA on one side and by the same rounded
# operations in torch order on the other: an ulp of a position moves a
# pixel of a noise image by up to ~1e-5 of its value, so 1e-3 on the
# 0..255 scale plus 1e-5 relative, as tests/test_torch_train.py holds the
# float32 Pallas kernel
F32_TOL, F32_RTOL = 1e-3, 1e-5


def _maps(rng, B, src_hw, out_hw, perspective=1e-3):
    """Forward maps src -> dst: rotation up to +-0.6 rad about the centres,
    anisotropic scale, a shift and perspective terms."""
    out = []
    for _ in range(B):
        a = rng.uniform(-0.6, 0.6)
        sx, sy = rng.uniform(0.75, 1.25, 2)
        R = np.array([[np.cos(a) * sx, -np.sin(a) * sy, 0.0],
                      [np.sin(a) * sx, np.cos(a) * sy, 0.0],
                      [0.0, 0.0, 1.0]])
        T_src = np.array([[1, 0, -(src_hw[1] - 1) / 2],
                          [0, 1, -(src_hw[0] - 1) / 2], [0, 0, 1.0]])
        T_out = np.array([[1, 0, (out_hw[1] - 1) / 2 + rng.normal(0, 2)],
                          [0, 1, (out_hw[0] - 1) / 2 + rng.normal(0, 2)],
                          [0, 0, 1.0]])
        H = T_out @ R @ T_src
        H[2, :2] = rng.normal(0, perspective, 2)
        out.append(H)
    return np.stack(out)


def _frames(rng, B, hw, C, dtype):
    frames = rng.integers(0, 256, (B, *hw, C))
    return frames.astype(np.uint8 if dtype == "uint8" else dtype)


# ------------------------------------------------------- kernel emulation


def _prologue(H, inverse):
    """The kernel's prologue per image, in numpy float64 scalars: the
    adjugate's 2x2 minors (the map itself when `inverse`), nan for a
    determinant of exactly 0, each divided by the [2, 2] entry."""
    out = []
    with np.errstate(all="ignore"):
        for m in np.asarray(H, np.float64).reshape(-1, 9):
            h = [np.float64(v) for v in m]
            if inverse:
                n = h
            else:
                def minor(p, q, r, s):
                    return h[p] * h[q] - h[r] * h[s]

                n = [minor(4, 8, 5, 7), minor(2, 7, 1, 8), minor(1, 5, 2, 4),
                     minor(5, 6, 3, 8), minor(0, 8, 2, 6), minor(2, 3, 0, 5),
                     minor(3, 7, 4, 6), minor(1, 6, 0, 7), minor(0, 4, 1, 3)]
                det = h[0] * n[0] + h[1] * n[3] + h[2] * n[6]
                if det == 0:
                    n = [np.float64(np.nan)] * 9
            out.append([n[k] / n[8] for k in range(8)])
    return np.array(out, np.float64)


def _taps(pos, n, vt):
    i0 = torch.floor(pos)
    w1 = (pos - i0).to(vt)
    ok0 = (i0 >= 0) & (i0 <= n - 1)
    ok1 = (i0 >= -1) & (i0 <= n - 2)
    return SimpleNamespace(
        i0=i0, w0=1.0 - w1, w1=w1, ok0=ok0, ok1=ok1, nan=torch.isnan(pos),
        c0=torch.where(ok0, i0, 0).long(),
        c1=torch.where(ok1, i0 + 1, 0).long())


def _combine(t, v0, v1):
    """(0 + [ok0] v0 w0) + [ok1] v1 w1, nan for a nan position."""
    a = torch.where(t.ok0[..., None], v0 * t.w0[..., None], 0.0)
    b = torch.where(t.ok1[..., None], v1 * t.w1[..., None], 0.0)
    return ((0.0 + a) + b).masked_fill(t.nan[..., None], math.nan)


def _emulate(images, H, out_hw, inverse=False, normalise=None):
    """The kernel's per-pixel order: frames (B, Hs, Ws, C) as numpy,
    maps (B, 3, 3) as numpy (their dtype sets the positions' type, as in
    the plain version), optional (colour (B, C), mean, std)."""
    src = torch.from_numpy(images)
    B, Hs, Ws, C = src.shape
    Ho, Wo = out_hw
    vt = torch.promote_types(src.dtype, torch.float32)
    ct = torch.promote_types(vt, torch.from_numpy(H).dtype)
    src = src.to(vt)
    coefs = torch.from_numpy(_prologue(H, inverse)).to(ct)
    y, x = torch.meshgrid(torch.arange(Ho), torch.arange(Wo), indexing="ij")
    xo, yo = x.to(ct), y.to(ct)
    out = []
    for b in range(B):
        a, bb, c, d, e, f, g, h = coefs[b].unbind()
        tv = _taps((d * xo + e * yo + f) / (g * xo + h * yo + 1.0), Hs, vt)
        rows = []
        for k, ok in ((0, tv.ok0), (1, tv.ok1)):
            s = torch.where(ok, tv.i0 + k, 0).long()
            ys = s.to(ct)
            ya = (ys * g * xo + ys - d * xo - f) / (e - ys * h)
            tu = _taps((a * xo + bb * ya + c) / (g * xo + h * ya + 1.0), Ws,
                       vt)
            rows.append(_combine(tu, src[b][s, tu.c0], src[b][s, tu.c1]))
        r = _combine(tv, *rows)
        if normalise is not None:
            colour, mean, std = normalise
            r = torch.clamp((r - torch.tensor(mean, dtype=vt))
                            / torch.tensor(std, dtype=vt)
                            * torch.from_numpy(colour[b]).to(vt), 0.0, 255.0)
        out.append(r)
    return torch.stack(out)


def _plain(images, H, out_hw, inverse=False, normalise=None):
    im, Hm = torch.from_numpy(images), torch.from_numpy(H)
    if normalise is None:
        return warp.warp_perspective_twopass(im, Hm, out_hw, inverse)
    colour, mean, std = normalise
    return warp.warp_normalise_batch(im, Hm, out_hw, torch.from_numpy(colour),
                                     mean, std, inverse)


@pytest.mark.parametrize("normalise", [False, True])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("frames", ["uint8", np.float32])
@pytest.mark.parametrize("positions", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(37, 41, 29, 33), (32, 24, 24, 40)])
def test_kernel_order_equals_the_plain_version_bitwise(shape, positions,
                                                       frames, channels,
                                                       normalise):
    """Ragged and even shapes, float32 and float64 positions (the maps'
    type), uint8 and float32 frames, C = 1 and 3, with and without the
    epilogue: the emulated kernel equals the plain version bit for bit."""
    Hs, Ws, Ho, Wo = shape
    rng = np.random.default_rng(hash((shape, channels)) % 2**32)
    images = _frames(rng, 3, (Hs, Ws), channels, frames)
    H = _maps(rng, 3, (Hs, Ws), (Ho, Wo)).astype(positions)
    norm = None
    if normalise:
        norm = (rng.uniform(0.8, 1.2, (3, channels)).astype(np.float32),
                tuple(rng.uniform(0, 1, channels)),
                tuple(rng.uniform(0.5, 1.5, channels)))
    for inverse, maps in ((False, H), (True, np.linalg.inv(H).astype(
            positions))):
        got = _emulate(images, maps, (Ho, Wo), inverse, norm)
        want = _plain(images, maps, (Ho, Wo), inverse, norm)
        assert got.dtype == want.dtype == torch.float32
        assert bool(torch.isfinite(want).all()) and float(want.max()) > 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_order_at_float64_frames():
    """Float64 frames and maps (the plain version's float64 path, which
    the card does not take): the same order, bit for bit."""
    rng = np.random.default_rng(3)
    images = _frames(rng, 2, (37, 41), 3, np.float64)
    H = _maps(rng, 2, (37, 41), (29, 33))
    got = _emulate(images, H, (29, 33))
    want = _plain(images, H, (29, 33))
    assert got.dtype == want.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("frames", ["uint8", np.float32])
def test_kernel_order_matches_the_pallas_kernel(frames):
    """The emulated kernel against the TPU kernel in interpret mode, both
    on the same float32 dst -> src maps (a float32 LU would move the
    positions by a few ulps, ~5e-2 on this scale): 1e-3 on 0..255."""
    rng = np.random.default_rng(20261017)
    images = _frames(rng, 2, (32, 40), 3, frames)
    Hinv = np.linalg.inv(_maps(rng, 2, (32, 40), (24, 32))).astype(
        np.float32)
    want = jwarp.warp_perspective_pallas(
        jnp.asarray(images.astype(np.float32)), jnp.asarray(Hinv), (24, 32),
        inverse=True, interpret=True)
    got = _emulate(images, Hinv, (24, 32), inverse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PALLAS_TOL, rtol=1e-5)
    assert float(got.abs().max()) > 10


# ------------------------------------------------------- the coefficients


def test_coefficients_match_the_jax_inverse():
    """Against `jnp.linalg.inv` scaled to [2, 2] = 1: float64 maps to
    1e-12 of the largest coefficient; float32 maps equal the float64 LU of
    the same map rounded to float32 (the adjugate and the LU differ by
    ~1e-14 relative, far inside half a float32 ulp for seeded maps); an
    inverse float32 map scaled in float64 and rounded equals the float32
    division."""
    rng = np.random.default_rng(7)
    H = _maps(rng, 64, (224, 224), (224, 224), perspective=2e-4)
    inv = np.asarray(jnp.linalg.inv(jnp.asarray(H)))
    want = (inv / inv[:, 2:3, 2:3]).reshape(-1, 9)[:, :8]
    got = warp.warp_coefficients(torch.from_numpy(H), dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())

    H32 = H.astype(np.float32)
    inv = np.asarray(jnp.linalg.inv(jnp.asarray(H32.astype(np.float64))))
    want = (inv / inv[:, 2:3, 2:3]).reshape(-1, 9)[:, :8].astype(np.float32)
    got = warp.warp_coefficients(torch.from_numpy(H32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _prologue(H32, False).astype(
        np.float32))

    Hi32 = np.linalg.inv(H).astype(np.float32)
    want = (Hi32 / Hi32[:, 2:3, 2:3]).reshape(-1, 9)[:, :8]
    got = warp.warp_coefficients(torch.from_numpy(Hi32), inverse=True)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------- degenerate maps


SINGULAR = np.array([[1.0, 2, 3], [2, 4, 6], [0, 0, 1]])
# a 90-degree turn about the centre of 16 x 16: e = h = 0 in pass A's
# divisor, so every u* is nan and every output row reads nan
ROT90 = np.array([[0.0, -1, 15], [1, 0, 0], [0, 0, 1]])


def _jax_twopass(images, H, out_hw, inverse=False):
    return np.stack([np.asarray(jwarp.warp_perspective_twopass(
        jnp.asarray(im), jnp.asarray(h), out_hw, inverse,
        precision=jax.lax.Precision.HIGHEST)) for im, h in zip(images, H)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["singular", "rot90"])
def test_degenerate_maps_give_nan_as_in_jax(name, dtype):
    """A singular map and an exact 90-degree turn give an all-nan image in
    the JAX two-pass warp, its Pallas kernel (interpret mode, float32) and
    the port's plain version and emulated kernel."""
    rng = np.random.default_rng(11)
    images = rng.uniform(0, 255, (2, 16, 16, 3)).astype(dtype)
    H = np.stack([SINGULAR if name == "singular" else ROT90] * 2).astype(
        dtype)
    want = _jax_twopass(images, H, (16, 16))
    got = warp.warp_perspective_twopass(torch.from_numpy(images),
                                        torch.from_numpy(H), (16, 16))
    assert np.isnan(want).all() and bool(torch.isnan(got).all())
    assert bool(torch.isnan(_emulate(images, H, (16, 16))).all())
    if dtype == np.float32:
        pallas = jwarp.warp_perspective_pallas(
            jnp.asarray(images), jnp.asarray(H), (16, 16), interpret=True)
        assert np.isnan(np.asarray(pallas)).all()


def test_a_horizon_inside_the_output_gives_nan_where_jax_does():
    """A forward map with H[2, 0] = 0.2 on 16 x 16 puts the horizon inside
    the output. The port's nan pixels are those whose own positions are
    nan; the JAX package's dense products spread each nan over a whole
    column (0 x nan), so the port's nan pixels are a subset of its, and
    every other pixel agrees at float64."""
    rng = np.random.default_rng(12)
    images = rng.uniform(0, 255, (1, 16, 16, 3))
    H = np.eye(3)[None].copy()
    H[0, 2, 0] = 0.2
    want = _jax_twopass(images, H, (16, 16))
    got = warp.warp_perspective_twopass(torch.from_numpy(images),
                                        torch.from_numpy(H), (16, 16)).numpy()
    nan_got, nan_want = np.isnan(got), np.isnan(want)
    assert nan_got.any(), "the map should put a nan inside the output"
    assert not (nan_got & ~nan_want).any()
    np.testing.assert_allclose(got[~nan_want], want[~nan_want], atol=F64_TOL)
    torch.testing.assert_close(_emulate(images, H, (16, 16)),
                               torch.from_numpy(got), rtol=0, atol=0,
                               equal_nan=True)


def test_positions_at_infinity_read_zero_in_both():
    """A dst -> src map whose denominator is exactly 0 on output column 16
    sends u* and v* there to +-inf: that column is 0 in both packages and
    every pixel agrees at float64."""
    rng = np.random.default_rng(13)
    images = rng.uniform(0, 255, (1, 20, 24, 3))
    Hinv = np.array([[[1.0, 0.05, 0.5], [0.1, 1.0, 0.3],
                      [-0.0625, 0.0, 1.0]]])
    want = _jax_twopass(images, Hinv, (20, 24), inverse=True)
    got = warp.warp_perspective_twopass(
        torch.from_numpy(images), torch.from_numpy(Hinv), (20, 24),
        inverse=True).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert (got[:, :, 16] == 0).all() and (want[:, :, 16] == 0).all()
    assert np.abs(got[:, :, :16]).max() > 10
    np.testing.assert_allclose(got, want, atol=F64_TOL)


# -------------------------------------------------- the fused plain chain


@pytest.mark.parametrize("case", ["float64", "uint8"])
def test_fused_plain_chain_matches_jax(case):
    """Frames -> normalised patch against the JAX package's
    `_normalise(warp_perspective_twopass(...))` with the same colour:
    float64 frames and maps to 1e-9; uint8 frames (float32 patch) with the
    float32 dst -> src maps the card's path hands the kernel, to 1e-3 on
    the 0..255 scale plus 1e-5 relative."""
    rng = np.random.default_rng(14)
    acfg, jacfg = AugmentConfig(), JaxAugmentConfig()
    out_hw = (24, 32)
    H = _maps(rng, 3, (32, 40), out_hw)
    colour = rng.uniform(0.8, 1.2, (3, 3))
    if case == "float64":
        images, inverse, tol, rtol = _frames(rng, 3, (32, 40), 3,
                                             np.float64), False, F64_TOL, 0
    else:
        images, inverse, tol, rtol = _frames(rng, 3, (32, 40), 3,
                                             "uint8"), True, F32_TOL, F32_RTOL
        H, colour = np.linalg.inv(H).astype(np.float32), colour.astype(
            np.float32)
    patch = jwarp.warp_perspective_batch(
        jnp.asarray(images.astype(np.promote_types(images.dtype,
                                                   np.float32))),
        jnp.asarray(H), out_hw, inverse=inverse, method="twopass",
        precision=jax.lax.Precision.HIGHEST)
    want = np.asarray(jpipeline._normalise(
        patch, jnp.asarray(colour)[:, None, None, :], jacfg))
    got = warp.warp_normalise_batch(
        torch.from_numpy(images), torch.from_numpy(H), out_hw,
        torch.from_numpy(colour), acfg.pixel_mean, acfg.pixel_std, inverse)
    assert got.dtype == (torch.float64 if case == "float64"
                         else torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=rtol)
    assert float(got.max()) > 100
    # the plain chain is the pipeline's former one: frames as float, the
    # two-pass warp, then `_normalise`'s formula
    chain = warp.normalise_patch(
        warp.warp_perspective_twopass(torch.from_numpy(images).to(got.dtype),
                                      torch.from_numpy(H), out_hw, inverse),
        torch.from_numpy(colour).to(got.dtype)[:, None, None, :],
        acfg.pixel_mean, acfg.pixel_std)
    torch.testing.assert_close(got, chain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_normalise_batch(
            torch.from_numpy(images), torch.from_numpy(H), out_hw,
            torch.from_numpy(colour), acfg.pixel_mean, acfg.pixel_std,
            method="kernel")


def test_epilogue_constants_stay_alive_for_the_launch():
    """The host array of means and stds that the kernel's C entry reads
    outlives the call that made it: its address still reads the values
    after a garbage collection."""
    mean, std = (0.4559, 0.5142, 0.5148), (1.0, 1.125, 1.25)
    address = warp._mean_std_block(mean, std)[1]
    gc.collect()
    warp._mean_std_block((9.0,), (9.0,))
    got = ctypes.cast(address, ctypes.POINTER(ctypes.c_float * 6)).contents
    np.testing.assert_array_equal(np.array(got[:]),
                                  np.array(mean + std, np.float32))
