"""The port's YUV 4:2:0 transport and batch prefetcher against the JAX
package and libjpeg on the CPU: `ops/yuv.py` bitwise against the JAX
functions on seeded planes, the packed planes of `decode_jpeg_yuv420`
finished by `yuv420_to_rgb` bitwise against the library's RGB decode on
4:2:0 JPEGs written with cv2, and `NativeLoader` in both layouts bitwise
against the JAX `NativeLoader` (double buffering, missing and corrupt
files), with the size checks the JAX loader lacks (odd sizes in YUV mode,
a refused native loader)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.data import native_loader as jnative
from hand_integral_pose_estimation_tpu.ops import yuv as jyuv
from hand_integral_pose_estimation_tpu_torch.data import native_loader
from hand_integral_pose_estimation_tpu_torch.ops import yuv
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

SIZES = [(224, 224), (200, 200), (226, 150), (120, 88), (2, 2)]


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture
def library():
    """The decoder library, which tests/test_torch_native_lib.py builds
    while the suite is collected; decided when the test runs."""
    if not os.path.exists(native_loader.LIB_PATH):
        pytest.skip("native/libhipe_io.so is not built (make -C native)")


def write_jpeg(cv2, path, h, w, seed=0, quality=95, sampling=None):
    """A smooth seeded image (blurred discs) as a JPEG; cv2 writes 4:2:0
    unless `sampling` says otherwise."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.uint8)
    for _ in range(14):
        x, y = int(rng.randint(0, w)), int(rng.randint(0, h))
        cv2.circle(img, (x, y), int(rng.randint(5, max(6, min(h, w) // 5))),
                   rng.randint(0, 255, 3).tolist(), -1)
    img = cv2.GaussianBlur(img, (5, 5), 1.2)
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    assert cv2.imwrite(str(path), img, flags)
    return str(path)


# ----------------------------------------------------------------- the ops

@pytest.mark.parametrize("hw", SIZES)
def test_yuv_ops_match_jax_bitwise(hw):
    """upsample_h2v2_fancy, ycc_to_rgb and yuv420_to_rgb on seeded uint8
    planes (every value 0..255, so the G term is negative for many) give
    the JAX functions' bytes at aligned, unaligned and minimal sizes."""
    h, w = hw
    rng = np.random.RandomState(h * 1000 + w)
    c = rng.randint(0, 256, (2, h // 2, w // 2)).astype(np.uint8)
    got = yuv.upsample_h2v2_fancy(torch.from_numpy(c))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jyuv.upsample_h2v2_fancy(jnp.asarray(c))))
    y, cb, cr = (rng.randint(0, 256, (2, h, w)).astype(np.uint8)
                 for _ in range(3))
    np.testing.assert_array_equal(
        yuv.ycc_to_rgb(*map(torch.from_numpy, (y, cb, cr))).numpy(),
        np.asarray(jyuv.ycc_to_rgb(*map(jnp.asarray, (y, cb, cr)))))
    packed = rng.randint(0, 256, (3, h * w * 3 // 2)).astype(np.uint8)
    got = yuv.yuv420_to_rgb(torch.from_numpy(packed), h, w)
    assert got.shape == (3, h, w, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jyuv.yuv420_to_rgb(jnp.asarray(packed), h,
                                                   w)))
    assert yuv.planar_sizes(h, w) == jyuv.planar_sizes(h, w)


def test_right_shift_is_arithmetic_on_negative_sums():
    """ycc_to_rgb's G term is negative where Cb and Cr are above 128:
    `>>` floors there as libjpeg's RIGHT_SHIFT does (a truncating shift
    would round toward zero), and every level of Y with neutral chroma comes
    back unchanged."""
    s = torch.tensor([-46802 * 127 - 22554 * 127 + 32768, -1, -65537],
                     dtype=torch.int32)
    assert (s >> 16).tolist() == [v >> 16 for v in s.tolist()]
    y = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16)
    n = torch.full_like(y, 128)
    rgb = yuv.ycc_to_rgb(y, n, n)
    for ch in range(3):
        assert torch.equal(rgb[..., ch], y)
    hi = torch.full_like(y, 255)
    np.testing.assert_array_equal(
        yuv.ycc_to_rgb(y, hi, hi).numpy(),
        np.asarray(jyuv.ycc_to_rgb(jnp.asarray(y.numpy()),
                                   jnp.asarray(hi.numpy()),
                                   jnp.asarray(hi.numpy()))))


def test_odd_sizes_raise():
    for h, w in ((223, 224), (224, 223), (1, 2)):
        with pytest.raises(ValueError, match="even"):
            yuv.planar_sizes(h, w)
        with pytest.raises(ValueError, match="even"):
            yuv.yuv420_to_rgb(torch.zeros(1, h * w * 3 // 2,
                                          dtype=torch.uint8), h, w)


# ------------------------------------------------------- decode vs libjpeg

@pytest.mark.parametrize("hw", SIZES[:4])
def test_yuv_decode_then_device_finish_is_the_rgb_decode(library, cv2,
                                                         tmp_path, hw):
    """decode_jpeg_yuv420 then yuv420_to_rgb gives decode_jpeg's pixels
    bitwise (libjpeg's fancy upsampling and fixed-point colour), and the
    planes are the JAX package's."""
    h, w = hw
    p = write_jpeg(cv2, tmp_path / "a.jpg", h, w, seed=h + w)
    packed = native_loader.decode_jpeg_yuv420(p, h, w)
    assert packed.shape == (h * w * 3 // 2,) and packed.dtype == np.uint8
    np.testing.assert_array_equal(packed,
                                  jnative.decode_jpeg_yuv420(p, h, w))
    rgb = yuv.yuv420_to_rgb(torch.from_numpy(packed[None]), h, w)[0]
    np.testing.assert_array_equal(rgb.numpy(),
                                  native_loader.decode_jpeg(p, h, w))


def test_yuv_decode_refuses_other_files(library, cv2, tmp_path):
    """A 4:4:4 JPEG and a file of another size raise (-3: no resize in YUV
    mode), as in the JAX package; odd sizes raise before the library."""
    p444 = write_jpeg(cv2, tmp_path / "s444.jpg", 224, 224,
                      sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    with pytest.raises(IOError, match="-3"):
        native_loader.decode_jpeg_yuv420(p444, 224, 224)
    p = write_jpeg(cv2, tmp_path / "a.jpg", 224, 224)
    with pytest.raises(IOError, match="-3"):
        native_loader.decode_jpeg_yuv420(p, 112, 112)
    with pytest.raises(ValueError, match="even"):
        native_loader.decode_jpeg_yuv420(p, 223, 224)


# ------------------------------------------------------------- the loader

@pytest.fixture
def jpegs(library, cv2, tmp_path):
    return [write_jpeg(cv2, tmp_path / f"{i}.jpg", 224, 224, seed=i)
            for i in range(6)]


@pytest.mark.parametrize("layout", ["rgb", "yuv420"])
def test_loader_matches_jax_loader(jpegs, layout):
    """Both loaders, batch 3: a full batch, a short one and a second full
    one in double-buffered order (submit, wait, submit, ...) give the same
    bytes; the RGB rows are decode_jpeg's, the YUV rows decode_jpeg_yuv420's
    (finished on the device: decode_jpeg's)."""
    seq = [jpegs[:3], jpegs[3:5], jpegs[2:5]]
    got_all, want_all = [], []
    for loader, out in ((native_loader.NativeLoader(3, layout=layout,
                                                    num_threads=2), got_all),
                        (jnative.NativeLoader(3, layout=layout,
                                              num_threads=2), want_all)):
        loader.submit(seq[0])
        for nxt in seq[1:] + [None]:
            batch = loader.wait()
            if nxt is not None:
                loader.submit(nxt)
            out.append(batch)
    for got, want, paths in zip(got_all, want_all, seq):
        np.testing.assert_array_equal(got, want)
        assert len(got) == len(paths)
        for row, p in zip(got, paths):
            if layout == "rgb":
                np.testing.assert_array_equal(row,
                                              native_loader.decode_jpeg(p))
            else:
                np.testing.assert_array_equal(
                    row, native_loader.decode_jpeg_yuv420(p))
                np.testing.assert_array_equal(
                    yuv.yuv420_to_rgb(torch.from_numpy(row[None]), 224,
                                      224)[0].numpy(),
                    native_loader.decode_jpeg(p))


@pytest.mark.parametrize("layout", ["rgb", "yuv420"])
def test_loader_bad_files_raise_and_it_stays_usable(jpegs, tmp_path, layout):
    """A missing file and a non-JPEG make `wait` raise IOError, as the JAX
    loader does; a truncated stream is no error to libjpeg (a warning, the
    rest filled) and both loaders give the same bytes for it; the loader
    then takes the next batch. In YUV mode a file of another size is a
    decode error too."""
    bad = tmp_path / "bad.jpg"
    with open(jpegs[0], "rb") as f:
        bad.write_bytes(f.read()[:2000])
    garbage = tmp_path / "garbage.jpg"
    garbage.write_bytes(b"\0" * 256)
    cases = [["/nonexistent/file.jpg"], [str(bad), str(garbage)],
             [str(garbage)]]
    truncated = []
    for loader in (native_loader.NativeLoader(2, layout=layout),
                   jnative.NativeLoader(2, layout=layout)):
        for paths in cases:
            loader.submit(paths)
            with pytest.raises(IOError, match="decode errors"):
                loader.wait()
        loader.submit([str(bad)])
        truncated.append(loader.wait())
    np.testing.assert_array_equal(*truncated)
    loader = native_loader.NativeLoader(2, layout=layout)
    loader.submit([jpegs[0]])
    assert len(loader.wait()) == 1
    if layout == "yuv420":
        import cv2
        small = write_jpeg(cv2, tmp_path / "small.jpg", 100, 100)
        loader.submit([jpegs[0], small])
        with pytest.raises(IOError, match="1 decode errors"):
            loader.wait()
    loader.close()


def test_loader_size_checks(library):
    """Odd sizes in YUV mode raise a size error before the library is
    asked (the JAX loader gets a NULL handle there and then reports a batch
    'already in flight'); a loader the library refuses raises and names the
    size; misuse raises instead of asserting."""
    for h, w in ((223, 224), (224, 101)):
        with pytest.raises(ValueError, match="even dims"):
            native_loader.NativeLoader(2, h, w, layout="yuv420")
        native_loader.NativeLoader(2, h, w).close()        # RGB resizes
    with pytest.raises(ValueError, match="batch 0 of 224x224"):
        native_loader.NativeLoader(0)
    with pytest.raises(ValueError, match="layout"):
        native_loader.NativeLoader(2, layout="nv12")
    with native_loader.NativeLoader(2) as loader:
        with pytest.raises(RuntimeError, match="no batch submitted"):
            loader.wait()
        with pytest.raises(ValueError, match="1 to 2 paths"):
            loader.submit(["a.jpg"] * 3)
        loader.submit(["/nonexistent.jpg"])
        with pytest.raises(RuntimeError, match="already in flight"):
            loader.submit(["/nonexistent.jpg"])
        loader.discard()
        loader.submit(["/nonexistent.jpg"])
    # leaving the block waited for the batch in flight and freed the loader
    with pytest.raises(RuntimeError, match="closed"):
        loader.submit(["/nonexistent.jpg"])
