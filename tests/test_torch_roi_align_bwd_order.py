"""The arithmetic of the ROIAlign backward kernel (`csrc/roi_align_bwd.cu`),
written out in torch at float64 and held against the plain VJP and JAX.

The kernel takes each image's RoIs in index order and, per RoI, contracts
the cotangent g (P, P, C) separably into the image's gradient strip:
columns first, T[p, x] = sum_q ax[q, x] g[p, q], then rows,
strip[y, x] += sum_p ay[p, y] T[p, x], with ay[p, y] the sum over bin p's
samples of the plain version's bilinear row weights (ax likewise); a
larger map is cut into bands of rows, each RoI clipped to a band. The
strip is scaled by 1/sr^2 at the end. `separable_bwd` below is that order;
the tests hold it to `roi_align_bwd_plain` (autograd through the plain
einsums) and to `jax.vjp` of the JAX package's `roi_align`
(ops/roi_align.py:57), all at float64.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu_torch.ops import roi_align as proi
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

# the module (the package's `ops` exports a function of the same name)
jroi = importlib.import_module(
    "hand_integral_pose_estimation_tpu.ops.roi_align")

SCALE = 1.0 / 16.0
# float64 sums of the same products in three orders: far inside 1e-12 of
# the largest gradient entry
TOL = 1e-12


def separable_bwd(g, rois, hw, sr, band_rows=None):
    """The kernel's order for one image: g (R, P, P, C), rois (R, 4) ->
    (H, W, C), RoIs in index order, bands of `band_rows` rows."""
    R, P, _, C = g.shape
    H, W = hw
    band_rows = band_rows or H
    out = torch.zeros(H, W, C, dtype=g.dtype)
    for y_lo in range(0, H, band_rows):
        y_hi = min(H, y_lo + band_rows)
        strip = torch.zeros(y_hi - y_lo, W, C, dtype=g.dtype)
        for r in range(R):
            wy = proi._linear_weights(
                proi._roi_sample_grid(rois[r], P, sr, SCALE, 1), H)
            wx = proi._linear_weights(
                proi._roi_sample_grid(rois[r], P, sr, SCALE, 0), W)
            ay = wy.reshape(P, sr, H).sum(1)[:, y_lo:y_hi]      # (P, rows)
            ax = wx.reshape(P, sr, W).sum(1)                    # (P, W)
            t = torch.einsum("qx,pqc->pxc", ax, g[r])           # columns
            strip += torch.einsum("py,pxc->yxc", ay, t)         # then rows
        out[y_lo:y_hi] = strip / sr ** 2
    return out


def _rois(rng, R, H, W):
    """RoIs of the detector's sampled layout on an (H, W) map of stride 16:
    anywhere, some partly off the map, plus the cases named below."""
    lo = rng.uniform(-40, 16 * max(H, W), size=(R, 2))
    wh = rng.uniform(2, 16 * max(H, W) / 2, size=(R, 2))
    return np.concatenate([lo, lo + wh], -1)


CASES = {
    # a RoI across the map's top-left border and one past the bottom-right
    "border": np.array([[-60.0, -30.0, 40.0, 16 * 17 + 30.0],
                        [120.0, 150.0, 16 * 13 + 50.0, 16 * 17 + 90.0]]),
    # under one feature cell
    "one_cell": np.array([[100.0, 100.0, 108.0, 104.0],
                          [33.0, 65.0, 34.0, 66.0]]),
    # tall RoIs that the bands of 5 rows cut in the middle
    "banded": np.array([[20.0, 40.0, 180.0, 230.0],
                        [0.0, 0.0, 16 * 13.0, 16 * 17.0]]),
}


def _case(name, C, sr, seed):
    rng = np.random.default_rng(seed)
    H, W = 17, 13
    rois = np.concatenate([CASES[name], _rois(rng, 4, H, W)])
    g = rng.normal(size=(len(rois), 7, 7, C))
    return (H, W), torch.from_numpy(rois), torch.from_numpy(g)


def _jax_vjp(g, rois, hw, sr):
    H, W = hw
    C = g.shape[-1]
    f = jnp.zeros((H, W, C), jnp.float64)
    _, vjp = jax.vjp(lambda x: jroi.roi_align(x, jnp.asarray(rois.numpy()),
                                              g.shape[1], SCALE, sr), f)
    return np.asarray(vjp(jnp.asarray(g.numpy()))[0])


def _close(got, want):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape
    assert float(np.abs(want).max()) > 0
    assert float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())


@pytest.mark.parametrize("name,C,sr,band_rows", [
    ("border", 8, 2, None), ("one_cell", 6, 2, None), ("one_cell", 8, 1, 4),
    ("banded", 6, 2, 5), ("banded", 8, 3, 5), ("border", 6, 2, 5)])
def test_separable_order_matches_plain_and_jax(name, C, sr, band_rows):
    """The kernel's order (columns, then rows, RoI by RoI, in bands) at
    float64 against the plain VJP and JAX's autodiff of its ROIAlign."""
    hw, rois, g = _case(name, C, sr, seed=len(name) + C + sr)
    got = separable_bwd(g, rois, hw, sr, band_rows)
    want = proi.roi_align_bwd_plain(g[None], rois[None], hw, SCALE, sr)[0]
    _close(got, want)
    _close(got, _jax_vjp(g, rois, hw, sr))


def test_bands_cut_a_roi_without_changing_its_gradient():
    """Bands of 5 rows through the middle of tall RoIs give the one-band
    strip (the same products summed in the same order per output)."""
    hw, rois, g = _case("banded", 6, 2, seed=3)
    whole = separable_bwd(g, rois, hw, 2)
    for band_rows in (1, 5, 8):
        torch.testing.assert_close(separable_bwd(g, rois, hw, 2, band_rows),
                                   whole, rtol=0, atol=1e-15)


def test_image_without_rois_gets_zero_gradient():
    """An image with no RoI, and one whose RoIs all lie off the map, get a
    zero gradient, as from the plain VJP and from JAX."""
    hw, rois, g = _case("border", 6, 2, seed=4)
    empty = separable_bwd(g[:0], rois[:0], hw, 2)
    assert empty.shape == (*hw, 6) and not bool(empty.any())
    off = torch.tensor([[-900.0, -900.0, -500.0, -600.0],
                        [2000.0, 10.0, 2600.0, 90.0]], dtype=torch.float64)
    g_off = g[:2]
    got = separable_bwd(g_off, off, hw, 2)
    assert not bool(got.any())
    assert not bool(proi.roi_align_bwd_plain(g_off[None], off[None], hw,
                                             SCALE, 2).any())
    assert not np.asarray(_jax_vjp(g_off, off, hw, 2)).any()
