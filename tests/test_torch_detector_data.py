"""The port's detector training data, VOC AP and the VGG16 backbone against
the JAX package on the CPU. `detect/data.py` is a numpy copy: its outputs
must equal the JAX package's bit for bit on the same inputs (and the same
`np.random.RandomState` draws). The VGG16 base and tail run on weights
bridged from the flax modules' init: float32 convs and products summed in
another order, 1e-5 of the largest output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.data.freihand import (
    SyntheticFreiHand as JaxSyntheticFreiHand,
)
from hand_integral_pose_estimation_tpu.detect import data as jdata
from hand_integral_pose_estimation_tpu.detect import vgg as jvgg
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.detect import data as pdata
from hand_integral_pose_estimation_tpu_torch.detect import (
    VGG16Base,
    VGG16Tail,
)


def assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("margin", [0.0, 3.5])
def test_gt_bbox_from_keypoints_matches_jax(margin):
    uv = np.random.RandomState(0).rand(5, 21, 2) * 224
    assert_same(pdata.gt_bbox_from_keypoints(uv, margin),
                jdata.gt_bbox_from_keypoints(uv, margin))


@pytest.mark.parametrize("flip", [False, True])
def test_build_detector_batch_matches_jax(flip):
    """The same synthetic samples (render_joints), gt boxes from their
    projected joints, and the same horizontal flips from the same
    RandomState draws."""
    kw = dict(n=8, image_hw=(48, 64), seed=3, render_joints=True)
    idx = [0, 3, 5, 7]
    got = pdata.build_detector_batch(
        SyntheticFreiHand(**kw), idx, max_gt=2,
        flip_rng=np.random.RandomState(4) if flip else None)
    want = jdata.build_detector_batch(
        JaxSyntheticFreiHand(**kw), idx, max_gt=2,
        flip_rng=np.random.RandomState(4) if flip else None)
    assert_same(tuple(got), tuple(want))


def test_aspect_ratio_ranking_and_batches_match_jax():
    r = np.random.RandomState(1)
    widths = r.randint(40, 400, 23)
    heights = r.randint(40, 400, 23)
    got = pdata.rank_aspect_ratios(widths, heights)
    want = jdata.rank_aspect_ratios(widths, heights)
    assert_same(got, want)
    assert want[2].any()   # some images need a crop
    for bs in (1, 4, 5):
        assert_same(pdata.aspect_ratio_batches(want[0], want[1], bs),
                    jdata.aspect_ratio_batches(want[0], want[1], bs))


@pytest.mark.parametrize("case", [
    ((300, 60), 0.5, True, None), ((300, 60), 0.5, True, 7),
    ((50, 240), 2.0, True, 8), ((80, 100), 1.0, False, None),
    ((100, 60), 0.8, False, None), ((60, 100), 1.5, False, None),
    ((200, 40), 0.5, True, 9)])
def test_crop_pad_to_ratio_matches_jax(case):
    (H, W), target, need_crop, seed = case
    r = np.random.RandomState(2)
    image = r.randint(0, 255, (H, W, 3)).astype(np.uint8)
    boxes = np.array([[0.2 * W, 0.3 * H, 0.6 * W, 0.5 * H],
                      [0.1 * W, 0.6 * H, 0.3 * W, 0.9 * H]], np.float32)
    got = pdata.crop_pad_to_ratio(
        image, boxes, target, need_crop,
        None if seed is None else np.random.RandomState(seed))
    want = jdata.crop_pad_to_ratio(
        image, boxes, target, need_crop,
        None if seed is None else np.random.RandomState(seed))
    assert_same(got, want)


def test_build_grouped_batches_matches_jax():
    r = np.random.RandomState(3)
    sizes = [(r.randint(30, 200), r.randint(30, 200)) for _ in range(11)]
    sizes[0], sizes[1] = (300, 50), (40, 240)   # beyond the ratio band
    images = [r.randint(0, 255, (h, w, 3)).astype(np.uint8)
              for h, w in sizes]
    boxes = [np.array([[0.2 * w, 0.2 * h, 0.7 * w, 0.8 * h]], np.float32)
             for h, w in sizes]
    got = pdata.build_grouped_batches(images, boxes, 4,
                                      rng=np.random.RandomState(5))
    want = jdata.build_grouped_batches(images, boxes, 4,
                                       rng=np.random.RandomState(5))
    assert_same(got, want)


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_ap_and_evaluate_detections_match_jax(use_07):
    """Score-ranked greedy matching against unclaimed gt boxes (duplicates
    count as false positives, an image without gt too) and both AP forms:
    equal results, bit for bit."""
    r = np.random.RandomState(6)
    gts = [np.array([[10, 10, 60, 70]], np.float32),
           np.array([[5, 5, 30, 30], [40, 40, 90, 90]], np.float32),
           np.zeros((0, 4), np.float32)]
    dets, scores = [], []
    for g in gts:
        base = g if len(g) else np.array([[0, 0, 20, 20]], np.float32)
        d = np.concatenate([base + r.randn(*base.shape) * 3,
                            base + r.randn(*base.shape) * 15,
                            r.rand(2, 4).cumsum(-1) * 50])
        dets.append(d.astype(np.float32))
        scores.append(r.rand(len(d)).astype(np.float32))
    got = pdata.evaluate_detections(dets, scores, gts, 0.5, use_07)
    want = jdata.evaluate_detections(dets, scores, gts, 0.5, use_07)
    assert_same(got, want)
    assert 0.0 < want["ap"] < 1.0
    rec, prec = want["recall"], want["precision"]
    assert pdata.voc_ap(rec, prec, use_07) == jdata.voc_ap(rec, prec, use_07)


def _conv(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k), (3, 2, 0, 1))))


def test_vgg16_base_and_tail_match_flax():
    """VGG16Base at 32 x 32 (2 x 2 features after four pools) and VGG16Tail
    on (3, 2, 2, 16) pooled features, on the flax modules' init bridged
    into the port's layout (convs at torchvision's `features` indices; fc6
    flattened in (C, H, W) order)."""
    r = np.random.RandomState(7)
    x = r.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    jbase = jvgg.VGG16Base()
    bvars = jax.jit(jbase.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    base = VGG16Base()
    convs = [m for m in base.features if isinstance(m, torch.nn.Conv2d)]
    sd = {}
    for i, conv in enumerate(convs):
        idx = list(base.features).index(conv)
        p = bvars["params"][f"conv{i}"]
        sd[f"features.{idx}.weight"] = _conv(p["kernel"])
        sd[f"features.{idx}.bias"] = torch.from_numpy(np.array(p["bias"]))
    base.load_state_dict(sd)
    want = np.asarray(jax.jit(jbase.apply)(bvars, jnp.asarray(x)))
    with torch.no_grad():
        got = base(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 0

    pooled = r.randn(3, 2, 2, 16).astype(np.float32)
    jtail = jvgg.VGG16Tail()
    tvars = jax.jit(jtail.init)(jax.random.PRNGKey(1), jnp.asarray(pooled))
    tail = VGG16Tail(pooled=2, channels=16)
    fc6 = np.asarray(tvars["params"]["fc6"]["kernel"])     # (H*W*C, out)
    tail.load_state_dict({
        "fc6.weight": torch.from_numpy(np.ascontiguousarray(
            fc6.reshape(2, 2, 16, -1).transpose(3, 2, 0, 1)
            .reshape(-1, 2 * 2 * 16))),
        "fc6.bias": torch.from_numpy(np.array(tvars["params"]["fc6"]
                                                ["bias"])),
        "fc7.weight": torch.from_numpy(np.ascontiguousarray(
            np.asarray(tvars["params"]["fc7"]["kernel"]).T)),
        "fc7.bias": torch.from_numpy(np.array(tvars["params"]["fc7"]
                                                ["bias"]))})
    want = np.asarray(jax.jit(jtail.apply)(tvars, jnp.asarray(pooled)))
    with torch.no_grad():
        got = tail(torch.from_numpy(pooled)).numpy()
    assert got.shape == want.shape == (3, 4096)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
