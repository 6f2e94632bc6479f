"""The port's R50 caffe-style detector against the JAX package on the
CPU, stage by stage (upstream features and RPN maps, downstream on the
same features and RoIs; the caffe bottleneck's stride on its first 1x1
conv and the -inf-padded stem pool at an even and an odd size), and the
detector's stages on given inputs: the proposal layer on the same RPN
outputs, the post-processing and crop on the same detector outputs, and
the blob. The helpers and the R18 stages are in
tests/test_torch_detector.py; the two files are apart so that parallel
test workers share their JAX compiles. Each comparison states its
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.config import (
    DetectorConfig as JaxDetectorConfig,
)
from hand_integral_pose_estimation_tpu.detect import box_ops as jbox
from hand_integral_pose_estimation_tpu.detect import hand_detector as jhd
from hand_integral_pose_estimation_tpu.detect.faster_rcnn import (
    DetectionOutputs as JaxDetectionOutputs,
)
from hand_integral_pose_estimation_tpu.detect.rpn import (
    proposal_layer as jax_proposal_layer,
)
from hand_integral_pose_estimation_tpu_torch.detect import (
    box_ops,
    hand_detector,
)
from hand_integral_pose_estimation_tpu_torch.detect.faster_rcnn import (
    DetectionOutputs,
)
from hand_integral_pose_estimation_tpu_torch.detect.rpn import proposal_layer
from test_torch_detector import (
    MARGIN,
    TINY,
    assert_iou_margin,
    assert_separated,
    check_downstream,
    check_freeze_bn,
    check_upstream,
    make_detector,
    port_config,
    tiny_images,
)


@pytest.fixture(scope="module", params=["r50_caffe", "r50_caffe_odd"])
def detector(request):
    return make_detector(request.param)


def test_upstream_features_and_rpn_maps_match_jax(detector):
    check_upstream(detector)


def test_downstream_matches_jax_on_the_same_features_and_rois(detector):
    check_downstream(detector)


def test_freeze_bn_keeps_running_statistics(detector):
    check_freeze_bn(detector)


def rpn_outputs(seed: int, B=2, H=6, W=6, A=12):
    """RPN logits whose fg - bg differences are a permutation of a spaced
    grid (so the fg scores are MARGIN apart) and random deltas, in the JAX
    layout (B, H, W, A, 2) and (B, H, W, A, 4)."""
    rng = np.random.RandomState(seed)
    N = H * W * A
    bg = rng.randn(B, N)
    fg = bg + np.stack([rng.permutation(np.linspace(-4, 4, N))
                        for _ in range(B)])
    cls = np.stack([bg, fg], -1).reshape(B, H, W, A, 2).astype(np.float32)
    reg = (0.3 * rng.randn(B, H, W, A, 4)).astype(np.float32)
    return cls, reg


def test_proposal_layer_matches_jax():
    """The same RPN outputs give the same proposals: identical keep sets,
    boxes to 1e-6 relative (exp in two libraries). The test asserts that
    no score pair, box size or IoU lies within 1e-4 of a decision."""
    cfg = JaxDetectorConfig()
    A = len(cfg.anchor_scales) * len(cfg.anchor_ratios)
    base = jbox.generate_base_anchors(16, cfg.anchor_ratios,
                                      cfg.anchor_scales)
    cls, reg = rpn_outputs(seed=0, A=A)
    B, H, W = cls.shape[:3]
    anchors = jbox.grid_anchors((H, W), 16, base)
    im_hw, pre, post, min_size = (96, 96), 200, 150, 8.0
    want = jax.vmap(lambda c, r: jax_proposal_layer(
        c, r, anchors, im_hw, pre, post, 0.7, min_size))(jnp.asarray(cls),
                                                          jnp.asarray(reg))
    for i in range(B):
        fg = np.asarray(jax.nn.softmax(jnp.asarray(cls[i]), -1)[..., 1])
        boxes = np.asarray(jbox.clip_boxes(jbox.decode_boxes(
            anchors, jnp.asarray(reg[i]).reshape(-1, 4)), im_hw))
        wh = boxes[:, 2:] - boxes[:, :2] + 1.0
        assert np.abs(wh - min_size).min() > MARGIN
        fg = np.where((wh >= min_size).all(1), fg.reshape(-1), -1.0)
        assert_separated(fg, pre, "rpn scores", 0.0)
        top = np.argsort(-fg, kind="stable")[:pre]
        assert_iou_margin(boxes[top][fg[top] > 0], 0.7, "rpn nms")

    cls_port = np.moveaxis(cls, -1, -2).reshape(B, H, W, 2 * A)
    got = proposal_layer(torch.from_numpy(cls_port),
                         torch.from_numpy(reg.reshape(B, H, W, 4 * A)),
                         box_ops.grid_anchors((H, W), 16, base), im_hw, pre,
                         post, 0.7, min_size)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum()) < B * post
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-7)


def jax_outputs(seed: int, B=2, R=16):
    """DetectionOutputs of a tiny detector in the JAX layout: RoIs, some
    invalid, class probabilities whose hand scores are MARGIN apart, and
    deltas."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 40, (B, R, 2))
    rois = np.concatenate([lo, lo + rng.uniform(6, 30, (B, R, 2))], -1)
    valid = rng.rand(B, R) < 0.8
    rois = np.where(valid[..., None], rois, 0.0).astype(np.float32)
    hand = np.stack([rng.permutation(np.linspace(0.05, 0.95, R))
                     for _ in range(B)])
    probs = np.stack([1 - hand, hand], -1).astype(np.float32)
    deltas = (0.5 * rng.randn(B, R, 8)).astype(np.float32)
    return rois, valid, probs, deltas


def test_postprocess_and_crop_match_jax():
    """The same detector outputs give the same detections (keep sets and
    scores identical, boxes to 1e-5) and the same crop boxes (1e-4), also
    for an image whose detections are all invalid (the full-image crop)."""
    cfg = JaxDetectorConfig(**TINY)
    rois, valid, probs, deltas = jax_outputs(seed=1)
    valid[1] = False                   # no detection: the fallback crop
    blob_hw, scale = (64, 64), 64 / 50.0
    want = jhd._postprocess(
        JaxDetectionOutputs(jnp.asarray(rois), jnp.asarray(valid),
                            jnp.asarray(probs), jnp.asarray(deltas), None),
        cfg, blob_hw, scale)
    got = hand_detector._postprocess(
        DetectionOutputs(torch.from_numpy(rois), torch.from_numpy(valid),
                         torch.from_numpy(probs), torch.from_numpy(deltas),
                         None), port_config(cfg), blob_hw, scale)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-5)
    assert int(got.valid[0].sum()) > 0 and not bool(got.valid[1].any())
    crop = hand_detector._crop_from_detections(got, (50, 40), 1.75)
    crop_j = jhd._crop_from_detections(want, (50, 40), 1.75)
    np.testing.assert_allclose(crop.numpy(), np.asarray(crop_j), atol=1e-4)
    np.testing.assert_allclose(crop[1].numpy(), [20.0, 25.0, 50.0, 50.0])



def test_prepare_blob_resizes_like_jax_and_skips_scale_one():
    """BGR, pixel means, the axis-aligned resize to the test scale (600
    short side from 224, as the serving path upscales) to 1e-3 on the
    0..255 scale, and no resample at scale 1."""
    images = tiny_images(seed=2, B=2, size=56)
    for fields in (dict(test_scale=150, test_max_size=1000),
                   dict(test_scale=56, test_max_size=56)):
        jcfg = JaxDetectorConfig(**fields)
        want, wscale = jhd.prepare_blob(jnp.asarray(images), jcfg)
        got, scale = hand_detector.prepare_blob(torch.from_numpy(images),
                                                port_config(jcfg))
        assert scale == wscale and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
