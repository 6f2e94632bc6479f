"""The port's hand detector against the JAX package on the CPU: the
ResNet base and tail and Faster R-CNN's model stages (upstream features
and RPN maps, downstream on the same features and RoIs) for R18 and R18
GroupNorm, then `detect_hand_crop_bbox` end to end on images whose score
and IoU margins the test asserts to be far above float32 noise.
tests/test_torch_detector_caffe.py runs the same stages for the R50
caffe-style detector, and the proposal layer, post-processing and crop on
given inputs (a file of its own, so that parallel test workers share the
JAX compiles).

Small sizes: R18 at 64x64 with 64 pre-NMS / 16 post-NMS proposals and 5
detections (tests/test_detector.py's tiny detector), R18 GroupNorm, R50
caffe-style at 96 and 81 px. Weights come from the JAX init with
randomised norms and biases and reach the port through
`interop.detector_state_dict_from_jax`. Each comparison states its
tolerance."""

import dataclasses
import importlib

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
    FasterRCNN as JaxFasterRCNN,
)
from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.detect import (
    FasterRCNN,
    hand_detector,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    detector_state_dict_from_jax,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

# the JAX package's ops/__init__ exports a function of this name
jnms = importlib.import_module("hand_integral_pose_estimation_tpu.ops.nms")

# Score gaps and IoU distances to thresholds that the detector comparisons
# need: features agree to ~1e-6 relative between the frameworks, so a gap
# of 1e-4 cannot flip an order or a suppression.
MARGIN = 1e-4
TINY = dict(resnet_type=18, test_scale=64, test_max_size=64,
            rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=16,
            rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=16,
            roi_batch_size=8, max_detections=5, rpn_min_size=2)


# ------------------------------------------------------------------ helpers

def randomized_variables(variables, seed: int):
    """JAX variables as numpy, with random norm scales / biases, running
    statistics and conv / dense biases, so the weights bridge carries
    every kind of leaf (the init's ones and zeros would hide a swap)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x, np.float32)
        name = str(path[-1].key)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.05 * rng.randn(*x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def port_config(jcfg) -> DetectorConfig:
    return DetectorConfig(**dataclasses.asdict(jcfg))


def carried(jcfg, jvars) -> FasterRCNN:
    model = FasterRCNN(port_config(jcfg))
    model.load_state_dict(detector_state_dict_from_jax(jvars, jcfg))
    return model.eval()


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def assert_rel_close(got, want, rel):
    """max |got - want| <= rel * max |want| (float32 convs summed in another
    order differ by a few ulps of the largest activation)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err,
                                                         np.abs(want).max())


def assert_separated(scores, n: int, what: str, floor: float):
    """Of these scores, leaving out exact -1s (the min-size filter's ties),
    none lies within MARGIN of the score threshold `floor`, and the first
    n + 1 above it are pairwise MARGIN apart."""
    s = np.asarray(scores, np.float64).reshape(-1)
    s = s[s != -1.0]
    assert np.abs(s - floor).min() > MARGIN, (what, "threshold")
    s = np.sort(s[s > floor])[::-1][:n + 1]
    gap = -np.diff(s)
    assert gap.size == 0 or gap.min() > MARGIN, (what, gap.min())


def assert_iou_margin(boxes, thr: float, what: str):
    iou = np.asarray(jnms.box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    iou = iou[np.triu_indices(len(boxes), 1)]
    assert iou.size == 0 or np.abs(iou - thr).min() > MARGIN, (
        what, np.abs(iou - thr).min())


# ----------------------------------------------------- the detector, staged

# (name, DetectorConfig fields, image size)
DETECTORS = {
    "r18": (TINY, 64),
    "r50_caffe": (dict(TINY, resnet_type=50, resnet_style="caffe",
                       test_scale=96, test_max_size=96), 96),
    "r50_caffe_odd": (dict(TINY, resnet_type=50, resnet_style="caffe",
                           test_scale=81, test_max_size=81), 81),
    "r18_group": (dict(TINY, norm="group", freeze_bn=False), 64),
}


_INITS = {}


def jax_detector(fields, size, seed):
    """JAX FasterRCNN and randomised variables; the variables do not depend
    on the image size, so configurations that differ only in it share one
    init. The init is jitted: one compile instead of an eager compile per
    op, and the same values."""
    jcfg = JaxDetectorConfig(**fields)
    key = (jcfg.resnet_type, jcfg.norm, jcfg.resnet_style, seed)
    if key not in _INITS:
        jvars = jax.jit(JaxFasterRCNN(cfg=jcfg).init)(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1)},
            jnp.zeros((1, size, size, 3), jnp.float32))
        _INITS[key] = randomized_variables(jvars, seed)
    return jcfg, JaxFasterRCNN(cfg=jcfg), _INITS[key]


def make_detector(name):
    """(name, JAX config, JAX model, its variables, the carried port model,
    a blob of two random images) for one entry of DETECTORS."""
    fields, size = DETECTORS[name]
    jcfg, jmodel, jvars = jax_detector(fields, size, seed=2)
    images = np.random.RandomState(size).randint(
        0, 255, (2, size, size, 3)).astype(np.uint8)
    blob = np.array(jhd.prepare_blob(jnp.asarray(images), jcfg)[0])
    return name, jcfg, jmodel, jvars, carried(jcfg, jvars), blob


def check_upstream(detector):
    """Base features and the RPN maps, through the reference's [bg x A,
    fg x A] class channels: 1e-4 of the largest value (float32 convs summed
    in another order)."""
    name, jcfg, jmodel, jvars, model, blob = detector
    feats_j, cls_j, reg_j, _, _ = jmodel.apply(
        jvars, jnp.asarray(blob), False, method=JaxFasterRCNN._rpn_proposals)
    with torch.inference_mode():
        f = model.RCNN_base(torch.from_numpy(blob).permute(0, 3, 1, 2))
        cls, reg = model.RCNN_rpn(f)
    assert_rel_close(nchw_to_nhwc(f), feats_j, 1e-4)
    B, H, W = cls_j.shape[:3]
    cls_ref = np.moveaxis(np.asarray(cls_j), -1, -2).reshape(B, H, W, -1)
    assert_rel_close(nchw_to_nhwc(cls), cls_ref, 1e-4)
    assert_rel_close(nchw_to_nhwc(reg), np.asarray(reg_j).reshape(B, H, W, -1),
                     1e-4)


def check_downstream(detector):
    """ROIAlign -> layer4 -> mean -> heads on the JAX upstream's features
    and RoIs: probabilities and deltas to 1e-4 of the largest."""
    name, jcfg, jmodel, jvars, model, blob = detector
    feats, rois, valid = jmodel.apply(jvars, jnp.asarray(blob),
                                      method=JaxFasterRCNN.upstream)
    want = jmodel.apply(jvars, feats, rois, valid,
                        method=JaxFasterRCNN.downstream)
    got = model.downstream(torch.from_numpy(np.array(feats)),
                           torch.from_numpy(np.array(rois)),
                           torch.from_numpy(np.array(valid)))
    assert_rel_close(got.cls_scores.detach(), want.cls_scores, 1e-4)
    assert_rel_close(got.bbox_deltas.detach(), want.bbox_deltas, 1e-4)
    np.testing.assert_array_equal(got.roi_valid.numpy(),
                                  np.asarray(want.roi_valid))


def check_freeze_bn(detector):
    """`freeze_bn` keeps every BatchNorm on its running statistics under
    `.train()`; GroupNorm detectors have none."""
    name, jcfg, jmodel, jvars, model, blob = detector
    model.train()
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bool(bns) == (jcfg.norm == "batch")
    if bns:
        assert all(not m.training for m in bns) == jcfg.freeze_bn
        assert any(m.training for m in model.modules())
    model.eval()


@pytest.fixture(scope="module", params=["r18", "r18_group"])
def detector(request):
    return make_detector(request.param)


def test_upstream_features_and_rpn_maps_match_jax(detector):
    check_upstream(detector)


def test_downstream_matches_jax_on_the_same_features_and_rois(detector):
    check_downstream(detector)


def test_freeze_bn_keeps_running_statistics(detector):
    check_freeze_bn(detector)


def assert_detection_margins(jmodel, jvars, jcfg, images):
    """Every decision of the JAX detector on these images is MARGIN away
    from flipping: the RPN's pre-NMS order and min-size filter, its NMS
    IoUs, the detection scores and their NMS IoUs, and the floor() in the
    crop centre. Then the port, whose features differ by ~1e-6, must make
    the same decisions."""
    c = jcfg
    blob, scale = jhd.prepare_blob(jnp.asarray(images), c)
    H, W = blob.shape[1:3]
    feats, cls, reg, anchors, props = jmodel.apply(
        jvars, blob, False, method=JaxFasterRCNN._rpn_proposals)
    for i in range(blob.shape[0]):
        fg = np.asarray(jax.nn.softmax(cls[i], -1)[..., 1]).reshape(-1)
        boxes = np.asarray(jbox.clip_boxes(jbox.decode_boxes(
            anchors, reg[i].reshape(-1, 4)), (H, W)))
        wh = boxes[:, 2:] - boxes[:, :2] + 1.0
        assert np.abs(wh - c.rpn_min_size).min() > MARGIN
        fg = np.where((wh >= c.rpn_min_size).all(1), fg, -1.0)
        assert_separated(fg, c.rpn_pre_nms_top_n_test, "rpn scores", 0.0)
        top = np.argsort(-fg, kind="stable")[:c.rpn_pre_nms_top_n_test]
        assert_iou_margin(boxes[top][fg[top] > 0], c.rpn_nms_thresh,
                          "rpn nms")
    out = jmodel.apply(jvars, feats, props.rois, props.valid,
                       method=JaxFasterRCNN.downstream)
    det = jhd._postprocess(out, c, (H, W), scale)
    hand = np.where(np.asarray(out.roi_valid), np.asarray(out.cls_scores)[
        ..., 1], 0.0)
    for i in range(blob.shape[0]):
        assert_separated(hand[i][np.asarray(out.roi_valid[i])],
                         c.max_detections, "detection scores",
                         c.det_score_thresh)
        b = np.asarray(det.boxes[i])[np.asarray(det.valid[i])]
        assert_iou_margin(b, c.det_nms_thresh, "class nms")
        if len(b):
            # the crop centre is floor((x1 + x2) / 2): away from an integer,
            # unless both ends are clipped to the image and so exact
            ends = np.stack([b[0, 0::2], b[0, 1::2]])        # (x, y) ends
            edge = np.array([[0.0, (W - 1) / scale], [0.0, (H - 1) / scale]],
                            np.float32)
            exact = np.isin(ends[0], edge[0]).all(), np.isin(ends[1],
                                                             edge[1]).all()
            ctr = ends.sum(1) / 2
            frac = ctr - np.floor(ctr)
            near = np.minimum(frac, 1 - frac) <= MARGIN
            assert not (near & ~np.asarray(exact)).any(), (ctr, exact)


def tiny_images(seed=11, B=2, size=64):
    return np.random.RandomState(seed).randint(0, 255, (B, size, size, 3)
                                               ).astype(np.uint8)


@pytest.fixture(scope="module")
def tiny():
    jcfg, jmodel, jvars = jax_detector(TINY, 64, seed=3)
    jvars = jax.tree_util.tree_map(np.copy, jvars)
    # random weights drive both class heads into saturation, where every
    # score is 0 or 1 and the detector decides nothing: scale them to
    # logits of about unit spread on the test images
    blob = jhd.prepare_blob(jnp.asarray(tiny_images()), jcfg)[0]
    _, cls, _, _, props = jmodel.apply(jvars, blob, False,
                                       method=JaxFasterRCNN._rpn_proposals)
    p = jvars["params"]
    k = 2.0 / float(np.std(np.asarray(cls)))
    p["rpn_cls"] = {n: np.float32(k) * v for n, v in p["rpn_cls"].items()}
    feats, rois, valid = jmodel.apply(jvars, blob,
                                      method=JaxFasterRCNN.upstream)
    h = jmodel.apply(jvars, feats, rois, False,
                     method=JaxFasterRCNN._head_outputs)[0]
    k = 2.0 / float(np.std(np.asarray(h)))
    p["cls_score"] = {n: np.float32(k) * v for n, v in p["cls_score"].items()}
    return jcfg, jmodel, jvars, carried(jcfg, jvars)


@pytest.mark.parametrize("split", [False, True])
def test_detect_hand_crop_bbox_matches_jax(tiny, split):
    """End to end on images whose decisions the test shows to be far from
    flipping: detections (keep sets identical, scores 1e-5, boxes 1e-4)
    and crop boxes to 1e-4; `detect_split` gives `detect`'s outputs."""
    jcfg, jmodel, jvars, model = tiny
    images = tiny_images()
    assert_detection_margins(jmodel, jvars, jcfg, images)
    want = jhd.detect(jmodel, jvars, jnp.asarray(images), jcfg)
    run = hand_detector.detect_split if split else hand_detector.detect
    got = run(model, torch.from_numpy(images))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) > 0
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-4)
    crop = hand_detector.detect_hand_crop_bbox(
        model, torch.from_numpy(images), split=split)
    crop_j = jhd.detect_hand_crop_bbox(jmodel, jvars, jnp.asarray(images),
                                       jcfg)
    np.testing.assert_allclose(crop.numpy(), np.asarray(crop_j), atol=1e-4)
