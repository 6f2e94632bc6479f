"""The detector's native recipe and its bf16 serving arm against the JAX
package on the CPU.

- Three SGD steps of the from-scratch recipe (`DetectorConfig.native`'s
  GroupNorm backbone with live norms, anchors (2, 4, 8, 12) and easy
  negatives, `roi_bg_thresh_lo=0`) at float64 and 96 px: the port's steps
  against the JAX package's steps, from the same weights and the same
  subsampling draws at each step, the JAX proposals stop-gradiented as
  in tests/test_torch_detector_train.py (the port, as the reference,
  detaches them). Proposal and RoI counts are that file's, cut to CPU
  size; the native recipe's fields are kept.
- The detector at `compute_dtype="bfloat16"` (the JAX package's serving
  dtype, `DetectorConfig.serving(64, "bfloat16")`) against the JAX detector
  at bf16 on the same carried weights: base features, RPN maps, and the
  downstream scores and deltas on the JAX features and RoIs.
- The convergence study's data (`detect/synthetic.py`, the port's copy)
  bitwise the JAX package's: its scenes, gt boxes and flips at 224 px, the
  train split's seeds and the held-out split's (seed + 10 000)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.config import (
    DetectorConfig as JaxDetectorConfig,
)
from hand_integral_pose_estimation_tpu.detect import faster_rcnn as jfr
from hand_integral_pose_estimation_tpu.detect import hand_detector as jhd
from hand_integral_pose_estimation_tpu.detect import synthetic as jsyn
from hand_integral_pose_estimation_tpu.training import (
    detector_trainer as jtrainer,
)
from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.detect import FasterRCNN
from hand_integral_pose_estimation_tpu_torch.detect import synthetic
from hand_integral_pose_estimation_tpu_torch.detect.faster_rcnn import (
    SamplingPriorities,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    detector_state_dict_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.training.detector_trainer import (
    make_detector_optimizer,
    make_detector_train_step,
)
from test_torch_detector import (
    TINY,
    assert_rel_close,
    carried,
    jax_detector,
)
from test_torch_detector_train import (
    GT,
    GT_CLASSES,
    GT_VALID,
    jax_draws,
    rel_dist,
    t,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

SIZE = 96
STEPS = 3
# the native recipe at 96 px, its proposal and RoI counts cut to CPU size;
# one image (the first of that file's gt: two boxes), since the JAX step
# at float64 takes seconds an image on the CPU
GT1, GT1_CLASSES, GT1_VALID = GT[:1], GT_CLASSES[:1], GT_VALID[:1]
NATIVE = dict(dataclasses.asdict(JaxDetectorConfig.native(SIZE, 18)),
              rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=16,
              rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=16,
              roi_batch_size=8, rpn_batch_size=32, max_detections=5,
              compute_dtype="float64")
# bf16 rounds each conv's inputs to 8 significant bits, in another order
# in each framework (XLA's convolutions against oneDNN's, each rounding its
# own float32 partial sums and activations): the two detectors part by a
# few bf16 ulps (2^-8 = 3.9e-3) of the largest value. Measured on this
# detector: 1.19e-2 (base features), 1.23e-2 (RPN class logits), 1.26e-2
# (RPN box deltas), 1.08e-2 (scores) and 4.9e-3 (box deltas), the same at
# 1, 2 and 8 torch threads; at float32 tests/test_torch_detector.py holds
# the same stages to 1e-4. An operator or a layout carried wrong moves
# these by far more than 2e-2.
BF16_REL = 2e-2


def drawn(shapes, seed):
    """float64 variables of these shapes from numpy (no JAX init to
    compile): convs He-normal over their fan-out, the Linear heads normal
    with std 0.01, and norm scales U(0.8, 1.2) and biases 0.05 N(0, 1) as
    tests/test_torch_detector_train.py's `randomized` sets them."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "scale":
            return rs.uniform(0.8, 1.2, x.shape)
        if name == "bias":
            return 0.05 * rs.randn(*x.shape)
        if len(x.shape) == 4:
            return rs.randn(*x.shape) * np.sqrt(
                2.0 / (x.shape[0] * x.shape[1] * x.shape[3]))
        return 0.01 * rs.randn(*x.shape)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_model(jcfg, jvars) -> FasterRCNN:
    """The port's detector at float64 from the JAX package's variables."""
    model = FasterRCNN(DetectorConfig(**dict(
        dataclasses.asdict(jcfg), compute_dtype="float64")))
    model.load_state_dict(detector_state_dict_from_jax(jvars, jcfg))
    return model.double().eval()


def scale_heads(jcfg, jvars, blob):
    """Scale the RPN's and the detection head's class and box layers to
    logits and deltas of about unit spread (0.2 for the RPN's deltas), as
    tests/test_torch_detector_train.py's `scale_heads` does: random
    weights saturate both softmaxes and clip every proposal to a sliver.
    The spreads are measured on the port (the same weights: its outputs
    agree with the JAX package's to ~1e-6) and the factors rounded to
    powers of two, so that the scaled weights are the same in both
    packages."""
    params = jax.tree_util.tree_map(np.array, jvars["params"])
    scaled = {"params": params, "batch_stats": jvars["batch_stats"]}
    blob = t(np.asarray(blob, np.float64))

    def scale(names, outs, wants):
        for name, out, want in zip(names, outs, wants):
            k = 2.0 ** round(np.log2(want / float(out.std())))
            for leaf in ("kernel", "bias"):
                params[name][leaf] *= k

    with torch.no_grad():
        _, cls, reg, _ = port_model(jcfg, scaled)._rpn(blob)
        scale(("rpn_cls", "rpn_bbox"), (cls, reg), (1.0, 0.2))
        model = port_model(jcfg, scaled)
        feats, rois, _ = model.upstream(blob)
        scale(("cls_score", "bbox_pred"), model._head(feats, rois),
              (1.0, 1.0))
    return scaled


@pytest.fixture(scope="module")
def native_steps():
    """STEPS float64 SGD steps of both packages from the same weights,
    blob, gt and draws; per step the losses and every parameter."""
    jcfg = JaxDetectorConfig(**NATIVE)
    assert jcfg.norm == "group" and not jcfg.freeze_bn
    assert jcfg.roi_bg_thresh_lo == 0.0
    assert tuple(jcfg.anchor_scales) == (2, 4, 8, 12)
    jmodel = jfr.FasterRCNN(cfg=jcfg)
    jvars = drawn(jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0),
                      "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3))), seed=5)
    images = np.random.RandomState(19).randint(
        0, 255, (len(GT1), SIZE, SIZE, 3)).astype(np.uint8)
    blob = np.array(jhd.prepare_blob(jnp.asarray(images), jcfg)[0],
                    np.float64)
    assert "batch_stats" not in jvars     # GroupNorm: no statistics
    # float32 values, so that the port (its weights carried as float32)
    # starts from the same point
    jvars = {"params": jax.tree_util.tree_map(
        lambda x: np.float64(np.float32(x)), jvars["params"]),
        "batch_stats": {}}
    jvars = scale_heads(jcfg, jvars, blob)
    params0 = jvars["params"]
    lr, wd = 0.01, 5e-4
    rngs = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]

    tx = jtrainer.make_detector_optimizer(lr=lr, weight_decay=wd)
    state = jtrainer.DetectorTrainState(
        step=jnp.zeros((), jnp.int32), params=jvars["params"],
        batch_stats=jvars["batch_stats"], opt_state=tx.init(jvars["params"]))
    orig = jfr.proposal_layer

    def stopped(*a, **k):
        return jax.tree_util.tree_map(jax.lax.stop_gradient, orig(*a, **k))

    jax_steps = []
    jfr.proposal_layer = stopped
    try:
        step = jtrainer.make_detector_train_step(jmodel, tx)
        for rng in rngs:
            state, metrics = step(state, jnp.asarray(blob), jnp.asarray(GT1),
                                  jnp.asarray(GT1_CLASSES),
                                  jnp.asarray(GT1_VALID), rng)
            # the change since the start, formed in float64
            moved = jax.tree_util.tree_map(lambda n, o: n - o, state.params,
                                           params0)
            jax_steps.append((
                {k: float(v) for k, v in metrics.items()},
                detector_state_dict_from_jax({"params": moved}, jcfg)))
    finally:
        jfr.proposal_layer = orig

    fh = fw = SIZE // jcfg.feat_stride
    A = len(jcfg.anchor_scales) * len(jcfg.anchor_ratios)
    model = port_model(jcfg, jvars)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = make_detector_optimizer(model.parameters(), lr=lr,
                                         weight_decay=wd)
    step = make_detector_train_step(model, opt, sched)
    port_steps = []
    for rng in rngs:
        # the key FasterRCNN.__call__ draws from: the root module's first
        # make_rng("sampling")
        key = jmodel.apply(jvars, method=lambda m: m.make_rng("sampling"),
                           rngs={"sampling": rng})
        keys = jax.random.split(key, 2 * len(GT1)).reshape(len(GT1), 2, 2)
        pri = SamplingPriorities(
            *jax_draws(keys[:, 0], fh * fw * A),
            *jax_draws(keys[:, 1],
                       jcfg.rpn_post_nms_top_n_train + GT1.shape[1]))
        metrics = step(t(blob), t(GT1), t(GT1_CLASSES), t(GT1_VALID),
                       priorities=pri)
        port_steps.append((
            {k: float(v) for k, v in metrics.items()},
            {n: p.detach() - start[n] for n, p in
             model.named_parameters()}))
    return jax_steps, port_steps


@pytest.mark.parametrize("step", range(STEPS))
def test_native_sgd_steps_match_jax(native_steps, step):
    """Each step's four losses to 1e-5 relative (float64 convs, the float32
    stages of both packages: proposals, ROIAlign, losses), and every
    parameter after the step: its change since the start (float64 in both
    packages) to ||d|| <= 1e-4 ||want||, the one-step bound of
    tests/test_torch_detector_train.py, held over three steps of momentum.
    GroupNorm's scales and biases train as every other leaf."""
    jax_steps, port_steps = native_steps
    (want_loss, want), (got_loss, got) = jax_steps[step], port_steps[step]
    for name in ("rpn_cls", "rpn_reg", "det_cls", "det_reg", "loss"):
        np.testing.assert_allclose(got_loss[name], want_loss[name],
                                   rtol=1e-5, err_msg=name)
        assert want_loss[name] > 0, name
    assert set(got) <= set(want)
    norms = {f"{m}.{p}" for m, mod in FasterRCNN(
        DetectorConfig(**NATIVE)).named_modules()
        if isinstance(mod, torch.nn.GroupNorm) for p, _ in
        mod.named_parameters()}
    assert norms and norms <= set(got)
    for name in got:
        assert float(want[name].norm()) > 0, name
        assert rel_dist(got[name], want[name]) <= 1e-4, name


@pytest.fixture(scope="module")
def bf16_detector():
    """TINY R18 of tests/test_torch_detector.py (its seed-2 variables), the
    heads scaled as above (unscaled, its class softmax saturates to 0 and
    1 and a comparison of scores sees nothing), at bf16 in both
    packages."""
    jcfg, _, jvars = jax_detector(TINY, 64, seed=2)
    images = np.random.RandomState(64).randint(
        0, 255, (2, 64, 64, 3)).astype(np.uint8)
    blob = np.array(jhd.prepare_blob(jnp.asarray(images), jcfg)[0])
    jvars = scale_heads(jcfg, jvars, blob)
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    jmodel = jfr.FasterRCNN(cfg=jcfg)
    model = carried(jcfg, jvars)
    assert model.compute_dtype == torch.bfloat16
    return jcfg, jmodel, jvars, model, blob


def jax_method(jmodel, method, *static):
    """`jmodel.apply(variables, *args, *static, method=method)`, jitted:
    one compile instead of an eager compile per op."""
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, *static,
                                              method=method))


def test_bf16_upstream_matches_jax_bf16(bf16_detector):
    """Base features and the RPN maps at bf16, within BF16_REL of the
    largest value."""
    jcfg, jmodel, jvars, model, blob = bf16_detector
    feats_j, cls_j, reg_j, _, _ = jax_method(
        jmodel, jfr.FasterRCNN._rpn_proposals, False)(jvars, jnp.asarray(blob))
    with torch.inference_mode():
        feats, cls, reg, _ = model._rpn(torch.from_numpy(blob))
    assert feats.dtype == torch.bfloat16
    assert_rel_close(feats.float(), np.asarray(feats_j, np.float32),
                     BF16_REL)
    B, H, W = cls_j.shape[:3]
    cls_ref = np.moveaxis(np.asarray(cls_j, np.float32), -1, -2).reshape(
        B, H, W, -1)
    assert_rel_close(cls.float(), cls_ref, BF16_REL)
    assert_rel_close(reg.float(),
                     np.asarray(reg_j, np.float32).reshape(B, H, W, -1),
                     BF16_REL)


def test_bf16_downstream_matches_jax_bf16(bf16_detector):
    """ROIAlign -> layer4 -> mean -> heads at bf16 on the JAX upstream's
    features and RoIs: scores and deltas within BF16_REL of the largest,
    the RoI validity equal."""
    jcfg, jmodel, jvars, model, blob = bf16_detector
    feats, rois, valid = jax_method(jmodel, jfr.FasterRCNN.upstream)(
        jvars, jnp.asarray(blob))
    want = jax_method(jmodel, jfr.FasterRCNN.downstream)(jvars, feats, rois,
                                                          valid)
    feats = torch.from_numpy(np.asarray(feats, np.float32))
    rois, valid = torch.from_numpy(np.array(rois)), torch.from_numpy(
        np.array(valid))
    with torch.inference_mode():
        got = model.downstream(feats.to(torch.bfloat16), rois, valid)
    assert_rel_close(got.cls_scores, np.asarray(want.cls_scores, np.float32),
                     BF16_REL)
    assert_rel_close(got.bbox_deltas,
                     np.asarray(want.bbox_deltas, np.float32), BF16_REL)
    np.testing.assert_array_equal(got.roi_valid.numpy(),
                                  np.asarray(want.roi_valid))
    # not a vacuous match: bf16 moved both away from their float32 outputs
    f32 = carried(dataclasses.replace(jcfg, compute_dtype="float32"), jvars)
    with torch.inference_mode():
        full = f32.downstream(feats, rois, valid)
    assert float((full.bbox_deltas - got.bbox_deltas).abs().max()) > 0


@pytest.mark.parametrize("n,seed", [(8, 0), (8, 1), (8, 2), (64, 10_000)])
def test_synthetic_scenes_match_jax_bitwise(n, seed):
    """`make_synthetic_box_dataset` at the study's 224 px, the train
    split's first scenes at seeds 0-2 and the whole held-out split of seed
    0 (64 scenes at seed + 10 000): images and gt boxes bitwise the JAX
    package's; then `flip_batch` on those scenes and boxes under one mask,
    bitwise too."""
    got = synthetic.make_synthetic_box_dataset(n, (224, 224), seed=seed)
    want = jsyn.make_synthetic_box_dataset(n, (224, 224), seed=seed)
    np.testing.assert_array_equal(got.images, want.images)
    assert len(got.gt_boxes) == len(want.gt_boxes) == n
    for g, w in zip(got.gt_boxes, want.gt_boxes):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    boxes = np.stack(want.gt_boxes)
    mask = np.random.RandomState(seed + 1).rand(n) < 0.5
    assert 0 < mask.sum() < n
    for g, w in zip(synthetic.flip_batch(got.images, boxes, mask),
                    jsyn.flip_batch(want.images, boxes, mask)):
        np.testing.assert_array_equal(g, w)
