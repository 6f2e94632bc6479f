"""The port's detector training against the JAX package on the CPU: the
smooth-L1, the anchor and proposal targets and both losses on the same
inputs and the same subsampling draws, the plain ROIAlign VJP against
`jax.vjp` of the XLA ROIAlign, the SGD chain against optax, the training
forward's four losses, and one SGD step of the whole detector at float64.

Draws: the JAX package samples with `jax.random.uniform` under keys split
from its "sampling" rng; the port takes the same uniforms as tensors
(`SamplingPriorities`), so targets and losses can be compared exactly.

Proposals: the JAX package differentiates through the proposal boxes
(ROIAlign's sampling positions and the proposal targets' encode); the port,
as the reference, detaches them. The step is compared against the JAX step
with its `proposal_layer` wrapped in `jax.lax.stop_gradient` (patched in
the test only); a second test shows that the unpatched JAX gradient of the
RPN's box branch differs.

Small sizes: R18 at 96 px with anchor scales (2, 4) (so that anchors lie
inside the image), 64 -> 16 train proposals, 8 sampled RoIs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hand_integral_pose_estimation_tpu.config import (
    DetectorConfig as JaxDetectorConfig,
)
from hand_integral_pose_estimation_tpu.detect import box_ops as jbox
from hand_integral_pose_estimation_tpu.detect import faster_rcnn as jfr
from hand_integral_pose_estimation_tpu.detect import hand_detector as jhd
from hand_integral_pose_estimation_tpu.detect import rpn as jrpn
from hand_integral_pose_estimation_tpu.detect import targets as jtargets
from hand_integral_pose_estimation_tpu.training import (
    detector_trainer as jtrainer,
)
from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.detect import (
    FasterRCNN,
    rpn,
    targets,
)
from hand_integral_pose_estimation_tpu_torch.detect.faster_rcnn import (
    SamplingPriorities,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    detector_state_dict_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.ops import roi_align as proi
from hand_integral_pose_estimation_tpu_torch.training.detector_trainer import (
    clip_by_global_norm_,
    make_detector_optimizer,
    make_detector_train_step,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

jroi = importlib.import_module("hand_integral_pose_estimation_tpu.ops.roi_align")

SIZE = 96
TRAIN = dict(resnet_type=18, test_scale=SIZE, test_max_size=SIZE,
             anchor_scales=(2, 4), rpn_pre_nms_top_n_test=64,
             rpn_post_nms_top_n_test=16, rpn_pre_nms_top_n_train=64,
             rpn_post_nms_top_n_train=16, roi_batch_size=8, rpn_batch_size=32,
             max_detections=5, rpn_min_size=2)
# two images, two gt slots, the second image's second slot padding
GT = np.array([[[20.0, 24.0, 70.0, 80.0], [50.0, 10.0, 90.0, 40.0]],
               [[10.0, 30.0, 60.0, 64.0], [0.0, 0.0, 0.0, 0.0]]], np.float32)
GT_VALID = np.array([[True, True], [True, False]])
GT_CLASSES = np.array([[1, 1], [1, 0]], np.int32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_draws(keys, n: int):
    """Per image key -> the (fg, bg) uniforms `_subsample` draws under it:
    split into k_fg, k_bg, then uniform((n,)) each, stacked over images."""
    fg, bg = [], []
    for k in keys:
        k_fg, k_bg = jax.random.split(k)
        fg.append(np.asarray(jax.random.uniform(k_fg, (n,))))
        bg.append(np.asarray(jax.random.uniform(k_bg, (n,))))
    return t(np.stack(fg)), t(np.stack(bg))


def anchors_of(jcfg, feat_hw):
    return jbox.grid_anchors(feat_hw, jcfg.feat_stride,
                             jbox.generate_base_anchors(
                                 jcfg.feat_stride, jcfg.anchor_ratios,
                                 jcfg.anchor_scales))


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_smooth_l1_matches_jax(sigma):
    d = np.random.RandomState(0).randn(257).astype(np.float32) * 0.4
    d[:3] = [1.0 / sigma ** 2, -1.0 / sigma ** 2, 0.0]   # the seam
    got = rpn.smooth_l1(t(d), sigma).numpy()
    want = np.asarray(jrpn.smooth_l1(jnp.asarray(d), sigma))
    np.testing.assert_array_equal(got, want)


def anchor_case():
    jcfg = JaxDetectorConfig(**TRAIN)
    anchors = anchors_of(jcfg, (8, 8))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = jax.vmap(lambda k, gb, gv: jrpn.anchor_target_layer(
        k, anchors, gb, gv, (128, 128), jcfg))(
            keys, jnp.asarray(GT), jnp.asarray(GT_VALID))
    got = rpn.anchor_target_layer(
        t(anchors), t(GT), t(GT_VALID), (128, 128),
        DetectorConfig(**TRAIN), jax_draws(keys, anchors.shape[0]))
    return jcfg, anchors, want, got


def test_anchor_targets_match_jax():
    """Labels and masks equal, regression targets to float32 rounding; the
    case samples: more negatives than the 16 background slots."""
    _, _, want, got = anchor_case()
    for name in ("labels", "fg_mask", "sample_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-6,
                               atol=1e-6)
    fg = int(got.fg_mask.sum())
    assert fg >= 2 and int(got.sample_mask.sum()) == fg + 32
    # 16 negatives an image, chosen among the ~140 inside anchors
    assert ((np.asarray(want.labels) == 0).sum(1) == 16).all()


def test_rpn_losses_match_jax():
    """The port's [bg x A, fg x A] class channels paired as the JAX
    package's (A, 2) pairs: both losses per image to 1e-6 relative."""
    jcfg, anchors, want_t, got_t = anchor_case()
    r = np.random.RandomState(1)
    A = len(jcfg.anchor_scales) * len(jcfg.anchor_ratios)
    cls = r.randn(2, 8, 8, A, 2).astype(np.float32)
    reg = (0.3 * r.randn(2, 8, 8, A, 4)).astype(np.float32)
    want = jax.vmap(jrpn.rpn_losses, in_axes=(0, 0, 0, None))(
        jnp.asarray(cls), jnp.asarray(reg), want_t, 3.0)
    port_cls = np.moveaxis(cls, -1, -2).reshape(2, 8, 8, 2 * A)
    got = rpn.rpn_losses(t(port_cls), t(reg.reshape(2, 8, 8, 4 * A)), got_t,
                         3.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        assert (np.asarray(w) > 0).all()


def proposal_case(cfg_fields=TRAIN):
    jcfg = JaxDetectorConfig(**cfg_fields)
    r = np.random.RandomState(5)
    R = 30
    lo = r.rand(2, R, 2) * 70
    rois = np.concatenate([lo, lo + 8 + r.rand(2, R, 2) * 40], -1)
    rois[:, :6] = GT[:, :1] + r.randn(2, 6, 4) * 4   # near the gt
    rois = rois.astype(np.float32)
    valid = np.ones((2, R), bool)
    valid[1, -5:] = False
    rois[1, -5:] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    want = jax.vmap(lambda k, rr, rv, gb, gc, gv:
                    jtargets.proposal_target_layer(k, rr, rv, gb, gc, gv,
                                                   jcfg))(
        keys, jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(GT),
        jnp.asarray(GT_CLASSES), jnp.asarray(GT_VALID))
    got = targets.proposal_target_layer(
        t(rois), t(valid), t(GT), t(GT_CLASSES), t(GT_VALID),
        DetectorConfig(**cfg_fields), jax_draws(keys, R + 2))
    return want, got


@pytest.mark.parametrize("bg_lo", [0.1, 0.0])
def test_proposal_targets_match_jax(bg_lo):
    """The sampled RoIs (fg first), labels and masks equal; the normalised
    targets to a float32 ulp (under x64 the JAX package normalises in
    float64, the port in float32)."""
    want, got = proposal_case(dict(TRAIN, roi_bg_thresh_lo=bg_lo))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    for name in ("labels", "fg_mask", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=2e-7,
                               atol=1e-6)
    assert 1 <= int(got.fg_mask.sum(1).min()) and int(got.valid.sum()) > 4


def test_detection_head_losses_match_jax():
    want_t, got_t = proposal_case()
    r = np.random.RandomState(2)
    cls = r.randn(2, 8, 2).astype(np.float32)
    sel = (0.5 * r.randn(2, 8, 4)).astype(np.float32)
    want = jax.vmap(jtargets.detection_head_losses)(
        jnp.asarray(cls), jnp.asarray(sel), want_t)
    got = targets.detection_head_losses(t(cls), t(sel), got_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        assert (np.asarray(w) > 0).all()


def test_roi_align_feature_vjp_matches_jax():
    """The plain ROIAlign's feature gradient (the backward kernel's plain
    version) against jax.vjp of the JAX package's XLA ROIAlign, on RoIs of
    the training layout (large, small, partly off the map, zero padding):
    1e-5 of the largest entry (float32 sums in another order)."""
    r = np.random.RandomState(4)
    feats = r.randn(2, 9, 11, 16).astype(np.float32)
    lo = r.rand(2, 12, 2) * 150 - 20
    rois = np.concatenate([lo, lo + 2 + r.rand(2, 12, 2) * 120], -1)
    rois[:, 0] = [70.0, 60.0, 78.0, 64.0]        # under one feature cell
    rois[:, -3:] = 0.0                            # padding slots
    rois = rois.astype(np.float32)
    cot = r.randn(2, 12, 7, 7, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jroi.roi_align_batched(
        f, jnp.asarray(rois), 7, 1 / 16.0, 2, impl="xla"), jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    got = proi.roi_align_bwd_plain(t(cot), t(rois), (9, 11)).numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    f = t(feats).requires_grad_()
    (proi.roi_align_batched(f, t(rois)) * t(cot)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=tol)


def test_sgd_chain_matches_optax():
    """make_detector_optimizer + clip_by_global_norm_ against the JAX
    package's optax chain over three steps of a toy tree at float64: the
    clip fires on steps 1 and 3 and not on 2, the staircase decay applies
    from step 2 (decay_step 2). Rates exact in float32 (optax forms the
    decayed rate in float32): parameters to 1e-12."""
    r = np.random.RandomState(8)
    params = {"a": r.randn(3, 4), "b": r.randn(5)}
    grads = [{"a": s * r.randn(3, 4), "b": s * r.randn(5)}
             for s in (20.0, 0.5, 30.0)]
    tx = jtrainer.make_detector_optimizer(lr=0.125, decay_step=2,
                                          decay_factor=0.5)
    state = tx.init(params)
    jp = params
    ps = [torch.tensor(params[k], requires_grad=True) for k in ("a", "b")]
    opt, sched = make_detector_optimizer(ps, lr=0.125, decay_step=2,
                                         decay_factor=0.5)
    norms = []
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(ps, ("a", "b")):
            p.grad = torch.tensor(g[k])
        norms.append(float(clip_by_global_norm_([p.grad for p in ps], 10.0)))
        opt.step()
        sched.step()
        for p, k in zip(ps, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-12, atol=1e-12)
    assert norms[0] > 10 and norms[1] < 10 and norms[2] > 10
    assert opt.param_groups[0]["lr"] == 0.125 * 0.5


# ---------------------------------------------------- the whole detector


def randomized(variables, seed):
    """float64 JAX variables with random norm scales, biases and running
    statistics, so the weights bridge carries every kind of leaf."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x, np.float64)
        name = str(path[-1].key)
        if name == "var":
            return rs.uniform(0.5, 1.5, x.shape)
        if name == "scale":
            return rs.uniform(0.8, 1.2, x.shape)
        if name in ("mean", "bias"):
            return 0.05 * rs.randn(*x.shape)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def scale_heads(jmodel, jvars, blob):
    """Scale the RPN's and the detection head's class and box layers, as
    chip_smoke.py's scale_detector_heads does, to unit-spread logits and
    deltas of a trained detector's spread (0.2 for the RPN's): random
    weights saturate both softmaxes and clip every proposal to a sliver."""
    params = jax.tree_util.tree_map(np.array, jvars["params"])
    feats, cls, reg, _, props = jmodel.apply(
        jvars, jnp.asarray(blob), False,
        method=jfr.FasterRCNN._rpn_proposals)
    for name, out, want in (("rpn_cls", cls, 1.0), ("rpn_bbox", reg, 0.2)):
        for k in ("kernel", "bias"):
            params[name][k] *= want / float(np.std(np.asarray(out)))
    jvars = {"params": params, "batch_stats": jvars["batch_stats"]}
    logits, deltas = jmodel.apply(jvars, feats, props.rois, False,
                                  method=jfr.FasterRCNN._head_outputs)
    for name, out in (("cls_score", logits), ("bbox_pred", deltas)):
        for k in ("kernel", "bias"):
            params[name][k] *= 1.0 / float(np.std(np.asarray(out)))
    return {"params": params, "batch_stats": jvars["batch_stats"]}


@pytest.fixture(scope="module")
def detector_step():
    """One float64 train step of both packages from the same weights, blob,
    gt and draws: the JAX step with its proposals stop-gradiented, the JAX
    step as it is, and the port's. Returns what the tests compare."""
    fields = dict(TRAIN, compute_dtype="float64")
    jcfg = JaxDetectorConfig(**fields)
    jmodel = jfr.FasterRCNN(cfg=jcfg)
    jvars = randomized(jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3))), seed=3)
    images = np.random.RandomState(9).randint(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.uint8)
    blob = np.array(jhd.prepare_blob(jnp.asarray(images), jcfg)[0],
                    np.float64)
    jvars = scale_heads(jmodel, jvars, blob)
    rng = jax.random.PRNGKey(11)
    lr, wd = 0.01, 5e-4

    def jax_step(stop: bool):
        orig = jfr.proposal_layer

        def stopped(*a, **k):
            return jax.tree_util.tree_map(jax.lax.stop_gradient, orig(*a, **k))

        tx = jtrainer.make_detector_optimizer(lr=lr, weight_decay=wd)
        state = jtrainer.DetectorTrainState(
            step=jnp.zeros((), jnp.int32), params=jvars["params"],
            batch_stats=jvars["batch_stats"],
            opt_state=tx.init(jvars["params"]))
        jfr.proposal_layer = stopped if stop else orig
        try:
            new, metrics = jtrainer.make_detector_train_step(jmodel, tx)(
                state, jnp.asarray(blob), jnp.asarray(GT),
                jnp.asarray(GT_CLASSES), jnp.asarray(GT_VALID), rng)
        finally:
            jfr.proposal_layer = orig
        # the clipped gradient: the first step's update is -lr (g + wd p)
        g = jax.tree_util.tree_map(lambda n, o: -(n - o) / lr - wd * o,
                                   new.params, jvars["params"])
        step = jax.tree_util.tree_map(lambda n, o: n - o, new.params,
                                      jvars["params"])
        as_port = [detector_state_dict_from_jax(
            {"params": tree, "batch_stats": jvars["batch_stats"]}, jcfg)
            for tree in (g, step)]
        return {k: float(v) for k, v in metrics.items()}, *as_port

    # the key FasterRCNN.__call__ draws from: the first make_rng("sampling")
    # of the root module
    key = jmodel.apply(jvars, method=lambda m: m.make_rng("sampling"),
                       rngs={"sampling": rng})
    keys = jax.random.split(key, 4).reshape(2, 2, 2)
    fh = fw = SIZE // 16
    A = len(jcfg.anchor_scales) * len(jcfg.anchor_ratios)
    pri = SamplingPriorities(
        *jax_draws(keys[:, 0], fh * fw * A),
        *jax_draws(keys[:, 1], jcfg.rpn_post_nms_top_n_train + GT.shape[1]))

    model = FasterRCNN(DetectorConfig(**fields))
    model.load_state_dict(detector_state_dict_from_jax(jvars, jcfg))
    model = model.double()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = make_detector_optimizer(model.parameters(), lr=lr,
                                         weight_decay=wd)
    metrics = make_detector_train_step(model, opt, sched)(
        t(blob), t(GT), t(GT_CLASSES), t(GT_VALID), priorities=pri)
    port = ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach() - before[n] for n, p in model.named_parameters()})
    return {"stopped": jax_step(True), "jax": jax_step(False), "port": port}


def rel_dist(got, want) -> float:
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp(
        min=1e-300))


def test_training_forward_losses_match_jax(detector_step):
    """The four losses of the training forward against the unpatched JAX
    `FasterRCNN(train=True)` (the forward does not depend on where the
    gradient stops), at float64 convs with the float32 stages of both
    packages (proposals, ROIAlign, losses): 1e-5 relative. The RPN losses
    are not zero: anchors lie inside the image."""
    got, _, _ = detector_step["port"]
    want = detector_step["jax"][0]
    for name in ("rpn_cls", "rpn_reg", "det_cls", "det_reg", "loss"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   err_msg=name)
        assert want[name] > 0, name
    np.testing.assert_allclose(detector_step["stopped"][0]["loss"],
                               want["loss"], rtol=1e-12)


def test_sgd_step_matches_jax_with_stopped_proposals(detector_step):
    """One SGD step at float64 against the JAX step with its proposals
    stop-gradiented: every leaf's clipped gradient and parameter update to
    ||d|| <= 1e-4 ||want|| (the float32 stages of both packages differ in
    their last bits; at float32 convs, ReLU masks near zero would flip)."""
    _, grads, steps = detector_step["port"]
    _, jgrads, jsteps = detector_step["stopped"]
    assert set(grads) <= set(jgrads)
    for name in grads:
        assert rel_dist(grads[name], jgrads[name]) <= 1e-4, name
        assert rel_dist(steps[name], jsteps[name]) <= 1e-4, name


def test_unpatched_jax_gradient_differs_in_rpn_box_branch(detector_step):
    """The JAX package as it is sends gradient through the proposal boxes
    into the RPN's box branch (ROIAlign's sampling positions, the proposal
    targets' encode): there the port's gradient, equal to the
    stop-gradiented JAX one to 1e-4, differs from it by more than 1 %
    (by about its own size on this case, measured)."""
    _, grads, _ = detector_step["port"]
    _, jgrads, _ = detector_step["jax"]
    box = "RCNN_rpn.RPN_bbox_pred.weight"
    assert rel_dist(grads[box], jgrads[box]) > 1e-2
    _, stopped, _ = detector_step["stopped"]
    assert rel_dist(grads[box], stopped[box]) <= 1e-4
