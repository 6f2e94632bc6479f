"""The port's int8 post-training quantization (`quantize/ptq.py`) against
the JAX package's on the CPU, at float32: R18 pose nets at 64x64 and the
TINY R18 detector of tests/test_torch_detector.py.

Tolerances. The same int8 inputs and kernels give bitwise-equal int32
sums in both packages (integer products, exact at these contraction
sizes), and the epilogue is the same float32 operations in the same
order, so single layers on one bundle are held bitwise equal. The port
builds the same int8 kernels and weight scales bitwise (the same float32
division and round-half-to-even); its activation scales come from its own
float forward, whose convolutions sum in another order: they agree to
1e-5 relative (measured 1.4e-6). Whole nets on one bundle differ only
where such float noise in a layer's input moves a value across a rounding
midpoint: the int8 input of every layer is held to one quantum, in at
most 1 in 1000 of its entries; the outputs to 1e-4 of their largest
value, the float noise of the unquantized parts (BatchNorm, the final
projection, ROIAlign) plus the effect of such rare flips."""

import dataclasses
import importlib
import json
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hand_integral_pose_estimation_tpu.detect import hand_detector as jhd
from hand_integral_pose_estimation_tpu.detect.faster_rcnn import (
    FasterRCNN as JaxFasterRCNN,
)
from hand_integral_pose_estimation_tpu.distill import teacher_labels as jtl
from hand_integral_pose_estimation_tpu.ops.fused_head import (
    head_projection_integral as jax_head_projection_integral,
)
from hand_integral_pose_estimation_tpu.config import AugmentConfig as JAug
from hand_integral_pose_estimation_tpu_torch.config import (
    AugmentConfig,
    Config,
    DetectorConfig,
)
from hand_integral_pose_estimation_tpu_torch.detect import build_detector
from hand_integral_pose_estimation_tpu_torch.distill import (
    generate_filtered_labels,
    quantized_teacher_apply,
)
from hand_integral_pose_estimation_tpu_torch.inference import (
    TwoStagePipeline,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    quantized_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.quantize import (
    Quantized,
    calibrate,
    load_quantized,
    quantize_model,
    quantize_params,
    quantized_apply,
    quantized_calls,
    save_quantized,
    verify_source_params,
)
from hand_integral_pose_estimation_tpu_torch.quantize.ptq import (
    _quantize_act,
)
from test_torch_detector import TINY, carried, jax_detector, tiny_images
from test_torch_distill import _mixed, _t, twopass_jax  # noqa: F401
from test_torch_panet import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_pose_net import (
    port_model,
    randomized_jax_variables,
    small_config,
)

jptq = importlib.import_module(
    "hand_integral_pose_estimation_tpu.quantize.ptq")

ASCALE_REL = 1e-5
FLIP_SHARE = 1e-3
OUT_REL = 1e-4


def assert_rel_close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


# ------------------------------------------------------------ single layers

# (flax module, its port twin from the flax kernel, input (NHWC / N, C))
LAYERS = {
    "conv3x3_s2": (lambda: flax_nn.Conv(8, (3, 3), strides=(2, 2),
                                        padding=1, dtype=jnp.float32),
                   lambda k: nn.Conv2d(k.shape[2], k.shape[3], 3, 2, 1),
                   (2, 16, 16, 4)),
    "stem7x7": (lambda: flax_nn.Conv(16, (7, 7), strides=(2, 2), padding=3,
                                     use_bias=False, dtype=jnp.float32),
                lambda k: nn.Conv2d(3, k.shape[3], 7, 2, 3, bias=False),
                (2, 20, 20, 3)),
    "conv1x1": (lambda: flax_nn.Conv(12, (1, 1), use_bias=False,
                                     dtype=jnp.float32),
                lambda k: nn.Conv2d(k.shape[2], 12, 1, bias=False),
                (3, 5, 5, 16)),
    "deconv4x4_s2": (lambda: flax_nn.ConvTranspose(
        6, (4, 4), strides=(2, 2), padding="SAME", use_bias=False,
        dtype=jnp.float32),
        lambda k: nn.ConvTranspose2d(k.shape[2], 6, 4, 2, 1, bias=False),
        (2, 7, 9, 4)),
    "dense_n18": (lambda: flax_nn.Dense(18, dtype=jnp.float32),
                  lambda k: nn.Linear(k.shape[0], 18), (5, 40)),
}


def port_layer(name, params):
    """The port module with the flax module's weights (the layout rules of
    interop.jax_params) and the JAX bundle's int8 kernel in its layout."""
    k = np.asarray(params["kernel"])
    mod = LAYERS[name][1](k)

    def layout(a):
        a = np.asarray(a)
        if isinstance(mod, nn.Linear):
            return a.T
        if isinstance(mod, nn.ConvTranspose2d):
            return np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        return np.transpose(a, (3, 2, 0, 1))

    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(layout(k).copy()))
        if mod.bias is not None:
            mod.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    return mod, layout


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax_bitwise(name):
    """One layer on the JAX package's bundle carried across: the int8
    product and epilogue are bitwise JAX `_run_quantized`'s; the port's own
    bundle has its int8 kernel and weight scales bitwise, its activation
    scale to ASCALE_REL; and both are the float64 product of the same int8
    values times the scales (exact integer sums)."""
    make, _, shape = LAYERS[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(*shape).astype(np.float32)
    fmod = make()
    variables = jax.device_get(fmod.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x)))
    jq = jptq.quantize_model(fmod, variables, [jnp.asarray(x)])
    want = np.asarray(jptq.quantized_apply(fmod, variables, jq,
                                           jnp.asarray(x)))
    mod, layout = port_layer(name, variables["params"])
    xt = torch.from_numpy(x if x.ndim == 2 else x.transpose(0, 3, 1, 2))
    carried_q = Quantized(
        {"": torch.from_numpy(layout(jq.kernels[""]).copy())},
        {"": torch.from_numpy(np.array(jq.kscales[""]))},
        {"": jq.ascales[""]},
        {k: torch.from_numpy(np.array(v)) for k, v in jq.biases.items()})
    with torch.no_grad():
        got = quantized_apply(mod, carried_q, xt)
    got = got.numpy() if x.ndim == 2 else got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)

    own = quantize_model(mod, [xt])
    assert own.paths == ("",)
    assert torch.equal(own.kernels[""], carried_q.kernels[""])
    assert own.kernels[""].dtype == torch.int8
    assert torch.equal(own.kscales[""], carried_q.kscales[""])
    assert abs(own.ascales[""] / jq.ascales[""] - 1) <= ASCALE_REL
    # the float64 oracle: the same int8 values, exact sums, then the scales
    xq = _quantize_act(xt, own.ascales[""]).double()
    w = own.kernels[""].double()
    if isinstance(mod, nn.Linear):
        y, view = xq @ w.T, (1, -1)
    elif isinstance(mod, nn.ConvTranspose2d):
        y = torch.nn.functional.conv_transpose2d(xq, w, None, 2, 1)
        view = (1, -1, 1, 1)
    else:
        y = torch.nn.functional.conv2d(xq, w, None, mod.stride, mod.padding)
        view = (1, -1, 1, 1)
    scale = (own.kscales[""] * own.ascales[""]).view(view)
    oracle = y.float() * scale
    if mod.bias is not None:
        oracle = oracle + own.biases[""].view(view)
    with torch.no_grad():
        assert torch.equal(quantized_apply(mod, own, xt), oracle)


# ------------------------------------------------------- whole nets vs JAX

def int8_inputs_jax(jq, to_port, run):
    """The int8 input of every quantized layer of the JAX run `run()`
    (NHWC), keyed by port name."""
    seen = {}

    def recorder(next_fn, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, jptq._QUANT_TYPES)
                and context.method_name == "__call__"):
            p = jptq._path_str(mod)
            if p in jq.kernels:
                seen.setdefault(to_port(p), []).append(np.asarray(
                    jptq._quantize_act(args[0], jq.ascales[p])))
        return next_fn(*args, **kwargs)

    with flax_nn.intercept_methods(recorder), jptq.quantized_calls(jq):
        out = run()
    return seen, out


def int8_inputs_port(model, q, run):
    """The same for the port's run `run()` (NCHW inputs made NHWC)."""
    seen = {}
    mods = dict(model.named_modules())

    def hook(name):
        def record(mod, args):
            x = _quantize_act(args[0], q.ascales[name])
            if x.ndim == 4:
                x = x.permute(0, 2, 3, 1)
            seen.setdefault(name, []).append(x.numpy())
        return record

    handles = [mods[n].register_forward_pre_hook(hook(n)) for n in q.paths]
    try:
        with torch.no_grad(), quantized_calls(q, model):
            out = run()
    finally:
        for h in handles:
            h.remove()
    return seen, out


def assert_within_one_quantum(got, want):
    assert set(got) == set(want)
    for name in want:
        a = np.concatenate([v.reshape(-1) for v in got[name]]).astype(int)
        b = np.concatenate([v.reshape(-1) for v in want[name]]).astype(int)
        d = np.abs(a - b)
        assert d.max() <= 1, (name, d.max())
        assert (d > 0).mean() <= FLIP_SHARE, (name, (d > 0).mean())


@pytest.fixture(scope="module")
def pose_bundles():
    """An R18 pose net (random weights and BatchNorm statistics) in both
    packages, the JAX bundle calibrated on its full forward with the
    heatmap projection skipped, carried across, and the port's own."""
    cfg = small_config(18)
    jnet, jvars = randomized_jax_variables(cfg, seed=5, final_scale=0.05)
    model = port_model(cfg, jvars)
    imgs = (np.random.RandomState(0).rand(4, 64, 64, 3).astype(np.float32)
            - 0.5) * 4.0
    jq = jptq.quantize_model(jnet, jvars, [jnp.asarray(imgs)],
                             skip=("head/final",),
                             apply_kwargs={"train": False})
    own = quantize_model(model, [torch.from_numpy(imgs)],
                         skip=("head.final_layer",))
    carried_q = quantized_from_jax(jq, model)
    return cfg, jnet, jvars, model, imgs, jq, carried_q, own


def test_pose_bundle_matches_jax(pose_bundles):
    """The port's bundle of the pose net: the same modules (every simple
    conv and transposed conv; `head.final_layer` skipped), int8 kernels
    and weight scales bitwise the JAX package's, activation scales to
    ASCALE_REL, the same digest as the carried bundle."""
    cfg, jnet, jvars, model, imgs, jq, carried_q, own = pose_bundles
    convs = {n for n, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))}
    assert set(own.paths) | set(own.skipped) == convs
    assert own.skipped == ("head.final_layer",) == carried_q.skipped
    assert any(p.startswith("head.deconv_layers") for p in own.paths)
    assert sorted(own.paths) == sorted(carried_q.paths)
    for p in own.paths:
        assert own.kernels[p].dtype == torch.int8
        assert torch.equal(own.kernels[p], carried_q.kernels[p]), p
        assert torch.equal(own.kscales[p], carried_q.kscales[p]), p
        assert abs(own.ascales[p] / carried_q.ascales[p] - 1) <= ASCALE_REL
    assert own.params_digest == carried_q.params_digest
    assert own.root_type is type(model)


def test_pose_net_int8_matches_jax(pose_bundles):
    """The int8 pose net on the JAX bundle in both packages: every layer's
    int8 input within one quantum (in at most FLIP_SHARE of its entries),
    the heatmap to OUT_REL of its largest value, and the int8 net really
    differs from the float one."""
    cfg, jnet, jvars, model, imgs, jq, carried_q, _ = pose_bundles
    want_in, want = int8_inputs_jax(
        jq, lambda p: jptq_to_port(p, model),
        lambda: jnet.apply(jvars, jnp.asarray(imgs), train=False))
    got_in, got = int8_inputs_port(model, carried_q,
                                   lambda: model(torch.from_numpy(imgs)))
    assert_within_one_quantum(got_in, want_in)
    assert_rel_close(got.numpy(), want, OUT_REL, "heatmap")
    with torch.no_grad():
        fp = model(torch.from_numpy(imgs)).numpy()
    assert np.abs(fp - got.numpy()).max() > 1e3 * np.abs(
        got.numpy() - np.asarray(want)).max()


def jptq_to_port(path, model):
    from hand_integral_pose_estimation_tpu_torch.interop.jax_params import (
        _module_from_jax,
    )
    return _module_from_jax(path, model)[0]


@pytest.fixture(scope="module")
def detector_bundles():
    jcfg, jmodel, jvars = jax_detector(TINY, 64, seed=3)
    model = carried(jcfg, jvars)
    blob = np.array(jhd.prepare_blob(jnp.asarray(tiny_images()), jcfg)[0])
    jq = jptq.quantize_model(jmodel, jvars, [jnp.asarray(blob)],
                             apply_kwargs={"train": False})
    own = quantize_model(model, [torch.from_numpy(blob)])
    return jcfg, jmodel, jvars, model, blob, jq, quantized_from_jax(
        jq, model), own


def test_detector_bundle_matches_jax(detector_bundles):
    """The detector's bundle: every conv and Linear of the base, the tail,
    the RPN and the heads, int8 kernels and weight scales bitwise the JAX
    package's (the RPN class conv's channels permuted into the reference's
    order with their scales and biases), activation scales to
    ASCALE_REL."""
    jcfg, jmodel, jvars, model, blob, jq, carried_q, own = detector_bundles
    layers = {n for n, m in model.named_modules()
              if isinstance(m, (nn.Conv2d, nn.Linear))}
    assert set(own.paths) == layers and not own.skipped
    assert sorted(own.paths) == sorted(carried_q.paths)
    for p in own.paths:
        assert torch.equal(own.kernels[p], carried_q.kernels[p]), p
        assert torch.equal(own.kscales[p], carried_q.kscales[p]), p
        assert abs(own.ascales[p] / carried_q.ascales[p] - 1) <= ASCALE_REL
        if p in own.biases:
            assert torch.equal(own.biases[p], carried_q.biases[p]), p
    assert "RCNN_rpn.RPN_cls_score" in own.biases


def test_detector_int8_matches_jax(detector_bundles):
    """The int8 detector on the JAX bundle: upstream (features, RPN maps)
    and the downstream on the JAX int8 upstream's features and RoIs; every
    layer's int8 input within one quantum, class probabilities and deltas
    and the RPN maps to OUT_REL of their largest."""
    jcfg, jmodel, jvars, model, blob, jq, carried_q, _ = detector_bundles
    to_port = lambda p: jptq_to_port(p, model)          # noqa: E731
    want_in, (fj, cls_j, reg_j, _, _) = int8_inputs_jax(
        jq, to_port, lambda: jmodel.apply(
            jvars, jnp.asarray(blob), False,
            method=JaxFasterRCNN._rpn_proposals))
    got_in, (f, cls, reg) = int8_inputs_port(
        model, carried_q, lambda: (lambda f: (f, *model.RCNN_rpn(f)))(
            model.RCNN_base(torch.from_numpy(blob).permute(0, 3, 1, 2))))
    assert_within_one_quantum(got_in, want_in)
    B, H, W = cls_j.shape[:3]
    assert_rel_close(f.permute(0, 2, 3, 1).numpy(), fj, OUT_REL, "feats")
    assert_rel_close(cls.permute(0, 2, 3, 1).numpy(), np.moveaxis(
        np.asarray(cls_j), -1, -2).reshape(B, H, W, -1), OUT_REL, "cls")
    assert_rel_close(reg.permute(0, 2, 3, 1).numpy(),
                     np.asarray(reg_j).reshape(B, H, W, -1), OUT_REL, "reg")

    with jptq.quantized_calls(jq):
        feats, rois, valid = jmodel.apply(jvars, jnp.asarray(blob),
                                          method=JaxFasterRCNN.upstream)
    want_in, want = int8_inputs_jax(jq, to_port, lambda: jmodel.apply(
        jvars, feats, rois, valid, method=JaxFasterRCNN.downstream))
    got_in, got = int8_inputs_port(model, carried_q, lambda: model.downstream(
        *(torch.from_numpy(np.array(a)) for a in (feats, rois, valid))))
    assert_within_one_quantum(got_in, want_in)
    assert_rel_close(got.cls_scores, want.cls_scores, OUT_REL, "scores")
    assert_rel_close(got.bbox_deltas, want.bbox_deltas, OUT_REL, "deltas")


# -------------------------------------------------------- bundle handling

def test_calibration_filters():
    """Modules whose input amax is 0, names under a skipped prefix and
    names that are no quantizable module are skipped; a grouped or dilated
    conv is never calibrated (the `_is_simple` filter); keys come sorted."""
    model = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1),
                          nn.Conv2d(4, 4, 3, padding=2, dilation=2),
                          nn.Conv2d(4, 4, 3, padding=1, groups=2),
                          nn.Conv2d(4, 4, 1))
    x = torch.randn(2, 3, 8, 8)
    amax = calibrate(model, x, model=model)
    assert sorted(amax) == ["0", "3"]
    q = quantize_params(model, {"3": 1.0, "0": 2.0, "9": 1.0, "x.y": 3.0})
    assert q.paths == ("0", "3")
    assert q.skipped == ("9", "x.y")
    q = quantize_params(model, {"0": 0.0, "3": 1.0}, skip=("3",))
    assert q.paths == () and q.skipped == ("0", "3")
    assert all(isinstance(v, float) for v in amax.values())


def test_bundle_round_trip_and_refusals(pose_bundles, tmp_path):
    """save/load is exact and replays bitwise; the wrong root type, a
    stale bundle (other weights: the digest) and the JAX package's bundle
    applied raw (flax paths name no module of the port's net) raise; the
    model's forwards are restored after the block."""
    cfg, jnet, jvars, model, imgs, jq, carried_q, own = pose_bundles
    path = str(tmp_path / "q.npz")
    save_quantized(path, own)
    back = load_quantized(path, root_type=type(model))
    assert back.paths == own.paths and back.skipped == own.skipped
    assert back.ascales == own.ascales
    assert back.params_digest == own.params_digest
    for p in own.paths:
        assert back.kernels[p].dtype == torch.int8
        assert torch.equal(back.kernels[p], own.kernels[p])
        assert torch.equal(back.kscales[p], own.kscales[p])
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        assert torch.equal(quantized_apply(model, own, x),
                           quantized_apply(model, back, x))
    with pytest.raises(ValueError, match="root type"):
        load_quantized(path, root_type=nn.Linear)
    verify_source_params(back, model)
    stale = get_pose_net(cfg, torch.Generator().manual_seed(9))
    with pytest.raises(ValueError, match="different checkpoint"):
        verify_source_params(back, stale)
    jpath = str(tmp_path / "jax.npz")
    jptq.save_quantized(jpath, jq)
    raw = load_quantized(jpath, root_type=type(model))     # same layout
    assert set(raw.paths) == set(jq.kernels)
    with pytest.raises(ValueError, match="does not have"):
        quantized_calls(raw, model)
    assert all("forward" not in m.__dict__ for m in model.modules())


# ------------------------------------------------- pipeline, teacher, CLIs

@pytest.fixture(scope="module")
def pipeline_parts():
    cfg = Config(model=small_config(18), detector=DetectorConfig(**TINY))
    pose = get_pose_net(cfg.model, torch.Generator().manual_seed(1))
    det = build_detector(cfg.detector, generator=torch.Generator()
                         .manual_seed(2))
    images = tiny_images(B=4)
    K = np.broadcast_to(np.array([[100.0, 0, 32], [0, 100.0, 32],
                                  [0, 0, 1.0]], np.float32), (4, 3, 3)).copy()
    ref = np.ones(4, np.float32)
    return cfg, pose, det, images, K, ref


def test_two_stage_pipeline_int8(pipeline_parts, tmp_path):
    """`TwoStagePipeline(int8_calib=...)` calibrates both nets through
    itself: every simple conv and Linear of each is quantized but the
    heatmap projection; the int8 outputs are finite and differ from the
    float ones; reloaded bundles reproduce them bitwise; swapped or
    unlabelled bundles, a stale bundle and split_detector raise."""
    cfg, pose, det, images, K, ref = pipeline_parts
    pipe = TwoStagePipeline(cfg, pose, det, device="cpu",
                            int8_calib=(images, K, ref))
    q_pose, q_det = pipe.quantized
    convs = {n for n, m in pose.named_modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))}
    assert set(q_pose.paths) == convs - {"head.final_layer"}
    assert set(q_det.paths) == {n for n, m in det.named_modules()
                                if isinstance(m, (nn.Conv2d, nn.Linear))}
    assert (q_pose.root_type, q_det.root_type) == (type(pose), type(det))
    out = pipe(images, K, ref)
    fp = TwoStagePipeline(cfg, pose, det, device="cpu")(images, K, ref)
    assert torch.isfinite(out.joints_cam).all()
    assert (out.crop_bbox[:, 2:] > 0).all()
    assert (out.coords_label - fp.coords_label).abs().max() > 0
    fp_q, fd_q = str(tmp_path / "p.npz"), str(tmp_path / "d.npz")
    save_quantized(fp_q, q_pose)
    save_quantized(fd_q, q_det)
    loaded = (load_quantized(fp_q, type(pose)), load_quantized(fd_q,
                                                              type(det)))
    again = TwoStagePipeline(cfg, pose, det, device="cpu",
                             int8_calib=loaded)(images, K, ref)
    for a, b in zip(again, out):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="q_pose, q_det"):
        TwoStagePipeline(cfg, pose, det, device="cpu",
                         int8_calib=loaded[::-1])
    with pytest.raises(ValueError, match="root_type"):
        TwoStagePipeline(cfg, pose, det, device="cpu", int8_calib=(
            dataclasses.replace(loaded[0], root_type=None), loaded[1]))
    stale = get_pose_net(cfg.model, torch.Generator().manual_seed(5))
    with pytest.raises(ValueError, match="different checkpoint"):
        TwoStagePipeline(cfg, stale, det, device="cpu", int8_calib=loaded)
    with pytest.raises(ValueError, match="split_detector"):
        TwoStagePipeline(cfg, pose, det, device="cpu", split_detector=True,
                         int8_calib=loaded)


def test_int8_teacher_keep_set_matches_jax(twopass_jax):
    """`quantized_teacher_apply` with the R18 teacher at a 64² patch,
    calibrated on 3 of 5 rotations of 4 rows, against the JAX package's
    with the same weights and its fused decode: the same int8 kernels, and
    the filter keeps the same rows at a threshold between the middle
    variances (no variance within 1 % of it)."""
    cfg = small_config(18)
    net, variables = randomized_jax_variables(cfg, seed=3, final_scale=1e-3)
    J, D = cfg.num_joints, cfg.depth_dim

    def jax_forward(patches):
        feats = net.apply(variables, patches, train=False,
                          return_features=True)
        Wp, bp = net.final_projection(variables["params"])
        return jax_head_projection_integral(feats, Wp, bp, J, D)

    model = port_model(cfg, variables)
    imgs, K, bbox, joints = _mixed(4, hw=128)
    bbox[:, 2:] = 60.0
    K, bbox = K.astype(np.float32), bbox.astype(np.float32)
    kw = dict(num_rotations=5, patch_hw=(64, 64), calib_rotations=3)
    jteacher, jq = jtl.quantized_teacher_apply(
        net, variables, jnp.asarray(imgs), jnp.asarray(K), jnp.asarray(bbox),
        JAug(), J, D, forward=jax_forward, **kw)
    timgs, tK, tbox, tlab, tjoints = _t(imgs, K, bbox, np.zeros(4, bool),
                                        joints)
    teacher, q = quantized_teacher_apply(model, timgs, tK, tbox,
                                         AugmentConfig(), J, D, **kw)
    carried_q = quantized_from_jax(jq, model)
    assert sorted(q.paths) == sorted(carried_q.paths) and q.paths
    assert "head.final_layer" not in q.paths
    for p in q.paths:
        assert torch.equal(q.kernels[p], carried_q.kernels[p]), p
        assert abs(q.ascales[p] / carried_q.ascales[p] - 1) <= ASCALE_REL
    sweep = dict(num_rotations=5, patch_hw=(64, 64))
    want = jtl.generate_filtered_labels(
        jax.jit(jteacher), jnp.asarray(imgs), jnp.asarray(K),
        jnp.asarray(bbox), jnp.zeros(4, bool), jnp.asarray(joints), JAug(),
        **sweep)
    with torch.no_grad():
        got = generate_filtered_labels(teacher, timgs, tK, tbox, tlab,
                                       tjoints, AugmentConfig(), **sweep)
    v = np.sort(np.asarray(want.variance))
    thr = float(np.sqrt(v[1] * v[2]))
    for var in (np.asarray(want.variance), got.variance.numpy()):
        assert np.abs(var / thr - 1).min() > 1e-2
    np.testing.assert_array_equal(got.variance.numpy() < thr,
                                  np.asarray(want.variance) < thr)
    assert 0 < (got.variance.numpy() < thr).sum() < 4


def test_int8_clis(tmp_path, capsys):
    """`cli.evaluate --use-detector --int8 --int8-db` writes both bundles,
    then reads them back for a bitwise-equal pred.json; `--int8` without
    the detector exits with the JAX CLI's message; `cli.generate_teacher_
    labels --teacher-dtype int8` writes its db."""
    from hand_integral_pose_estimation_tpu_torch.cli import evaluate
    from hand_integral_pose_estimation_tpu_torch.cli import (
        generate_teacher_labels as gen,
    )

    sizing = ["--synthetic", "--synthetic-size", "5", "--batch-size", "2",
              "--detector-resnet", "18", "--detector-scale", "64",
              "--detector-proposals", "16", "--pose-resnet", "18",
              "--pose-input", "64", "--device", "cpu", "--model-dir",
              str(tmp_path / "none")]
    prefix = str(tmp_path / "int8")
    preds = []
    for run in range(2):
        res = str(tmp_path / f"res{run}")
        evaluate.main([*sizing, "--use-detector", "--int8", "--int8-db",
                       prefix, "--result-dir", res])
        out = capsys.readouterr().out
        assert ("wrote the bundles" if run == 0 else
                "loaded the bundles") in out, out
        with open(os.path.join(res, "pred.json")) as f:
            preds.append(json.load(f))
    assert os.path.exists(prefix + ".pose.npz")
    assert os.path.exists(prefix + ".det.npz")
    assert preds[0] == preds[1]
    with pytest.raises(SystemExit, match="two-stage detector"):
        evaluate.main([*sizing, "--int8"])
    db = gen.main(["--synthetic", "--synthetic-size", "3", "--batch-size",
                   "2", "--pose-resnet", "18", "--pose-input", "64",
                   "--device", "cpu", "--teacher-dtype", "int8",
                   "--model-dir", str(tmp_path / "none"),
                   "--out", str(tmp_path / "db.npz")])
    assert "int8 teacher" in capsys.readouterr().out
    assert db["keep"].shape == (3,) and np.isfinite(db["variance"]).all()
