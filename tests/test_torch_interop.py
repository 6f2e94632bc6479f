"""Torch-oracle tests for the .pth converters (interop/torch_weights.py).

The torch modules below are standalone re-statements of the standard
public ResNet / faster-rcnn layouts, written here so the tests run without
torchvision — with the exact state-dict KEY NAMES the converters target:
torchvision naming for the pose backbone (common/nets/resnet.py uses
torchvision blocks) and the jwyang RCNN_base/RCNN_top/RCNN_rpn layout for
the detector (lib/model_rcnn/faster_rcnn/resnet.py:229-288).  All weights
are random — the oracle is forward-output agreement, not stored files.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

torch = pytest.importorskip("torch")
import torch.nn as tnn  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hand_integral_pose_estimation_tpu.interop import (  # noqa: E402
    convert_faster_rcnn_state_dict,
    convert_resnet_stage4,
    convert_torchvision_resnet,
    imagenet_init_pose_variables,
    load_torch_state_dict,
)
from hand_integral_pose_estimation_tpu.models.resnet import (  # noqa: E402
    RESNET_SPECS,
    ResNetBackbone,
    ResNetStage4,
)


# ---------------------------------------------------------------- torch side
class _TBasic(tnn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = self.bn1(self.conv1(x)).relu()
        y = self.bn2(self.conv2(y))
        return (y + r).relu()


class _TBottleneck(tnn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=None, caffe=False):
        super().__init__()
        # caffe style strides the 1x1; torchvision strides the 3x3
        s1, s3 = (stride, 1) if caffe else (1, stride)
        self.conv1 = tnn.Conv2d(cin, planes, 1, s1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, s3, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(4 * planes)
        self.downsample = downsample

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = self.bn1(self.conv1(x)).relu()
        y = self.bn2(self.conv2(y)).relu()
        y = self.bn3(self.conv3(y))
        return (y + r).relu()


def _make_layer(block, cin, planes, blocks, stride=1, **kw):
    exp = block.expansion
    down = None
    if stride != 1 or cin != planes * exp:
        down = tnn.Sequential(
            tnn.Conv2d(cin, planes * exp, 1, stride, bias=False),
            tnn.BatchNorm2d(planes * exp))
    layers = [block(cin, planes, stride, down, **kw)]
    for _ in range(1, blocks):
        layers.append(block(planes * exp, planes, **kw))
    return tnn.Sequential(*layers), planes * exp


class TorchResNet(tnn.Module):
    """torchvision-naming trunk (conv1/bn1/layer1-4); `caffe=True` switches
    to the detector's variant: strided 1x1 bottleneck conv + ceil-mode
    padding-0 stem pool (faster_rcnn/resnet.py:67-80, 115)."""

    def __init__(self, resnet_type, num_stages=4, caffe=False):
        super().__init__()
        block_name, layers = RESNET_SPECS[resnet_type]
        block = _TBasic if block_name == "basic" else _TBottleneck
        kw = {"caffe": caffe} if block is _TBottleneck else {}
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.maxpool = (tnn.MaxPool2d(3, 2, 0, ceil_mode=True) if caffe
                        else tnn.MaxPool2d(3, 2, 1))
        c = 64
        for i, (planes, stride) in enumerate(
                list(zip((64, 128, 256, 512), (1, 2, 2, 2)))[:num_stages]):
            layer, c = _make_layer(block, c, planes, layers[i], stride, **kw)
            setattr(self, f"layer{i + 1}", layer)
        self.num_stages = num_stages

    def forward(self, x):
        x = self.maxpool(self.bn1(self.conv1(x)).relu())
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


def _randomize(model: tnn.Module, seed: int):
    """Random weights AND random BN running stats, so conversion of the
    statistics (not just params) is exercised."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (tnn.Conv2d, tnn.Linear)):
                m.weight.normal_(0, 0.05, generator=g)
                if m.bias is not None:
                    m.bias.normal_(0, 0.05, generator=g)
            elif isinstance(m, tnn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    model.eval()


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.transpose(x_nhwc, (0, 3, 1, 2)).copy())


def _to_nhwc(y: torch.Tensor) -> np.ndarray:
    return np.transpose(y.detach().numpy(), (0, 2, 3, 1))


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("rtype", [18, 50])
def test_torchvision_resnet_oracle(rtype):
    """Converted random torch weights reproduce the torch forward through
    the full NHWC flax backbone (common/nets/resnet.py:70-76 ingestion)."""
    tm = TorchResNet(rtype)
    _randomize(tm, seed=rtype)
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        ref = _to_nhwc(tm(_nchw(x)))

    variables = convert_torchvision_resnet(tm.state_dict(), rtype)
    fm = ResNetBackbone(resnet_type=rtype)
    out = fm.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-3, atol=1e-2)


def test_fc_keys_ignored():
    """Model-zoo dicts carry fc.weight/bias; the reference pops them
    (resnet.py:72-74) — the converter must tolerate them."""
    tm = TorchResNet(18)
    _randomize(tm, seed=3)
    sd = dict(tm.state_dict())
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    convert_torchvision_resnet(sd, 18)  # no raise


def test_wrong_arch_fails_attributably():
    tm = TorchResNet(18)
    _randomize(tm, seed=4)
    with pytest.raises((KeyError, ValueError)):
        convert_torchvision_resnet(tm.state_dict(), 50)


def test_caffe_style_base_and_stage4_oracle():
    """The detector split: caffe-style layer1-3 base (incl. the ceil-mode
    stem pool emulation) + layer4 tail, vs one torch R50 caffe model."""
    tm = TorchResNet(50, num_stages=4, caffe=True)
    _randomize(tm, seed=7)
    x = np.random.default_rng(1).normal(size=(1, 75, 75, 3)) \
        .astype(np.float32)  # odd size exercises the ceil-mode alignment
    with torch.no_grad():
        h = tm.maxpool(tm.bn1(tm.conv1(_nchw(x))).relu())
        for i in range(3):
            h = getattr(tm, f"layer{i + 1}")(h)
        base_ref = _to_nhwc(h)
        tail_ref = _to_nhwc(tm.layer4(h))

    sd = tm.state_dict()
    base_vars = convert_torchvision_resnet(sd, 50, num_stages=3)
    base = ResNetBackbone(resnet_type=50, num_stages=3, style="caffe")
    base_out = base.apply(base_vars, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(base_out), base_ref,
                               rtol=2e-3, atol=1e-2)

    tail_vars = convert_resnet_stage4(sd, 50)
    tail = ResNetStage4(resnet_type=50, style="caffe")
    tail_out = tail.apply(tail_vars, jnp.asarray(base_ref), train=False)
    np.testing.assert_allclose(np.asarray(tail_out), tail_ref,
                               rtol=2e-3, atol=1e-2)


class TorchFasterRCNN(tnn.Module):
    """jwyang-layout detector skeleton: the state-dict surface of
    lib/model_rcnn (RCNN_base Sequential indices 0-6, RCNN_top,
    RCNN_rpn.RPN_*, head linears) over a caffe-style trunk."""

    def __init__(self, rtype=50, num_anchors=12, num_classes=2):
        super().__init__()
        r = TorchResNet(rtype, num_stages=4, caffe=True)
        self.RCNN_base = tnn.Sequential(
            r.conv1, r.bn1, tnn.ReLU(inplace=True), r.maxpool,
            r.layer1, r.layer2, r.layer3)
        self.RCNN_top = tnn.Sequential(r.layer4)
        din = 1024 if RESNET_SPECS[rtype][0] == "bottleneck" else 256
        ch = 2048 if RESNET_SPECS[rtype][0] == "bottleneck" else 512

        class _RPN(tnn.Module):
            def __init__(self):
                super().__init__()
                self.RPN_Conv = tnn.Conv2d(din, 512, 3, 1, 1, bias=True)
                self.RPN_cls_score = tnn.Conv2d(512, 2 * num_anchors, 1)
                self.RPN_bbox_pred = tnn.Conv2d(512, 4 * num_anchors, 1)

        self.RCNN_rpn = _RPN()
        self.RCNN_cls_score = tnn.Linear(ch, num_classes)
        self.RCNN_bbox_pred = tnn.Linear(ch, 4 * num_classes)
        self.A = num_anchors

    def score_maps(self, x):
        """base feats, fg prob map, bbox delta map — through the torch
        [bg x A, fg x A] channel convention (rpn.py:63-76)."""
        feats = self.RCNN_base(x)
        t = self.RCNN_rpn.RPN_Conv(feats).relu()
        cls = self.RCNN_rpn.RPN_cls_score(t)       # (B, 2A, H, W)
        B, _, H, W = cls.shape
        prob = torch.softmax(cls.view(B, 2, self.A * H, W), dim=1) \
            .view(B, 2 * self.A, H, W)
        fg = prob[:, self.A:]                      # last A channels = fg
        reg = self.RCNN_rpn.RPN_bbox_pred(t)       # (B, 4A, H, W), A-major
        return feats, fg, reg

    def head(self, pooled):
        """pooled (N, C, 7, 7) -> logits + deltas (_head_to_tail +
        linears, faster_rcnn/resnet.py:285-288)."""
        fc7 = self.RCNN_top(pooled).mean(3).mean(2)
        return self.RCNN_cls_score(fc7), self.RCNN_bbox_pred(fc7)


def test_faster_rcnn_checkpoint_oracle(tmp_path):
    """End-to-end: save a random torch detector the reference's way
    ({'model': state_dict} .pth), load + convert, and match every head's
    forward — base features, RPN fg-prob / delta maps (incl. the
    [bg*A, fg*A] -> (A, 2) channel permutation), and the
    tail+cls_score/bbox_pred pooled-feature head."""
    from hand_integral_pose_estimation_tpu.config import DetectorConfig
    import flax.linen as fnn

    torch.manual_seed(0)
    tm = TorchFasterRCNN(rtype=50)
    _randomize(tm, seed=11)
    path = str(tmp_path / "faster_rcnn_1_8_132028.pth")
    torch.save({"model": tm.state_dict(), "pooling_mode": "align"}, path)

    cfg = DetectorConfig(resnet_type=50, resnet_style="caffe")
    sd = load_torch_state_dict(path)
    variables = convert_faster_rcnn_state_dict(sd, cfg)

    x = np.random.default_rng(2).normal(size=(1, 96, 96, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        feats_ref, fg_ref, reg_ref = tm.score_maps(_nchw(x))

    A = 12
    base = ResNetBackbone(resnet_type=50, num_stages=3, style="caffe")
    feats = base.apply({"params": variables["params"]["base"],
                        "batch_stats": variables["batch_stats"]["base"]},
                       jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(feats), _to_nhwc(feats_ref),
                               rtol=2e-3, atol=1e-2)

    trunk = fnn.relu(fnn.Conv(512, (3, 3), padding=1).apply(
        {"params": variables["params"]["rpn_conv"]}, feats))
    cls = fnn.Conv(2 * A, (1, 1)).apply(
        {"params": variables["params"]["rpn_cls"]}, trunk)
    H, W = cls.shape[1], cls.shape[2]
    fg = jax.nn.softmax(cls.reshape(1, H, W, A, 2), axis=-1)[..., 1]
    fg_ref_nhwc = _to_nhwc(fg_ref)  # (1, H, W, A)
    np.testing.assert_allclose(np.asarray(fg), fg_ref_nhwc,
                               rtol=1e-3, atol=1e-5)
    reg = fnn.Conv(4 * A, (1, 1)).apply(
        {"params": variables["params"]["rpn_bbox"]}, trunk)
    np.testing.assert_allclose(np.asarray(reg), _to_nhwc(reg_ref),
                               rtol=2e-3, atol=1e-2)

    pooled = np.random.default_rng(3).normal(size=(4, 7, 7, 1024)) \
        .astype(np.float32)
    with torch.no_grad():
        logit_ref, delta_ref = tm.head(_nchw(pooled))
    tail = ResNetStage4(resnet_type=50, style="caffe")
    h = tail.apply({"params": variables["params"]["tail"],
                    "batch_stats": variables["batch_stats"]["tail"]},
                   jnp.asarray(pooled), train=False).mean(axis=(1, 2))
    logits = h @ variables["params"]["cls_score"]["kernel"] \
        + variables["params"]["cls_score"]["bias"]
    deltas = h @ variables["params"]["bbox_pred"]["kernel"] \
        + variables["params"]["bbox_pred"]["bias"]
    np.testing.assert_allclose(np.asarray(logits), logit_ref.numpy(),
                               rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(np.asarray(deltas), delta_ref.numpy(),
                               rtol=2e-3, atol=1e-2)

    # the converted tree drops straight into the full FasterRCNN module
    from hand_integral_pose_estimation_tpu.detect.faster_rcnn import (
        FasterRCNN,
    )
    out = FasterRCNN(cfg=cfg).apply(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]},
        jnp.asarray(np.broadcast_to(x, (1, 96, 96, 3))), train=False)
    assert np.isfinite(np.asarray(out.cls_scores)).all()


def test_style_mismatch_refused():
    from hand_integral_pose_estimation_tpu.config import DetectorConfig
    with pytest.raises(ValueError, match="caffe"):
        convert_faster_rcnn_state_dict(
            {}, DetectorConfig(resnet_type=50))


def test_imagenet_init_pose_variables():
    """--imagenet-init semantics: backbone overwritten, head untouched
    (common/nets/resnet.py:70-76 — only the trunk gets zoo weights)."""
    from hand_integral_pose_estimation_tpu.config import ModelConfig
    from hand_integral_pose_estimation_tpu.models.pose_net import (
        get_pose_net,
    )

    cfg = ModelConfig(resnet_type=18, input_shape=(64, 64),
                      output_shape=(16, 16), depth_dim=16,
                      compute_dtype="float32")
    net = get_pose_net(cfg)
    variables = net.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3)), train=False)
    variables = {"params": variables["params"],
                 "batch_stats": variables["batch_stats"]}

    tm = TorchResNet(18)
    _randomize(tm, seed=5)
    new_vars = imagenet_init_pose_variables(variables, tm.state_dict(), 18)

    # head untouched, backbone replaced
    h0 = jax.tree_util.tree_leaves(variables["params"]["head"])
    h1 = jax.tree_util.tree_leaves(new_vars["params"]["head"])
    assert all(np.array_equal(a, b) for a, b in zip(h0, h1))
    x = np.random.default_rng(4).normal(size=(1, 64, 64, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        ref = _to_nhwc(tm(_nchw(x)))
    bb = ResNetBackbone(resnet_type=18)
    out = bb.apply({"params": new_vars["params"]["backbone"],
                    "batch_stats": new_vars["batch_stats"]["backbone"]},
                   jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-3, atol=1e-2)

    with pytest.raises(ValueError, match="resnet"):
        imagenet_init_pose_variables(variables, TorchResNet(50).state_dict(),
                                     50)


class TorchHeadNet(tnn.Module):
    """Reference HeadNet (main/model.py:5-44): 3x [ConvTranspose2d(4, s2,
    p1, no bias) + BN + ReLU] + 1x1 final conv — with the snapshot's exact
    key names (head.deconv_layers.{0,3,6}.weight etc.)."""

    def __init__(self, cin, joint_num, depth_dim, channels=256):
        super().__init__()
        layers = []
        for _ in range(3):
            layers += [tnn.ConvTranspose2d(cin, channels, 4, 2, 1,
                                           bias=False),
                       tnn.BatchNorm2d(channels), tnn.ReLU(inplace=True)]
            cin = channels
        self.deconv_layers = tnn.Sequential(*layers)
        self.final_layer = tnn.Conv2d(channels, joint_num * depth_dim, 1)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class TorchResPoseNet(tnn.Module):
    """Reference ResPoseNet (main/model.py:58-66): backbone + head, the
    module whose state_dict() the reference snapshots."""

    def __init__(self, resnet_type, joint_num=21, depth_dim=16):
        super().__init__()
        self.backbone = TorchResNet(resnet_type)
        cin = 2048 if resnet_type >= 50 else 512
        self.head = TorchHeadNet(cin, joint_num, depth_dim)

    def forward(self, x):
        return self.head(self.backbone(x))


@pytest.mark.parametrize("wrap_module_prefix", [False, True])
def test_pose_snapshot_oracle(wrap_module_prefix):
    """convert_pose_snapshot: a full reference ResPoseNet snapshot
    (backbone + deconv head + final layer, optionally with DataParallel's
    'module.' prefix) reproduces the torch forward heatmap through our
    ResPoseNet — the converter that lets a trained reference snapshot_*.pth
    drop into our Tester (cli/test.py --torch-snapshot)."""
    from hand_integral_pose_estimation_tpu.config import ModelConfig
    from hand_integral_pose_estimation_tpu.interop import (
        convert_pose_snapshot,
    )
    from hand_integral_pose_estimation_tpu.models.pose_net import (
        get_pose_net,
    )

    J, D = 21, 16
    tm = TorchResPoseNet(50, joint_num=J, depth_dim=D)
    _randomize(tm, seed=11)
    sd = tm.state_dict()
    if wrap_module_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}

    variables = convert_pose_snapshot(sd, resnet_type=50)
    cfg = ModelConfig(resnet_type=50, input_shape=(64, 64),
                      output_shape=(16, 16), depth_dim=D, num_joints=J,
                      compute_dtype="float32")
    net = get_pose_net(cfg)
    x = np.random.default_rng(7).normal(size=(2, 64, 64, 3)) \
        .astype(np.float32) * 40 + 100
    with torch.no_grad():
        ref = _to_nhwc(tm(_nchw(x)))
    out = net.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                    jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-3, atol=2e-2)

    # the fused-head projection consumes the same converted final params
    Wp, bp = net.final_projection(variables["params"])
    assert Wp.shape == (256, J * D) and bp.shape == (J * D,)


def test_load_torch_state_dict_network_envelope(tmp_path):
    """The pose trainer's snapshot envelope {"epoch", "network",
    "optimizer"} (common/base.py:57-67) unwraps like the detector's
    {"model": ...} one."""
    from hand_integral_pose_estimation_tpu.interop import (
        load_torch_state_dict,
    )
    path = str(tmp_path / "snapshot_3.pth")
    torch.save({"epoch": 3,
                "network": {"backbone.conv1.weight": torch.zeros(2)}},
               path)
    out = load_torch_state_dict(path)
    assert set(out) == {"backbone.conv1.weight"}


def test_build_detector_pth_path(tmp_path):
    """detect/load.py routes .pth checkpoints through the converter — the
    runner-side of `load_faster_rcnn_detector` (hand_detector.py:111-158)."""
    from hand_integral_pose_estimation_tpu.config import DetectorConfig
    from hand_integral_pose_estimation_tpu.detect.load import build_detector

    torch.manual_seed(1)
    tm = TorchFasterRCNN(rtype=50)
    _randomize(tm, seed=21)
    path = str(tmp_path / "faster_rcnn_1_8_132028.pth")
    torch.save({"model": tm.state_dict()}, path)

    cfg = DetectorConfig(resnet_type=50, resnet_style="caffe",
                         test_scale=64, test_max_size=64)
    model, det_vars = build_detector(cfg, path, log=lambda *a: None)
    np.testing.assert_allclose(
        np.asarray(det_vars["params"]["base"]["conv1"]["kernel"]),
        np.transpose(tm.RCNN_base[0].weight.detach().numpy(), (2, 3, 1, 0)),
        rtol=1e-6)
    # wrong style is refused attributably, not silently mis-run
    with pytest.raises(ValueError, match="caffe"):
        build_detector(DetectorConfig(resnet_type=50, test_scale=64,
                                      test_max_size=64),
                       path, log=lambda *a: None)


def test_trainer_imagenet_init(tmp_path):
    """Trainer(imagenet_init=...) = the reference's model-zoo backbone init
    before training (common/base.py + common/nets/resnet.py:70-76)."""
    from hand_integral_pose_estimation_tpu.config import (
        Config, ModelConfig, TrainConfig,
    )
    from hand_integral_pose_estimation_tpu.data.freihand import (
        SyntheticFreiHand,
    )
    from hand_integral_pose_estimation_tpu.training import Trainer

    tm = TorchResNet(18)
    _randomize(tm, seed=31)
    path = str(tmp_path / "resnet18-imagenet.pth")
    torch.save(tm.state_dict(), path)

    cfg = Config(model=ModelConfig(resnet_type=18, input_shape=(32, 32),
                                   output_shape=(8, 8), depth_dim=8,
                                   compute_dtype="float32"),
                 train=TrainConfig(batch_size=4, lr=1e-3))
    t = Trainer(cfg=cfg, dataset=SyntheticFreiHand(n=8, image_hw=(32, 32)),
                model_dir=str(tmp_path / "model"), integral_impl="xla",
                imagenet_init=path)
    np.testing.assert_allclose(
        np.asarray(t.state.params["backbone"]["conv1"]["kernel"]),
        np.transpose(tm.conv1.weight.detach().numpy(), (2, 3, 1, 0)),
        rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(t.state.batch_stats["backbone"]["_Norm_0"]
                   ["BatchNorm_0"]["mean"]),
        tm.bn1.running_mean.detach().numpy(), rtol=1e-6)
