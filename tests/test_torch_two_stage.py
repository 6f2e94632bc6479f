"""The port's two-stage serving path against the JAX package on the CPU:
`TwoStagePipeline` (both detector arms) through the crop boxes, the coords
and the camera-frame joints, `evaluate_challenge`'s pred.json and .npy, the
crop-box db, `cli.evaluate` with and without the detector, the detector
weights bridge (its round trip through the JAX package's
`convert_faster_rcnn_state_dict`, and a reference-layout .pth loaded
strictly by `build_detector`). Tiny sizes: the R18 detector at 64x64 of
tests/test_torch_detector.py and an R18 pose net at 64x64 with an 8-deep
16x16 heatmap. Each comparison states its tolerance."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hand_integral_pose_estimation_tpu.config as jconfig
from hand_integral_pose_estimation_tpu.cli import evaluate as jax_evaluate_cli
from hand_integral_pose_estimation_tpu.evaluation import (
    evaluate_challenge as jax_evaluate_challenge,
)
from hand_integral_pose_estimation_tpu.inference import (
    TwoStagePipeline as JaxTwoStagePipeline,
)
from hand_integral_pose_estimation_tpu.interop import (
    convert_faster_rcnn_state_dict,
)
from hand_integral_pose_estimation_tpu_torch.cli import evaluate as cli
from hand_integral_pose_estimation_tpu_torch.config import (
    Config,
    DetectorConfig,
)
from hand_integral_pose_estimation_tpu_torch.data import (
    SyntheticFreiHand,
    detector_db,
)
from hand_integral_pose_estimation_tpu_torch.detect import (
    FasterRCNN,
    build_detector,
    default_resnet_style,
)
from hand_integral_pose_estimation_tpu_torch.evaluation import (
    evaluate_challenge,
)
from hand_integral_pose_estimation_tpu_torch.inference import (
    TwoStagePipeline,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    detector_state_dict_from_jax,
)
from test_torch_detector import (  # noqa: F401  (tiny is a fixture)
    TINY,
    assert_detection_margins,
    tiny,
    tiny_images,
)
from test_torch_interop import TorchFasterRCNN, _nchw, _randomize, _to_nhwc
from test_torch_pose_net import (
    port_model,
    randomized_jax_variables,
    small_config,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

CAMERA = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1.0]], np.float32)


# ----------------------------------------------------------- the pipeline

@pytest.fixture(scope="module")
def pose():
    cfg = small_config(18)
    net, variables = randomized_jax_variables(cfg, seed=5, final_scale=0.05)
    return cfg, net, variables, port_model(cfg, variables)


@pytest.mark.parametrize("split", [False, True])
def test_two_stage_pipeline_matches_jax(tiny, pose, split):
    """Detector -> crop -> pose -> camera joints on images whose detector
    decisions are far from flipping (asserted): crop boxes to 1e-4, coords
    to 1e-4 (soft-argmax averages, as the pose-net parity test holds them),
    joints to 1e-4 relative."""
    jdet_cfg, jdet, jdet_vars, det = tiny
    mcfg, jnet, jpose_vars, net = pose
    images = tiny_images()
    assert_detection_margins(jdet, jdet_vars, jdet_cfg, images)
    K = np.broadcast_to(CAMERA, (2, 3, 3)).copy()
    ref = np.array([0.8, 1.3], np.float32)
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(**dataclasses.asdict(mcfg)),
        detector=jdet_cfg)
    want = JaxTwoStagePipeline(jcfg, jnet, jpose_vars, jdet, jdet_vars,
                               split_detector=split)(
        jnp.asarray(images), jnp.asarray(K), jnp.asarray(ref))
    cfg = Config(model=mcfg,
                 detector=DetectorConfig(**dataclasses.asdict(jdet_cfg)))
    got = TwoStagePipeline(cfg, net, det, device="cpu",
                           split_detector=split)(images, K, ref)
    np.testing.assert_allclose(got.crop_bbox.numpy(),
                               np.asarray(want.crop_bbox), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.tprime.numpy(), np.asarray(want.tprime),
                               rtol=1e-5)
    np.testing.assert_allclose(got.coords_label.numpy(),
                               np.asarray(want.coords_label), atol=1e-4)
    np.testing.assert_allclose(got.joints_cam.numpy(),
                               np.asarray(want.joints_cam), rtol=1e-4,
                               atol=1e-6)
    assert np.isfinite(got.joints_cam.numpy()).all()
    assert float(got.coords_label.std()) > 1e-3   # not a degenerate decode


def test_two_stage_pipeline_refuses_what_it_has_not_ported(tiny, pose):
    """`mesh` is ported (tests/test_torch_mesh_serving.py runs it over two
    ranks); with `split_detector` it is refused, as in the JAX package.
    int8 serving is ported and runs (tests/test_torch_quantize.py holds it
    to the JAX package): both nets are quantized and the output is
    finite."""
    _, _, _, det = tiny
    mcfg, _, _, net = pose
    cfg = Config(model=mcfg, detector=DetectorConfig(**TINY))
    with pytest.raises(ValueError, match="split_detector does not compose "
                       "with mesh"):
        TwoStagePipeline(cfg, net, det, device="cpu", mesh=object(),
                         split_detector=True)
    images = tiny_images()
    K = np.broadcast_to(CAMERA, (2, 3, 3)).copy()
    ref = np.ones(2, np.float32)
    pipe = TwoStagePipeline(cfg, net, det, device="cpu",
                            int8_calib=(images, K, ref))
    q_pose, q_det = pipe.quantized
    assert len(q_pose.paths) > 10 and len(q_det.paths) > 10
    assert np.isfinite(pipe(images, K, ref).joints_cam.numpy()).all()


# ------------------------------------------------------- the challenge dump

def test_evaluate_challenge_matches_jax(tmp_path):
    """Back-projection with the box-derived tprime, the bone rescale and
    the two artifacts: the same pred.json and .npy to 1e-6."""
    rng = np.random.RandomState(0)
    n = 5
    coords = rng.uniform(-0.5, 0.5, (n, 21, 3)).astype(np.float32)
    bbox = np.concatenate([rng.uniform(60, 160, (n, 2)),
                           np.repeat(rng.uniform(40, 120, (n, 1)), 2, 1)],
                          1).astype(np.float32)
    K = np.tile(np.array([[531.9, 0, 112], [0, 532.2, 112], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    ref = rng.uniform(0.02, 0.04, n).astype(np.float32)
    for hw in ((224, 224), (64, 64)):
        got = evaluate_challenge(coords, bbox, K, ref,
                                 result_dir=str(tmp_path / "port"),
                                 patch_hw=hw)
        want = jax_evaluate_challenge(coords, bbox, K, ref,
                                      result_dir=str(tmp_path / "jax"),
                                      patch_hw=hw)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for name in ("evaluation_predictions.npy",):
            np.testing.assert_allclose(np.load(tmp_path / "port" / name),
                                       np.load(tmp_path / "jax" / name),
                                       rtol=1e-6, atol=1e-6)
        pj = json.load(open(tmp_path / "port" / "pred.json"))
        wj = json.load(open(tmp_path / "jax" / "pred.json"))
        assert len(pj) == 2 and len(pj[1]) == n
        assert np.asarray(pj[1]).shape == np.asarray(wj[1]).shape == (
            n, 778, 3)
        np.testing.assert_allclose(np.asarray(pj[0]), np.asarray(wj[0]),
                                   rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- crop-box db

def test_bbox_db_generate_save_load_attach(tiny, tmp_path):
    """A batched detector sweep with a padded tail gives square, padded
    crop boxes equal to one call per image; the npz round trip; attaching
    makes host batches carry them; a db of another record set raises."""
    _, _, _, det = tiny
    ds = SyntheticFreiHand(n=5, image_hw=(64, 64), seed=4)
    bbox = detector_db.generate_detector_bboxes(ds, det, batch_size=2)
    assert bbox.shape == (5, 4) and bbox.dtype == np.float32
    assert np.isfinite(bbox).all() and (bbox[:, 2:] > 0).all()
    np.testing.assert_allclose(bbox[:, 2], bbox[:, 3], rtol=1e-6)
    one = detector_db.generate_detector_bboxes(ds, det, batch_size=1)
    np.testing.assert_allclose(one, bbox, rtol=1e-5, atol=1e-4)

    path = str(tmp_path / "db" / "bbox.npz")
    detector_db.save_bbox_db(path, ds, bbox)
    names, loaded = detector_db.load_bbox_db(path)
    np.testing.assert_array_equal(loaded, bbox)
    detector_db.attach_detector_bboxes(ds, loaded, names)
    np.testing.assert_array_equal(ds.host_batch(np.arange(3))[
        "bbox_detector"], bbox[:3])
    with pytest.raises(ValueError):
        detector_db.attach_detector_bboxes(
            SyntheticFreiHand(n=3, image_hw=(64, 64)), loaded[:3], names)


# -------------------------------------------------------------------- CLI

SIZING = ["--detector-resnet", "18", "--detector-scale", "64",
          "--detector-proposals", "16", "--pose-resnet", "18",
          "--pose-input", "64", "--device", "cpu"]


def test_evaluate_cli_runs_the_detector_then_reuses_its_cache(tmp_path,
                                                              capsys):
    """`cli.evaluate --synthetic --use-detector --device cpu` at tiny sizes
    writes pred.json and the crop-box db; a second run takes the boxes from
    the db instead of the detector and writes the same predictions."""
    res, db = tmp_path / "res", tmp_path / "bbox.npz"
    argv = ["--synthetic", "--synthetic-size", "5", "--batch-size", "2",
            "--use-detector", "--model-dir", str(tmp_path / "none"),
            "--result-dir", str(res), "--bbox-db", str(db), *SIZING]
    first = cli.main(argv)
    assert db.exists() and "cached crop boxes" in capsys.readouterr().out
    xyz, verts = json.load(open(res / "pred.json"))
    assert np.asarray(xyz).shape == (5, 21, 3) and len(verts) == 5
    assert np.isfinite(first).all()
    second = cli.main(argv)
    assert "attached 5 cached crop boxes" in capsys.readouterr().out
    np.testing.assert_allclose(second, first, rtol=1e-5, atol=1e-7)
    # without the detector the synthetic split crops its projected joints
    third = cli.main(["--synthetic", "--synthetic-size", "5", "--batch-size",
                      "2", "--model-dir", str(tmp_path / "none"),
                      "--result-dir", str(res), *SIZING])
    assert third.shape == (5, 21, 3) and np.isfinite(third).all()


def test_evaluate_cli_flags_resolve_as_in_jax():
    """The detector flags, the native preset and --set give the JAX CLI's
    DetectorConfig; --mesh data=2 in one process exits with the JAX CLI's
    message for a layout larger than the visible devices, --int8 without
    the detector path with the JAX CLI's message."""
    for argv in ([], ["--detector-native"],
                 ["--detector-native", "--detector-scale", "128",
                  "--detector-resnet", "50", "--detector-proposals", "32"],
                 ["--detector-scale", "64", "--detector-resnet", "18",
                  "--detector-proposals", "16", "--detector-norm", "group"],
                 ["--detector-ckpt", "x.pth", "--set",
                  "TEST.RPN_POST_NMS_TOP_N", "64", "TEST.NMS", "0.4"]):
        got = cli.resolve_detector_cfg(cli.build_argparser().parse_args(argv),
                                       DetectorConfig())
        want = jax_evaluate_cli.resolve_detector_cfg(
            jax_evaluate_cli.build_argparser().parse_args(argv),
            jconfig.DetectorConfig())
        assert dataclasses.asdict(got) == dataclasses.asdict(want), argv
    for flag, why in ((["--mesh", "data=2"], "needs 2 devices, 1 visible"),
                      (["--int8"], "two-stage detector")):
        with pytest.raises(SystemExit, match=why):
            cli.main(["--synthetic", *flag])
    with pytest.raises(SystemExit, match="synthetic"):
        cli.main([])


# ----------------------------------------------------------------- weights

@pytest.mark.parametrize("resnet_type", [50, 18])
def test_detector_weights_round_trip(resnet_type):
    """A port state_dict through the JAX package's converter and back
    through `detector_state_dict_from_jax` is the same state_dict bit for
    bit, RPN class permutation included, and loads strictly. The JAX
    converter fixes the RPN conv's input at 1024 channels (the bottleneck
    base), so for R18 the round trip starts from JAX variables instead:
    JAX -> port -> strict load -> the same tensors."""
    cfg = DetectorConfig(**dict(TINY, resnet_type=resnet_type,
                                resnet_style="caffe"))
    model = FasterRCNN(cfg)
    _randomize(model, seed=resnet_type)
    sd = model.state_dict()
    if resnet_type == 50:
        back = detector_state_dict_from_jax(
            convert_faster_rcnn_state_dict(sd, cfg), cfg)
    else:
        with pytest.raises(ValueError, match="RPN_Conv"):
            convert_faster_rcnn_state_dict(sd, cfg)
        jcfg = jconfig.DetectorConfig(**dataclasses.asdict(cfg))
        from hand_integral_pose_estimation_tpu.detect.faster_rcnn import (
            FasterRCNN as JaxFasterRCNN,
        )
        jvars = jax.jit(JaxFasterRCNN(cfg=jcfg).init)(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1)},
            jnp.zeros((1, 64, 64, 3), jnp.float32))
        sd = detector_state_dict_from_jax(jvars, jcfg)
        model.load_state_dict(sd, strict=True)
        back = model.state_dict()
        np.testing.assert_array_equal(
            sd["RCNN_rpn.RPN_cls_score.weight"][:, :, 0, 0].numpy(),
            np.asarray(jvars["params"]["rpn_cls"]["kernel"])[0, 0].T[
                np.arange(24).reshape(12, 2).T.reshape(-1)])
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    FasterRCNN(cfg).load_state_dict(back, strict=True)


def test_build_detector_loads_a_reference_pth_strictly(tmp_path):
    """A random detector in the reference's layout, saved the reference's
    way ({'model': state_dict}), loads into the port by `build_detector`
    (caffe style implied by .pth) with a strict load, and the port's base
    features, RPN fg probabilities (the [bg x A, fg x A] channels) and
    pooled-feature head equal the reference module's: 1e-4 of the largest
    value."""
    tm = TorchFasterRCNN(rtype=50)
    _randomize(tm, seed=11)
    path = str(tmp_path / "faster_rcnn_1_8_132028.pth")
    torch.save({"model": tm.state_dict(), "pooling_mode": "align"}, path)
    args = cli.build_argparser().parse_args(["--detector-ckpt", path,
                                             "--detector-resnet", "50"])
    cfg = cli.resolve_detector_cfg(args, DetectorConfig())
    assert cfg.resnet_style == default_resnet_style(path) == "caffe"
    model = build_detector(cfg, path, log=lambda *a: None)

    x = np.random.default_rng(2).normal(size=(1, 96, 96, 3)).astype(
        np.float32)
    with torch.no_grad():
        feats_ref, fg_ref, _ = tm.score_maps(_nchw(x))
        f = model.RCNN_base(torch.from_numpy(x).permute(0, 3, 1, 2))
        cls, _ = model.RCNN_rpn(f)
        pooled = np.random.default_rng(3).normal(size=(3, 7, 7, 1024)) \
            .astype(np.float32)
        logit_ref, delta_ref = tm.head(_nchw(pooled))
        h = model.RCNN_top(torch.from_numpy(pooled).permute(0, 3, 1, 2))
        h = h.mean(dim=(2, 3))
        logits, deltas = model.RCNN_cls_score(h), model.RCNN_bbox_pred(h)
    from hand_integral_pose_estimation_tpu_torch.detect.rpn import fg_scores
    B, _, H, W = fg_ref.shape
    for got, want in (
            (f.permute(0, 2, 3, 1).numpy(), _to_nhwc(feats_ref)),
            (fg_scores(cls.permute(0, 2, 3, 1)).reshape(B, H, W, -1).numpy(),
             _to_nhwc(fg_ref)),
            (logits.numpy(), logit_ref.numpy()),
            (deltas.numpy(), delta_ref.numpy())):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_build_detector_refusals(tmp_path):
    cfg = DetectorConfig(**TINY)
    with pytest.raises(FileNotFoundError, match="detector checkpoint"):
        build_detector(cfg, str(tmp_path / "nope.pth"))
    os.makedirs(tmp_path / "orbax_dir")
    with pytest.raises(ValueError, match="orbax"):
        build_detector(cfg, str(tmp_path / "orbax_dir"))
    torch.save({"model": {}}, tmp_path / "x.pth")
    with pytest.raises(ValueError, match="caffe"):
        build_detector(cfg, str(tmp_path / "x.pth"))
    a = build_detector(cfg, generator=torch.Generator().manual_seed(1))
    b = build_detector(cfg, generator=torch.Generator().manual_seed(1))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not a.training
