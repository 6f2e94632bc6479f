"""The port's detector-training CLIs on the CPU, at tiny sizes, mirroring
the JAX package's CLI tests: `cli.train_detector` writes a `.pth` that
`detect.build_detector` restores (tests/test_train_detector_cli.py), the
from-scratch convergence study, `cli.train --use-hand-detector --bbox-db`
with `data.detector_db.ensure_detector_bboxes`, and
`cli.visualize_detections`. Configuration plumbing is held equal to the
JAX CLIs' on the same flags."""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.cli import (
    detector_convergence as jconv,
)
from hand_integral_pose_estimation_tpu.cli import train_detector as jtd
from hand_integral_pose_estimation_tpu_torch.cli import (
    detector_convergence,
    train_detector,
)
from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
from hand_integral_pose_estimation_tpu_torch.data import (
    SyntheticFreiHand,
    detector_db,
)
from hand_integral_pose_estimation_tpu_torch.detect import (
    build_detector,
    detect,
)
from hand_integral_pose_estimation_tpu_torch.detect.load import save_detector
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

TINY_TRAIN = ["--synthetic", "--n", "16", "--steps", "2", "--batch", "2",
              "--eval-every", "2", "--resnet", "18", "--scale", "112",
              "--max-size", "112", "--rpn-pre-nms", "128", "--rpn-post-nms",
              "32", "--roi-batch", "16", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    [], ["--norm", "batch", "--reference-sampling"],
    ["--norm", "batch", "--no-freeze-bn", "--rpn-post-nms", "40"]])
def test_detector_cfg_from_args_matches_jax(flags):
    """The recipe flags give the JAX CLI's DetectorConfig, field for
    field (from scratch: roi_bg_thresh_lo 0, test proposals post/4)."""
    args = train_detector.build_argparser().parse_args(flags)
    jargs = argparse.Namespace(**vars(args))
    got = dataclasses.asdict(train_detector.detector_cfg_from_args(args))
    want = dataclasses.asdict(jtd.detector_cfg_from_args(jargs))
    assert got == want


def test_train_detector_writes_a_snapshot_build_detector_restores(tmp_path):
    """Two SGD steps of the R18 GroupNorm detector on the synthetic split
    write `faster_rcnn_final.pth`; `build_detector` restores every tensor,
    and its `detect` equals the trained model's."""
    result = train_detector.main(TINY_TRAIN + ["--model-dir", str(tmp_path)])
    path = tmp_path / "faster_rcnn_final.pth"
    assert path.exists()
    assert [h["step"] for h in result["history"]] == [2]
    assert np.isfinite(result["history"][0]["loss"])
    args = train_detector.build_argparser().parse_args(TINY_TRAIN)
    cfg = train_detector.detector_cfg_from_args(args)
    trained = result["model"]
    restored = build_detector(cfg, str(path), log=lambda *a: None)
    for k, v in trained.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k
    images = torch.from_numpy(SyntheticFreiHand(n=2, seed=5).images)
    a, b = detect(trained, images, cfg), detect(restored, images, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the snapshot records its architecture: another one is refused
    with pytest.raises(ValueError, match="norm='group'"):
        build_detector(dataclasses.replace(cfg, norm="batch"), str(path))


def test_save_detector_of_batchnorm_caffe_detector_restores(tmp_path):
    """A snapshot of a caffe-style BatchNorm detector loads as the
    reference's weights do; a torchvision-style configuration is
    refused."""
    cfg = DetectorConfig(resnet_type=18, resnet_style="caffe",
                         test_scale=64, test_max_size=64)
    model = build_detector(cfg, generator=torch.Generator().manual_seed(2))
    path = save_detector(model, str(tmp_path / "d" / "x.pth"))
    again = build_detector(cfg, path, log=lambda *a: None)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    with pytest.raises(ValueError, match="resnet_style='caffe'"):
        build_detector(dataclasses.replace(cfg, resnet_style="torchvision"),
                       path)


def test_detector_convergence_study_tiny():
    """The from-scratch study runs at toy scale: the native recipe (JAX's
    study_config field for field), one evaluation, the proposal and dtype
    sweeps on the same weights."""
    assert (dataclasses.asdict(detector_convergence.study_config((64, 96)))
            == dataclasses.asdict(jconv.study_config((64, 96))))
    cfg = detector_convergence.study_config((64, 64))
    assert cfg.norm == "group" and not cfg.freeze_bn
    res = detector_convergence.run_study(
        train_n=6, val_n=3, hw=(64, 64), steps=2, batch=2, eval_every=2,
        proposal_sweep=(8,), dtype_sweep=("bfloat16",), device="cpu",
        log=lambda *a: None)
    assert len(res["history"]) == 1 and res["history"][0]["step"] == 2
    rec = res["history"][0]
    assert all(np.isfinite(rec[k]) for k in ("loss", "rpn_cls", "det_cls"))
    assert 0.0 <= res["final_ap"] <= 1.0
    assert set(res["proposal_sweep"]) == {8}
    assert set(res["dtype_sweep"]) == {"bfloat16"}
    assert set(res["rpn_recall"]) == {"step_0", "final"}
    assert all(0.0 <= v <= 1.0 for v in res["rpn_recall"].values())
    assert res["train_ms_per_step"] > 0
    assert res["train_launches"] == {}      # no kernel launches on the CPU


def test_proposal_recall_counts_gt_boxes_under_a_proposal():
    """`proposal_recall`: the share of gt boxes that a valid test-time
    proposal covers at IoU >= 0.5 (the reference's +1 box convention), in
    image coordinates (the blob's scale undone), against the count made by
    hand on given proposals."""

    class Upstream(torch.nn.Module):
        def __init__(self, rois, valid):
            super().__init__()
            self.rois, self.valid = rois, valid

        def upstream(self, blob):
            return None, self.rois, self.valid

    cfg = dataclasses.replace(DetectorConfig(), test_scale=128,
                              test_max_size=128)
    images = torch.zeros(2, 64, 64, 3, dtype=torch.uint8)   # blob scale 2
    gt = [np.array([[0, 0, 19, 19], [30, 30, 49, 49]], np.float32),
          np.array([[10, 10, 29, 29]], np.float32)]
    # in the blob (x2); in the image: image 0 [0, 0, 19, 19] (its first gt
    # box exactly) and [40, 40, 59, 59] (IoU 100 / 700 with its second);
    # image 1 [10, 10, 29, 29] (exact, but not valid) and [20, 10, 39, 29]
    # (IoU 200 / 600)
    rois = torch.tensor([[[0, 0, 38, 38], [80, 80, 118, 118]],
                         [[20, 20, 58, 58], [40, 20, 78, 58]]],
                        dtype=torch.float32)
    valid = torch.tensor([[True, True], [False, True]])
    model = Upstream(rois, valid)
    assert detector_convergence.proposal_recall(
        model, images, gt, cfg) == pytest.approx(1 / 3)
    assert detector_convergence.proposal_recall(
        model, images, gt, cfg, iou=0.3) == pytest.approx(2 / 3)
    valid[1, 0] = True
    assert detector_convergence.proposal_recall(
        model, images, gt, cfg) == pytest.approx(2 / 3)
    assert model.training


def test_ensure_detector_bboxes_reuses_a_matching_cache(tmp_path):
    """A cache made for the dataset is attached without a detector; one
    made for another record set is stale, and without a detector that
    raises."""
    ds = SyntheticFreiHand(n=4, image_hw=(64, 64))
    bbox = np.tile([30.0, 30.0, 22.0, 22.0], (4, 1)).astype(np.float32)
    path = str(tmp_path / "bbox_db.npz")
    detector_db.save_bbox_db(path, ds, bbox)
    detector_db.ensure_detector_bboxes(ds, None, cache_path=path)
    np.testing.assert_array_equal(ds.host_batch(np.arange(4))[
        "bbox_detector"], bbox)
    other = SyntheticFreiHand(n=3, image_hw=(64, 64), seed=9)
    with pytest.raises(ValueError, match="no detector"):
        detector_db.ensure_detector_bboxes(other, None, cache_path=path)


def test_train_cli_use_hand_detector_bbox_db(tmp_path, monkeypatch):
    """`cli.train --use-hand-detector --bbox-db`: the first run sweeps the
    (seeded R18) detector over the split, saves the db and trains on the
    detector crops; the second finds the db and builds no detector."""
    from hand_integral_pose_estimation_tpu_torch.cli import train as cli_train
    from hand_integral_pose_estimation_tpu_torch.detect import load

    db = str(tmp_path / "bbox.npz")
    flags = ["--synthetic", "--synthetic-size", "4", "--epochs", "1",
             "--steps-per-epoch", "1", "--batch-size", "2",
             "--pose-resnet", "18", "--pose-input", "64", "--device", "cpu",
             "--use-hand-detector", "--bbox-db", db,
             "--detector-resnet", "18", "--detector-norm", "group",
             "--log-dir", str(tmp_path / "log")]
    trainer = cli_train.main(flags + ["--model-dir", str(tmp_path / "a")])
    names, boxes = detector_db.load_bbox_db(db)
    assert boxes.shape == (4, 4) and np.isfinite(boxes).all()
    np.testing.assert_array_equal(
        trainer.dataset.host_batch(np.arange(4))["bbox_detector"], boxes)
    assert trainer.cfg.detector.norm == "group"
    assert os.path.exists(tmp_path / "a" / "snapshot_0.pth.tar")

    def no_detector(*a, **k):
        raise AssertionError("the cached db should have been reused")

    monkeypatch.setattr(load, "build_detector", no_detector)
    again = cli_train.main(flags + ["--model-dir", str(tmp_path / "b")])
    np.testing.assert_array_equal(
        again.dataset.host_batch(np.arange(4))["bbox_detector"], boxes)


def test_visualize_detections_writes_images(tmp_path):
    pytest.importorskip("matplotlib")
    from hand_integral_pose_estimation_tpu_torch.cli import (
        visualize_detections,
    )

    out = tmp_path / "vis"
    visualize_detections.main(["--synthetic", "--num-images", "2",
                               "--detector-resnet", "18",
                               "--detector-scale", "64", "--device", "cpu",
                               "--out-dir", str(out)])
    assert sorted(os.listdir(out)) == ["det_0.jpg", "det_1.jpg"]
