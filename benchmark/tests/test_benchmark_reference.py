"""The plain reference against the port at a tiny size on the CPU: with the
port computing in float32, each cell's compared numbers are round-off."""

import pytest
import torch

from benchmark import harness
from conftest import tiny

CELLS = ("pose_r50_224.train_b32", "pose_r50_224.eval_b32",
         "two_stage_r101c4_600.serve_b4")


@pytest.mark.parametrize("name", CELLS)
def test_port_in_float32_meets_the_reference(name):
    cell = tiny(name, dtype="float32")
    driver = harness.make_driver(cell, 2147483648 + 5, "cpu")
    driver.setup()
    driver.window(0.2)
    driver.release()
    numbers = driver.check()
    # label units, relative gaps and pixels: round-off, which Adam turns
    # into whole steps of the elements whose gradient is near 0, so a
    # leaf's change after three steps moves by ~1e-3
    assert all(v < 1e-2 for v in numbers.values()), numbers


def test_same_state_dict_loads_into_both_nets():
    from hand_integral_pose_estimation_tpu_torch.config import (
        DetectorConfig,
        ModelConfig,
    )
    from hand_integral_pose_estimation_tpu_torch.detect import FasterRCNN
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net

    from benchmark.reference.detector import Detector
    from benchmark.reference.pose import PoseNet

    ref = PoseNet(50).state_dict()
    port = get_pose_net(ModelConfig()).state_dict()
    assert {k: v.shape for k, v in ref.items()} == {
        k: v.shape for k, v in port.items()}
    cell = harness.find_cell("two_stage_r101c4_600.serve_b4")
    det = cell.config["detector"]
    ref = Detector(det).state_dict()
    port = FasterRCNN(DetectorConfig(resnet_type=101,
                                     resnet_style="caffe")).state_dict()
    assert {k: v.shape for k, v in ref.items()} == {
        k: v.shape for k, v in port.items()}


def test_frames_are_drawn_from_the_seed():
    from benchmark import frames

    a = frames.render(6, 2 ** 33 + 1, "cpu")
    b = frames.render(6, 2 ** 33 + 1, "cpu")
    c = frames.render(6, 2 ** 33 + 2, "cpu")
    assert (a.images == b.images).all() and (a.joint_cam == b.joint_cam).all()
    assert not (a.images == c.images).all()
    # each joint's blob is painted in its colour
    assert a.images.max() > 63  # the noise stays below 64
