"""Fixtures of the benchmark's own tests: its cells cut to sizes that run on
a CPU in seconds (the widths of the cells are the card's)."""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

TINY_POSE = dict(resnet_type=18, input_shape=[64, 64], output_shape=[16, 16],
                 depth_dim=8, deconv_channels=32)
TINY_DETECTOR = dict(resnet_type=18, test_scale=96, test_max_size=96,
                     rpn_pre_nms_top_n_test=200, rpn_post_nms_top_n_test=16)


def tiny(name: str, dtype: str = "bfloat16", root: str = ROOT):
    """Cell `name` with a ResNet-18 at 64x64, a few frames and small
    batches; `dtype` the pose net's compute type."""
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = copy.deepcopy(harness.find_cell(name, root))
    cell.config["model"].update(TINY_POSE, compute_dtype=dtype)
    data = cell.config["data"]
    if "detector" in cell.config:
        cell.config["detector"].update(TINY_DETECTOR)
        data["frame_hw"] = [64, 64]
        cell.traffic.update(batch_size=2, pool_requests=4, checked_requests=3)
    else:
        data.update(training_size=24, testing_size=10)
        cell.traffic["batch_size"] = 4
        if "checked_rows" in cell.traffic:
            cell.traffic["checked_rows"] = 6
    return cell


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
