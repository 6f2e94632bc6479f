"""The operation and byte counters against counts written out from the
shapes, and against torch's own count of the plain reference's products."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.reference import Precision
from benchmark.reference.detector import Detector
from benchmark.reference.pose import PoseNet

POSE = {"resnet_type": 50, "input_shape": [224, 224], "output_shape": [56, 56],
        "depth_dim": 56, "num_deconv_layers": 3, "deconv_channels": 256,
        "num_joints": 21}


def test_r18_pose_forward_written_out():
    model = dict(POSE, resnet_type=18, input_shape=[64, 64],
                 output_shape=[16, 16], deconv_channels=32, depth_dim=8)
    stem = 3 * 64 * 49 * 32 * 32                      # 7x7/2 -> 32x32
    layer1 = 4 * 64 * 64 * 9 * 16 * 16               # after the pool
    layer2 = (64 * 128 * 9 * 8 * 8 + 128 * 128 * 9 * 8 * 8
              + 64 * 128 * 8 * 8 + 2 * 128 * 128 * 9 * 8 * 8)
    layer3 = (128 * 256 * 9 * 16 + 256 * 256 * 9 * 16 + 128 * 256 * 16
              + 2 * 256 * 256 * 9 * 16)
    layer4 = (256 * 512 * 9 * 4 + 512 * 512 * 9 * 4 + 256 * 512 * 4
              + 2 * 512 * 512 * 9 * 4)
    deconv = 512 * 32 * 16 * 4 + 32 * 32 * 16 * 16 + 32 * 32 * 16 * 64
    proj = 32 * 21 * 8 * 16 * 16
    macs = flops.pose_forward_macs(model)
    assert macs == {"trunk": stem + layer1 + layer2 + layer3 + layer4,
                    "deconv": deconv, "projection": proj}
    assert flops.pose_train_flops(model) == 6 * (stem + layer1 + layer2
                                                 + layer3 + layer4 + deconv
                                                 + proj)


def test_r50_pose_forward_against_torch_count():
    net = PoseNet(50)
    x = torch.zeros(1, 224, 224, 3)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        logits = torch.nn.functional.conv2d(
            net.features(x, Precision()), net.head.final_layer.weight)
    assert logits.shape == (1, 21 * 56, 56, 56)
    assert counter.get_total_flops() == flops.pose_forward_flops(POSE)
    # the published shapes' counts: 4.09, 1.44 and 0.94 GMAC
    macs = flops.pose_forward_macs(POSE)
    assert round(macs["trunk"] / 1e9, 2) == 4.09
    assert round(macs["deconv"] / 1e9, 2) == 1.44
    assert round(macs["projection"] / 1e9, 2) == 0.94


def test_r101_c4_detector_against_torch_count():
    det = {"resnet_type": 101, "test_scale": 600, "test_max_size": 1000,
           "anchor_scales": [4, 8, 16, 32], "anchor_ratios": [0.5, 1, 2],
           "pooling_size": 7, "rpn_post_nms_top_n_test": 300,
           "classes": ["__background__", "hand"]}
    net = Detector(det).eval()
    q = Precision()
    with torch.device("meta"):
        blob = torch.zeros(1, 600, 600, 3)
        pooled = torch.zeros(300, 1024, 7, 7)
    net = net.to("meta")
    with FlopCounterMode(display=False) as base:
        feats = net.base(blob, q)
        net.rpn(feats, q)
    with FlopCounterMode(display=False) as tail:
        net.heads(net.tail(pooled, q), q)
    assert feats.shape == (1, 1024, 38, 38)
    macs = flops.detector_forward_macs(det, (224, 224))
    assert base.get_total_flops() == 2 * (macs["base"] + macs["rpn"])
    assert tail.get_total_flops() == 2 * macs["tail"]


@pytest.mark.parametrize("backward", [False, True])
def test_head_projection_counts(backward):
    B, P, F, C, J = 32, 56 * 56, 256, 21 * 56, 21
    ops, nbytes = flops.head_projection(B, POSE, backward=backward)
    product = 2 * B * P * F * C
    feats, params = B * P * F * 2, C * F * 4 + C * 4
    if backward:
        assert ops == 3 * product
        assert nbytes == 2 * (feats + params) + B * J * 5 * 4
    else:
        assert ops == product
        assert nbytes == feats + params + B * J * 5 * 4
    # compute bound on the card: the products at 989 TFLOP/s
    assert flops.least_seconds(ops, nbytes, "bfloat16") == ops / 989e12
