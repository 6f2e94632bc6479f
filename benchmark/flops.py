"""Operations and bytes the math needs, counted from a configuration's
shapes, and the peaks they are held against.

A convolution of cin -> cout channels with a k x k kernel over an ho x wo
output does cin * cout * k * k * ho * wo multiply-adds; a transposed one
does cin * cout * k * k per input pixel. One multiply-add is two
operations. Training counts the backward as twice the forward (the input
gradient and the weight gradient). Bytes count each input read once and
each output written once.
"""

from __future__ import annotations

from benchmark.reference.pose import RESNET_LAYERS

#: NVIDIA H100 SXM data sheet, dense (the card's power limit is printed
#: beside every measurement)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def out_size(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet_stages_macs(resnet_type: int, h: int, w: int, first: int,
                       last: int, cin: int, caffe: bool = False):
    """Multiply-adds of stages `first`..`last` (1-based) over an h x w
    input of `cin` channels: (macs, h, w, channels) after them."""
    kind, layers = RESNET_LAYERS[resnet_type]
    macs = 0
    for stage in range(first, last + 1):
        planes = (64, 128, 256, 512)[stage - 1]
        for i in range(layers[stage - 1]):
            stride = (1, 2, 2, 2)[stage - 1] if i == 0 else 1
            ho, wo = out_size(h, 1, stride, 0), out_size(w, 1, stride, 0)
            if kind == "basic":
                out = planes
                macs += cin * planes * 9 * ho * wo + planes * planes * 9 * ho * wo
            else:
                out = 4 * planes
                # caffe strides the first 1x1, torchvision the 3x3
                h1, w1 = (ho, wo) if caffe else (h, w)
                macs += (cin * planes * h1 * w1 + planes * planes * 9 * ho * wo
                         + planes * out * ho * wo)
            if stride != 1 or cin != out:
                macs += cin * out * ho * wo
            cin, h, w = out, ho, wo
    return macs, h, w, cin


def stem(h: int, w: int, caffe: bool = False):
    """The 7x7 stride-2 convolution and the 3/2 max pool: (macs, h, w)."""
    h, w = out_size(h, 7, 2, 3), out_size(w, 7, 2, 3)
    macs = 3 * 64 * 49 * h * w
    if caffe:       # ceil mode, no padding
        return macs, -(-(h - 3) // 2) + 1, -(-(w - 3) // 2) + 1
    return macs, out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)


def pose_forward_macs(model: dict) -> dict:
    """Multiply-adds of one image's pose forward by part: trunk, deconv
    head, projection."""
    h, w = model["input_shape"]
    macs, h, w = stem(h, w)
    trunk, h, w, c = resnet_stages_macs(model["resnet_type"], h, w, 1, 4, 64)
    deconv = 0
    for _ in range(model["num_deconv_layers"]):
        deconv += c * model["deconv_channels"] * 16 * h * w
        c, h, w = model["deconv_channels"], 2 * h, 2 * w
    proj = c * model["num_joints"] * model["depth_dim"] * h * w
    return {"trunk": macs + trunk, "deconv": deconv, "projection": proj}


def pose_forward_flops(model: dict) -> float:
    return 2.0 * sum(pose_forward_macs(model).values())


def pose_train_flops(model: dict) -> float:
    """One image's training step: forward, and a backward of twice it."""
    return 3.0 * pose_forward_flops(model)


def detector_forward_macs(det: dict, image_hw) -> dict:
    """Multiply-adds of one image's Faster R-CNN C4 forward by part: the
    stride-16 base at the blob's size, the RPN, and the stage-4 tail and
    heads over every post-NMS proposal."""
    h, w = image_hw
    scale = det["test_scale"] / min(h, w)
    if scale * max(h, w) > det["test_max_size"]:
        scale = det["test_max_size"] / max(h, w)
    h, w = int(round(h * scale)), int(round(w * scale))
    rtype = det["resnet_type"]
    macs, h, w = stem(h, w, caffe=True)
    base, h, w, c = resnet_stages_macs(rtype, h, w, 1, 3, 64, caffe=True)
    anchors = len(det["anchor_scales"]) * len(det["anchor_ratios"])
    rpn = c * 512 * 9 * h * w + 512 * 6 * anchors * h * w
    p = det["pooling_size"]
    rois = det["rpn_post_nms_top_n_test"]
    tail, _, _, ct = resnet_stages_macs(rtype, p, p, 4, 4, c, caffe=True)
    classes = len(det["classes"])
    heads = ct * classes * 5
    return {"base": macs + base, "rpn": rpn, "tail": rois * (tail + heads)}


def detector_forward_flops(det: dict, image_hw) -> float:
    return 2.0 * sum(detector_forward_macs(det, image_hw).values())


def head_projection(batch: int, model: dict, feat_dtype: str = "bfloat16",
                    backward: bool = False) -> tuple[float, float]:
    """(operations, bytes) of the fused projection + soft-argmax over a
    batch: one product of positions x features x channels forward; in the
    backward the logits, dfeat and dW products. Bytes: features, weight,
    bias read once and the coords (with the per-joint max and sum) written
    once; the backward reads the features, weight, bias, the coords'
    cotangent and the max and sum, and writes dfeat, dW and db."""
    h, w = model["output_shape"]
    F = model["deconv_channels"]
    J, D = model["num_joints"], model["depth_dim"]
    C = J * D
    positions = batch * h * w
    product = 2.0 * positions * F * C
    feats = positions * F * DTYPE_BYTES[feat_dtype]
    params = C * F * 4 + C * 4
    small = batch * J * 5 * 4
    if not backward:
        return product, feats + params + small
    return 3 * product, 2 * (feats + params) + small


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The roofline's least time: operations at the type's peak or bytes at
    the memory's, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
