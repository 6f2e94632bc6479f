"""The hand detector and the two-stage pipeline, in plain PyTorch.

The detector is the reference repository's Faster R-CNN C4
(lib/model_rcnn/faster_rcnn/resnet.py, common/hand_detector.py): a caffe
ResNet base to stride 16, the RPN (3x3 conv, 1x1 class and box heads over
4 x 3 anchors), the test-time proposal layer (foreground softmax, decode,
clip, min-size filter, pre-NMS top-k, NMS), ROIAlign, the stage-4 tail and
its spatial mean, the class and box heads, and the post-processing (class-1
deltas times their stds, clip, rescale, score threshold, class NMS). The
pipeline then crops the best box squared and padded and runs the pose net
on it (common/augment.py:317-342, the reference's test path). Parameter
names are the reference's (RCNN_base, RCNN_top, RCNN_rpn.*, RCNN_cls_score,
RCNN_bbox_pred). NMS is written as the greedy loop it is defined by.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import Precision
from benchmark.reference import geometry as geo
from benchmark.reference.pose import ResNet, conv, eval_batch

MAX_SCALE_DELTA = 4.135166556742356


class Detector(nn.Module):
    def __init__(self, det: dict):
        super().__init__()
        self.det = det
        r = ResNet(det["resnet_type"], num_stages=4, caffe=True)
        self.RCNN_base = nn.Sequential(
            r.conv1, r.bn1, nn.ReLU(), nn.MaxPool2d(3, 2, 0, ceil_mode=True),
            r.layer1, r.layer2, r.layer3)
        self.RCNN_top = nn.Sequential(r.layer4)
        wide = 4 if r.layer1[0].kind == "bottleneck" else 1
        self.A = len(det["anchor_scales"]) * len(det["anchor_ratios"])
        rpn = nn.Module()
        rpn.RPN_Conv = nn.Conv2d(256 * wide, 512, 3, 1, 1)
        rpn.RPN_cls_score = nn.Conv2d(512, 2 * self.A, 1)
        rpn.RPN_bbox_pred = nn.Conv2d(512, 4 * self.A, 1)
        self.RCNN_rpn = rpn
        classes = len(det["classes"])
        self.RCNN_cls_score = nn.Linear(512 * wide, classes)
        self.RCNN_bbox_pred = nn.Linear(512 * wide, 4 * classes)

    def base(self, blob_nhwc, q: Precision):
        m = self.RCNN_base
        x = torch.relu(m[1](conv(m[0], blob_nhwc.permute(0, 3, 1, 2), q)))
        x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
        for layer in m[4:]:
            for block in layer:
                x = block.run(x, q)
        return x

    def rpn(self, feats, q: Precision):
        t = torch.relu(conv(self.RCNN_rpn.RPN_Conv, feats, q))
        return (conv(self.RCNN_rpn.RPN_cls_score, t, q),
                conv(self.RCNN_rpn.RPN_bbox_pred, t, q))

    def tail(self, pooled_nchw, q: Precision):
        """Pooled RoIs -> the stage-4 tail's spatial mean (R, 2048)."""
        x = pooled_nchw
        for block in self.RCNN_top[0]:
            x = block.run(x, q)
        return x.mean(dim=(2, 3))

    def heads(self, h, q: Precision):
        return (F.linear(q(h), q(self.RCNN_cls_score.weight),
                         self.RCNN_cls_score.bias),
                F.linear(q(h), q(self.RCNN_bbox_pred.weight),
                         self.RCNN_bbox_pred.bias))


# ---------------------------------------------------------------- boxes
def base_anchors(stride, ratios, scales) -> np.ndarray:
    """generate_anchors.py:44-55: rounded ratio widths, scales inside."""
    w = h = float(stride)
    cx = cy = 0.5 * (stride - 1)
    out = []
    for r in ratios:
        ws = np.round(np.sqrt(w * h / r))
        hs = np.round(ws * r)
        for s in scales:
            out.append([cx - 0.5 * (ws * s - 1), cy - 0.5 * (hs * s - 1),
                        cx + 0.5 * (ws * s - 1), cy + 0.5 * (hs * s - 1)])
    return np.asarray(out)


def grid_anchors(hw, stride, base, device) -> torch.Tensor:
    """(H * W * A, 4), row-major over (y, x, anchor)."""
    H, W = hw
    X, Y = np.meshgrid(np.arange(W) * stride, np.arange(H) * stride)
    shifts = np.stack([X.ravel(), Y.ravel(), X.ravel(), Y.ravel()], 1)
    a = (base[None] + shifts[:, None]).reshape(-1, 4)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def decode(anchors, deltas):
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(torch.clamp(deltas[..., 2], max=MAX_SCALE_DELTA)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], max=MAX_SCALE_DELTA)) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w - 1.0,
                        cy + 0.5 * h - 1.0], -1)


def clip(boxes, hw):
    h, w = hw
    return torch.stack([boxes[..., 0].clamp(0, w - 1),
                        boxes[..., 1].clamp(0, h - 1),
                        boxes[..., 2].clamp(0, w - 1),
                        boxes[..., 3].clamp(0, h - 1)], -1)


def iou(a, b):
    """Pairwise IoU with the reference's +1 width and height."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-12)


def nms(boxes, scores, threshold, keep, score_threshold):
    """Greedy NMS of one image: in descending score order (ties by index)
    keep a box above `score_threshold` unless a kept box overlaps it by
    more than `threshold`; the first `keep` kept, as (boxes, scores) with
    zeroed padding and a validity mask."""
    order = torch.sort(scores, descending=True, stable=True).indices
    b, s = boxes[order], scores[order]
    over = (iou(b, b) > threshold).cpu().numpy()
    alive = (s > score_threshold).cpu().numpy()
    kept = []
    suppressed = np.zeros(len(s), bool)
    for i in range(len(s)):
        if len(kept) == keep:
            break
        if alive[i] and not suppressed[i]:
            kept.append(i)
            suppressed |= over[i]
    idx = torch.tensor(kept, dtype=torch.long, device=boxes.device)
    out_b = torch.zeros(keep, 4, device=boxes.device)
    out_s = torch.zeros(keep, device=boxes.device)
    valid = torch.zeros(keep, dtype=torch.bool, device=boxes.device)
    out_b[:len(kept)], out_s[:len(kept)], valid[:len(kept)] = b[idx], s[idx], True
    return out_b, out_s, valid


def roi_align(feats_nhwc, rois, pooled, scale, ratio):
    """One image's ROIAlign (sampling_ratio samples per bin and axis, each
    bilinear, averaged): (H, W, C) x (R, 4) -> (R, C, pooled, pooled)."""
    H, W, C = feats_nhwc.shape

    def centres(axis):
        lo, hi = rois[:, axis] * scale, rois[:, axis + 2] * scale
        size = torch.clamp(hi - lo, min=1.0) / pooled
        i = torch.arange(pooled * ratio, dtype=rois.dtype, device=rois.device)
        b = torch.div(i, ratio, rounding_mode="floor")
        return lo[:, None] + b * size[:, None] + (i - b * ratio + 0.5) * (
            size / ratio)[:, None]

    def weights(c, n):
        inside = (c >= -1.0) & (c <= n)
        c = torch.clamp(c, 0.0, n - 1.0)
        w = torch.clamp(1.0 - torch.abs(
            c[..., None] - torch.arange(n, dtype=c.dtype, device=c.device)),
            min=0.0)
        return w * inside[..., None]

    Wy, Wx = weights(centres(1), H), weights(centres(0), W)
    s = torch.einsum("rsh,hwc,rtw->rstc", Wy, feats_nhwc, Wx)
    R = rois.shape[0]
    s = s.reshape(R, pooled, ratio, pooled, ratio, C).mean(dim=(2, 4))
    return s.permute(0, 3, 1, 2)


# ---------------------------------------------------------------- pipeline
def blob(images, det):
    """RGB frames -> BGR, pixel means off, scaled to the test size."""
    B, H, W, _ = images.shape
    scale = det["test_scale"] / min(H, W)
    if scale * max(H, W) > det["test_max_size"]:
        scale = det["test_max_size"] / max(H, W)
    oh, ow = int(round(H * scale)), int(round(W * scale))
    x = images.flip(-1).float() - torch.tensor(
        det["pixel_means"], device=images.device)
    if (oh, ow) == (H, W):
        return x, scale
    Hm = torch.diag(torch.tensor([scale, scale, 1.0], device=images.device))
    return geo.warp_axis_aligned(x, Hm.expand(B, 3, 3), (oh, ow)), scale


def proposals(net: Detector, x, q: Precision):
    """A blob -> (features NHWC, per image (rois (R, 4), valid (R,))): the
    base, the RPN and the test-time proposal layer."""
    det = net.det
    Hb, Wb = x.shape[1:3]
    feats = net.base(x, q)
    cls, reg = net.rpn(feats, q)
    B, _, h, w = cls.shape
    A = net.A
    pairs = cls.permute(0, 2, 3, 1).reshape(B, h, w, 2, A).transpose(3, 4)
    fg = torch.softmax(pairs.reshape(B, -1, 2), -1)[..., 1]
    anchors = grid_anchors((h, w), det["feat_stride"], base_anchors(
        det["feat_stride"], det["anchor_ratios"], det["anchor_scales"]),
        x.device)
    boxes = clip(decode(anchors, reg.permute(0, 2, 3, 1).reshape(B, -1, 4)),
                 (Hb, Wb))
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    fg = torch.where((bw >= det["rpn_min_size"]) & (bh >= det["rpn_min_size"]),
                     fg, torch.full_like(fg, -1.0))
    props = []
    for i in range(B):
        order = torch.sort(fg[i], descending=True, stable=True).indices
        top = order[:det["rpn_pre_nms_top_n_test"]]
        rois, _, roi_valid = nms(boxes[i, top], fg[i, top],
                                 det["rpn_nms_thresh"],
                                 det["rpn_post_nms_top_n_test"], 0.0)
        props.append((rois, roi_valid))
    return feats.permute(0, 2, 3, 1), props


def pool(net: Detector, feats_nhwc, rois):
    det = net.det
    return roi_align(feats_nhwc, rois, det["pooling_size"],
                     det["spatial_scale"], det["sampling_ratio"])


@torch.no_grad()
def detect(net: Detector, images, q: Precision = Precision()):
    """(B, H, W, 3) RGB frames -> per image (boxes (K, 4) xyxy in frame
    coordinates, scores (K,), valid (K,)), K = max_detections."""
    det = net.det
    x, scale = blob(images, det)
    Hb, Wb = x.shape[1:3]
    feats_nhwc, props = proposals(net, x, q)
    stds = torch.tensor(det["bbox_normalize_stds"], device=images.device)
    means = torch.tensor(det["bbox_normalize_means"], device=images.device)
    out = []
    for i, (rois, roi_valid) in enumerate(props):
        logits, deltas = net.heads(net.tail(pool(net, feats_nhwc[i], rois),
                                            q), q)
        scores = torch.softmax(logits.float(), -1)[:, 1]
        d = deltas.float().reshape(len(rois), -1, 4)[:, 1] * stds + means
        b = clip(decode(rois, d), (Hb, Wb)) / scale
        scores = torch.where(roi_valid, scores, torch.zeros_like(scores))
        out.append(nms(b, scores, det["det_nms_thresh"],
                       det["max_detections"], det["det_score_thresh"]))
    return out


def crop_boxes(detections, hw, pad_factor=1.75):
    """Best detection -> square padded crop box (cx, cy, w, h); the whole
    frame, squared, where no detection is valid or the best is degenerate."""
    H, W = hw
    rows = []
    for b, s, _ in detections:
        crop = geo.bbox_from_detection(b[None], s[None], pad_factor)[0]
        full = geo.scale_bbox(torch.tensor([W / 2.0, H / 2.0, float(W),
                                            float(H)], device=b.device), 1.0)
        ok = (s.max() > 0) & (crop[2] > 0) & (crop[3] > 0)
        rows.append(torch.where(ok, crop, full))
    return torch.stack(rows)


@torch.no_grad()
def two_stage(det_net: Detector, pose_net, images, K, ref_bone_len,
              det_q: Precision = Precision(), pose_q: Precision = Precision(),
              size: int = 224):
    """Frames -> (crop boxes (B, 4), label-space coords (B, J, 3), joints in
    the camera frame (B, J, 3), metres, scaled to the reference bone); each
    net computes in its own precision, the float32 back-projection in the
    detector's."""
    with det_q:
        bbox = crop_boxes(detect(det_net, images, det_q), images.shape[1:3])
    J = pose_net.num_joints
    zeros = torch.zeros(images.shape[0], J, 3, device=images.device)
    with pose_q:
        patch, lab = eval_batch(images, zeros, K, bbox, size)
        coords = pose_net(patch, pose_q)
    with det_q:
        cam = geo.label_to_camera(coords, lab.trans_inv, lab.tprime, K, size,
                                  det_q)
    return bbox, coords, geo.scale_by_ref_bone(cam, ref_bone_len)
