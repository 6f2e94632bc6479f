"""Two-stage inference: raw image -> detector -> crop -> pose -> 3D joints.

Port of hand_integral_pose_estimation_tpu/inference.py, the production
path of BASELINE config 4 (the reference's `HandDetector.detect` ->
`find_bb_hand_detector` square + pad crop -> `generate_input_unlabelled`
-> pose net -> integral -> back-projection). Everything runs on one device
with no host round trip: the detector (kernels 7 and 6 on the card), the
eval crop, the pose net's features, the fused projection + soft-argmax
(kernel 3) and the camera back-projection. The JAX package compiles the
stages into one program; eagerly they are issued one after another. With
int8 post-training quantization (`int8_calib`) both nets' convs and
Linears run as int8 products (`quantize/ptq.py`); the kernels stay the
same.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.data import pipeline
from hand_integral_pose_estimation_tpu_torch.detect.hand_detector import (
    detect_hand_crop_bbox,
)
from hand_integral_pose_estimation_tpu_torch.evaluation import metrics
from hand_integral_pose_estimation_tpu_torch.geometry import labels
from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
    head_projection_integral,
)
from hand_integral_pose_estimation_tpu_torch.quantize import (
    Quantized,
    calibrate,
    quantize_params,
    quantized_calls,
    verify_source_params,
)


class PipelineOutput(NamedTuple):
    joints_cam: torch.Tensor      # (B, J, 3) metric camera-frame joints
    coords_label: torch.Tensor    # (B, J, 3) raw integral outputs
    crop_bbox: torch.Tensor       # (B, 4) detector-derived crop box
    tprime: torch.Tensor          # (B,)


class TwoStagePipeline:
    """A detector and a pose net behind one callable, on `device` (the card
    unless the caller asks for the CPU). Both models are moved there and
    put in eval mode.

    `split_detector=True` runs the detector as its two halves
    (`detect_split`).

    With `int8_calib`, both nets' convs, transposed convs and Linears run
    as s8 x s8 -> s32 products (`quantize`). It is either
    `(images_rgb, K, ref_bone_len)`, calibration inputs that the pipeline
    itself runs once per net in float to take each module's input scale,
    or a pre-built `(q_pose, q_det)` pair of bundles carrying their root
    types (`quantize.load_quantized(path, root_type=...)`), checked against
    the nets' weights. The heatmap projection stays in float: kernel 3
    reads its weights directly. The bundles land on
    `self.quantized = (q_pose, q_det)`. As in the JAX package, int8 does
    not compose with `split_detector`. `mesh` (multi-GPU serving) comes
    with the port of `parallel/` and raises."""

    def __init__(self, cfg: Config, pose_net: nn.Module, detector: nn.Module,
                 device: str | torch.device = "cuda",
                 split_detector: bool = False, mesh=None, int8_calib=None):
        if mesh is not None:
            raise NotImplementedError(
                "TwoStagePipeline(mesh=...): multi-GPU serving comes with "
                "the port of parallel/")
        if split_detector and int8_calib is not None:
            raise ValueError("split_detector does not compose with "
                             "int8_calib (as in the JAX package)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.pose_net = pose_net.to(self.device).eval()
        self.detector = detector.to(self.device).eval()
        self.split_detector = split_detector
        self.quantized = None
        self._int8 = ()
        if int8_calib is not None:
            self.quantized = self._quantize(int8_calib)
            q_pose, q_det = self.quantized
            self._int8 = (quantized_calls(q_det, self.detector),
                          quantized_calls(q_pose, self.pose_net))

    def _quantize(self, int8_calib):
        """(q_pose, q_det) from pre-built bundles, checked, or calibrated
        through the pipeline on the given inputs, one net at a time."""
        if (len(int8_calib) == 2
                and all(isinstance(x, Quantized) for x in int8_calib)):
            q_pose, q_det = int8_calib
            for q, want in ((q_pose, type(self.pose_net)),
                            (q_det, type(self.detector))):
                if q.root_type is None:
                    raise ValueError(
                        f"pre-built int8 bundles must carry root_type "
                        f"(expected {want.__name__}); load them with "
                        f"quantize.load_quantized(path, root_type=ModelCls)")
                if q.root_type is not want:
                    raise ValueError(
                        f"int8 bundle order is (q_pose, q_det): got a "
                        f"{q.root_type.__name__} bundle where a "
                        f"{want.__name__} one was expected")
            verify_source_params(q_pose, self.pose_net, "pose net")
            verify_source_params(q_det, self.detector, "detector")
            return q_pose, q_det
        images, K, ref = int8_calib
        K, ref = self._tensor(K), self._tensor(ref)

        def run(im):
            return self(im, K, ref)

        amax_det = calibrate(run, images, model=self.detector)
        amax_pose = calibrate(run, images, model=self.pose_net)
        q_det = dataclasses.replace(quantize_params(self.detector, amax_det),
                                    root_type=type(self.detector))
        q_pose = dataclasses.replace(
            quantize_params(self.pose_net, amax_pose,
                            skip=("head.final_layer",)),
            root_type=type(self.pose_net))
        return q_pose, q_det

    def _tensor(self, x) -> torch.Tensor:
        """A host array goes to a card through pinned memory with a
        non-blocking copy, so the host does not wait for the stream."""
        t = x if torch.is_tensor(x) else torch.from_numpy(
            np.ascontiguousarray(x))
        if t.device.type == "cpu" and self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _pose_stage(self, images_rgb: torch.Tensor, bbox: torch.Tensor,
                    K: torch.Tensor, ref_bone_len: torch.Tensor
                    ) -> PipelineOutput:
        """Stage 2 from a given crop box (JAX inference.py:167-190): the
        R = I eval crop, the pose net's features, the fused projection +
        decode, back-projection without derotation, the bone rescale."""
        m = self.cfg.model
        J, D = m.num_joints, m.depth_dim
        ph, pw = m.input_shape
        batch = pipeline.make_eval_batch(
            images_rgb, torch.zeros(images_rgb.shape[0], J, 3, dtype=K.dtype,
                                    device=K.device),
            K, bbox, ref_bone_len, self.cfg.augment, m.input_shape)
        feats = self.pose_net(batch.image, return_features=True)
        weight, bias = self.pose_net.final_projection()
        coords = head_projection_integral(feats, weight, bias, J, D)
        cam = labels.patch_label_to_camera(
            coords, batch.trans_inv, batch.tprime, K, R=None,
            patch_width=pw, patch_height=ph, derotate=False)
        cam = metrics.scale_by_ref_bone(cam, ref_bone_len)
        return PipelineOutput(joints_cam=cam, coords_label=coords,
                              crop_bbox=bbox, tprime=batch.tprime)

    @torch.inference_mode()
    def __call__(self, images_rgb, K, ref_bone_len) -> PipelineOutput:
        """images_rgb (B, H, W, 3) uint8 or float, K (B, 3, 3), ref_bone_len
        (B,): tensors or numpy arrays, moved to the pipeline's device."""
        images_rgb = self._tensor(images_rgb)
        K = self._tensor(K)
        ref_bone_len = self._tensor(ref_bone_len)
        with contextlib.ExitStack() as int8:
            for calls in self._int8:
                int8.enter_context(calls)
            bbox = detect_hand_crop_bbox(
                self.detector, images_rgb, self.cfg.detector,
                pad_factor=self.cfg.augment.pad_factor,
                split=self.split_detector)
            return self._pose_stage(images_rgb, bbox.to(K.dtype), K,
                                    ref_bone_len)
