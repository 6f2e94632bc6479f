"""The kernels' calls under a mesh.

Port of hand_integral_pose_estimation_tpu/parallel/shard_ops.py, where
`shard_map` keeps each Pallas kernel partitioned. Here every rank already
holds only its rows (the data axis needs no collective: each rank runs
the kernel on its slice, and the gradient all-reduce of the train step
does the rest), so these functions deal with the model axis:

- the fused projection + soft-argmax head splits its J*D output channels
  over `model` when the joints divide the axis (`head_model_split`): each
  rank runs kernels 3 and 4 with `num_joints = J / model` on its block of
  the weight and bias, the coords are gathered over the model row, and the
  features' gradient is summed over it. No collective runs in the forward
  but the gather of the (B, J, 3) coords. A joint's softmax cannot be
  split, so when the joints do not divide the axis (J = 21 on model = 2)
  the weight is gathered, once a call, and the head runs data-parallel:
  a documented path, not an error;
- the soft-argmax decode of a heatmap whose channels are this rank's
  block (a split final projection in the unfused arm) decodes its joints
  and gathers the coords, or gathers the channels when its block splits a
  joint.

Each function passes straight through without a mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
    head_projection_integral,
)
from hand_integral_pose_estimation_tpu_torch.ops.integral import (
    softmax_integral,
)
from hand_integral_pose_estimation_tpu_torch.ops.warp import (
    warp_perspective_batch,
)
from hand_integral_pose_estimation_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_model,
)
from hand_integral_pose_estimation_tpu_torch.parallel.mesh import Mesh


def head_model_split(mesh: Optional[Mesh], num_joints: int,
                     model_axis: str = "model") -> bool:
    """True when the fused head consumes a model-split final projection in
    place (the joints divide the model axis); False means the
    data-parallel path with the whole weight runs."""
    return (mesh is not None and model_axis in mesh.axis_names
            and mesh.shape[model_axis] > 1
            and num_joints % mesh.shape[model_axis] == 0)


def sharded_softmax_integral(heatmap: torch.Tensor, num_joints: int,
                             depth: int, mesh: Optional[Mesh] = None
                             ) -> torch.Tensor:
    """`softmax_integral` of this rank's rows. The heatmap's channels are
    all J*D, or this rank's block of them from a split final projection:
    its J/model joints are decoded and the coords gathered over the model
    row, or, where the block splits a joint, the channels are gathered
    and all joints decoded."""
    if mesh is None or heatmap.shape[-1] == num_joints * depth:
        return softmax_integral(heatmap, num_joints, depth)
    if head_model_split(mesh, num_joints):
        coords = softmax_integral(heatmap,
                                  num_joints // mesh.shape["model"], depth)
        return gather_model(coords, mesh, 1)
    return softmax_integral(gather_model(heatmap, mesh, -1), num_joints,
                            depth)


def sharded_head_projection_integral(feats: torch.Tensor,
                                     weight: torch.Tensor,
                                     bias: torch.Tensor, num_joints: int,
                                     depth: int,
                                     mesh: Optional[Mesh] = None
                                     ) -> torch.Tensor:
    """The fused head of this rank's rows `feats` (B, H, W, F). `weight`
    (C, F) and `bias` (C,) are the whole projection (C = J*D) or this
    rank's block of it (`parallel.place_state`). Under a model split each
    rank decodes its J/model joints (kernels 3 and 4) and the coords are
    gathered over the model row; otherwise a block is gathered into the
    whole weight and all joints are decoded."""
    if mesh is None:
        return head_projection_integral(feats, weight, bias, num_joints,
                                        depth)
    whole = weight.shape[0] == num_joints * depth
    if head_model_split(mesh, num_joints):
        if whole:
            raise ValueError(
                "under a model split the final projection is this rank's "
                "block of it (parallel.place_state)")
        coords = head_projection_integral(
            copy_to_model(feats, mesh), weight, bias,
            num_joints // mesh.shape["model"], depth)
        return gather_model(coords, mesh, 1)
    if not whole:
        weight = gather_model(weight, mesh, 0)
        bias = gather_model(bias, mesh, 0)
    return head_projection_integral(feats, weight, bias, num_joints, depth)


def sharded_warp_perspective_batch(images: torch.Tensor,
                                   H_mats: torch.Tensor,
                                   out_hw: Tuple[int, int],
                                   mesh: Optional[Mesh] = None,
                                   inverse: bool = False,
                                   method: str = "auto") -> torch.Tensor:
    """`warp_perspective_batch` of this rank's rows: each rank warps its
    own images, with or without a mesh (no collective)."""
    return warp_perspective_batch(images, H_mats, out_hw, inverse=inverse,
                                  method=method)
