"""Synthetic hand frames from a seed, made on the device in bulk.

The same distribution as the port's `SyntheticFreiHand(render_joints=True)`
(data/freihand.py), drawn from a torch generator instead of numpy's: noise
frames darkened to a quarter, FreiHAND-like intrinsics, a joint cloud of
+-3.5 cm about (0, 0, 0.45 m), and a 3x3 blob at each joint's projection
whose colour names the joint (j mod 3) and whose brightness its depth.
FreiHAND's JPEGs are not in the repository, and the card's machine has no
libjpeg, so the frames are rendered; the frames are the benchmark's input,
handed to the port and to the reference alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_JOINTS = 21
FOCAL = (531.9, 532.2)
CENTER_Z = 0.45
SPREAD = 0.035


@dataclasses.dataclass
class Frames:
    """n frames as host arrays, the fields of the port's host batches."""

    images: np.ndarray        # (n, H, W, 3) uint8
    K: np.ndarray             # (n, 3, 3) float32
    joint_cam: np.ndarray     # (n, J, 3) float32, metres
    ref_bone_len: np.ndarray  # (n,) float32
    labelled: np.ndarray      # (n,) bool

    def __len__(self) -> int:
        return len(self.images)


def render(n: int, seed: int, device, image_hw=(224, 224)) -> Frames:
    """`n` frames drawn from `seed` on `device`, every one labelled,
    returned on the host."""
    H, W = image_hw
    g = torch.Generator(device=device).manual_seed(seed)
    images = torch.randint(0, 255, (n, H, W, 3), generator=g, device=device,
                           dtype=torch.uint8) // 4
    K = torch.tensor([[FOCAL[0], 0, W / 2], [0, FOCAL[1], H / 2], [0, 0, 1]],
                     dtype=torch.float32, device=device).expand(n, 3, 3)
    joint_cam = (torch.rand(n, NUM_JOINTS, 3, generator=g, device=device)
                 * (2 * SPREAD) - SPREAD)
    joint_cam[..., 2] += CENTER_Z
    uvw = torch.einsum("nij,nkj->nki", K, joint_cam)
    uv = torch.round(uvw[..., :2] / uvw[..., 2:3]).long()
    z = joint_cam[..., 2]
    zn = (z - z.amin(1, keepdim=True)) / (
        z.amax(1, keepdim=True) - z.amin(1, keepdim=True)).clamp_min(1e-6)
    onehot = torch.eye(3, device=device)[torch.arange(NUM_JOINTS) % 3]
    colour = (255 * onehot[None] * (0.4 + 0.6 * zn)[..., None]).to(
        torch.uint8)                                     # (n, J, 3)
    x, y = uv[..., 0], uv[..., 1]
    inside = (x >= 1) & (x < W - 1) & (y >= 1) & (y < H - 1)
    rows = torch.arange(n, device=device)
    flat = images.view(n * H * W, 3)
    # joint by joint, as the port's loop paints them: a later joint's blob
    # covers an earlier one's
    for j in range(NUM_JOINTS):
        keep = inside[:, j]
        r, xj, yj, c = rows[keep], x[keep, j], y[keep, j], colour[keep, j]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                flat[(r * H + yj + dy) * W + xj + dx] = c
    bone = torch.linalg.vector_norm(joint_cam[:, 9] - joint_cam[:, 10], dim=-1)
    return Frames(images=images.cpu().numpy(),
                  K=K.contiguous().cpu().numpy(),
                  joint_cam=joint_cam.cpu().numpy(),
                  ref_bone_len=bone.cpu().numpy(),
                  labelled=np.ones(n, bool))


class PoolDataset:
    """A training split over `frames` with the host-batch contract of the
    port's datasets (`sample_indices`, `host_batch`): each batch draws its
    rows without replacement, so no row repeats inside a batch, and every
    batch it hands out is recorded in `served`."""

    def __init__(self, frames: Frames):
        self.frames = frames
        self.served: list[np.ndarray] = []
        self.record = True

    def __len__(self) -> int:
        return len(self.frames)

    def sample_indices(self, rng: np.random.RandomState, batch_size: int,
                       labelled_prob=None) -> np.ndarray:
        return rng.choice(len(self.frames), batch_size, replace=False)

    def host_batch(self, indices: np.ndarray) -> dict:
        i = np.asarray(indices)
        if self.record:
            self.served.append(i)
        f = self.frames
        return {
            "image": f.images[i],
            "joint_cam": f.joint_cam[i],
            "K": f.K[i],
            "ref_bone_len": f.ref_bone_len[i],
            "labelled": f.labelled[i],
            "bbox_detector": None,
            "teacher_cam_normalized": None,
        }
