"""Pinhole-camera projection math as batched tensor functions.

Port of hand_integral_pose_estimation_tpu/geometry/camera.py (reference
common/augment.py:80-121). Any leading batch shape; inputs are never
mutated. Units as in the reference: 3D points in metres, the depth channel
of pixel-space coordinates in millimetres (augment.py:87, :100). The
inverse uses `torch.linalg.inv_ex`: no host-side singularity check, so no
device sync.
"""

from __future__ import annotations

import torch


def project_points(xyz: torch.Tensor, R: torch.Tensor, K: torch.Tensor):
    """Project camera-frame points (augment.py:80-87 `projectPoints`).

    Args:
        xyz: (..., N, 3) points in metres.
        R: (..., 3, 3) rotation applied before projection.
        K: (..., 3, 3) intrinsics.

    Returns:
        uv (..., N, 2), z_mm (..., N) and the rotated points (..., N, 3).
    """
    xyz_rot = torch.einsum("...ij,...nj->...ni", R, xyz)
    uvw = torch.einsum("...ij,...nj->...ni", K, xyz_rot)
    uv = uvw[..., :2] / uvw[..., 2:3]
    z_mm = xyz_rot[..., 2] * 1000.0
    return uv, z_mm, xyz_rot


def pixel2cam(pixel_coord: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(u, v, z_mm) -> camera-frame metres, K^-1 [u, v, 1]^T * z_mm / 1000
    (augment.py:89-103 `pixel2cam`)."""
    uv1 = torch.cat([pixel_coord[..., :2],
                     torch.ones_like(pixel_coord[..., 2:3])], dim=-1)
    rays = torch.einsum("...ij,...nj->...ni", torch.linalg.inv_ex(K).inverse,
                        uv1)
    return rays * (pixel_coord[..., 2:3] / 1000.0)


def cam2pixel(xyz: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame metres -> (u, v, z_mm); inverse of :func:`pixel2cam`."""
    uvw = torch.einsum("...ij,...nj->...ni", K, xyz)
    uv = uvw[..., :2] / uvw[..., 2:3]
    return torch.cat([uv, xyz[..., 2:3] * 1000.0], dim=-1)
