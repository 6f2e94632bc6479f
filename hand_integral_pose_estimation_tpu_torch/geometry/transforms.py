"""2D projective transforms: homographies, the bbox -> patch crop, point maps.

Port of hand_integral_pose_estimation_tpu/geometry/transforms.py (reference
common/augment.py:448-517). Every map is a (..., 3, 3) matrix, so the crop
and the rotation compose into one homography and an image is resampled
once. Solves and inverses use the `_ex` forms, which skip the host-side
singularity check (a device sync per call); a singular system gives
inf/nan, as in the JAX package.
"""

from __future__ import annotations

import torch


def get_perspective_transform(src: torch.Tensor,
                              dst: torch.Tensor) -> torch.Tensor:
    """Homography with dst ~ H @ src from 4 point pairs: the 8x8 system of
    cv2.getPerspectiveTransform (augment.py:502-504), h33 = 1.

    Args:
        src, dst: (..., 4, 2).

    Returns:
        (..., 3, 3).
    """
    x, y = src[..., 0], src[..., 1]
    X, Y = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    ax = torch.stack([x, y, ones, zeros, zeros, zeros, -X * x, -X * y], dim=-1)
    ay = torch.stack([zeros, zeros, zeros, x, y, ones, -Y * x, -Y * y], dim=-1)
    A = torch.cat([ax, ay], dim=-2)
    b = torch.cat([X, Y], dim=-1)
    h = torch.linalg.solve_ex(A, b[..., None]).result[..., 0]
    h = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    return h.reshape(h.shape[:-1] + (3, 3))


def patch_corner_points(c_x, c_y, src_w, src_h, dst_w, dst_h, scale=1.0):
    """The 4 src/dst correspondences of the bbox -> patch crop, in the
    reference's corner order (augment.py:476-499): left-top, left-bottom,
    right-top, right-bottom of the scaled box map to (0, 0), (0, H), (W, 0),
    (W, H)."""
    c_x, c_y = torch.as_tensor(c_x), torch.as_tensor(c_y)
    w = torch.as_tensor(src_w) * scale
    h = torch.as_tensor(src_h) * scale
    src = torch.stack([
        torch.stack([c_x - w * 0.5, c_y - h * 0.5], dim=-1),
        torch.stack([c_x - w * 0.5, c_y + h * 0.5], dim=-1),
        torch.stack([c_x + w * 0.5, c_y - h * 0.5], dim=-1),
        torch.stack([c_x + w * 0.5, c_y + h * 0.5], dim=-1),
    ], dim=-2)
    W, H = float(dst_w), float(dst_h)
    dst = torch.tensor([[0.0, 0.0], [0.0, H], [W, 0.0], [W, H]],
                       dtype=src.dtype, device=src.device)
    return src, dst.expand(src.shape)


def trans_from_patch(c_x, c_y, src_w, src_h, dst_w, dst_h, scale=1.0,
                     inv=False) -> torch.Tensor:
    """bbox -> patch transform (augment.py:457-506 `gen_trans_from_patch_cv`;
    the patch -> image map with `inv=True`).

    The 4 correspondences are the corners of two axis-aligned rectangles, so
    the map is a scale and a translation, built in closed form. Box values
    are tensors (or floats) of any batch shape; the sizes are numbers.
    Returns (..., 3, 3) with last row [0, 0, 1].
    """
    c_x = torch.as_tensor(c_x)
    dt = torch.promote_types(c_x.dtype, torch.float32)
    c_x = c_x.to(dt)
    c_y = torch.as_tensor(c_y).to(dt)
    w = torch.as_tensor(src_w).to(dt) * scale
    h = torch.as_tensor(src_h).to(dt) * scale
    sx = dst_w / w
    sy = dst_h / h
    tx = -sx * (c_x - w * 0.5)
    ty = -sy * (c_y - h * 0.5)
    if inv:
        sx, sy = 1.0 / sx, 1.0 / sy
        tx = c_x - dst_w * 0.5 * sx
        ty = c_y - dst_h * 0.5 * sy
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    return torch.stack([torch.stack([sx, zero, tx], dim=-1),
                        torch.stack([zero, sy, ty], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def rotation_homography(K: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Camera rotation as an image warp, K R K^-1 (augment.py:370)."""
    return K @ R @ torch.linalg.inv_ex(K).inverse


def transform_points_2d(points: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) homographies to (..., N, 2) points with the
    projective divide (augment.py:508-511 `trans_point2d`, batched)."""
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    out = torch.einsum("...ij,...nj->...ni", H, pts_h)
    return out[..., :2] / out[..., 2:3]
