"""Rotation sampling and axis-angle math for the training augmentation.

Port of hand_integral_pose_estimation_tpu/geometry/rotation.py (reference
common/augment.py:252-280). The JAX package vmaps a per-key sampler; here a
whole batch is drawn at once from an explicit `torch.Generator` on the
compute device. The streams differ from `jax.random`'s, the distributions
are the same.
"""

from __future__ import annotations

import torch


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3), the
    closed-form Rodrigues formula (cv2.Rodrigues); a zero vector gives I."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    small = theta < 1e-8
    axis = rvec / torch.where(small, torch.ones_like(theta), theta)
    theta = theta[..., 0]
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], dim=-1),
                     torch.stack([z, zero, -x], dim=-1),
                     torch.stack([-y, x, zero], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    R = eye + s * K + (1.0 - c) * (K @ K)
    return torch.where(small[..., None], eye, R)


def rotation_z(theta: torch.Tensor) -> torch.Tensor:
    """z-axis rotation matrices (..., 3, 3) for angles (...)."""
    c, s = torch.cos(theta), torch.sin(theta)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero], dim=-1),
                        torch.stack([s, c, zero], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def _uniform(generator: torch.Generator, shape, low: float, high: float,
             dtype: torch.dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    return low + (high - low) * u


def sample_rotation_matrix(generator: torch.Generator, batch: int,
                           rot_prob: float = 0.4, z_range: float = 0.52,
                           arbitrary_range: float = 0.05,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """(batch, 3, 3) augmentation rotations R = R1 @ R2 on the generator's
    device (augment.py:252-280):

      * with probability 1 - rot_prob, R = I;
      * otherwise R1 rotates by theta1 ~ U(-z_range, z_range) about +z or -z
        (the sign of a standard normal, as the reference draws the axis);
      * R2 rotates by theta2 ~ U(-arbitrary_range, arbitrary_range) about an
        isotropic random axis.
    """
    apply = _uniform(generator, (batch,), 0.0, 1.0, dtype) > (1.0 - rot_prob)
    theta1 = _uniform(generator, (batch,), -z_range, z_range, dtype)
    sgn = torch.sign(torch.randn(batch, generator=generator,
                                 device=generator.device, dtype=dtype))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    R1 = rotation_z(sgn * theta1)
    theta2 = _uniform(generator, (batch,), -arbitrary_range, arbitrary_range,
                      dtype)
    axis = torch.randn(batch, 3, generator=generator, device=generator.device,
                       dtype=dtype)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    R = R1 @ rodrigues(axis * theta2[:, None])
    eye = torch.eye(3, dtype=dtype, device=R.device).expand(batch, 3, 3)
    return torch.where(apply[:, None, None], R, eye)


def sample_color_scale(generator: torch.Generator, batch: int,
                       color_factor: float = 0.2,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(batch, 3) per-channel colour jitter in [1 - f, 1 + f]
    (augment.py:246-248)."""
    return _uniform(generator, (batch, 3), 1.0 - color_factor,
                    1.0 + color_factor, dtype)
