"""Batched perspective warp (inverse-map bilinear resampling, zero border).

Port of the eval-path parts of hand_integral_pose_estimation_tpu/ops/warp.py:
`warp_axis_aligned_batch` (the eval crop, two batched matmuls the JAX
package leaves to XLA), `warp_perspective` (the single-pass bilinear
oracle) and `warp_perspective_batch` with methods "affine" and "gather".
The Pallas two-pass warp of the training augmentation is not ported yet.

Semantics of cv2.warpPerspective(..., INTER_LINEAR) with a constant-zero
border: dst(x, y) = src(H^-1 [x, y, 1]), without cv2's 1/32-pixel
quantisation of source coordinates. Inverses use `torch.linalg.inv_ex`,
which skips the host-side singularity check (a device sync per call); a
singular map gives inf/nan, as in the JAX package.
"""

from __future__ import annotations

import torch


def _bilinear_sample(image: torch.Tensor, sx: torch.Tensor,
                     sy: torch.Tensor) -> torch.Tensor:
    """Sample image (H, W, C) at float coords sx, sy (Ho, Wo); bilinear,
    zero outside."""
    H, W, C = image.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    flat = image.reshape(H * W, C)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat[idx.reshape(-1)].reshape(idx.shape + (C,))
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def warp_perspective(image: torch.Tensor, H_mat: torch.Tensor,
                     out_hw: tuple[int, int],
                     inverse: bool = False) -> torch.Tensor:
    """Warp one (H, W, C) image by a (3, 3) homography: the forward map
    src -> dst like cv2, or the dst -> src map when `inverse=True`."""
    Ho, Wo = out_hw
    Hi = H_mat if inverse else torch.linalg.inv_ex(H_mat).inverse
    ys, xs = torch.meshgrid(
        torch.arange(Ho, dtype=Hi.dtype, device=Hi.device),
        torch.arange(Wo, dtype=Hi.dtype, device=Hi.device), indexing="ij")
    u = Hi[0, 0] * xs + Hi[0, 1] * ys + Hi[0, 2]
    v = Hi[1, 0] * xs + Hi[1, 1] * ys + Hi[1, 2]
    w = Hi[2, 0] * xs + Hi[2, 1] * ys + Hi[2, 2]
    return _bilinear_sample(image.to(Hi.dtype), u / w, v / w)


def warp_axis_aligned_batch(images: torch.Tensor, H_mats: torch.Tensor,
                            out_hw: tuple[int, int],
                            inverse: bool = False) -> torch.Tensor:
    """Batched warp for AXIS-ALIGNED affine maps
    H = [[sx, 0, tx], [0, sy, ty], [0, 0, 1]], the eval crop transform.

    The inverse map is src_x = a x' + c, src_y = e y' + f, so the bilinear
    weights separate into a (B, Ws, Wo) and a (B, Hs, Ho) matrix and the
    warp is two batched matmuls, exactly single-pass bilinear with a zero
    border. Off-diagonal entries of `H_mats` are ignored: callers guarantee
    axis alignment (make_eval_batch does by construction).

    images (B, Hs, Ws, C) of any real dtype -> (B, Ho, Wo, C) in at least
    float32, computed in that type.
    """
    B, Hs, Ws, C = images.shape
    Ho, Wo = out_hw
    Hi = H_mats if inverse else torch.linalg.inv_ex(H_mats).inverse
    Hi = Hi / Hi[:, 2:3, 2:3]
    dt = torch.promote_types(images.dtype, torch.float32)
    dev = images.device
    a = Hi[:, 0, 0, None, None].to(dt)
    c = Hi[:, 0, 2, None, None].to(dt)
    e = Hi[:, 1, 1, None, None].to(dt)
    f = Hi[:, 1, 2, None, None].to(dt)
    xo = torch.arange(Wo, dtype=dt, device=dev)[None, None, :]
    xs = torch.arange(Ws, dtype=dt, device=dev)[None, :, None]
    Wx = torch.relu(1.0 - torch.abs(xs - (a * xo + c)))      # (B, Ws, Wo)
    yo = torch.arange(Ho, dtype=dt, device=dev)[None, None, :]
    ys = torch.arange(Hs, dtype=dt, device=dev)[None, :, None]
    Wy = torch.relu(1.0 - torch.abs(ys - (e * yo + f)))      # (B, Hs, Ho)
    tmp = torch.einsum("bjic,bio->bjoc", images.to(dt), Wx)
    return torch.einsum("bjoc,bjy->byoc", tmp, Wy)


def warp_perspective_batch(images: torch.Tensor, H_mats: torch.Tensor,
                           out_hw: tuple[int, int], inverse: bool = False,
                           method: str = "gather") -> torch.Tensor:
    """(B, H, W, C) x (B, 3, 3) -> (B, Ho, Wo, C).

    method: "affine" (axis-aligned maps only, see
    :func:`warp_axis_aligned_batch`) or "gather" (single-pass bilinear,
    any homography)."""
    if method == "affine":
        return warp_axis_aligned_batch(images, H_mats, out_hw, inverse)
    if method == "gather":
        return torch.stack([warp_perspective(im, hm, out_hw, inverse)
                            for im, hm in zip(images, H_mats)])
    raise ValueError(f"unknown warp method {method!r}")
