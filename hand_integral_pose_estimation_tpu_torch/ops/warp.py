"""Batched perspective warp (inverse-map bilinear resampling, zero border).

Port of hand_integral_pose_estimation_tpu/ops/warp.py:
`warp_axis_aligned_batch` (the eval crop, two batched matmuls the JAX
package leaves to XLA), `warp_perspective` (the single-pass bilinear
oracle), `warp_perspective_twopass` (the training augmentation's filter) and
`warp_perspective_batch` with methods "auto", "kernel", "twopass", "affine"
and "gather".

Semantics of cv2.warpPerspective(..., INTER_LINEAR) with a constant-zero
border: dst(x, y) = src(H^-1 [x, y, 1]), without cv2's 1/32-pixel
quantisation of source coordinates. Inverses use `torch.linalg.inv_ex`,
which skips the host-side singularity check (a device sync per call); a
singular map gives inf/nan, as in the JAX package.

The two-pass warp is the TPU kernel's filter: "kernel" launches
`csrc/warp_twopass.cu` on a CUDA tensor, and `warp_perspective_twopass` is
its plain version, taken for a CPU tensor. "auto" picks between the two by
the tensor's device, so the CPU and the card compute the same filter.
"""

from __future__ import annotations

import torch

from hand_integral_pose_estimation_tpu_torch.ops import kernels


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


def _normalised_inverse(H_mats: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, 3, 3) dst -> src maps scaled so that [2, 2] = 1 (warp.py:320-321);
    its first 8 entries are the coefficients a..h of the two passes."""
    Hi = H_mats if inverse else torch.linalg.inv_ex(H_mats).inverse
    return Hi / Hi[:, 2:3, 2:3]


def _resample_2tap(src: torch.Tensor, coord: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """Resample `src` (B, ., ., C) along `dim` (1: rows, 2: columns) at the
    float positions `coord`, which has `src`'s shape without C and with the
    resampled axis replaced: the 2-tap bilinear weights 1 - frac and frac,
    equal to the TPU kernel's dense relu(1 - |i - coord|) weights, with taps
    outside the axis reading zero."""
    n = src.shape[dim]
    i0 = torch.floor(coord)
    frac = (coord - i0).to(src.dtype)[..., None]
    out = torch.zeros((), dtype=src.dtype, device=src.device)
    for idx, w in ((i0, 1.0 - frac), (i0 + 1.0, frac)):
        valid = (idx >= 0) & (idx <= n - 1)      # false for nan / inf too
        gi = torch.where(valid, idx, torch.zeros_like(idx)).long()
        vals = torch.gather(src, dim, gi[..., None].expand(
            *coord.shape, src.shape[-1]))
        out = out + torch.where(valid[..., None], vals * w,
                                torch.zeros_like(vals))
    return out


def warp_perspective_twopass(images: torch.Tensor, H_mats: torch.Tensor,
                             out_hw: tuple[int, int],
                             inverse: bool = False) -> torch.Tensor:
    """Batched homography warp as two separable 1-D resamples
    (Catmull-Smith), the plain version of the warp kernel: a batched port
    of `warp_perspective_twopass` (warp.py:77-153) at full precision.

    With Hinv normalised so that Hinv[2, 2] = 1 and coefficients a..h,
    pass A resamples every source row s horizontally at
    u*(x', s) = u(x', yA), yA = (s g x' + s - d x' - f) / (e - s h), and
    pass B every intermediate column x' vertically at
    v*(x', y') = (d x' + e y' + f) / (g x' + h y' + 1). For maps with
    cross terms (rotations) this is a different bilinear filter from the
    single-pass `warp_perspective` (warp.py:99-106); for axis-aligned maps
    the two are equal.

    images (B, Hs, Ws, C) of any real dtype -> (B, Ho, Wo, C) in at least
    float32; coordinates are computed in the wider of that and H's dtype.
    The weights are 2-tap gathers instead of the JAX function's dense
    weight matrices (the same numbers: relu(1 - |i - u|) is nonzero only
    at the two taps)."""
    B, Hs, Ws, C = images.shape
    Ho, Wo = out_hw
    Hi = _normalised_inverse(H_mats, inverse)
    dt = torch.promote_types(images.dtype, torch.float32)
    ct = torch.promote_types(dt, Hi.dtype)
    a, b, c, d, e, f, g, h = (Hi.reshape(B, 9)[:, k, None, None].to(ct)
                              for k in range(8))
    dev = images.device
    xo = torch.arange(Wo, dtype=ct, device=dev)[None, None, :]
    ys = torch.arange(Hs, dtype=ct, device=dev)[None, :, None]
    yA = (ys * g * xo + ys - d * xo - f) / (e - ys * h)
    u = (a * xo + b * yA + c) / (g * xo + h * yA + 1.0)      # (B, Hs, Wo)
    tmp = _resample_2tap(images.to(dt), u, dim=2)             # (B, Hs, Wo, C)
    yo = torch.arange(Ho, dtype=ct, device=dev)[None, :, None]
    v = (d * xo + e * yo + f) / (g * xo + h * yo + 1.0)       # (B, Ho, Wo)
    return _resample_2tap(tmp, v, dim=1)


def warp_perspective_cuda(images: torch.Tensor, H_mats: torch.Tensor,
                          out_hw: tuple[int, int],
                          inverse: bool = False) -> torch.Tensor:
    """Launch the two-pass warp kernel (`csrc/warp_twopass.cu`).

    images: contiguous CUDA (B, Hs, Ws, C) float32; H_mats (B, 3, 3) on the
    same device, any float dtype. The 8 coefficients per image are formed
    here in torch (no host sync) and handed to the kernel as float32, as
    the TPU kernel takes them. Returns (B, Ho, Wo, C) float32."""
    if images.device.type != "cuda" or H_mats.device != images.device:
        raise ValueError(f"warp_perspective_cuda needs CUDA images and maps "
                         f"on one device, got {images.device} and "
                         f"{H_mats.device}")
    if images.dtype != torch.float32:
        raise TypeError(f"warp_perspective_cuda takes float32 images, got "
                        f"{images.dtype}")
    if images.dim() != 4 or not images.is_contiguous():
        raise ValueError(f"images must be a contiguous (B, H, W, C) tensor, "
                         f"got {tuple(images.shape)}")
    B, Hs, Ws, C = images.shape
    Ho, Wo = out_hw
    if tuple(H_mats.shape) != (B, 3, 3):
        raise ValueError(f"H_mats shape {tuple(H_mats.shape)} is not "
                         f"({B}, 3, 3)")
    if min(B, Hs, Ws, C, Ho, Wo) < 1:
        raise ValueError(f"empty warp {tuple(images.shape)} -> {out_hw}")
    if B * max(Hs, Ho) * Wo >= 2**31:
        raise ValueError(f"warp of {tuple(images.shape)} -> {out_hw} is too "
                         f"large for the kernel's 32-bit indexing")
    coefs = _normalised_inverse(H_mats, inverse).reshape(B, 9)[:, :8].to(
        torch.float32).contiguous()
    with torch.cuda.device(images.device):
        tmp = torch.empty(B, Hs, Wo, C, dtype=torch.float32,
                          device=images.device)
        out = torch.empty(B, Ho, Wo, C, dtype=torch.float32,
                          device=images.device)
        kernels.WARP_TWOPASS(
            images.data_ptr(), coefs.data_ptr(), tmp.data_ptr(),
            out.data_ptr(), B, Hs, Ws, Ho, Wo, C,
            torch.cuda.current_stream().cuda_stream)
    return out


def warp_perspective_batch(images: torch.Tensor, H_mats: torch.Tensor,
                           out_hw: tuple[int, int], inverse: bool = False,
                           method: str = "auto") -> torch.Tensor:
    """(B, H, W, C) x (B, 3, 3) -> (B, Ho, Wo, C).

    method: "kernel" (the two-pass CUDA kernel, CUDA tensors only),
    "twopass" (its plain version), "auto" (the kernel for a CUDA tensor,
    "twopass" for a CPU tensor), "affine" (axis-aligned maps only, see
    :func:`warp_axis_aligned_batch`) or "gather" (single-pass bilinear,
    any homography)."""
    if method == "auto":
        method = "kernel" if images.device.type == "cuda" else "twopass"
    if method == "kernel":
        return warp_perspective_cuda(images, H_mats, out_hw, inverse)
    if method == "twopass":
        return warp_perspective_twopass(images, H_mats, out_hw, inverse)
    if method == "affine":
        return warp_axis_aligned_batch(images, H_mats, out_hw, inverse)
    if method == "gather":
        return torch.stack([warp_perspective(im, hm, out_hw, inverse)
                            for im, hm in zip(images, H_mats)])
    raise ValueError(f"unknown warp method {method!r}")
