"""Batched perspective warp (inverse-map bilinear resampling, zero border).

Port of hand_integral_pose_estimation_tpu/ops/warp.py:
`warp_axis_aligned_batch` (the eval crop, two batched matmuls the JAX
package leaves to XLA), `warp_perspective` (the single-pass bilinear
oracle), `warp_perspective_twopass` (the training augmentation's filter) and
`warp_perspective_batch` with methods "auto", "kernel", "twopass", "affine"
and "gather".

Semantics of cv2.warpPerspective(..., INTER_LINEAR) with a constant-zero
border: dst(x, y) = src(H^-1 [x, y, 1]), without cv2's 1/32-pixel
quantisation of source coordinates. The two-pass warp forms H^-1 scaled to
[2, 2] = 1 from the float64 adjugate (`warp_coefficients`): a map whose
determinant is exactly 0 gives nan coefficients, and a nan source position
gives a nan pixel, as in the JAX package; a position at +-inf reads 0.
The single-pass and axis-aligned warps invert with `torch.linalg.inv_ex`,
which skips the host-side singularity check (a device sync per call).

The two-pass warp is the TPU kernel's filter: "kernel" launches
`csrc/warp_twopass.cu` on a CUDA tensor, and `warp_perspective_twopass` is
its plain version, taken for a CPU tensor. "auto" picks between the two by
the tensor's device, so the CPU and the card compute the same filter.
`warp_normalise_batch` is the training path's call: one launch from the
stored uint8 frames to the normalised patch on the card, the plain chain
`warp_normalise_twopass` on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

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


def warp_coefficients(H_mats: torch.Tensor, inverse: bool = False,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, 3, 3) maps -> (B, 8) coefficients a..h of the dst -> src map
    scaled so that its [2, 2] entry is 1 (warp.py:320-322), the kernel's
    prologue operation for operation.

    In float64: for `inverse=False` the adjugate of the forward map, its
    nine 2x2 minors each formed as p*q - r*s (Hinv / Hinv[2, 2] = adj / adj
    [2, 2]: the determinant cancels), nan where the determinant is exactly
    0, as `jnp.linalg.inv` gives; for `inverse=True` the map itself. Divided
    by the [2, 2] entry in float64 and rounded once to `dtype`, the type
    of the warp's positions."""
    m = H_mats.to(torch.float64).reshape(-1, 9)
    if not inverse:
        h = m.unbind(1)

        def minor(p, q, r, s):
            return h[p] * h[q] - h[r] * h[s]

        adj = (minor(4, 8, 5, 7), minor(2, 7, 1, 8), minor(1, 5, 2, 4),
               minor(5, 6, 3, 8), minor(0, 8, 2, 6), minor(2, 3, 0, 5),
               minor(3, 7, 4, 6), minor(1, 6, 0, 7), minor(0, 4, 1, 3))
        det = h[0] * adj[0] + h[1] * adj[3] + h[2] * adj[6]
        m = torch.stack(adj, 1).masked_fill((det == 0)[:, None], math.nan)
    return (m[:, :8] / m[:, 8:]).to(dtype)


def _resample_2tap(src: torch.Tensor, coord: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """Resample `src` (B, ., ., C) along `dim` (1: rows, 2: columns) at the
    float positions `coord`, which has `src`'s shape without C and with the
    resampled axis replaced: the 2-tap bilinear weights 1 - frac and frac,
    equal to the TPU kernel's dense relu(1 - |i - coord|) weights, with taps
    outside the axis reading zero. A nan position gives nan, a +-inf one 0,
    as the dense weights give them."""
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
    return out.masked_fill(torch.isnan(coord)[..., None], math.nan)


def warp_perspective_twopass(images: torch.Tensor, H_mats: torch.Tensor,
                             out_hw: tuple[int, int],
                             inverse: bool = False) -> torch.Tensor:
    """Batched homography warp as two separable 1-D resamples
    (Catmull-Smith), the plain version of the warp kernel: a batched port
    of `warp_perspective_twopass` (warp.py:77-153) at full precision.

    With Hinv normalised so that Hinv[2, 2] = 1 and coefficients a..h
    (:func:`warp_coefficients`), pass A resamples every source row s
    horizontally at u*(x', s) = u(x', yA),
    yA = (s g x' + s - d x' - f) / (e - s h), and pass B every intermediate
    column x' vertically at v*(x', y') = (d x' + e y' + f) / (g x' + h y'
    + 1). For maps with cross terms (rotations) this is a different
    bilinear filter from the single-pass `warp_perspective` (warp.py:
    99-106); for axis-aligned maps the two are equal.

    images (B, Hs, Ws, C) of any real dtype -> (B, Ho, Wo, C) in the wider
    of that and float32; the coefficients and positions are in the wider of
    that and H's dtype (float32 for float32 frames and maps, as the TPU
    kernel takes them). The weights are 2-tap gathers instead of the JAX
    function's dense weight matrices (the same numbers: relu(1 - |i - u|)
    is nonzero only at the two taps)."""
    B, Hs, Ws, C = images.shape
    Ho, Wo = out_hw
    dt = torch.promote_types(images.dtype, torch.float32)
    ct = torch.promote_types(dt, H_mats.dtype)
    a, b, c, d, e, f, g, h = (
        k[:, None, None] for k in warp_coefficients(H_mats, inverse,
                                                    ct).unbind(1))
    dev = images.device
    xo = torch.arange(Wo, dtype=ct, device=dev)[None, None, :]
    ys = torch.arange(Hs, dtype=ct, device=dev)[None, :, None]
    yA = (ys * g * xo + ys - d * xo - f) / (e - ys * h)
    u = (a * xo + b * yA + c) / (g * xo + h * yA + 1.0)      # (B, Hs, Wo)
    tmp = _resample_2tap(images.to(dt), u, dim=2)             # (B, Hs, Wo, C)
    yo = torch.arange(Ho, dtype=ct, device=dev)[None, :, None]
    v = (d * xo + e * yo + f) / (g * xo + h * yo + 1.0)       # (B, Ho, Wo)
    return _resample_2tap(tmp, v, dim=1)


def channel_constant(values, like: torch.Tensor) -> torch.Tensor:
    """(C,) tensor of `values` on `like`'s device, written by fill kernels:
    a blocking host-to-device copy would wait for the stream to drain."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype,
                                   device=like.device) for v in values])


def normalise_patch(patch: torch.Tensor, colour: torch.Tensor, mean,
                    std) -> torch.Tensor:
    """clamp((patch - mean) / std * colour, 0, 255), the training patch's
    normalisation (the JAX package's data/pipeline.py:55-60): `mean` and `std` hold one float
    per channel, `colour` broadcasts against `patch`. nan passes the clamp,
    as in `jnp.clip`."""
    return torch.clamp((patch - channel_constant(mean, patch))
                       / channel_constant(std, patch) * colour, 0.0, 255.0)


def warp_normalise_twopass(images: torch.Tensor, H_mats: torch.Tensor,
                           out_hw: tuple[int, int], colour: torch.Tensor,
                           mean, std, inverse: bool = False) -> torch.Tensor:
    """The plain version of the fused kernel call: the stored frames
    (B, Hs, Ws, C) of any real dtype (uint8 frames become float32, exactly)
    warped by :func:`warp_perspective_twopass`, then
    :func:`normalise_patch` with the per-image colour scale (B, C)."""
    patch = warp_perspective_twopass(images, H_mats, out_hw, inverse)
    return normalise_patch(patch, colour.to(patch.dtype)[:, None, None, :],
                           mean, std)


@functools.lru_cache(maxsize=None)
def _mean_std_block(mean: tuple, std: tuple):
    """(array, its address): the epilogue's means then stds as a host
    float32 array, which the C entry copies into the kernel's parameters.
    The cache keeps the array alive for every launch that reads it."""
    block = (ctypes.c_float * (2 * len(mean)))(*mean, *std)
    return block, ctypes.addressof(block)


_IMAGE_DTYPES = {torch.float32: 0, torch.uint8: 1}
_MAP_DTYPES = {torch.float32: 0, torch.float64: 1}


def warp_perspective_cuda(images: torch.Tensor, H_mats: torch.Tensor,
                          out_hw: tuple[int, int], inverse: bool = False,
                          normalise=None) -> torch.Tensor:
    """Launch the warp kernel (`csrc/warp_twopass.cu`): one launch from the
    frames to the (optionally normalised) patch.

    images: contiguous CUDA (B, Hs, Ws, C) uint8 or float32; H_mats
    (B, 3, 3) float32 or float64 on the same device, any strides. The
    kernel forms the coefficients itself, as :func:`warp_coefficients`
    does, and its positions in the map's type, as the plain version
    does. `normalise`: None, or (colour, mean, std) with colour a
    contiguous (B, C) float32 tensor on the device and mean, std C floats
    each (C <= 4), for :func:`warp_normalise_twopass`'s epilogue. Returns
    (B, Ho, Wo, C) float32; nothing else runs on the device. The kernel has
    no backward: under grad mode, inputs that require grad raise (method
    "twopass" is the differentiable path)."""
    colour = None if normalise is None else normalise[0]
    if torch.is_grad_enabled() and (
            images.requires_grad or H_mats.requires_grad
            or (colour is not None and colour.requires_grad)):
        raise RuntimeError("warp_perspective_cuda has no backward and would "
                           "return a result detached from inputs that "
                           "require grad: use warp_perspective_batch(..., "
                           "method=\"twopass\") to differentiate, or run "
                           "under torch.no_grad()")
    dev = images.device
    if dev.type != "cuda" or H_mats.device != dev:
        raise ValueError(f"warp_perspective_cuda needs CUDA images and maps "
                         f"on one device, got {dev} and {H_mats.device}")
    image_code = _IMAGE_DTYPES.get(images.dtype)
    map_code = _MAP_DTYPES.get(H_mats.dtype)
    if image_code is None or map_code is None:
        raise TypeError(f"warp_perspective_cuda takes uint8 or float32 "
                        f"images and float32 or float64 maps, got "
                        f"{images.dtype} and {H_mats.dtype}")
    if images.dim() != 4 or not images.is_contiguous():
        raise ValueError(f"images must be a contiguous (B, H, W, C) tensor, "
                         f"got {tuple(images.shape)}")
    B, Hs, Ws, C = images.shape
    Ho, Wo = out_hw
    if H_mats.shape != (B, 3, 3):
        raise ValueError(f"H_mats shape {tuple(H_mats.shape)} is not "
                         f"({B}, 3, 3)")
    if min(B, Hs, Ws, C, Ho, Wo) < 1:
        raise ValueError(f"empty warp {tuple(images.shape)} -> {out_hw}")
    if Hs * Ws * C >= 2**31:
        raise ValueError(f"frames of {(Hs, Ws, C)} are too large for the "
                         f"kernel's 32-bit offsets within a frame")
    block = colour_ptr = None
    if normalise is not None:
        mean, std = tuple(normalise[1]), tuple(normalise[2])
        if (colour.device != dev or colour.dtype != torch.float32
                or colour.shape != (B, C) or not colour.is_contiguous()):
            raise ValueError(f"colour must be a contiguous ({B}, {C}) "
                             f"float32 tensor on {dev}, got "
                             f"{tuple(colour.shape)} {colour.dtype} on "
                             f"{colour.device}")
        if not len(mean) == len(std) == C <= 4:
            raise ValueError(f"the epilogue takes one mean and std per "
                             f"channel, at most 4 channels: got {len(mean)} "
                             f"and {len(std)} for C = {C}")
        block = _mean_std_block(mean, std)[1]
        colour_ptr = colour.data_ptr()
    with torch.cuda.device(dev):
        out = torch.empty(B, Ho, Wo, C, dtype=torch.float32, device=dev)
        kernels.WARP_TWOPASS(
            images.data_ptr(), image_code, H_mats.data_ptr(), map_code,
            *H_mats.stride(), int(inverse), colour_ptr, block,
            out.data_ptr(), B, Hs, Ws, Ho, Wo, C,
            kernels.stream_handle(dev.index))
    return out


def warp_normalise_batch(images: torch.Tensor, H_mats: torch.Tensor,
                         out_hw: tuple[int, int], colour: torch.Tensor, mean,
                         std, inverse: bool = False,
                         method: str = "auto") -> torch.Tensor:
    """Stored frames (B, Hs, Ws, C) -> normalised patch (B, Ho, Wo, C):
    :func:`warp_normalise_twopass`'s function. method: "kernel" (one launch
    of the warp kernel with its epilogue; CUDA tensors only, uint8 or
    float32 frames), "twopass" (the plain chain) or "auto" (the kernel for
    a CUDA tensor, the plain chain for a CPU one)."""
    if method == "auto":
        method = "kernel" if images.device.type == "cuda" else "twopass"
    if method == "kernel":
        return warp_perspective_cuda(images, H_mats, out_hw, inverse,
                                     normalise=(colour, mean, std))
    if method == "twopass":
        return warp_normalise_twopass(images, H_mats, out_hw, colour, mean,
                                      std, inverse)
    raise ValueError(f"unknown warp method {method!r}")


def warp_perspective_batch(images: torch.Tensor, H_mats: torch.Tensor,
                           out_hw: tuple[int, int], inverse: bool = False,
                           method: str = "auto") -> torch.Tensor:
    """(B, H, W, C) x (B, 3, 3) -> (B, Ho, Wo, C).

    method: "kernel" (the two-pass CUDA kernel, CUDA tensors only,
    forward only: it raises for inputs that require grad under grad mode),
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
