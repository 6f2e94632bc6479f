"""ROIAlign and ROIPool over NHWC feature maps.

Port of hand_integral_pose_estimation_tpu/ops/roi_align.py (the reference's
lib/model_rcnn/csrc/cuda/ROIAlign_cuda.cu:15-345 and ROIPool_cuda.cu
contract): pooled x pooled bins over a stride-16 map, each the average
(align) or max (pool) of bilinear samples.

`roi_align` is the plain version, the JAX package's separable per-RoI
weights (roi_align.py:25-90): a (S, H) row and a (S, W) column weight
matrix per RoI, S = pooled * sampling_ratio, contracted with the map, then
averaged per bin. Autograd differentiates it. `roi_align_batched` takes the
image batch; on a CUDA tensor it launches kernel 6 (`csrc/roi_align.cu`),
which reads the taps directly in the same separable form (at each tap
column, the tap rows of seven pooled rows at once) instead of building the
TPU kernel's dense combined weights (`_ra_kernel`, roi_align.py:93).
Forward only: the detector's training comes in a later port and
differentiates the plain version, as the JAX package trains through its
XLA path; until then `roi_align_cuda` raises for inputs that require grad
under grad mode, so the kernel never returns a silently detached result.
"""

from __future__ import annotations

import torch

from hand_integral_pose_estimation_tpu_torch.ops import kernels


def _linear_weights(centers: torch.Tensor, size: int) -> torch.Tensor:
    """(..., S) sample centres -> (..., S, size) bilinear weight rows: a
    sample below -1 or beyond `size` contributes zero; otherwise it is
    clamped into [0, size - 1] and split over its two neighbours."""
    inside = (centers >= -1.0) & (centers <= size)
    c = torch.clamp(centers, 0.0, size - 1.0)
    grid = torch.arange(size, dtype=centers.dtype, device=centers.device)
    w = torch.clamp(1.0 - torch.abs(c[..., None] - grid), min=0.0)
    return w * inside[..., None].to(centers.dtype)


def _roi_sample_grid(rois: torch.Tensor, pooled: int, sampling_ratio: int,
                     spatial_scale: float, axis: int) -> torch.Tensor:
    """(..., 4) RoIs -> (..., pooled * sampling_ratio) sample centres along
    `axis` (0: x, 1: y), `sampling_ratio` evenly placed per bin
    (ROIAlign_cuda.cu:76-107)."""
    lo = rois[..., axis] * spatial_scale
    hi = rois[..., axis + 2] * spatial_scale
    length = torch.clamp(hi - lo, min=1.0)
    bin_size = length / pooled
    i = torch.arange(pooled * sampling_ratio, dtype=rois.dtype,
                     device=rois.device)
    bin_idx = torch.div(i, sampling_ratio, rounding_mode="floor")
    within = i - bin_idx * sampling_ratio
    return (lo[..., None] + bin_idx * bin_size[..., None]
            + (within + 0.5) * (bin_size / sampling_ratio)[..., None])


def _sampled(features: torch.Tensor, rois: torch.Tensor, pooled: int,
             spatial_scale: float, samples: int) -> torch.Tensor:
    """(B, H, W, C) x (B, R, 4) -> (B, R, pooled, samples, pooled, samples,
    C): every bilinear sample, rows contracted first."""
    B, H, W, C = features.shape
    R = rois.shape[1]
    Wy = _linear_weights(_roi_sample_grid(rois, pooled, samples,
                                          spatial_scale, 1), H)  # (B,R,S,H)
    Wx = _linear_weights(_roi_sample_grid(rois, pooled, samples,
                                          spatial_scale, 0), W)  # (B,R,S,W)
    tmp = torch.einsum("brsh,bhwc->brswc", Wy, features)
    samp = torch.einsum("brtw,brswc->brstc", Wx, tmp)        # (B,R,S,S,C)
    return samp.reshape(B, R, pooled, samples, pooled, samples, C)


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              pooled_size: int = 7, spatial_scale: float = 1.0 / 16.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign over one feature map, the plain version.

    features (H, W, C), rois (R, 4) xyxy in image coordinates ->
    (R, pooled, pooled, C). `sampling_ratio` samples per bin per axis: the
    reference passes 0 (adaptive ceil(roi / pooled)); a fixed ratio keeps
    the shapes static and matches it for RoIs of the usual size."""
    return _sampled(features[None], rois[None], pooled_size, spatial_scale,
                    sampling_ratio).mean(dim=(3, 5))[0]


def roi_align_cuda(features: torch.Tensor, rois: torch.Tensor,
                   pooled_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """Launch the ROIAlign kernel (`csrc/roi_align.cu`).

    features: contiguous CUDA (B, H, W, C) float32; rois (B, R, 4) on the
    same device, any float dtype (taken as float32). Returns
    (B, R, pooled, pooled, C) float32. The kernel has no backward: under
    grad mode, features or RoIs that require grad raise (`impl="plain"`
    is the differentiable path)."""
    if torch.is_grad_enabled() and (features.requires_grad
                                    or rois.requires_grad):
        raise RuntimeError("roi_align_cuda has no backward and would return "
                           "a result detached from inputs that require "
                           "grad: use roi_align_batched(..., impl=\"plain\") "
                           "to differentiate, or run under torch.no_grad()")
    if features.device.type != "cuda" or rois.device != features.device:
        raise ValueError(f"roi_align_cuda needs CUDA features and RoIs on "
                         f"one device, got {features.device} and "
                         f"{rois.device}")
    if features.dtype != torch.float32:
        raise TypeError(f"roi_align_cuda takes float32 features, got "
                        f"{features.dtype}")
    if features.dim() != 4 or not features.is_contiguous():
        raise ValueError(f"features must be a contiguous (B, H, W, C) "
                         f"tensor, got {tuple(features.shape)}")
    B, H, W, C = features.shape
    if rois.dim() != 3 or rois.shape[0] != B or rois.shape[2] != 4:
        raise ValueError(f"rois shape {tuple(rois.shape)} is not ({B}, R, 4)")
    R = rois.shape[1]
    if min(B, H, W, C, R, pooled_size) < 1 or not 1 <= sampling_ratio <= 8:
        raise ValueError(f"empty ROIAlign {tuple(features.shape)} x "
                         f"{tuple(rois.shape)} or sampling_ratio "
                         f"{sampling_ratio} outside 1..8")
    if B * R * pooled_size ** 2 >= 2**31:
        raise ValueError(f"{B * R} RoIs are too many for the kernel's grid")
    boxes = rois.to(torch.float32).contiguous()
    with torch.cuda.device(features.device):
        out = torch.empty(B, R, pooled_size, pooled_size, C,
                          dtype=torch.float32, device=features.device)
        kernels.ROI_ALIGN_FWD(
            features.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W, C,
            R, pooled_size, sampling_ratio, float(spatial_scale),
            torch.cuda.current_stream().cuda_stream)
    return out


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor,
                      pooled_size: int = 7,
                      spatial_scale: float = 1.0 / 16.0,
                      sampling_ratio: int = 2,
                      impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) x (B, R, 4) -> (B, R, P, P, C).

    impl: "cuda" (kernel 6, CUDA tensors, forward only: it raises for
    inputs that require grad under grad mode), "plain" (the separable
    weights, differentiable) or "auto" (the kernel for a CUDA tensor, the
    plain version for a CPU tensor)."""
    if impl == "auto":
        impl = "cuda" if features.device.type == "cuda" else "plain"
    if impl == "cuda":
        return roi_align_cuda(features, rois, pooled_size, spatial_scale,
                              sampling_ratio)
    if impl == "plain":
        return _sampled(features, rois, pooled_size, spatial_scale,
                        sampling_ratio).mean(dim=(3, 5))
    raise ValueError(f"unknown ROIAlign impl {impl!r}")


def roi_pool(features: torch.Tensor, rois: torch.Tensor,
             pooled_size: int = 7, spatial_scale: float = 1.0 / 16.0,
             samples_per_bin: int = 4) -> torch.Tensor:
    """ROI max-pool over one (H, W, C) map (the ROIPool_cuda.cu contract,
    POOLING_MODE='pool'), approximated on a dense per-bin sample grid so
    the shapes stay static: the max of each bin's samples replaces
    `roi_align`'s average. Plain PyTorch only."""
    return _sampled(features[None], rois[None], pooled_size, spatial_scale,
                    samples_per_bin).amax(dim=(3, 5))[0]
