"""ROIAlign and ROIPool over NHWC feature maps.

Port of hand_integral_pose_estimation_tpu/ops/roi_align.py (the reference's
lib/model_rcnn/csrc/cuda/ROIAlign_cuda.cu:15-345 and ROIPool_cuda.cu
contract): pooled x pooled bins over a stride-16 map, each the average
(align) or max (pool) of bilinear samples.

`roi_align` is the plain version, the JAX package's separable per-RoI
weights (roi_align.py:25-90): a (S, H) row and a (S, W) column weight
matrix per RoI, S = pooled * sampling_ratio, contracted with the map, then
averaged per bin. Autograd differentiates it in the features and the RoIs.
`roi_align_batched` takes the image batch; on a CUDA tensor it launches
kernel 6 (`csrc/roi_align.cu`), which reads the taps directly in the same
separable form (at each tap column, the tap rows of seven pooled rows at
once) instead of building the TPU kernel's dense combined weights
(`_ra_kernel`, roi_align.py:93). On the card it is a
`torch.autograd.Function` whose backward is the kernel
`csrc/roi_align_bwd.cu`: the plain version's VJP with respect to the
features, one CTA per (image, channel slice) holding that slice of the
gradient in shared memory and adding the RoIs' separable contractions
(columns, then rows) in RoI order, each output owned by one thread at a
time (the same bits every run).
It gives the RoIs no gradient: detector training detaches its proposals,
as the reference's approximate joint training does, and RoIs that require
grad under grad mode raise (`impl="plain"` differentiates them).
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


def _check_geometry(what: str, dev_tensor: torch.Tensor, rois: torch.Tensor,
                    B: int, H: int, W: int, C: int, pooled: int,
                    sampling_ratio: int, max_pooled: int) -> int:
    """The kernels' common argument checks; returns R."""
    if dev_tensor.device.type != "cuda" or rois.device != dev_tensor.device:
        raise ValueError(f"{what} needs CUDA tensors and RoIs on one "
                         f"device, got {dev_tensor.device} and {rois.device}")
    if rois.dim() != 3 or rois.shape[0] != B or rois.shape[2] != 4:
        raise ValueError(f"rois shape {tuple(rois.shape)} is not ({B}, R, 4)")
    R = rois.shape[1]
    if (min(B, H, W, C, R, pooled) < 1 or pooled > max_pooled
            or not 1 <= sampling_ratio <= 8):
        raise ValueError(f"{what}: empty ROIAlign ({B}, {H}, {W}, {C}) x "
                         f"{tuple(rois.shape)}, pooled {pooled} outside "
                         f"1..{max_pooled} or sampling_ratio "
                         f"{sampling_ratio} outside 1..8")
    if B * R * pooled ** 2 >= 2**31 or B * H * W >= 2**31:
        raise ValueError(f"{what}: {B * R} RoIs or a ({B}, {H}, {W}) map are "
                         f"too many for the kernel's grid")
    return R


def _roi_align_fwd(features: torch.Tensor, boxes: torch.Tensor, pooled: int,
                   spatial_scale: float, sampling_ratio: int) -> torch.Tensor:
    """Launch kernel 6 on checked, contiguous float32 inputs."""
    B, H, W, C = features.shape
    R = boxes.shape[1]
    with torch.cuda.device(features.device):
        out = torch.empty(B, R, pooled, pooled, C, dtype=torch.float32,
                          device=features.device)
        kernels.ROI_ALIGN_FWD(
            features.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W, C,
            R, pooled, sampling_ratio, float(spatial_scale),
            torch.cuda.current_stream().cuda_stream)
    return out


#: the largest pooled size of the backward kernel (one bit per pooled row)
MAX_POOLED_BWD = 32


def roi_align_bwd_cuda(g: torch.Tensor, rois: torch.Tensor, feature_hw,
                       spatial_scale: float = 1.0 / 16.0,
                       sampling_ratio: int = 2) -> torch.Tensor:
    """Launch the ROIAlign backward kernel (`csrc/roi_align_bwd.cu`): the
    gradient of the features for the cotangent `g` of the pooled output.

    g: CUDA (B, R, P, P, C), taken as contiguous float32; rois (B, R, 4) on
    the same device, any float dtype (taken as float32); feature_hw the
    map's (H, W). Returns (B, H, W, C) float32. P is at most 32. The
    kernel reads each image's cotangent once when a 32-channel slice of
    its gradient fits in shared memory, else once per band of rows a RoI
    crosses."""
    B, R, P, P2, C = g.shape
    H, W = int(feature_hw[0]), int(feature_hw[1])
    if P != P2:
        raise ValueError(f"cotangent shape {tuple(g.shape)} is not "
                         f"(B, R, P, P, C)")
    _check_geometry("roi_align_bwd_cuda", g, rois, B, H, W, C, P,
                    sampling_ratio, MAX_POOLED_BWD)
    if rois.shape[1] != R:
        raise ValueError(f"{rois.shape[1]} RoIs for a cotangent of {R}")
    grad_out = g.to(torch.float32).contiguous()
    boxes = rois.detach().to(torch.float32).contiguous()
    with torch.cuda.device(g.device):
        grad = torch.empty(B, H, W, C, dtype=torch.float32, device=g.device)
        ws = torch.empty(kernels.roi_align_bwd_workspace(B, R, H, W, P),
                         dtype=torch.uint8, device=g.device)
        kernels.ROI_ALIGN_BWD(
            grad_out.data_ptr(), boxes.data_ptr(), grad.data_ptr(),
            ws.data_ptr(), B, H, W, C, R, P, sampling_ratio,
            float(spatial_scale), torch.cuda.current_stream().cuda_stream)
    return grad


def roi_align_bwd_plain(g: torch.Tensor, rois: torch.Tensor, feature_hw,
                        spatial_scale: float = 1.0 / 16.0,
                        sampling_ratio: int = 2) -> torch.Tensor:
    """The backward kernel's plain version: autograd's VJP of the plain
    ROIAlign with respect to the features (it is linear in them, so the
    point it is taken at does not matter)."""
    B, R, P, _, C = g.shape
    H, W = int(feature_hw[0]), int(feature_hw[1])
    with torch.enable_grad():
        f = torch.zeros(B, H, W, C, dtype=g.dtype, device=g.device,
                        requires_grad=True)
        out = _sampled(f, rois.detach().to(g.dtype), P, spatial_scale,
                       sampling_ratio).mean(dim=(3, 5))
        (grad,) = torch.autograd.grad(out, f, g)
    return grad


class _RoIAlignCuda(torch.autograd.Function):
    """Kernel 6 forward, the backward kernel for the features' gradient;
    the RoIs are constants."""

    @staticmethod
    def forward(ctx, features, boxes, pooled, spatial_scale, sampling_ratio):
        ctx.save_for_backward(boxes)
        ctx.geometry = (features.shape[1:3], spatial_scale, sampling_ratio)
        return _roi_align_fwd(features, boxes, pooled, spatial_scale,
                              sampling_ratio)

    @staticmethod
    def backward(ctx, g):
        (boxes,) = ctx.saved_tensors
        hw, spatial_scale, sampling_ratio = ctx.geometry
        grad = roi_align_bwd_cuda(g, boxes, hw, spatial_scale, sampling_ratio)
        return grad, None, None, None, None


def roi_align_cuda(features: torch.Tensor, rois: torch.Tensor,
                   pooled_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """Launch the ROIAlign kernel (`csrc/roi_align.cu`), differentiable in
    the features through the backward kernel (`csrc/roi_align_bwd.cu`).

    features: contiguous CUDA (B, H, W, C) float32; rois (B, R, 4) on the
    same device, any float dtype (taken as float32). Returns
    (B, R, pooled, pooled, C) float32. The RoIs get no gradient: under grad
    mode, RoIs that require grad raise (`impl="plain"` differentiates
    them)."""
    if torch.is_grad_enabled() and rois.requires_grad:
        raise RuntimeError("roi_align_cuda gives the RoIs no gradient and "
                           "would detach them silently: detach the RoIs, or "
                           "use roi_align_batched(..., impl=\"plain\") to "
                           "differentiate them")
    if features.dtype != torch.float32:
        raise TypeError(f"roi_align_cuda takes float32 features, got "
                        f"{features.dtype}")
    if features.dim() != 4 or not features.is_contiguous():
        raise ValueError(f"features must be a contiguous (B, H, W, C) "
                         f"tensor, got {tuple(features.shape)}")
    B, H, W, C = features.shape
    max_pooled = (MAX_POOLED_BWD if torch.is_grad_enabled()
                  and features.requires_grad else 2**15)
    _check_geometry("roi_align_cuda", features, rois, B, H, W, C, pooled_size,
                    sampling_ratio, max_pooled)
    boxes = rois.detach().to(torch.float32).contiguous()
    return _RoIAlignCuda.apply(features, boxes, pooled_size, spatial_scale,
                               sampling_ratio)


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor,
                      pooled_size: int = 7,
                      spatial_scale: float = 1.0 / 16.0,
                      sampling_ratio: int = 2,
                      impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) x (B, R, 4) -> (B, R, P, P, C).

    impl: "cuda" (kernel 6 and its backward kernel, CUDA tensors,
    differentiable in the features only: RoIs that require grad raise under
    grad mode), "plain" (the separable weights, differentiable in both) or
    "auto" (the kernels for a CUDA tensor, the plain version for a CPU
    tensor)."""
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
