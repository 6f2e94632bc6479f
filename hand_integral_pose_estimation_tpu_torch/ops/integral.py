"""Softmax-integral (soft-argmax) decode of an NHWC 3D heatmap.

Port of hand_integral_pose_estimation_tpu/ops/integral.py: softmax over each
joint's whole D*H*W volume, then the expectation of each grid axis, as in the
reference's `softmax_integral_tensor` (common/nets/loss.py:46-59).

Layout as in the JAX package: heatmap (B, H, W, J*D), channel = j*D + d;
coords (B, J, 3) = (x/W - 0.5, y/H - 0.5, z/D - 0.5).

`softmax_integral` launches the CUDA kernel `csrc/softmax_integral.cu` for a
CUDA tensor and takes the plain version, `softmax_integral_reference`, for a
CPU tensor. The kernel has no backward yet, so on CUDA it refuses inputs
that require a gradient instead of returning a detached result.
"""

from __future__ import annotations

import torch

from hand_integral_pose_estimation_tpu_torch.ops import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DEPTH = 128


def softmax_integral_reference(heatmap: torch.Tensor, num_joints: int,
                               depth: int):
    """Plain PyTorch soft-argmax; counterpart of `_softmax_integral_xla`
    (integral.py:48). Accumulates in at least float32 (float64 stays
    float64). Returns (coords (B, J, 3), m (B, J), s (B, J)) with m the
    per-joint max logit and s = sum exp(h - m)."""
    B, H, W, C = heatmap.shape
    if C != num_joints * depth:
        raise ValueError(f"heatmap has {C} channels, expected "
                         f"{num_joints} x {depth}")
    acc = torch.promote_types(heatmap.dtype, torch.float32)
    h = heatmap.reshape(B, H, W, num_joints, depth).to(acc)
    m = h.amax(dim=(1, 2, 4), keepdim=True)
    e = torch.exp(h - m)
    s = e.sum(dim=(1, 2, 4))
    dev = heatmap.device
    ez = (e * torch.arange(depth, dtype=acc, device=dev)).sum(dim=(1, 2, 4))
    ex = (e * torch.arange(W, dtype=acc, device=dev)[None, None, :, None, None]
          ).sum(dim=(1, 2, 4))
    ey = (e * torch.arange(H, dtype=acc, device=dev)[None, :, None, None, None]
          ).sum(dim=(1, 2, 4))
    coords = torch.stack(
        [ex / s / W - 0.5, ey / s / H - 0.5, ez / s / float(depth) - 0.5],
        dim=-1)
    return coords, m.reshape(B, num_joints), s


def check_no_grad(*tensors: torch.Tensor) -> None:
    """Forward-only kernels refuse inputs that autograd would track: their
    result would silently carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "this CUDA kernel has no backward yet; call it under "
            "torch.no_grad()/torch.inference_mode() or detach the inputs")


def softmax_integral_cuda(heatmap: torch.Tensor, num_joints: int,
                          depth: int):
    """Launch the soft-argmax kernel (`csrc/softmax_integral.cu`).

    heatmap: contiguous CUDA (B, H, W, J*D) float32 or bfloat16.
    Returns (coords, m, s) in float32, as `softmax_integral_reference`."""
    if heatmap.device.type != "cuda":
        raise ValueError(f"softmax_integral_cuda needs a CUDA tensor, got "
                         f"{heatmap.device}")
    if heatmap.dtype not in _DTYPE_CODES:
        raise TypeError(f"softmax_integral_cuda takes float32 or bfloat16, "
                        f"got {heatmap.dtype}")
    if heatmap.dim() != 4 or heatmap.shape[3] != num_joints * depth:
        raise ValueError(f"heatmap shape {tuple(heatmap.shape)} is not "
                         f"(B, H, W, {num_joints} x {depth})")
    if not heatmap.is_contiguous():
        raise ValueError("softmax_integral_cuda needs a contiguous heatmap")
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth} outside 1..{MAX_DEPTH}")
    check_no_grad(heatmap)
    B, H, W, _ = heatmap.shape
    if B * H * W * num_joints == 0:
        raise ValueError(f"empty heatmap {tuple(heatmap.shape)}")
    with torch.cuda.device(heatmap.device):
        f32 = dict(dtype=torch.float32, device=heatmap.device)
        coords = torch.empty(B, num_joints, 3, **f32)
        m = torch.empty(B, num_joints, **f32)
        s = torch.empty(B, num_joints, **f32)
        kernels.SOFTMAX_INTEGRAL_FWD(
            heatmap.data_ptr(), _DTYPE_CODES[heatmap.dtype], coords.data_ptr(),
            m.data_ptr(), s.data_ptr(), B, H, W, num_joints, depth,
            torch.cuda.current_stream().cuda_stream)
    return coords, m, s


def softmax_integral(heatmap: torch.Tensor, num_joints: int,
                     depth: int) -> torch.Tensor:
    """(B, H, W, J*D) logits -> (B, J, 3) coords in the reference's
    normalised patch units (loss.py:54-56). CUDA tensors go through the
    kernel, CPU tensors through the plain version."""
    if heatmap.device.type == "cuda":
        return softmax_integral_cuda(heatmap, num_joints, depth)[0]
    if heatmap.device.type == "cpu":
        return softmax_integral_reference(heatmap, num_joints, depth)[0]
    raise ValueError(f"unsupported device {heatmap.device}")


def softmax_probs(heatmap: torch.Tensor, num_joints: int,
                  depth: int) -> torch.Tensor:
    """Per-joint softmax distributions over the full volume, (B, J, H*W*D)
    in (H, W, D) order; counterpart of `integral.softmax_probs`
    (reference `softmax_integral_tensor2`, loss.py:61-67)."""
    B, H, W, C = heatmap.shape
    h = heatmap.reshape(B, H * W, num_joints, depth).float()
    m = h.amax(dim=(1, 3), keepdim=True)
    e = torch.exp(h - m)
    p = e / e.sum(dim=(1, 3), keepdim=True)
    return p.movedim(2, 1).reshape(B, num_joints, H * W * depth)


def heatmap_entropy(heatmap: torch.Tensor, num_joints: int,
                    depth: int) -> torch.Tensor:
    """Per-joint entropy of the softmax volume, (B, J), in closed form from
    the logits; counterpart of `integral.heatmap_entropy`."""
    B, H, W, C = heatmap.shape
    h = heatmap.reshape(B, H * W, num_joints, depth).float()
    m = h.amax(dim=(1, 3), keepdim=True)
    e = torch.exp(h - m)
    s = e.sum(dim=(1, 3))
    weighted = (e * (h - m)).sum(dim=(1, 3))
    return torch.log(s) - weighted / s
