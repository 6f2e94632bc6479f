"""Fused heatmap projection + soft-argmax: the pose head's final 1x1 conv and
the integral decode in one step, so the (B, 56, 56, 21*56) heatmap is never
written to device memory.

Port of hand_integral_pose_estimation_tpu/ops/fused_head.py. One difference
of convention: the projection is passed as torch's (out, in) matrix,
`weight` (J*D, F) = `final_layer.weight.view(J*D, F)`, where the JAX
function takes its transpose (F, J*D). The bias is (J*D,).

`head_projection_integral` launches `csrc/head_projection_integral.cu` for
CUDA tensors and takes the plain version for CPU tensors. The kernel has no
backward yet, so on CUDA it refuses inputs that require a gradient.
"""

from __future__ import annotations

import torch

from hand_integral_pose_estimation_tpu_torch.ops import kernels
from hand_integral_pose_estimation_tpu_torch.ops.integral import (
    MAX_DEPTH,
    check_no_grad,
    softmax_integral_reference,
)

_FEAT_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel stages a joint's (F, D rounded up to 8) float32 weight slice
# plus a (64, 65) float32 feature slice in one CTA's shared memory
_SMEM_BYTES = 232448 - 1024


def head_projection_integral_reference(feats: torch.Tensor,
                                       weight: torch.Tensor,
                                       bias: torch.Tensor, num_joints: int,
                                       depth: int):
    """Plain PyTorch projection + soft-argmax; counterpart of the non-Pallas
    branch of `_hp_fwd_dispatch` (fused_head.py:206-214). The product is
    promoted to at least float32, as the JAX einsum promotes bf16 features
    times the float32 kernel. Returns (coords, m, s)."""
    acc = torch.promote_types(
        torch.promote_types(feats.dtype, weight.dtype), torch.float32)
    hm = torch.matmul(feats.to(acc), weight.to(acc).t()) + bias.to(acc)
    return softmax_integral_reference(hm, num_joints, depth)


def head_projection_integral_cuda(feats: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, num_joints: int,
                                  depth: int):
    """Launch the fused kernel. feats: contiguous CUDA (B, H, W, F) bfloat16
    or float32; weight: contiguous float32 (J*D, F); bias: float32 (J*D,).
    Returns (coords, m, s) in float32."""
    for name, t in (("feats", feats), ("weight", weight), ("bias", bias)):
        if t.device.type != "cuda" or t.device != feats.device:
            raise ValueError(f"{name} must be on the CUDA device of feats, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.dtype not in _FEAT_DTYPE_CODES:
        raise TypeError(f"feats must be bfloat16 or float32, got {feats.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"weight and bias must be float32, got "
                        f"{weight.dtype}, {bias.dtype}")
    if feats.dim() != 4:
        raise ValueError(f"feats shape {tuple(feats.shape)} is not (B, H, W, F)")
    B, H, W, F = feats.shape
    C = num_joints * depth
    if tuple(weight.shape) != (C, F) or tuple(bias.shape) != (C,):
        raise ValueError(f"weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not match ({C}, {F})")
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth} outside 1..{MAX_DEPTH}")
    depth_pad = -(-depth // 8) * 8
    if 4 * (F * depth_pad + 64 * 65) > _SMEM_BYTES:
        raise ValueError(f"F = {F} at depth {depth} does not fit the kernel's "
                         f"shared memory")
    if B * H * W * num_joints == 0:
        raise ValueError(f"empty features {tuple(feats.shape)}")
    check_no_grad(feats, weight, bias)
    with torch.cuda.device(feats.device):
        f32 = dict(dtype=torch.float32, device=feats.device)
        coords = torch.empty(B, num_joints, 3, **f32)
        m = torch.empty(B, num_joints, **f32)
        s = torch.empty(B, num_joints, **f32)
        kernels.HEAD_PROJECTION_INTEGRAL_FWD(
            feats.data_ptr(), _FEAT_DTYPE_CODES[feats.dtype],
            weight.data_ptr(), bias.data_ptr(), coords.data_ptr(),
            m.data_ptr(), s.data_ptr(), B, H, W, F, num_joints, depth,
            torch.cuda.current_stream().cuda_stream)
    return coords, m, s


def head_projection_integral(feats: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, num_joints: int,
                             depth: int) -> torch.Tensor:
    """(B, H, W, F) features x (J*D, F) projection -> (B, J, 3) coords.

    Equal to `conv1x1(feats, weight, bias)` followed by `softmax_integral`.
    CUDA tensors go through the fused kernel, CPU tensors through the plain
    version."""
    if feats.device.type == "cuda":
        return head_projection_integral_cuda(feats, weight, bias, num_joints,
                                             depth)[0]
    if feats.device.type == "cpu":
        return head_projection_integral_reference(feats, weight, bias,
                                                  num_joints, depth)[0]
    raise ValueError(f"unsupported device {feats.device}")
