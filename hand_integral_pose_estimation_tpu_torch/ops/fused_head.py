"""Fused heatmap projection + soft-argmax: the pose head's final 1x1 conv and
the integral decode in one step, so the (B, 56, 56, 21*56) heatmap is never
written to device memory.

Port of hand_integral_pose_estimation_tpu/ops/fused_head.py. One difference
of convention: the projection is passed as torch's (out, in) matrix,
`weight` (J*D, F) = `final_layer.weight.view(J*D, F)`, where the JAX
function takes its transpose (F, J*D). The bias is (J*D,).

`head_projection_integral` is a `torch.autograd.Function`. For CUDA
tensors its forward launches kernel 3 (`csrc/head_projection_integral_mma.cu`)
and its backward kernel 4 (`csrc/head_projection_integral_bwd_mma.cu`),
which recomputes the logits per tile and contracts the soft-argmax
cotangent into dfeat, dW and db without writing the heatmap or its
gradient; for CPU tensors both take the plain versions. Both run on the
tensor cores at every width F and depth D: each float32 operand is split
into bf16 parts (`bf16_split`) and multiplied part by part, which keeps
float32 accuracy. bf16 features, the main path's, are exact in bf16;
float32 features (`compute_dtype="float32"`) are split into three parts
as well, and the part pairs kept to float32 accuracy (`F32_PART_PAIRS`).
Up to F = 256 a CTA keeps its block's weight planes at the whole F in
shared memory; wider features are walked in slices of 64
(`csrc/k_slices.cuh`), the backward's through a ring of bulk copies with
F split between two warpgroups, in passes of 512 features past 512. Each feature dtype counts its launches on its own
entry point (`forward_route`; `kernels.HEAD_PROJECTION_INTEGRAL_*_F32`
for float32 features).
"""

from __future__ import annotations

import math

import torch

from hand_integral_pose_estimation_tpu_torch.ops import kernels
from hand_integral_pose_estimation_tpu_torch.ops.integral import (
    channel_constants,
    softmax_integral_reference,
)

# each feature dtype's entry points: kernel 3 and kernel 4
_FWD = {torch.bfloat16: kernels.HEAD_PROJECTION_INTEGRAL_FWD,
        torch.float32: kernels.HEAD_PROJECTION_INTEGRAL_FWD_F32}
_BWD = {torch.bfloat16: kernels.HEAD_PROJECTION_INTEGRAL_BWD,
        torch.float32: kernels.HEAD_PROJECTION_INTEGRAL_BWD_F32}
# the widest F at which the tensor-core kernels keep a block's weight
# planes at the whole F in shared memory; wider F is walked in slices
_RESIDENT_FEATS = 256
# the tensor-core kernels' blocks of 64 channels and their tiles of
# positions in the forward's chunks and the dW partials: 64 for bf16
# features, 32 for float32 ones up to 256 features, 64 past that
_MMA_BLOCK_C = 64
_DW_TILE = {torch.bfloat16: 64, torch.float32: 32}
# features a pass of kernel 4's N = F products takes past
# `_RESIDENT_FEATS`: each of the two warpgroups owns half of them
_PASS_FEATS = 512
# float32 features: the (feature part, weight part) pairs the tensor-core
# route multiplies, of the three-part splits (0 hi, 1 mid, 2 lo): those
# whose parts' orders add up to at most 2^-16 of the product. The logits
# pair feature and weight parts, dW the cotangent's and the feature's;
# dfeat keeps the bf16 route's pairs of g and W, (0, 0), (0, 1), (1, 0).
F32_PART_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def bf16_split(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """The bf16 parts the tensor-core kernels multiply in place of float32
    `x` (as `csrc/bf16x3_mma.cuh` splits in shared memory): part k is what
    the parts before it leave of `x`, rounded to the nearest bf16. Three
    parts sum back to float32 `x` exactly (3 x 8 significand bits cover
    float32's 24, for |x| in 2^-100 .. 2^100), two keep 16 bits."""
    out, rest = [], x.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16)
        out.append(part)
        rest = rest - part.float()
    return out


def _chunk_tile(dtype: torch.dtype, num_feats: int) -> int:
    """Positions in a tile of the forward's chunks and the dW partials:
    the dtype's `_DW_TILE` up to `_RESIDENT_FEATS` features, 64 for the
    slice-walking kernels past that (as the C launchers cut them)."""
    return _DW_TILE[dtype] if num_feats <= _RESIDENT_FEATS else 64


def _mma_chunks(feats: torch.Tensor, num_channels: int,
                passes: int = 1) -> int:
    """Chunks per image of the tensor-core forward and dW grids, which have
    one CTA per (image, chunk of its tiles of positions, block of 64
    channels, pass) and one CTA per SM: the count that least waves x
    (tiles per chunk + 1, the weight staging's share) take, so the last
    wave is nearly full at any batch. Tiles are `_chunk_tile` positions."""
    B, H, W, F = feats.shape
    tiles = -(-(H * W) // _chunk_tile(feats.dtype, F))
    ctas = B * -(-num_channels // _MMA_BLOCK_C) * passes
    sms = kernels.sm_count(feats.device.index or 0)
    return min(range(1, tiles + 1), key=lambda c: (
        math.ceil(ctas * c / sms) * (-(-tiles // c) + 1)))


def backward_passes(num_feats: int) -> int:
    """Passes of the N = F products in kernel 4's grids: one up to
    `_PASS_FEATS` features, then one per `_PASS_FEATS` (as the C launcher
    cuts them: `SlicePlanes::passes`, `csrc/k_slices.cuh`)."""
    return max(1, -(-num_feats // _PASS_FEATS))


def dweight_grid(feats: torch.Tensor, num_channels: int
                 ) -> tuple[int, int, int]:
    """The grid kernel 4's dW launch starts, (channel blocks, images x
    chunks, passes), with the chunks planned over every dimension of it."""
    B, F = feats.shape[0], feats.shape[-1]
    passes = backward_passes(F)
    chunks = _mma_chunks(feats, num_channels, passes)
    return -(-num_channels // _MMA_BLOCK_C), B * chunks, passes


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


def forward_route(dtype: torch.dtype) -> kernels.Kernel:
    """The entry point that runs kernel 3 on CUDA features of `dtype`, at
    every width and depth: each dtype has one route, which gives way to
    no other and to no plain version."""
    return _FWD[dtype]


def _check_feats(feats: torch.Tensor, weight: torch.Tensor,
                 depth: int) -> None:
    for name, t in (("feats", feats), ("weight", weight)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if depth < 1:
        raise ValueError(f"depth {depth} is not positive")


def _planes(feats: torch.Tensor, num_joints: int, depth: int,
            backward: bool) -> torch.Tensor:
    """The route's workspace of split bf16 planes (`kernels.
    head_projection_workspace` bytes, maybe none)."""
    B, H, W, F = feats.shape
    return torch.empty(kernels.head_projection_workspace(
        feats.dtype, backward, B, H, W, F, num_joints, depth),
        dtype=torch.uint8, device=feats.device)


def head_projection_integral_cuda(feats: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, num_joints: int,
                                  depth: int):
    """Launch the fused kernel. feats: contiguous CUDA (B, H, W, F) bfloat16
    or float32 of any width, on its dtype's route (`forward_route`);
    weight: contiguous float32 (J*D, F); bias: float32 (J*D,); any depth
    D. Returns (coords, m, s) in float32."""
    for name, t in (("feats", feats), ("weight", weight), ("bias", bias)):
        if t.device.type != "cuda" or t.device != feats.device:
            raise ValueError(f"{name} must be on the CUDA device of feats, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.dtype not in _FWD:
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
    _check_feats(feats, weight, depth)
    if B * H * W * F * num_joints == 0:
        raise ValueError(f"empty features {tuple(feats.shape)}")
    with torch.cuda.device(feats.device):
        f32 = dict(dtype=torch.float32, device=feats.device)
        coords = torch.empty(B, num_joints, 3, **f32)
        m = torch.empty(B, num_joints, **f32)
        s = torch.empty(B, num_joints, **f32)
        # per-(image, chunk, channel) partial states (m, s, sx, sy)
        chunks = _mma_chunks(feats, C)
        ws = torch.empty(B * chunks * C * 4, **f32)
        planes = _planes(feats, num_joints, depth, backward=False)
        forward_route(feats.dtype)(
            feats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            coords.data_ptr(), m.data_ptr(), s.data_ptr(), ws.data_ptr(),
            planes.data_ptr(), B, H, W, F, num_joints, depth, chunks,
            torch.cuda.current_stream().cuda_stream)
    return coords, m, s


def head_projection_integral_bwd_reference(feats: torch.Tensor,
                                           weight: torch.Tensor,
                                           bias: torch.Tensor, m: torch.Tensor,
                                           s: torch.Tensor,
                                           coords: torch.Tensor,
                                           cot: torch.Tensor, num_joints: int,
                                           depth: int):
    """Plain PyTorch VJP of the fused head; port of the non-Pallas branch
    of `_hp_bwd` (fused_head.py:242-255): recompute the heatmap, form the
    soft-argmax cotangent g with the folded per-channel constants, then
    dfeat = g @ W, dW = g^T feats, db = sum g. Returns dfeat in the
    features' dtype and dW (J*D, F), db (J*D,) in the weight's and bias's
    dtypes."""
    B, H, W, F = feats.shape
    acc = torch.promote_types(
        torch.promote_types(feats.dtype, weight.dtype), torch.float32)
    f2 = feats.reshape(B, H * W, F).to(acc)
    w = weight.to(acc)
    mvec, T, A, Bc = channel_constants(m, s, coords, cot, H, W, depth,
                                       dtype=acc)
    h2 = torch.matmul(f2, w.t()) + bias.to(acc)               # (B, HW, C)
    hw = torch.arange(H * W, device=feats.device)
    col = (hw % W).to(acc)[None, :, None]
    row = (hw // W).to(acc)[None, :, None]
    g = (torch.exp(h2 - mvec[:, None, :])
         * (T[:, None, :] + A[:, None, :] * col + Bc[:, None, :] * row))
    dfeat = torch.matmul(g, w).reshape(feats.shape)
    dW = torch.einsum("bsc,bsf->cf", g, f2)
    db = g.sum(dim=(0, 1))
    return dfeat.to(feats.dtype), dW.to(weight.dtype), db.to(bias.dtype)


def head_projection_integral_bwd_cuda(feats: torch.Tensor,
                                      weight: torch.Tensor,
                                      bias: torch.Tensor, m: torch.Tensor,
                                      s: torch.Tensor, coords: torch.Tensor,
                                      cot: torch.Tensor, num_joints: int,
                                      depth: int):
    """Launch the fused-head backward (`csrc/head_projection_integral_bwd.cu`,
    three launches: dfeat, per-chunk dW/db partials, their fixed-order sum;
    on the tensor cores for both feature dtypes, `*_bwd_mma.cu`; float32
    features, and past 256 features both operands, laid out first; float32
    features counted on `HEAD_PROJECTION_INTEGRAL_BWD_F32`). Operands as
    `head_projection_integral_cuda` takes them (any width and depth),
    plus the forward's m, s (B, J), coords and the cotangent (B, J, 3).
    Returns (dfeat in the features' dtype, dW (J*D, F) float32, db (J*D,)
    float32); dW and db are the same bits from run to run."""
    for name, t in (("feats", feats), ("weight", weight), ("bias", bias),
                    ("m", m), ("s", s), ("coords", coords), ("cot", cot)):
        if t.device.type != "cuda" or t.device != feats.device:
            raise ValueError(f"{name} must be on the CUDA device of feats, "
                             f"got {t.device}")
    for name, t in (("feats", feats), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.dtype not in (torch.bfloat16, torch.float32):
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
    for name, t, shape in (("m", m, (B, num_joints)), ("s", s, (B, num_joints)),
                           ("coords", coords, (B, num_joints, 3)),
                           ("cot", cot, (B, num_joints, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} is not {shape}")
    _check_feats(feats, weight, depth)
    if B * H * W * F * num_joints == 0:
        raise ValueError(f"empty features {tuple(feats.shape)}")
    chunks = dweight_grid(feats, C)[1] // B
    with torch.cuda.device(feats.device):
        mvec, T, A, Bc = channel_constants(m, s, coords, cot, H, W, depth)
        f32 = dict(dtype=torch.float32, device=feats.device)
        dfeat = torch.empty_like(feats)
        dW = torch.empty(C, F, **f32)
        db = torch.empty(C, **f32)
        # per-chunk dW partials in rows of F rounded up to 64
        ws = torch.empty(B * chunks, C, -(-F // 64) * 64, **f32)
        ws_db = torch.empty(B * chunks, C, **f32)
        planes = _planes(feats, num_joints, depth, backward=True)
        _BWD[feats.dtype](
            feats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            mvec.data_ptr(), T.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            dfeat.data_ptr(), dW.data_ptr(), db.data_ptr(), ws.data_ptr(),
            ws_db.data_ptr(), planes.data_ptr(), B, H, W, F, num_joints,
            depth, chunks, torch.cuda.current_stream().cuda_stream)
    return dfeat, dW, db


class HeadProjectionIntegral(torch.autograd.Function):
    """Fused projection + soft-argmax with its backward: kernels 3 and 4
    for CUDA tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, feats, weight, bias, num_joints, depth):
        feats, weight, bias = (t.contiguous() for t in (feats, weight, bias))
        if feats.device.type == "cuda":
            coords, m, s = head_projection_integral_cuda(
                feats, weight, bias, num_joints, depth)
        else:
            coords, m, s = head_projection_integral_reference(
                feats, weight, bias, num_joints, depth)
        ctx.save_for_backward(feats, weight, bias, m, s, coords)
        ctx.dims = (num_joints, depth)
        return coords

    @staticmethod
    def backward(ctx, grad_coords):
        feats, weight, bias, m, s, coords = ctx.saved_tensors
        num_joints, depth = ctx.dims
        # (b) the cotangent may arrive non-contiguous or in another dtype;
        # the constants are formed from a contiguous (B, J, 3) copy in the
        # forward's accumulation dtype (float32 on CUDA)
        cot = grad_coords.to(coords.dtype).contiguous()
        # (c) feats are the model's bf16 autocast output while weight and
        # bias are float32 params: dfeat comes back in the features' dtype,
        # which is what autograd expects for that input
        if feats.device.type == "cuda":
            dfeat, dW, db = head_projection_integral_bwd_cuda(
                feats, weight, bias, m, s, coords, cot, num_joints, depth)
        else:
            dfeat, dW, db = head_projection_integral_bwd_reference(
                feats, weight, bias, m, s, coords, cot, num_joints, depth)
        return dfeat, dW, db, None, None


def head_projection_integral(feats: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, num_joints: int,
                             depth: int) -> torch.Tensor:
    """(B, H, W, F) features x (J*D, F) projection -> (B, J, 3) coords.

    Equal to `conv1x1(feats, weight, bias)` followed by `softmax_integral`,
    differentiable in all three operands. CUDA tensors go through kernels 3
    (forward) and 4 (backward), CPU tensors through the plain versions."""
    if feats.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {feats.device}")
    return HeadProjectionIntegral.apply(feats, weight, bias, num_joints, depth)
