"""Softmax-integral (soft-argmax) decode of an NHWC 3D heatmap.

Port of hand_integral_pose_estimation_tpu/ops/integral.py: softmax over each
joint's whole D*H*W volume, then the expectation of each grid axis, as in the
reference's `softmax_integral_tensor` (common/nets/loss.py:46-59).

Layout as in the JAX package: heatmap (B, H, W, J*D), channel = j*D + d;
coords (B, J, 3) = (x/W - 0.5, y/H - 0.5, z/D - 0.5).

`softmax_integral` is a `torch.autograd.Function`. For a CUDA tensor its
forward launches `csrc/softmax_integral.cu` and its backward
`csrc/softmax_integral_bwd.cu`; for a CPU tensor both take the plain
versions, `softmax_integral_reference` and
`softmax_integral_bwd_reference`. The backward is the closed form
dL/dh = p * sum_a cot_a (g_a - c_a) of the JAX package's custom VJP
(integral.py:302-331): the probability volume is recomputed from the saved
per-joint max and sum, never stored.

The forward kernel cuts each image's H*W rows into chunks
(`softmax_integral_chunks`), writes one online-softmax state per (image,
chunk, channel) into a workspace allocated here, and merges the chunks in
order in a second launch behind the same C entry. The backward kernel forms
its per-channel constants from the (B, J) statistics itself: one call is
one launch.
"""

from __future__ import annotations

import torch

from hand_integral_pose_estimation_tpu_torch.ops import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DEPTH = 128


def softmax_integral_chunks(heatmap: torch.Tensor) -> int:
    """Chunks per image of kernel 1's vectorised path for this CUDA
    heatmap (B, H, W, C) float32 or bfloat16, 0 where it takes the generic
    path; the C library plans them (`kernels.softmax_integral_fwd_chunks`)
    for the heatmap's device."""
    B, H, W, C = heatmap.shape
    return kernels.softmax_integral_fwd_chunks(
        heatmap.data_ptr(), _DTYPE_CODES[heatmap.dtype], B, H * W, C,
        heatmap.device.index)


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


def softmax_integral_cuda(heatmap: torch.Tensor, num_joints: int,
                          depth: int):
    """Launch the soft-argmax kernel (`csrc/softmax_integral.cu`).

    heatmap: contiguous CUDA (B, H, W, J*D) float32 or bfloat16. Returns
    (coords, m, s) in float32, as `softmax_integral_reference`."""
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
    B, H, W, C = heatmap.shape
    if B * H * W * num_joints == 0:
        raise ValueError(f"empty heatmap {tuple(heatmap.shape)}")
    with torch.cuda.device(heatmap.device):
        chunks = softmax_integral_chunks(heatmap)
        f32 = dict(dtype=torch.float32, device=heatmap.device)
        coords = torch.empty(B, num_joints, 3, **f32)
        m = torch.empty(B, num_joints, **f32)
        s = torch.empty(B, num_joints, **f32)
        ws = torch.empty(B * chunks * C * 4 if chunks else 0, **f32)
        kernels.SOFTMAX_INTEGRAL_FWD(
            heatmap.data_ptr(), _DTYPE_CODES[heatmap.dtype], coords.data_ptr(),
            m.data_ptr(), s.data_ptr(), ws.data_ptr(), B, H, W, num_joints,
            depth, chunks, torch.cuda.current_stream().cuda_stream)
    return coords, m, s


def softmax_integral_bwd_reference(heatmap: torch.Tensor, m: torch.Tensor,
                                   s: torch.Tensor, coords: torch.Tensor,
                                   cot: torch.Tensor, num_joints: int,
                                   depth: int) -> torch.Tensor:
    """Plain PyTorch soft-argmax VJP; port of the XLA branch of `_bwd`
    (integral.py:313-331). With p = softmax(h) per joint and g_a the grid
    position in normalised coords, dL/dh = p * sum_a cot_a (g_a - c_a).
    m, s (B, J) and coords (B, J, 3) are the forward's; cot (B, J, 3) the
    incoming gradient. Computed in at least float32, returned in the
    heatmap's dtype."""
    B, H, W, C = heatmap.shape
    acc = torch.promote_types(heatmap.dtype, torch.float32)
    dev = heatmap.device
    h = heatmap.reshape(B, H, W, num_joints, depth).to(acc)
    m, s, coords, cot = (t.to(acc) for t in (m, s, coords, cot))
    p = (torch.exp(h - m[:, None, None, :, None])
         / s[:, None, None, :, None])
    gx = (torch.arange(W, dtype=acc, device=dev) / W - 0.5
          )[None, None, :, None, None]
    gy = (torch.arange(H, dtype=acc, device=dev) / H - 0.5
          )[None, :, None, None, None]
    gz = torch.arange(depth, dtype=acc, device=dev) / depth - 0.5
    cx, cy, cz = (coords[:, None, None, :, k, None] for k in range(3))
    common = (cot[:, None, None, :, 0, None] * (gx - cx)
              + cot[:, None, None, :, 1, None] * (gy - cy)
              + cot[:, None, None, :, 2, None] * (gz - cz))
    return (p * common).reshape(B, H, W, C).to(heatmap.dtype)


def channel_constants(m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor,
                      cot: torch.Tensor, height: int, width: int, depth: int,
                      dtype: torch.dtype = torch.float32):
    """The per-channel constants of the folded backward
    (integral.py:253-268), each (B, J*D) in `dtype` with channel j*D + d:
    grad = exp(h - m_c) * (T_c + A_c * col + B_c * row), col and row in
    raw grid units. Formed on the tensors' device with no host sync, for
    the fused head's backward (kernel 2 forms the same numbers in its
    registers)."""
    B, J = m.shape
    m, s, coords, cot = (t.to(dtype) for t in (m, s, coords, cot))
    gz = torch.arange(depth, dtype=dtype, device=m.device) / depth - 0.5
    cx, cy, cz = coords.unbind(-1)
    cotx, coty, cotz = cot.unbind(-1)
    svec = s[:, :, None]
    T = ((cotx * (-0.5 - cx) + coty * (-0.5 - cy))[:, :, None]
         + cotz[:, :, None] * (gz - cz[:, :, None])) / svec
    A = (cotx / (s * width))[:, :, None].expand(B, J, depth)
    Bc = (coty / (s * height))[:, :, None].expand(B, J, depth)
    mvec = m[:, :, None].expand(B, J, depth)
    return tuple(v.reshape(B, J * depth).contiguous()
                 for v in (mvec, T, A, Bc))


def softmax_integral_bwd_cuda(heatmap: torch.Tensor, m: torch.Tensor,
                              s: torch.Tensor, coords: torch.Tensor,
                              cot: torch.Tensor, num_joints: int,
                              depth: int) -> torch.Tensor:
    """Launch the soft-argmax backward kernel
    (`csrc/softmax_integral_bwd.cu`): one launch, which forms the
    per-channel constants of `channel_constants` itself. heatmap:
    contiguous CUDA (B, H, W, J*D) float32 or bfloat16; m, s (B, J),
    coords and cot (B, J, 3), contiguous float32 on the same device.
    Returns the gradient in the heatmap's dtype, as
    `softmax_integral_bwd_reference`."""
    if heatmap.device.type != "cuda":
        raise ValueError(f"softmax_integral_bwd_cuda needs a CUDA tensor, "
                         f"got {heatmap.device}")
    if heatmap.dtype not in _DTYPE_CODES:
        raise TypeError(f"softmax_integral_bwd_cuda takes float32 or "
                        f"bfloat16, got {heatmap.dtype}")
    if heatmap.dim() != 4 or heatmap.shape[3] != num_joints * depth:
        raise ValueError(f"heatmap shape {tuple(heatmap.shape)} is not "
                         f"(B, H, W, {num_joints} x {depth})")
    if not heatmap.is_contiguous():
        raise ValueError("softmax_integral_bwd_cuda needs a contiguous "
                         "heatmap")
    B, H, W, C = heatmap.shape
    for name, t, shape in (("m", m, (B, num_joints)), ("s", s, (B, num_joints)),
                           ("coords", coords, (B, num_joints, 3)),
                           ("cot", cot, (B, num_joints, 3))):
        if t.device != heatmap.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {heatmap.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if H * W * C >= 2**31:
        raise ValueError(f"heatmap image {(H, W, C)} is too large for the "
                         f"kernel's 32-bit indexing")
    if B * H * W * C == 0:
        raise ValueError(f"empty heatmap {tuple(heatmap.shape)}")
    with torch.cuda.device(heatmap.device):
        grad = torch.empty_like(heatmap)
        kernels.SOFTMAX_INTEGRAL_BWD(
            heatmap.data_ptr(), _DTYPE_CODES[heatmap.dtype], m.data_ptr(),
            s.data_ptr(), coords.data_ptr(), cot.data_ptr(), grad.data_ptr(),
            B, H, W, num_joints, depth,
            torch.cuda.current_stream().cuda_stream)
    return grad


class SoftmaxIntegral(torch.autograd.Function):
    """Soft-argmax with the closed-form backward: kernels 1 and 2 for CUDA
    tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, heatmap, num_joints, depth):
        heatmap = heatmap.contiguous()
        if heatmap.device.type == "cuda":
            coords, m, s = softmax_integral_cuda(heatmap, num_joints, depth)
        else:
            coords, m, s = softmax_integral_reference(heatmap, num_joints,
                                                      depth)
        ctx.save_for_backward(heatmap, m, s, coords)
        ctx.dims = (num_joints, depth)
        return coords

    @staticmethod
    def backward(ctx, grad_coords):
        heatmap, m, s, coords = ctx.saved_tensors
        num_joints, depth = ctx.dims
        # (b) autograd may hand over a non-contiguous cotangent in another
        # dtype; the kernel reads a contiguous (B, J, 3) in the forward's
        # accumulation dtype (float32 on CUDA)
        cot = grad_coords.to(coords.dtype).contiguous()
        if heatmap.device.type == "cuda":
            grad = softmax_integral_bwd_cuda(heatmap, m, s, coords, cot,
                                             num_joints, depth)
        else:
            grad = softmax_integral_bwd_reference(heatmap, m, s, coords, cot,
                                                  num_joints, depth)
        return grad, None, None


def softmax_integral(heatmap: torch.Tensor, num_joints: int,
                     depth: int) -> torch.Tensor:
    """(B, H, W, J*D) logits -> (B, J, 3) coords in the reference's
    normalised patch units (loss.py:54-56), differentiable in the heatmap.
    CUDA tensors go through kernels 1 (forward) and 2 (backward), CPU
    tensors through the plain versions."""
    if heatmap.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {heatmap.device}")
    return SoftmaxIntegral.apply(heatmap, num_joints, depth)


def softmax_integral_flat(heatmap: torch.Tensor, num_joints: int,
                          depth: int) -> torch.Tensor:
    """(B, J*3) flattened variant matching the reference's return shape
    (loss.py:58)."""
    c = softmax_integral(heatmap, num_joints, depth)
    return c.reshape(c.shape[0], num_joints * 3)


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
