"""Fixed-shape greedy NMS, batched over a leading image axis.

Port of hand_integral_pose_estimation_tpu/ops/nms.py (the reference's
bitmask kernel + host sweep, lib/model_rcnn/csrc/cuda/nms.cu:23-131). Boxes
are sorted by score (a stable descending sort, so ties keep the lower
index first, as `jnp.argsort(-scores)` does), suppressed greedily, and the
survivors compacted into a fixed top-K slot array with a validity mask:
the zero-padded contract of the reference proposal layer
(rpn/proposal_layer.py:127). IoU uses the +1-pixel widths of that stack.

Two resolvers of the greedy keep set over score-sorted boxes:
  * `_alive_plain`, a port of `_alive_xla` (nms.py:101-173): tiles of up to
    512 boxes, each suppressed by the final earlier boxes, then resolved by
    the fixpoint of within-tile suppression. It is the plain version, taken
    for CPU tensors.
  * `_alive_cuda`, kernel 7 (`csrc/nms.cu`): a parallel launch builds the
    upper triangle of the 64-bit suppression masks, then one CTA per image
    sweeps them in score order, the row blocks staged ahead by bulk copies
    and each block resolved by one warp. It replaces the TPU kernel
    `_nms_kernel` (nms.py:231).
Both apply `inter / max(union, 1e-12) > thr` with the same float32
operations, so their keep sets are bitwise equal.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from hand_integral_pose_estimation_tpu_torch.ops import kernels

_MASK_BITS = 64


def box_iou(a: torch.Tensor, b: torch.Tensor,
            plus_one: bool = True) -> torch.Tensor:
    """Pairwise IoU, (..., N, 4) x (..., K, 4) -> (..., N, K), with the
    reference's +1 width / height convention when `plus_one`."""
    off = 1.0 if plus_one else 0.0
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    area_a = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    iw = torch.clamp(ix2 - ix1 + off, min=0.0)
    ih = torch.clamp(iy2 - iy1 + off, min=0.0)
    inter = iw * ih
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def _alive_plain(b: torch.Tensor, alive0: torch.Tensor, iou_threshold: float,
                 plus_one: bool, stop_after: int | None = None
                 ) -> torch.Tensor:
    """(B, N, 4) score-sorted boxes, (B, N) pre-alive -> (B, N) keep.

    Tiled sweep: each tile of T boxes is first suppressed by the final
    earlier boxes through a (T, N) IoU strip, then resolved by iterating
    F(a)[i] = cand[i] & !exists j < i: a[j] & hit[j, i] to its fixpoint,
    the greedy solution. `stop_after=K` ends an image's sweep once K
    survivors are final; rows of tiles it never reached are reported dead,
    which leaves the first K survivors unchanged."""
    B, N, _ = b.shape
    T = min(512, N)
    pad = (-N) % T
    if pad:
        b = torch.cat([b, b.new_zeros(B, pad, 4)], dim=1)
        alive0 = torch.cat([alive0, alive0.new_zeros(B, pad)], dim=1)
    Np = N + pad
    idx = torch.arange(Np, device=b.device)
    lower = torch.tril(torch.ones(T, T, dtype=torch.bool, device=b.device),
                       diagonal=-1)                           # j < i
    alive = alive0.clone()
    t_end = torch.zeros(B, dtype=torch.long, device=b.device)
    for t in range(Np // T):
        start = t * T
        active = (torch.ones_like(t_end, dtype=torch.bool) if stop_after is None
                  else (alive & (idx < start)).sum(1) < stop_after)
        if not bool(active.any()):
            break
        hit = box_iou(b[:, start:start + T], b, plus_one) > iou_threshold
        earlier = (idx < start) & alive                       # (B, Np)
        cand = alive[:, start:start + T] & ~(hit & earlier[:, None, :]).any(2)
        sup = hit[:, :, start:start + T].transpose(1, 2) & lower  # (B, i, j)
        a = cand
        while True:
            new = cand & ~(sup & a[:, None, :]).any(2)
            if torch.equal(new, a):
                break
            a = new
        alive[:, start:start + T] = torch.where(active[:, None], a,
                                                alive[:, start:start + T])
        t_end = t_end + active.long()
    if stop_after is not None:
        alive = alive & (idx < t_end[:, None] * T)
    return alive[:, :N]


def _alive_cuda(b: torch.Tensor, alive0: torch.Tensor, iou_threshold: float,
                plus_one: bool, stop_after: int | None = None
                ) -> torch.Tensor:
    """Kernel 7 on (B, N, 4) score-sorted CUDA boxes and (B, N) pre-alive:
    the upper triangle of the 64-bit suppression masks in a parallel launch,
    then a serial sweep per image that stops after `stop_after` survivors
    (all N boxes when None). Returns the (B, N) bool keep vector. Bool flags
    go in and come out as they are (one byte, 0 or 1): no conversion
    launch."""
    if b.device.type != "cuda" or alive0.device != b.device:
        raise ValueError(f"nms_cuda needs CUDA boxes and scores on one "
                         f"device, got {b.device} and {alive0.device}")
    if b.dim() != 3 or b.shape[-1] != 4 or tuple(alive0.shape) != b.shape[:2]:
        raise ValueError(f"boxes {tuple(b.shape)} and alive "
                         f"{tuple(alive0.shape)} are not (B, N, 4) and (B, N)")
    B, N, _ = b.shape
    if B < 1 or N < 1:
        raise ValueError(f"empty NMS input {tuple(b.shape)}")
    col_blocks = math.ceil(N / _MASK_BITS)
    if B * N * col_blocks >= 2**31 or col_blocks > 65535:
        raise ValueError(f"NMS over {N} boxes is too large for the kernel")
    boxes = b.to(torch.float32).contiguous()
    alive_in = alive0.to(torch.bool).contiguous()   # no-op for bool
    with torch.cuda.device(b.device):
        # each image's row blocks, block-major: row block v holds the 64
        # rows' words of its column blocks v .. col_blocks - 1
        mask = torch.empty(B, 32 * col_blocks * (col_blocks + 1),
                           dtype=torch.int64, device=b.device)
        keep = torch.empty(B, N, dtype=torch.bool, device=b.device)
        kernels.NMS(boxes.data_ptr(), alive_in.data_ptr(), mask.data_ptr(),
                    keep.data_ptr(), B, N, float(iou_threshold),
                    1 if plus_one else 0,
                    N if stop_after is None else int(stop_after),
                    torch.cuda.current_stream().cuda_stream)
    return keep


def _compact(b: torch.Tensor, s: torch.Tensor, alive: torch.Tensor,
             top_k: int):
    """Survivors to the front of (B, top_k) slots, in score order; dead and
    padding slots zeroed."""
    B, N = s.shape
    if top_k > N:   # fewer candidates than output slots
        pad = top_k - N
        b = torch.cat([b, b.new_zeros(B, pad, 4)], dim=1)
        s = torch.cat([s, s.new_zeros(B, pad)], dim=1)
        alive = torch.cat([alive, alive.new_zeros(B, pad)], dim=1)
        N = top_k
    idx = torch.arange(N, device=s.device)
    rank = torch.where(alive, idx, N + idx)
    sel = torch.argsort(rank, dim=1)[:, :top_k]
    valid = torch.gather(alive, 1, sel)
    out_b = torch.gather(b, 1, sel[..., None].expand(B, top_k, 4))
    out_s = torch.gather(s, 1, sel)
    return (torch.where(valid[..., None], out_b, torch.zeros_like(out_b)),
            torch.where(valid, out_s, torch.zeros_like(out_s)), valid)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        top_k: int, score_threshold: float = -math.inf,
        plus_one: bool = True, impl: str = "auto",
        early_exit: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS with a fixed-size output, per image of a batch.

    Args:
        boxes: (B, N, 4) xyxy; scores: (B, N).
        iou_threshold: suppress a box whose IoU with a kept, higher-scored
            box is above it.
        top_k: number of output slots (zero-padded).
        score_threshold: boxes at or below it are dead from the start (the
            detector's 0.001, the proposal layer's 0.0).
        impl: "cuda" (kernel 7, CUDA tensors), "plain" (the tiled fixpoint
            sweep), or "auto" (the kernel for a CUDA tensor, the plain
            version for a CPU tensor).
        early_exit: stop once `top_k` survivors are final. Exact: greedy
            survivors arrive in score order, so later boxes can only be
            survivors ranked past top_k.

    Returns:
        (boxes (B, top_k, 4), scores (B, top_k), valid (B, top_k) bool) in
        descending score order; invalid slots are zeroed.
    """
    if impl == "auto":
        impl = "cuda" if boxes.device.type == "cuda" else "plain"
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand_as(boxes))
    s = torch.gather(scores, 1, order)
    alive0 = s > score_threshold
    stop_after = top_k if early_exit else None
    if impl == "cuda":
        alive = _alive_cuda(b, alive0, iou_threshold, plus_one, stop_after)
    elif impl == "plain":
        alive = _alive_plain(b, alive0, iou_threshold, plus_one, stop_after)
    else:
        raise ValueError(f"unknown NMS impl {impl!r}")
    return _compact(b, s, alive, top_k)
