"""Procrustes alignment (PA-MPJPE, "protocol #1") as batched linear algebra.

Port of hand_integral_pose_estimation_tpu/geometry/procrustes.py: the
reference's `compute_similarity_transform` (common/augment.py:18-77) and
the FreiHAND scorer's `align_w_scale` (main/eval.py:142-165).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SimilarityTransform(NamedTuple):
    d: torch.Tensor   # residual
    Z: torch.Tensor   # Y aligned to X
    T: torch.Tensor   # rotation, applied as Y0 @ T
    b: torch.Tensor   # scale
    c: torch.Tensor   # translation


def compute_similarity_transform(X: torch.Tensor, Y: torch.Tensor,
                                 compute_optimal_scale: bool = True
                                 ) -> SimilarityTransform:
    """Align Y (..., N, M) to X (..., N, M) by rotation, optional
    least-squares scale and translation, with the reference's reflection
    fix (augment.py:58-62): if det(T) < 0 the last right-singular vector and
    singular value change sign, so T is a proper rotation."""
    muX = X.mean(dim=-2, keepdim=True)
    muY = Y.mean(dim=-2, keepdim=True)
    X0 = X - muX
    Y0 = Y - muY
    ssX = (X0 ** 2).sum(dim=(-2, -1))
    ssY = (Y0 ** 2).sum(dim=(-2, -1))
    normX = torch.sqrt(ssX)[..., None, None]
    normY = torch.sqrt(ssY)[..., None, None]
    X0 = X0 / normX
    Y0 = Y0 / normY

    A = X0.transpose(-1, -2) @ Y0
    U, s, Vt = torch.linalg.svd(A, full_matrices=False)
    V = Vt.transpose(-1, -2)
    T = V @ U.transpose(-1, -2)

    sign = torch.sign(torch.linalg.det(T))[..., None]          # (..., 1)
    V = torch.cat([V[..., :, :-1], V[..., :, -1:] * sign[..., None]], dim=-1)
    s = torch.cat([s[..., :-1], s[..., -1:] * sign], dim=-1)
    T = V @ U.transpose(-1, -2)

    traceTA = s.sum(dim=-1)
    normX_s = normX[..., 0, 0]
    normY_s = normY[..., 0, 0]
    if compute_optimal_scale:
        b = traceTA * normX_s / normY_s
        d = 1.0 - traceTA ** 2
        Z = normX * traceTA[..., None, None] * (Y0 @ T) + muX
    else:
        b = torch.ones_like(traceTA)
        d = 1.0 + ssY / ssX - 2.0 * traceTA * normY_s / normX_s
        Z = normY * (Y0 @ T) + muX
    c = muX[..., 0, :] - b[..., None] * torch.einsum(
        "...j,...jk->...k", muY[..., 0, :], T)
    return SimilarityTransform(d=d, Z=Z, T=T, b=b, c=c)


def procrustes_align(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """`pred` aligned to `gt` with the optimal scale (the PA-MPJPE path)."""
    return compute_similarity_transform(gt, pred,
                                        compute_optimal_scale=True).Z


def align_w_scale(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """`pred` (..., N, 3) aligned to `gt` as the FreiHAND-official scorer
    aligns it (main/eval.py:142-165, scipy's orthogonal_procrustes): both
    point sets centred and Frobenius-normalised (+1e-8), R = U Vt and the
    scale = the sum of singular values from the SVD of gt_n^T pred_n, then
    pred_n R^T * scale, rescaled and translated back to gt."""
    t1 = gt.mean(dim=-2, keepdim=True)
    t2 = pred.mean(dim=-2, keepdim=True)
    m1 = gt - t1
    m2 = pred - t2
    s1 = torch.linalg.norm(m1, dim=(-2, -1), keepdim=True) + 1e-8
    s2 = torch.linalg.norm(m2, dim=(-2, -1), keepdim=True) + 1e-8
    m1 = m1 / s1
    m2 = m2 / s2
    U, s, Vt = torch.linalg.svd(m1.transpose(-1, -2) @ m2,
                                full_matrices=False)
    R = U @ Vt
    scale = s.sum(dim=-1)[..., None, None]
    return (m2 @ R.transpose(-1, -2)) * scale * s1 + t1
