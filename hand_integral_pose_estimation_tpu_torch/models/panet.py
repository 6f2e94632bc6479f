"""PANet: the NRSfM hierarchical block-sparse-coding autoencoder.

Port of hand_integral_pose_estimation_tpu/models/panet.py (the reference's
procrustes_encoding nrsfm/nrsfmnet.py and nrsfm/nrsfm_modules.py): a
camera-equivariant sparse encoder stack, a camera estimator projected to
the closest rotation, a pose-code layer, and a mirrored decoder giving
`pts_recon = canonical @ camera`. Each layer is an einsum, as in the JAX
package; the parameters carry the reference's torch names and shapes, so a
reference `model_best.pth` loads with `load_state_dict` (`load_panet`):

  sparse_coding_layers.0.dictionary            (P, 3, D0)
  sparse_coding_layers.0.bias_encode_with_cam  (D0,)
  sparse_coding_layers.0.bias_decode           (P * 3,)
  sparse_coding_layers.i.dictionary            (D[i-1], D[i], 1, 1)
  sparse_coding_layers.i.bias_encode_with_cam  (D[i],)
  sparse_coding_layers.i.bias_decode           (D[i-1],)
  camera_estimator.linear_comb_layer.weight    (1, D[-1], 1, 1)
  code_estimator.fc_layer.weight               (D[-1], D[-1], 3, 3)

The camera is the closest rotation to the estimator's 3x3 output: U V^T
from its SVD with the last column of U flipped where det(U V^T) < 0
(nrsfm_modules.py:46-67). `torch.linalg.svd` on a CUDA tensor checks
cuSOLVER's status on the host, a synchronisation that a CUDA-graph capture
forbids, so `make_orthonormal` computes the same rotation with tensor
operations only: a fixed number of one-sided Jacobi sweeps on M, and the
closed-form gradient of the closest rotation in its backward. The JAX
package's orbax PANet checkpoints are a JAX format and are not read.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

DEFAULT_DICT_SIZES: Tuple[int, ...] = (512, 256, 128, 64, 32, 16, 8)

#: cyclic one-sided Jacobi sweeps over the three column pairs of a 3x3
#: matrix; the columns' non-orthogonality falls quadratically, and six
#: sweeps take any float64 input to its rounding level
JACOBI_SWEEPS = 6


def block_soft_threshold(x: torch.Tensor, thrsh: torch.Tensor) -> torch.Tensor:
    """Group shrinkage of each (3, 3) code block (nrsfm_modules.py:13-22):
    the block times relu(1 - thrsh / ||block||), the norm clamped away from
    0 so that a zero block stays zero."""
    norm = torch.linalg.vector_norm(x.flatten(2), dim=-1)       # (B, D)
    scale = torch.relu(1.0 - thrsh[None, :] / norm.clamp_min(1e-12))
    return scale[..., None, None] * x


def relu_threshold(x: torch.Tensor, thrsh: torch.Tensor) -> torch.Tensor:
    """Channel-biased relu (nrsfm_modules.py:10-11)."""
    return torch.relu(x + thrsh[None, :, None, None])


def _one_sided_jacobi(M: torch.Tensor):
    """(N, 3, 3) -> (W, V) with M V = W, V orthogonal and the columns of W
    orthogonal, ordered by length (the singular values) descending, ties in
    index order: `JACOBI_SWEEPS` cyclic sweeps of one-sided (Hestenes)
    Jacobi rotations on the columns of M, with no data-dependent control
    flow. Working on M's columns rather than on M^T M keeps the accuracy
    of a right singular vector at eps s1 / gap, not eps s1^2 / gap^2."""
    n = M.shape[0]
    eye = torch.eye(3, dtype=M.dtype, device=M.device).expand(n, 3, 3)
    W, V = M, eye.clone()
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            wp, wq = W[..., p], W[..., q]
            a, b, g = (wp * wp).sum(-1), (wq * wq).sum(-1), (wp * wq).sum(-1)
            nz = g != 0
            zeta = (b - a) / (2.0 * torch.where(nz, g, torch.ones_like(g)))
            sgn = torch.where(zeta >= 0, 1.0, -1.0).to(M.dtype)
            # zeta * zeta may overflow to inf: t is then 0, as it should
            t = sgn / (zeta.abs() + torch.sqrt(zeta * zeta + 1.0))
            t = torch.where(nz, t, torch.zeros_like(t))
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            J = eye.clone()
            J[:, p, p] = c
            J[:, q, q] = c
            J[:, p, q] = s
            J[:, q, p] = -s
            W = W @ J
            V = V @ J
    order = torch.argsort(torch.linalg.vector_norm(W, dim=-2), dim=-1,
                          descending=True, stable=True)
    idx = order[:, None, :].expand(n, 3, 3)
    return W.gather(2, idx), V.gather(2, idx)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _unit_orthogonal(u: torch.Tensor, candidates, floor) -> torch.Tensor:
    """The first of `candidates` (rows of (N, 3)) whose part orthogonal to
    the unit rows `u` is longer than `floor`, normalised (the last
    candidate is taken when none is)."""
    out = None
    for w in reversed(candidates):
        w = w - (u * w).sum(-1, keepdim=True) * u
        out = w if out is None else torch.where(_norm(w) > floor, w, out)
    return out / _norm(out)


class _ClosestRotation(torch.autograd.Function):
    """M (N, 3, 3) -> the closest rotation U diag(1, 1, d) V^T, computed in
    float64 as [u1, u2, u1 x u2] [v1, v2, v1 x v2]^T from the two leading
    right singular vectors v1, v2 (one-sided Jacobi) and u_i = M v_i
    orthonormalised; that equals the SVD formula for every M of rank >= 2,
    reflections included. Where the rotation is not unique (rank <= 1) the
    missing u are completed from the v, so the result is always a
    rotation (M = 0 gives I); the SVD's completion there is LAPACK's
    choice. Backward: with M = U' S' V'^T in those proper frames (S' =
    diag(s1, s2, d s3)), dL/dM = U' [(Y - Y^T)_ij / (s'_i + s'_j)] V'^T
    where Y = U'^T G V', which stays bounded where s1 and s2 meet (the
    SVD's own U and V gradients do not); a pair whose s'_i + s'_j is
    exactly 0 (rank <= 1, where the gradient does not exist) contributes
    0."""

    @staticmethod
    def forward(ctx, mats):
        M = mats.to(torch.float64)
        W, V = _one_sided_jacobi(M)
        v1, v2 = V[..., 0], V[..., 1]
        w1, w2 = W[..., 0], W[..., 1]
        s1 = _norm(w1)
        u1 = torch.where(s1 > 0, w1 / torch.where(s1 > 0, s1, 1.0), v1)
        u2 = _unit_orthogonal(u1, (w2, v2, v1), 1e-12 * s1)
        Up = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], dim=-1)
        Vp = torch.stack([v1, v2, torch.linalg.cross(v1, v2)], dim=-1)
        sig = torch.diagonal(Up.mT @ M @ Vp, dim1=-2, dim2=-1)
        ctx.save_for_backward(Up, Vp, sig)
        return (Up @ Vp.mT).to(mats.dtype)

    @staticmethod
    def backward(ctx, grad):
        Up, Vp, sig = ctx.saved_tensors
        Y = Up.mT @ grad.to(torch.float64) @ Vp
        denom = sig[..., :, None] + sig[..., None, :]
        use = denom != 0
        dX = torch.where(use, (Y - Y.mT) / torch.where(
            use, denom, torch.ones_like(denom)), torch.zeros_like(Y))
        return (Up @ dX @ Vp.mT).to(grad.dtype)


def make_orthonormal(mats: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> the closest rotations (det +1), the function of the
    JAX package's `make_orthonormal` (nrsfm_modules.py:46-67), in tensor
    operations only, so that it runs inside a captured CUDA graph."""
    lead = mats.shape[:-2]
    return _ClosestRotation.apply(mats.reshape(-1, 3, 3)).reshape(
        *lead, 3, 3)


class _SparseCodingLayer(nn.Module):
    def __init__(self, dictionary_shape, enc: int, dec: int):
        super().__init__()
        self.dictionary = nn.Parameter(torch.empty(dictionary_shape))
        self.bias_encode_with_cam = nn.Parameter(torch.zeros(enc))
        self.bias_decode = nn.Parameter(torch.zeros(dec))


class _CameraEstimator(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.linear_comb_layer = nn.Conv2d(channels, 1, 1, bias=False)


class _CodeEstimator(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.fc_layer = nn.Conv2d(channels, channels, 3, bias=False)


def _uniform_(t: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class PANet(nn.Module):
    """pts (B, P, 3) -> (pts_recon, pts_recon_canonical, camera, code), the
    reference PANet.forward (nrsfmnet.py:51-72).

    `encode_with_relu` picks the encoder threshold (nrsfm_modules.py:92-95,
    143-146): relu_threshold, or block_soft_threshold; the decoder always
    uses the relu. Weights are drawn as the JAX package draws them (He
    uniform dictionaries, fan-in uniform camera and code layers, zero
    biases) from `generator`."""

    def __init__(self, pts_num: int = 21,
                 dict_sizes: Sequence[int] = DEFAULT_DICT_SIZES,
                 encode_with_relu: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ds = list(dict_sizes)
        self.pts_num = pts_num
        self.dict_sizes = tuple(ds)
        self.encode_with_relu = encode_with_relu
        layers = [_SparseCodingLayer((pts_num, 3, ds[0]), ds[0],
                                     pts_num * 3)]
        for i in range(1, len(ds)):
            layers.append(_SparseCodingLayer((ds[i - 1], ds[i], 1, 1),
                                             ds[i], ds[i - 1]))
        self.sparse_coding_layers = nn.ModuleList(layers)
        self.camera_estimator = _CameraEstimator(ds[-1])
        self.code_estimator = _CodeEstimator(ds[-1])
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax he_uniform (fan-in: 3 P for the first dictionary, D[i-1]
        for the others), the fan-in uniform of the camera (D[-1]) and code
        (9 D[-1]) layers, zero biases."""
        ds = self.dict_sizes
        for i, layer in enumerate(self.sparse_coding_layers):
            fan_in = 3 * self.pts_num if i == 0 else ds[i - 1]
            _uniform_(layer.dictionary, math.sqrt(6.0 / fan_in), generator)
            nn.init.zeros_(layer.bias_encode_with_cam)
            nn.init.zeros_(layer.bias_decode)
        _uniform_(self.camera_estimator.linear_comb_layer.weight,
                  1.0 / math.sqrt(ds[-1]), generator)
        _uniform_(self.code_estimator.fc_layer.weight,
                  1.0 / math.sqrt(9 * ds[-1]), generator)

    def forward(self, pts_3d: torch.Tensor):
        layers = self.sparse_coding_layers
        thresh = (relu_threshold if self.encode_with_relu
                  else block_soft_threshold)
        dict0 = layers[0].dictionary
        x = pts_3d.to(dict0.dtype)
        # (B, P, 3) x (P, 3, D) -> the (B, D, 3, 3) camera-equivariant code
        code = thresh(torch.einsum("pid,bpj->bdij", dict0, x),
                      layers[0].bias_encode_with_cam)
        for layer in layers[1:]:
            code = thresh(torch.einsum("co,bcij->boij",
                                       layer.dictionary[..., 0, 0], code),
                          layer.bias_encode_with_cam)

        cam_w = self.camera_estimator.linear_comb_layer.weight.reshape(-1)
        camera = make_orthonormal(torch.einsum("c,bcij->bij", cam_w, code))
        bottleneck = torch.einsum("bcij,ocij->bo", code,
                                  self.code_estimator.fc_layer.weight)

        z = bottleneck
        for layer in reversed(layers[1:]):
            z = torch.relu(torch.einsum("bo,co->bc", z,
                                        layer.dictionary[..., 0, 0])
                           + layer.bias_decode)
        recon = (torch.einsum("bd,pid->bpi", z, dict0)
                 + layers[0].bias_decode.reshape(self.pts_num, 3))
        return recon @ camera, recon, camera, bottleneck


def panet_reconstruction_fn(model: PANet):
    """(B, P, 3) centred points -> (B, P, 3) reconstruction, the callable
    the combined loss takes (PANet_reconstruction.py:58-62)."""
    def apply(pts):
        return model(pts)[0]
    return apply


def frobenius_norm_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sample flattened L2 norm, batch mean (train.py:14-17)."""
    return torch.linalg.vector_norm((a - b).flatten(1), dim=-1).mean()


def panet_loss(model: PANet, pts_3d: torch.Tensor,
               sparsity_weight: float = 1e-4):
    """The NRSfM_learner loss (train.py:83-104): Frobenius reconstruction
    plus `sparsity_weight` times mean |code|. Returns (loss, metrics)."""
    pts_recon, _, _, code = model(pts_3d)
    loss_recon = frobenius_norm_loss(pts_recon, pts_3d)
    loss_sparsity = code.abs().mean()
    loss = loss_recon + sparsity_weight * loss_sparsity
    mpjpe = torch.linalg.vector_norm(pts_recon - pts_3d, dim=-1).mean()
    return loss, {"loss": loss, "loss_recon": loss_recon,
                  "loss_sparsity": loss_sparsity, "mpjpe": mpjpe}


def panet_loss_per_sample(model: PANet, pts_3d: torch.Tensor) -> torch.Tensor:
    """Per-sample Frobenius reconstruction loss (train_kernel.py:470-479),
    the hard-example score of the composite trainer."""
    pts_recon = model(pts_3d)[0]
    return torch.linalg.vector_norm((pts_recon - pts_3d).flatten(1), dim=-1)


def load_panet(path: str, encode_with_relu: bool = True) -> PANet:
    """A PANet from a `.pth` state dict, sized from it and loaded strictly:
    the reference's `model_best.pth` or one that `cli.train_panet` wrote
    (the loader behind `load_nrsfm_tester`, base.py:111-115). The JAX
    package's orbax directories are not read."""
    from hand_integral_pose_estimation_tpu_torch.interop.snapshot import (
        load_state_dict_file,
    )

    if not path.endswith(".pth") or not os.path.isfile(path):
        raise ValueError(f"{path}: a PANet checkpoint is a .pth file (the "
                         f"JAX package's orbax directories are not read)")
    state_dict = load_state_dict_file(path)
    # sized from the file: the points and each layer's dictionary size
    ds, i = [], 0
    while f"sparse_coding_layers.{i}.dictionary" in state_dict:
        ds.append(state_dict[f"sparse_coding_layers.{i}.dictionary"].shape[
            -1 if i == 0 else 1])
        i += 1
    if not ds:
        raise ValueError(f"{path}: not a PANet state dict (no "
                         f"sparse_coding_layers.0.dictionary)")
    pts_num = state_dict["sparse_coding_layers.0.dictionary"].shape[0]
    model = PANet(pts_num, ds, encode_with_relu)
    model.load_state_dict(state_dict)
    return model
