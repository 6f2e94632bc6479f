"""Camera, crop-box, label and warp geometry: frozen copies of the port's
plain paths (geometry/*.py, ops/warp.py's two-pass and axis-aligned
warps), which follow the reference repository's common/augment.py."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ROOT_IDX = 9


# ---------------------------------------------------------------- camera
def project_points(xyz, R, K):
    """(..., N, 3) metres -> uv (..., N, 2), z_mm (..., N) after R
    (augment.py:80-87)."""
    xyz_rot = torch.einsum("...ij,...nj->...ni", R, xyz)
    uvw = torch.einsum("...ij,...nj->...ni", K, xyz_rot)
    return uvw[..., :2] / uvw[..., 2:3], xyz_rot[..., 2] * 1000.0


def pixel2cam(pixel, K, q=lambda t: t):
    """(u, v, z_mm) -> camera metres (augment.py:89-103); `q` rounds the
    product's operands."""
    uv1 = torch.cat([pixel[..., :2], torch.ones_like(pixel[..., 2:3])], -1)
    rays = torch.einsum("...ij,...nj->...ni", q(torch.linalg.inv(K)), q(uv1))
    return rays * (pixel[..., 2:3] / 1000.0)


# ---------------------------------------------------------------- boxes
def scale_bbox(bbox, pad_factor=1.75):
    """Square the box, then pad (augment.py:344-356)."""
    cx, cy, w, h = bbox.unbind(-1)
    h2 = torch.where(w > h, w, h)
    w2 = torch.where(w < h, h, w)
    return torch.stack([cx, cy, w2 * pad_factor, h2 * pad_factor], -1)


def bbox_from_keypoints(uv, pad_factor=1.75):
    """GT crop box of projected joints (augment.py:282-315)."""
    x, y = uv[..., 0], uv[..., 1]
    u, d = y.amin(-1), y.amax(-1)
    l, r = x.amin(-1), x.amax(-1)
    box = torch.stack([(l + r) * 0.5, (u + d) * 0.5, r - l, d - u], -1)
    return scale_bbox(box, pad_factor)


def bbox_from_detection(boxes, scores, pad_factor=1.75):
    """The best-scoring xyxy box -> centre by floor division, square, pad
    (augment.py:317-342)."""
    best = boxes[torch.arange(len(boxes)), scores.argmax(-1)]
    x1, y1, x2, y2 = best.unbind(-1)
    box = torch.stack([torch.floor((x1 + x2) / 2.0),
                       torch.floor((y1 + y2) / 2.0), x2 - x1, y2 - y1], -1)
    return scale_bbox(box, pad_factor)


def tprime_from_bbox(bbox, K, c=100.0):
    w, h = bbox[..., 2], bbox[..., 3]
    L = torch.maximum(w, h)
    return c * torch.where(L == w, K[..., 0, 0], K[..., 1, 1]) / L


def trans_from_box(bbox, size, inv=False):
    """box (cx, cy, w, h) -> patch map (or its inverse), (..., 3, 3)
    (augment.py:457-506)."""
    cx, cy, w, h = bbox.unbind(-1)
    sx, sy = size / w, size / h
    tx, ty = -sx * (cx - w * 0.5), -sy * (cy - h * 0.5)
    if inv:
        sx, sy = 1.0 / sx, 1.0 / sy
        tx, ty = cx - size * 0.5 * sx, cy - size * 0.5 * sy
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([torch.stack([sx, z, tx], -1),
                        torch.stack([z, sy, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def transform_points_2d(points, H, q=lambda t: t):
    ph = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    out = torch.einsum("...ij,...nj->...ni", q(H), q(ph))
    return out[..., :2] / out[..., 2:3]


# ---------------------------------------------------------------- labels
class Labels(NamedTuple):
    label: torch.Tensor        # (B, J, 3) encoded patch label
    tprime: torch.Tensor       # (B,)
    trans: torch.Tensor        # (B, 3, 3) image -> patch
    trans_inv: torch.Tensor    # (B, 3, 3) patch -> image
    bbox: torch.Tensor         # (B, 4)


def patch_labels(joint_cam, R, K, bbox, size=224):
    """The label half of generate_patch_image (augment.py:358-413)."""
    _, z = project_points(joint_cam, R, K)
    tprime = tprime_from_bbox(bbox, K)
    jcn = joint_cam * (tprime / z[..., ROOT_IDX])[..., None, None]
    uv, zs = project_points(jcn, R, K)
    trans = trans_from_box(bbox, size)
    uvp = transform_points_2d(uv, trans)
    zp = zs - tprime[..., None]
    label = torch.stack([uvp[..., 0] / size - 0.5, uvp[..., 1] / size - 0.5,
                         zp / size], -1)
    return Labels(label, tprime, trans, trans_from_box(bbox, size, True),
                  bbox)


def label_to_camera(label, trans_inv, tprime, K, size=224, q=lambda t: t):
    """Label -> camera metres, no derotation (FreiHand.py:686-725); `q`
    rounds the products' operands."""
    coords = torch.stack([(label[..., 0] + 0.5) * size,
                          (label[..., 1] + 0.5) * size,
                          label[..., 2] * size], -1)
    uv = transform_points_2d(coords[..., :2], trans_inv, q)
    img = torch.cat([uv, (coords[..., 2] + tprime[..., None])[..., None]], -1)
    return pixel2cam(img, K, q)


def scale_by_ref_bone(kpt, ref, a=9, b=10):
    n = torch.linalg.vector_norm(kpt[..., a, :] - kpt[..., b, :], dim=-1)
    return kpt * (ref / n)[..., None, None]


# ---------------------------------------------------------------- warps
def _resample_2tap(src, coord, dim):
    n = src.shape[dim]
    i0 = torch.floor(coord)
    frac = (coord - i0).to(src.dtype)[..., None]
    out = torch.zeros((), dtype=src.dtype, device=src.device)
    for idx, w in ((i0, 1.0 - frac), (i0 + 1.0, frac)):
        valid = (idx >= 0) & (idx <= n - 1)
        gi = torch.where(valid, idx, torch.zeros_like(idx)).long()
        vals = torch.gather(src, dim, gi[..., None].expand(
            *coord.shape, src.shape[-1]))
        out = out + torch.where(valid[..., None], vals * w,
                                torch.zeros_like(vals))
    return out.masked_fill(torch.isnan(coord)[..., None], math.nan)


def warp_twopass(images, H, size):
    """Homography warp as two separable 1-D bilinear resamples, the
    training augmentation's filter (the port's and the JAX package's
    `warp_perspective_twopass`); images (B, Hs, Ws, C) -> (B, size, size,
    C) float32. The inverse map is formed in float64 and rounded once."""
    m = torch.linalg.inv(H.double())
    m = (m / m[:, 2:3, 2:3]).reshape(-1, 9)[:, :8].float()
    a, b, c, d, e, f, g, h = (k[:, None, None] for k in m.unbind(1))
    Hs = images.shape[1]
    dev = images.device
    xo = torch.arange(size, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(Hs, dtype=torch.float32, device=dev)[None, :, None]
    yA = (ys * g * xo + ys - d * xo - f) / (e - ys * h)
    u = (a * xo + b * yA + c) / (g * xo + h * yA + 1.0)
    tmp = _resample_2tap(images.float(), u, dim=2)
    yo = torch.arange(size, dtype=torch.float32, device=dev)[None, :, None]
    v = (d * xo + e * yo + f) / (g * xo + h * yo + 1.0)
    return _resample_2tap(tmp, v, dim=1)


def warp_axis_aligned(images, H, out_hw):
    """Axis-aligned affine warp (a scale and a shift), exact single-pass
    bilinear with a zero border, as two batched products."""
    Hi = torch.linalg.inv(H)
    Hi = Hi / Hi[:, 2:3, 2:3]
    Ho, Wo = out_hw
    B, Hs, Ws, _ = images.shape
    dev = images.device
    a, c = Hi[:, 0, 0, None, None], Hi[:, 0, 2, None, None]
    e, f = Hi[:, 1, 1, None, None], Hi[:, 1, 2, None, None]
    xo = torch.arange(Wo, dtype=torch.float32, device=dev)[None, None, :]
    xs = torch.arange(Ws, dtype=torch.float32, device=dev)[None, :, None]
    Wx = torch.relu(1.0 - torch.abs(xs - (a * xo + c)))
    yo = torch.arange(Ho, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(Hs, dtype=torch.float32, device=dev)[None, :, None]
    Wy = torch.relu(1.0 - torch.abs(ys - (e * yo + f)))
    tmp = torch.einsum("bjic,bio->bjoc", images.float(), Wx)
    return torch.einsum("bjoc,bjy->byoc", tmp, Wy)


def normalise(patch, colour, mean):
    """clamp((patch - mean) * colour, 0, 255) (the std is 1)."""
    m = torch.tensor(mean, dtype=patch.dtype, device=patch.device)
    return torch.clamp((patch - m) * colour, 0.0, 255.0)


# ---------------------------------------------------------------- draws
def rodrigues(rvec):
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    small = theta < 1e-8
    axis = rvec / torch.where(small, torch.ones_like(theta), theta)
    theta = theta[..., 0]
    x, y, z = axis.unbind(-1)
    o = torch.zeros_like(x)
    Km = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                      torch.stack([-y, x, o], -1)], -2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(Km.shape)
    R = (eye + torch.sin(theta)[..., None, None] * Km
         + (1.0 - torch.cos(theta))[..., None, None] * (Km @ Km))
    return torch.where(small[..., None], eye, R)


def rotation_z(t):
    c, s = torch.cos(t), torch.sin(t)
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, o], -1), torch.stack([s, c, o], -1),
                        torch.stack([o, o, i], -1)], -2)


def augmentation_draws(generator, batch, rot_prob=0.4, z_range=0.52,
                       arbitrary_range=0.05, color_factor=0.2):
    """(R (B, 3, 3), colour (B, 3)) drawn from `generator` in the order the
    training augmentation draws them (augment.py:246-280): the rotation's
    switch, angle, sign, tilt angle and axis, then the colour scale."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    apply = uniform((batch,), 0.0, 1.0) > (1.0 - rot_prob)
    theta1 = uniform((batch,), -z_range, z_range)
    sgn = torch.sign(torch.randn(batch, generator=generator, device=dev))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    theta2 = uniform((batch,), -arbitrary_range, arbitrary_range)
    axis = torch.randn(batch, 3, generator=generator, device=dev)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    R = rotation_z(sgn * theta1) @ rodrigues(axis * theta2[:, None])
    eye = torch.eye(3, device=dev).expand(batch, 3, 3)
    R = torch.where(apply[:, None, None], R, eye)
    colour = uniform((batch, 3), 1.0 - color_factor, 1.0 + color_factor)
    return R, colour
