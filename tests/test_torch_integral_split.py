"""The plans of the soft-argmax kernels (kernels 1 and 2), emulated step by
step on the CPU and held against the JAX package.

Kernel 1 (`csrc/softmax_integral.cu`, vectorised path) cuts each image's
H*W rows into chunks of ceil(H*W / chunks) rows (the last ones may be
short or empty). A CTA walks its chunk with a few rows side by side; each
lane folds K rows per step (2 of bf16, 1 of float32): it takes each
channel's max over them, rescales its online state (m, sum e, sum e col,
sum e row) only when the running max rises, and adds one exp per
element. The CTA merges its lanes in order and writes one state per
(image, chunk, channel); a second launch merges each channel's chunks in
chunk order, then the channels of each joint.

Kernel 2 (`csrc/softmax_integral_bwd.cu`) forms its per-channel constants
from the (B, J) statistics, indexing each channel's joint on its own, so a
group of 8 channels may span two joints when D is not a multiple of 8.

Inputs come from numpy seeds; the JAX side is `_softmax_integral_xla`,
the Pallas kernels in interpret mode (as tests/test_integral.py runs
them) and the port's plain backward.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.ops import integral as jintegral
from hand_integral_pose_estimation_tpu_torch.ops import integral

B = 2
# (H, W, J, D): 8-channel groups inside a joint (D = 56), across joints
# (D = 4, 100), and a width that does not divide the row lanes' step
SHAPES = [(8, 8, 3, 4), (7, 5, 3, 56), (8, 8, 2, 100)]
# 1, 3, a count that divides neither 64 nor 35 rows, and more chunks than
# rows (empty chunks)
CHUNKS = [1, 3, 6, "rows+7"]
# rows a CTA walks side by side: a count that divides neither width
ROW_LANES = 3
# coords and m absolute, s relative: the same sums in another order
TOL = 1e-5
# the backward to 1e-5 of its largest entry
GRAD_SCALE = 1e-5


def _heatmap(shape, seed):
    H, W, J, D = shape
    rng = np.random.default_rng(seed)
    # logits spread as a trained head's (std 3), so the running max rises
    # many times across rows, lanes and chunks
    return (3 * rng.normal(size=(B, H, W, J * D))).astype(np.float64)


def _merge(a, b):
    """online_softmax.cuh `merge` on (m, s, sx, sy) tensors, elementwise;
    two empty states stay empty (no exp(-inf - (-inf)))."""
    m = torch.maximum(a[0], b[0])
    empty = m == -torch.inf
    safe = torch.where(empty, torch.zeros_like(m), m)
    ca = torch.where(empty, torch.ones_like(m), torch.exp(a[0] - safe))
    cb = torch.where(empty, torch.zeros_like(m), torch.exp(b[0] - safe))
    return (torch.where(empty, a[0], m),) + tuple(
        x * ca + y * cb for x, y in zip(a[1:], b[1:]))


def _empty(shape, dtype):
    return (torch.full(shape, -torch.inf, dtype=dtype),) + tuple(
        torch.zeros(shape, dtype=dtype) for _ in range(3))


def _chunk_state(h, r_begin, r_end, width, lanes, k_rows):
    """One CTA of the first launch: (B, C) states of rows [r_begin,
    r_end), `lanes` rows side by side, `k_rows` rows folded at a time."""
    Bn, _, C = h.shape
    lane_states = []
    for lane in range(lanes):
        m, s, sx, sy = _empty((Bn, C), h.dtype)
        for first in range(r_begin + lane, r_end, k_rows * lanes):
            rows = [r for r in range(first, first + k_rows * lanes, lanes)
                    if r < r_end]
            x = h[:, rows]                                   # (B, k, C)
            lm = x.amax(dim=1)
            rise = lm > m
            scale = torch.exp(torch.where(rise, m - lm, torch.zeros_like(m)))
            s, sx, sy = s * scale, sx * scale, sy * scale
            m = torch.where(rise, lm, m)
            e = torch.exp(x - m[:, None])
            col = torch.tensor([r % width for r in rows], dtype=h.dtype)
            row = torch.tensor([r // width for r in rows], dtype=h.dtype)
            s = s + e.sum(dim=1)
            sx = sx + (e * col[None, :, None]).sum(dim=1)
            sy = sy + (e * row[None, :, None]).sum(dim=1)
        lane_states.append((m, s, sx, sy))
    state = lane_states[0]
    for other in lane_states[1:]:
        state = _merge(state, other)
    return state


def _emulated_forward(hm, J, D, chunks, dtype, k_rows):
    """Kernel 1's vectorised plan in `dtype`: coords (B, J, 3), m, s."""
    Bn, H, W, C = hm.shape
    rows = H * W
    h = torch.from_numpy(hm).to(dtype).reshape(Bn, rows, C)
    per_chunk = -(-rows // chunks)
    states = []
    for q in range(chunks):
        r_begin = min(rows, q * per_chunk)
        r_end = min(rows, r_begin + per_chunk)
        states.append(_chunk_state(h, r_begin, r_end, W, ROW_LANES, k_rows))
    channel = states[0]
    for other in states[1:]:        # the second launch: chunk order
        channel = _merge(channel, other)
    m, s, sx, sy = (t.reshape(Bn, J, D) for t in channel)
    sz = s * torch.arange(D, dtype=dtype)
    joint = (m[..., 0], s[..., 0], sx[..., 0], sy[..., 0], sz[..., 0])
    for d in range(1, D):           # then the joint's channels
        mm = torch.maximum(joint[0], m[..., d])
        ca, cb = torch.exp(joint[0] - mm), torch.exp(m[..., d] - mm)
        joint = (mm,) + tuple(a * ca + b[..., d] * cb for a, b in
                              zip(joint[1:], (s, sx, sy, sz)))
    mj, sj, ex, ey, ez = joint
    coords = torch.stack([ex / sj / W - 0.5, ey / sj / H - 0.5,
                          ez / sj / D - 0.5], dim=-1)
    return coords, mj, sj


@functools.lru_cache(maxsize=None)
def _jax_forward(shape):
    """(XLA at float64, Pallas in interpret mode at float32) of one input."""
    H, W, J, D = shape
    hm = _heatmap(shape, seed=H * W + J * D)
    xla = jintegral._softmax_integral_xla(jnp.asarray(hm), J, D)
    pallas = jintegral._softmax_integral_pallas(
        jnp.asarray(hm.astype(np.float32)), J, D, interpret=True)
    return hm, tuple(tuple(np.asarray(a, np.float64) for a in r)
                     for r in (xla, pallas))


def _assert_close(got, want):
    coords, m, s = (t.double().numpy() for t in got)
    np.testing.assert_allclose(coords, want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(m, want[1], rtol=0, atol=TOL)
    np.testing.assert_allclose(s, want[2], rtol=TOL, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel1_chunked_plan_matches_jax(shape):
    """Partial states per (image, chunk, channel), merged in chunk order
    and then over each joint's channels, give the XLA soft-argmax and
    the Pallas kernel's outputs at float64 and float32, for every chunk
    count; empty chunks add nothing."""
    H, W, J, D = shape
    hm, (xla, pallas) = _jax_forward(shape)
    for dtype in (torch.float64, torch.float32):
        for chunks in CHUNKS:
            n = H * W + 7 if chunks == "rows+7" else chunks
            # K rows folded per step: 1 for float32 heatmaps, 2 for bf16
            for k_rows in (1, 2):
                got = _emulated_forward(hm, J, D, n, dtype, k_rows)
                _assert_close(got, xla)
                _assert_close(got, pallas)


def _emulated_constants(m, s, coords, cot, H, W, D):
    """Kernel 2's m, T, A, B per channel, (B, J*D) each, formed from the
    (B, J) statistics of each channel's own joint, as its `joint_terms`
    and `channel_t` do."""
    Bn, J = m.shape
    C = J * D
    consts = torch.empty(4, Bn, C, dtype=m.dtype)
    for c in range(C):
        j, d = divmod(c, D)
        sj = s[:, j]
        cx, cy, cz = coords[:, j].unbind(-1)
        ox, oy, oz = cot[:, j].unbind(-1)
        txy = ox * (-0.5 - cx) + oy * (-0.5 - cy)
        gz = torch.tensor(d, dtype=m.dtype) / D - 0.5
        consts[0, :, c] = m[:, j]
        consts[1, :, c] = (txy + oz * (gz - cz)) / sj
        consts[2, :, c] = ox / (sj * W)
        consts[3, :, c] = oy / (sj * H)
    return consts


def _excess(got, want, scale):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() - scale * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES + [(7, 5, 4, 6)])
def test_kernel2_constants_fold_the_jax_backward(shape):
    """exp(h - m_c) (T_c + A_c col + B_c row) with the constants formed per
    channel from (B, J) statistics gives the Pallas backward (interpret
    mode) and the port's plain backward at float64 and float32; the
    constants equal `channel_constants`, which the fused head's backward
    still uses."""
    H, W, J, D = shape
    hm = _heatmap(shape, seed=100 + J * D)
    coords, m, s = (np.array(a) for a in jintegral._softmax_integral_xla(
        jnp.asarray(hm), J, D))
    cot = np.random.default_rng(J * D).normal(size=(B, J, 3))
    plain = integral.softmax_integral_bwd_reference(
        torch.from_numpy(hm), *(torch.from_numpy(np.array(a))
                                for a in (m, s, coords, cot)), J, D)
    f32 = [jnp.asarray(np.asarray(a, np.float32))
           for a in (hm, m, s, coords, cot)]
    pallas = jintegral._softmax_integral_bwd_pallas(*f32, J, D,
                                                    interpret=True)
    rows = torch.arange(H * W)
    for dtype in (torch.float64, torch.float32):
        t = [torch.from_numpy(np.array(a)).to(dtype)
             for a in (m, s, coords, cot)]
        consts = _emulated_constants(*t, H, W, D)
        for got, want in zip(consts, integral.channel_constants(
                *t, H, W, D, dtype=dtype)):
            torch.testing.assert_close(got, want, rtol=1e-6 if dtype ==
                                       torch.float32 else 1e-12, atol=0)
        col = (rows % W).to(dtype)[None, :, None]
        row = (rows // W).to(dtype)[None, :, None]
        h = torch.from_numpy(hm).to(dtype).reshape(B, H * W, J * D)
        mc, T, A, Bc = consts[:, :, None, :]
        grad = (torch.exp(h - mc) * (T + A * col + Bc * row)
                ).reshape(hm.shape)
        assert _excess(grad.numpy(), plain.numpy(), GRAD_SCALE) <= 0
        assert _excess(grad.numpy(), pallas, GRAD_SCALE) <= 0
