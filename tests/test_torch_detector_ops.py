"""The port's detector ops against the JAX package on the CPU: box math,
NMS (the plain version of kernel 7, against the JAX fixpoint sweep, its
Pallas kernel in interpret mode and a sequential numpy oracle) and ROIAlign
(the plain version of kernel 6, against the JAX vmap path and its Pallas
kernel in interpret mode). Inputs come from numpy seeds; each comparison
states its tolerance."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.detect import box_ops as jbox
from hand_integral_pose_estimation_tpu_torch.detect import box_ops
from hand_integral_pose_estimation_tpu_torch.ops import kernels
from hand_integral_pose_estimation_tpu_torch.ops import nms as pnms
from hand_integral_pose_estimation_tpu_torch.ops import roi_align as proi
from test_detector import _np_greedy_nms

# the JAX package's ops/__init__ exports functions of these names
jnms = importlib.import_module("hand_integral_pose_estimation_tpu.ops.nms")
jroi = importlib.import_module(
    "hand_integral_pose_estimation_tpu.ops.roi_align")


def jax_nms_batched(boxes, scores, thr, top_k, **kw):
    run = jax.jit(lambda b, s: jnms.nms(b, s, thr, top_k, **kw))
    out = [run(jnp.asarray(b), jnp.asarray(s)) for b, s in zip(boxes, scores)]
    return tuple(np.stack([np.asarray(o[i]) for o in out]) for i in range(3))



# ------------------------------------------------------------------ box ops

def test_box_ops_match_jax_at_f64():
    """Anchors exactly; the encode / decode round trip and clipping at f64
    to 1e-12."""
    for args in ((16, (0.5, 1.0, 2.0), (4, 8, 16, 32)),
                 (16, (0.5, 1.0, 2.0), (8, 16, 32)), (8, (1.0,), (2, 3))):
        np.testing.assert_array_equal(box_ops.generate_base_anchors(*args),
                                      jbox.generate_base_anchors(*args))
    base = jbox.generate_base_anchors(16, (0.5, 1.0, 2.0), (4, 8, 16, 32))
    np.testing.assert_array_equal(
        box_ops.grid_anchors((5, 7), 16, base).numpy(),
        np.asarray(jbox.grid_anchors((5, 7), 16, base)))

    rng = np.random.RandomState(3)
    anchors = rng.rand(200, 4) * 50
    anchors[:, 2:] += anchors[:, :2] + 10
    gt = rng.rand(200, 4) * 50
    gt[:, 2:] += gt[:, :2] + 5
    deltas = rng.randn(200, 4) * 2          # some above the scale clamp
    for got, want in (
            (box_ops.encode_boxes(torch.from_numpy(anchors),
                                  torch.from_numpy(gt)),
             jbox.encode_boxes(jnp.asarray(anchors), jnp.asarray(gt))),
            (box_ops.decode_boxes(torch.from_numpy(anchors),
                                  torch.from_numpy(deltas)),
             jbox.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas))),
            (box_ops.clip_boxes(torch.from_numpy(gt * 2 - 20), (48, 70)),
             jbox.clip_boxes(jnp.asarray(gt * 2 - 20), (48, 70)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    rec = box_ops.decode_boxes(torch.from_numpy(anchors),
                               box_ops.encode_boxes(torch.from_numpy(anchors),
                                                    torch.from_numpy(gt)))
    np.testing.assert_allclose(rec.numpy(), gt, atol=1e-12)


# ---------------------------------------------------------------------- NMS

def nms_inputs(mode: str, B: int, N: int, seed: int):
    """float32 boxes (B, N, 4) and scores (B, N): the alternating chain
    across tiles, random boxes, proposal-like clusters of near-duplicates,
    tied scores with a tenth at -1 (the min-size filter's ties)."""
    rng = np.random.RandomState(seed)
    if mode == "chain":
        i = np.arange(N, dtype=np.float64)
        b = np.stack([4 * i, 0 * i, 4 * i + 10, 0 * i + 10], -1)
        return (np.broadcast_to(b, (B, N, 4)).astype(np.float32),
                np.broadcast_to(np.linspace(1.0, 0.5, N), (B, N))
                .astype(np.float32))
    if mode == "random":
        ctr = rng.rand(B, N, 2) * 300
        wh = rng.rand(B, N, 2) * 60 + 5
    else:
        ctr = rng.rand(B, N, 2) * 40 + np.repeat(
            rng.rand(B, 7, 2) * 200, -(-N // 7), axis=1)[:, :N]
        wh = rng.rand(B, N, 2) * 30 + 20
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = rng.rand(B, N)
    if mode == "ties":
        scores = np.round(scores * 8) / 8
        scores[rng.rand(B, N) < 0.1] = -1.0
    return boxes.astype(np.float32), scores.astype(np.float32)


# (mode, B, N, IoU threshold, top_k, score threshold)
NMS_CASES = [("chain", 1, 1100, 0.3, 1100, -math.inf),
             ("random", 2, 700, 0.7, 300, -math.inf),
             ("clustered", 2, 700, 0.7, 300, 0.0),
             ("ties", 2, 300, 0.5, 40, 0.0),
             ("clustered", 2, 120, 0.3, 200, 0.5)]


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_matches_jax_and_the_oracle(case, early_exit):
    """The plain NMS has the keep sets of the JAX fixpoint sweep (and its
    boxes and scores bitwise), covering the chain whose every box depends
    on a suppressor tiles earlier, ties, score thresholds, top_k > N and
    the early exit; without a score threshold and without ties, also the
    keep order of the sequential numpy oracle."""
    mode, B, N, thr, top_k, score_thr = case
    boxes, scores = nms_inputs(mode, B, N, seed=N)
    got = pnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                   top_k, score_thr, early_exit=early_exit)
    want = jax_nms_batched(boxes, scores, thr, top_k, impl="xla",
                           score_threshold=score_thr, early_exit=early_exit)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if mode in ("chain", "random") and score_thr == -math.inf \
            and not early_exit:
        for i in range(B):
            keep = _np_greedy_nms(boxes[i].astype(np.float64),
                                  scores[i].astype(np.float64), thr)[:top_k]
            n = int(got[2][i].sum())
            assert n == len(keep)
            np.testing.assert_array_equal(got[0][i, :n].numpy(),
                                          boxes[i, keep])
    if mode == "chain":
        assert int(got[2].sum()) == N // 2


@pytest.mark.parametrize("case", [NMS_CASES[0], NMS_CASES[2], NMS_CASES[3]])
def test_nms_matches_the_pallas_kernel(case):
    """Kernel 7's TPU form (`_nms_kernel`, interpret mode) gives the same
    keep sets; it is divide-free (inter > thr * union), equal to the plain
    IoU test on these inputs."""
    mode, B, N, thr, top_k, score_thr = case
    boxes, scores = nms_inputs(mode, B, N, seed=N)
    got = pnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                   top_k, score_thr)
    want = jax_nms_batched(boxes, scores, thr, top_k, impl="pallas",
                           interpret=True, score_threshold=score_thr)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6)


def test_nms_auto_takes_the_plain_version_on_the_cpu():
    boxes, scores = nms_inputs("random", 2, 50, seed=1)
    before = [k.launches for k in kernels.KERNELS]
    b, s, v = pnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       0.5, 10)
    assert b.shape == (2, 10, 4) and s.shape == (2, 10) and v.dtype == \
        torch.bool
    assert [k.launches for k in kernels.KERNELS] == before
    with pytest.raises(ValueError):
        pnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 10,
                 impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        pnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 10,
                 impl="pallas")


# ----------------------------------------------------------------- ROIAlign

def roi_inputs(B, H, W, C, R, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, H, W, C).astype(np.float32)
    lo = rng.uniform(-40, 16 * max(H, W), (B, R, 2))
    rois = np.concatenate([lo, lo + rng.uniform(2, 200, (B, R, 2))], -1)
    return feats, rois.astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_roi_align_matches_jax(impl):
    """C = 256, H*W = 21*19 (not a multiple of 8), 13 RoIs (not a multiple
    of the Pallas group size), RoIs crossing the border and thinner than a
    cell: 1e-5 (float32 sums in another order; the Pallas kernel rounds no
    operand to bf16 in interpret mode on the CPU)."""
    feats, rois = roi_inputs(2, 21, 19, 256, 13, seed=4)
    got = proi.roi_align_batched(torch.from_numpy(feats),
                                 torch.from_numpy(rois), 7, 1 / 16.0, 2)
    want = jroi.roi_align_batched(jnp.asarray(feats), jnp.asarray(rois), 7,
                                  1 / 16.0, 2, impl=impl,
                                  interpret=impl == "pallas")
    assert got.shape == (2, 13, 7, 7, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    one = proi.roi_align(torch.from_numpy(feats[1]), torch.from_numpy(rois[1]))
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=1e-6,
                               atol=1e-6)


def test_roi_pool_matches_jax_and_roi_align_differentiates():
    feats, rois = roi_inputs(1, 9, 11, 5, 6, seed=5)
    got = proi.roi_pool(torch.from_numpy(feats[0]), torch.from_numpy(rois[0]))
    want = jroi.roi_pool(jnp.asarray(feats[0]), jnp.asarray(rois[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    f = torch.from_numpy(feats).requires_grad_()
    proi.roi_align_batched(f, torch.from_numpy(rois)).sum().backward()
    assert float(f.grad.abs().sum()) > 0
