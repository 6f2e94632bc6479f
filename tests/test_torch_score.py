"""The port's offline scorer against the JAX package at float64 on the CPU
(tests/conftest.py enables x64 for JAX): `align_w_scale`,
`scale_by_root_depth`, `pck_auc`, `aligned_pck_auc`,
`estimate_absolute_depth` (both of its branches), `score_predictions`
(scores.txt equal as text) and `cli.score` on a .json and an .npy.

Tolerance: 1e-10 relative (with an absolute floor of 1e-12 for entries
near 0). Both packages form the same float64 operations; only the 3x3
SVD's LAPACK routine, reduction orders and the last bit of some PCK
thresholds (`torch.linspace` against `jnp.linspace`) differ, ~1e-15
relative. A distance within an ulp of a threshold would flip a PCK count;
the inputs here have none (the curves compare at 1e-10, well below one
count's share of 1 / (24 * 21))."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.cli import score as jcli_score
from hand_integral_pose_estimation_tpu.evaluation import evaluator as jeval
from hand_integral_pose_estimation_tpu.evaluation import metrics as jmetrics
from hand_integral_pose_estimation_tpu.geometry import procrustes as jproc
from hand_integral_pose_estimation_tpu_torch.cli import score as cli_score
from hand_integral_pose_estimation_tpu_torch.evaluation import (
    evaluator,
    metrics,
)
from hand_integral_pose_estimation_tpu_torch.geometry import procrustes

RTOL, ATOL = 1e-10, 1e-12


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _hands(n=24, seed=0):
    """Ground truth (n, 21, 3) hands ~8 cm across half a metre in front of
    the camera, and predictions: each rotated, scaled, shifted and
    perturbed by 1-3 cm, so that PCK over 0-5 cm is neither 0 nor 1."""
    rng = np.random.default_rng(seed)
    gt = (np.array([0.01, -0.005, 0.47])
          + rng.uniform(-0.04, 0.04, size=(n, 21, 3)))
    a = rng.uniform(-0.3, 0.3, size=n)
    rot = np.zeros((n, 3, 3))
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(a)
    rot[:, 0, 1], rot[:, 1, 0] = -np.sin(a), np.sin(a)
    rot[:, 2, 2] = 1.0
    scale = rng.uniform(0.8, 1.2, size=(n, 1, 1))
    pred = (scale * (gt - gt.mean(1, keepdims=True)) @ rot
            + gt.mean(1, keepdims=True) + rng.normal(0, 0.01, size=(n, 1, 3))
            + rng.normal(0, 0.012, size=gt.shape))
    return gt, pred


def test_align_w_scale_matches_jax():
    gt, pred = _hands()
    got = procrustes.align_w_scale(torch.as_tensor(gt), torch.as_tensor(pred))
    assert got.dtype == torch.float64
    _close(got, jproc.align_w_scale(jnp.asarray(gt), jnp.asarray(pred)))


def test_scale_by_root_depth_matches_jax():
    gt, _ = _hands(seed=1)
    rng = np.random.default_rng(1)
    depth, tprime = rng.uniform(0.3, 0.9, 24), rng.uniform(500, 700, 24)
    got = metrics.scale_by_root_depth(*map(torch.as_tensor,
                                           (gt, depth, tprime)))
    _close(got, jmetrics.scale_by_root_depth(*map(jnp.asarray,
                                                  (gt, depth, tprime))))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("aligned", [False, True])
def test_pck_auc_matches_jax(aligned, masked):
    """Every field of PCKResult; with a visibility mask that hides some
    entries and one joint entirely (skipped, as EvalUtil skips it)."""
    gt, pred = _hands(seed=2)
    kw = {}
    if masked:
        vis = np.random.default_rng(2).uniform(size=gt.shape[:2]) > 0.3
        vis[:, 4] = False
        kw = {"vis": vis}
    port_fn = metrics.aligned_pck_auc if aligned else metrics.pck_auc
    jax_fn = jmetrics.aligned_pck_auc if aligned else jmetrics.pck_auc
    got = port_fn(torch.as_tensor(pred), torch.as_tensor(gt),
                  **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = jax_fn(jnp.asarray(pred), jnp.asarray(gt),
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        _close(g, w)
    assert 0.05 < float(got.auc) < 0.95


def test_estimate_absolute_depth_matches_jax_on_both_branches():
    """Hands projected through K; the true bone length gives real roots,
    a bone far shorter than the projected one a negative discriminant
    (the complex-pair magnitude)."""
    gt, _ = _hands(n=16, seed=3)
    K = np.array([[531.9, 0.0, 112.0], [0.0, 532.2, 112.0], [0.0, 0.0, 1.0]])
    uv = gt @ K.T
    uv = uv[..., :2] / uv[..., 2:]
    root = gt[:, 9:10, 2]
    pre = np.concatenate([uv, gt[..., 2:] - root[..., None]], axis=-1)
    bone = np.linalg.norm(gt[:, 9] - gt[:, 10], axis=-1)
    bone = np.where(np.arange(16) % 2 == 0, bone, 0.05 * bone)
    Ks = np.broadcast_to(K, (16, 3, 3)).copy()
    depth, cplx = metrics.estimate_absolute_depth(
        *map(torch.as_tensor, (bone, Ks, pre)))
    jdepth, jcplx = jmetrics.estimate_absolute_depth(
        *map(jnp.asarray, (bone, Ks, pre)))
    np.testing.assert_array_equal(cplx.numpy(), np.asarray(jcplx))
    assert cplx.any() and not cplx.all()
    _close(depth, jdepth)


def test_score_predictions_matches_jax(tmp_path):
    gt, pred = _hands(seed=4)
    got = evaluator.score_predictions(pred, gt,
                                      output_dir=str(tmp_path / "port"))
    want = jeval.score_predictions(pred, gt, output_dir=str(tmp_path / "jax"))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    text = (tmp_path / "port" / "scores.txt").read_text()
    assert text == (tmp_path / "jax" / "scores.txt").read_text()
    assert text.count("\n") == 4


@pytest.mark.parametrize("suffix", [".json", ".npy"])
def test_cli_score_matches_jax(tmp_path, capsys, suffix):
    """cli.score --pred (pred.json of [xyz_list, verts_list], or .npy)
    --gt --output-dir: the same printout and scores.txt as the JAX CLI."""
    gt, pred = _hands(seed=5)
    np.save(tmp_path / "gt.npy", gt)
    pred_path = tmp_path / f"pred{suffix}"
    if suffix == ".json":
        with open(pred_path, "w") as f:
            json.dump([pred.tolist(), [np.zeros((778, 3)).tolist()] * 2], f)
    else:
        np.save(pred_path, pred)
    outs = {}
    for name, cli in (("jax", jcli_score), ("port", cli_score)):
        result = cli.main(["--pred", str(pred_path), "--gt",
                           str(tmp_path / "gt.npy"), "--output-dir",
                           str(tmp_path / name)])
        outs[name] = (result, capsys.readouterr().out)
    assert outs["port"][1] == outs["jax"][1]
    assert outs["port"][1].startswith("Evaluation 3D KP results:\nauc=")
    for k, v in outs["jax"][0].items():
        np.testing.assert_allclose(outs["port"][0][k], v, rtol=RTOL)
    assert ((tmp_path / "port" / "scores.txt").read_text()
            == (tmp_path / "jax" / "scores.txt").read_text())
    assert os.listdir(tmp_path / "port") == ["scores.txt"]
