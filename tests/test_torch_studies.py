"""The port's study CLIs on the CPU at toy scale, mirroring
tests/test_semi_supervised_cli.py: `subset_view`, the three-arm
semi-supervised study, the cascade-survival study (whose single pass and
cascade keep sets must agree), and `analyze_correlation`'s per-sample CSV
against the JAX CLI's on the same weights (a JAX teacher snapshot and its
bridge into a port snapshot, one PANet .pth read by both)."""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu import config as jconfig
from hand_integral_pose_estimation_tpu.cli import (
    analyze_correlation as jcorr,
)
from hand_integral_pose_estimation_tpu.data.freihand import (
    SyntheticFreiHand as JaxSyntheticFreiHand,
)
from hand_integral_pose_estimation_tpu.training import (
    checkpoint as jcheckpoint,
)
from hand_integral_pose_estimation_tpu.training import (
    create_train_state as jax_create_train_state,
)
from hand_integral_pose_estimation_tpu_torch.cli import (
    analyze_correlation,
    filter_cascade_study,
    semi_supervised_study,
)
from hand_integral_pose_estimation_tpu_torch.cli import train as cli_train
from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.models.panet import PANet
from hand_integral_pose_estimation_tpu_torch.training import (
    checkpoint,
    make_optimizer,
)
from test_torch_pose_net import jax_pose_net, port_model, \
    randomized_jax_variables

TINY = ["--batch-size", "4", "--pose-resnet", "18", "--pose-input", "32",
        "--device", "cpu"]


def test_study_subset_view():
    """Per-sample arrays sliced together, the labelled mask overridden,
    the counts recomputed, the original untouched."""
    ds = SyntheticFreiHand(n=12, image_hw=(32, 32), seed=5)
    idx = np.asarray([1, 3, 5, 7])
    sub = semi_supervised_study.subset_view(
        ds, idx, np.asarray([True, False, True, False]))
    assert sub.n == 4 and len(sub) == 4
    assert sub.num_labelled == 2 and sub.num_unlabelled == 2
    np.testing.assert_array_equal(sub.images, ds.images[idx])
    np.testing.assert_array_equal(sub.joint_cam, ds.joint_cam[idx])
    np.testing.assert_array_equal(sub.ref_bone_len, ds.ref_bone_len[idx])
    b = sub.host_batch(np.asarray([0, 2]))
    np.testing.assert_array_equal(b["image"], ds.images[[1, 5]])
    assert b["labelled"].tolist() == [True, True]
    assert ds.n == 12 and ds.images.shape[0] == 12


def test_semi_supervised_study_tiny_end_to_end(capsys):
    """The three arms run (teacher snapshot, frozen teacher, Tester and
    evaluate_test_split per arm) and the summary line is printed."""
    results = semi_supervised_study.main(
        ["--n", "12", "--labelled", "4", "--test-n", "6",
         "--teacher-steps", "2", "--student-steps", "2"] + TINY)
    assert set(results) == {"teacher", "baseline", "distilled"}
    for rec in results.values():
        assert np.isfinite(rec["mpjpe"]) and np.isfinite(rec["pa_mpjpe"])
    assert results["baseline"]["train_images"] == 4
    assert results["distilled"]["labelled"] == 4
    assert '"summary": "semi_supervised_study"' in capsys.readouterr().out


def test_filter_cascade_study_tiny_end_to_end():
    """A tiny teacher filters a pool twice; the keep sets agree (the CLI
    raises otherwise) and the rates are fractions."""
    rec = filter_cascade_study.main(
        ["--n", "8", "--pool", "16", "--teacher-steps", "2",
         "--cascade-pass1", "5"] + TINY)
    assert rec["keep_sets_equal"] is True
    assert 0.0 <= rec["pass1_survival"] <= 1.0
    assert 0.0 <= rec["keep_rate"] <= 1.0
    assert rec["timer"] == "host clock"
    assert rec["wall_single_s"] > 0 and rec["wall_cascade_s"] > 0


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def test_analyze_correlation_csv_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the same 4 synthetic samples, teacher weights and
    PANet, R18 at the reference's 224 input and float32 compute (both
    packages' Config patched in the test, as neither CLI has a flag for
    it): the header equal, every row's teacher error, PANet error and
    entropy to 1e-4 relative (float32 convs of two frameworks)."""
    jcfg = dataclasses.replace(jconfig.Config(), model=dataclasses.replace(
        jconfig.Config().model, resnet_type=18, compute_dtype="float32"))
    pcfg = Config().replace(model=dataclasses.replace(
        Config().model, resnet_type=18, compute_dtype="float32"))
    monkeypatch.setattr(jconfig, "Config", lambda: jcfg)
    monkeypatch.setattr(cli_train, "sized_config", lambda *a, **k: pcfg)

    net, variables = randomized_jax_variables(jcfg.model, seed=4,
                                              final_scale=1e-4)
    state, _ = jax_create_train_state(
        jax_pose_net(jcfg.model), jax.random.PRNGKey(0),
        jnp.zeros((1, *jcfg.model.input_shape, 3)), jcfg.train)
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    jcheckpoint.save_checkpoint(str(tmp_path / "jax_teacher"), state, 0)
    model = port_model(pcfg.model, variables)
    checkpoint.save_checkpoint(str(tmp_path / "teacher"), model,
                               make_optimizer(model.parameters(),
                                              pcfg.train), 0)
    panet_path = str(tmp_path / "panet.pth")
    torch.save(PANet(generator=torch.Generator().manual_seed(3)).state_dict(),
               panet_path)
    np.testing.assert_array_equal(SyntheticFreiHand(n=4).images,
                                  JaxSyntheticFreiHand(n=4).images)

    common = ["--synthetic", "--max-samples", "4", "--batch-size", "2",
              "--panet-ckpt", panet_path]
    jcorr.main(common + ["--model-dir", str(tmp_path / "jax_teacher"),
                         "--out", str(tmp_path / "jax.csv")])
    analyze_correlation.main(common + [
        "--model-dir", str(tmp_path / "teacher"), "--device", "cpu",
        "--out", str(tmp_path / "port.csv")])
    jhead, want = read_csv(tmp_path / "jax.csv")
    head, got = read_csv(tmp_path / "port.csv")
    assert head == jhead and got.shape == want.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert (np.ptp(want, axis=0) > 0).all()
