"""The CLIs under a launcher: two gloo ranks on the CPU with the
environment `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR /
MASTER_PORT), one module-scoped spawn in which each rank runs `cli.train
--mesh data=2`, then `cli.test`, `cli.evaluate` and
`cli.generate_teacher_labels` with `--mesh data=2` on its snapshot. The
tests hold rank 0's files to one-process runs: the training to the
one-process Trainer over the union of the two ranks' draws (loss and
parameters at tests/test_torch_mesh_train.py's tolerances), the sweeps to
the same CLIs without a launcher on the same snapshot."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu_torch.cli import (
    evaluate as cli_evaluate,
    generate_teacher_labels as cli_labels,
    test as cli_test,
    train as cli_train,
)
from hand_integral_pose_estimation_tpu_torch.training import Trainer
from torch_mesh_worker import spawn

SIZING = ["--pose-resnet", "18", "--pose-input", "32", "--device", "cpu"]
TRAIN = ["--synthetic", "--synthetic-size", "16", "--batch-size", "8",
         "--epochs", "1", "--steps-per-epoch", "2", *SIZING]
TEST = ["--synthetic", "--synthetic-size", "5", "--batch-size", "2",
        *SIZING]
EVALUATE = ["--synthetic", "--synthetic-size", "5", "--batch-size", "2",
            *SIZING]
LABELS = ["--synthetic", "--synthetic-size", "4", "--batch-size", "2",
          "--variance-threshold", "1e-2", *SIZING]


def _commands(d: str, mesh: str):
    """The four CLIs' argument lists over model dir `d`, writing under it."""
    return [
        (cli_train, TRAIN + ["--model-dir", f"{d}/model", "--mesh", mesh]),
        (cli_test, TEST + ["--model-dir", f"{d}/model", "--result-dir",
                           f"{d}/test_{mesh}", "--mesh", mesh]),
        (cli_evaluate, EVALUATE + ["--model-dir", f"{d}/model",
                                   "--result-dir", f"{d}/eval_{mesh}",
                                   "--mesh", mesh]),
        (cli_labels, LABELS + ["--model-dir", f"{d}/model", "--out",
                               f"{d}/labels_{mesh}.npz", "--mesh", mesh]),
    ]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_cli")
    calls = [f"{cli.__name__.rsplit('.', 1)[1]}.main({json.dumps(argv)})"
             for cli, argv in _commands(str(out), "data=2")]
    script = "; ".join(
        ["import torch",
         "from hand_integral_pose_estimation_tpu_torch.cli import "
         "train, test, evaluate, generate_teacher_labels",
         calls[0], f"summary = {calls[1]}",
         f"torch.save(summary, {str(out / 'summary.pt')!r}) "
         "if summary is not None else None", *calls[2:]])
    logs = spawn("cli", 2, out, command=[sys.executable, "-c", script])
    return dict(out=out, logs=logs)


def test_cli_train_mesh_data2_equals_the_union_run(run):
    """Rank 0 wrote the one snapshot; its parameters are those of the
    one-process Trainer fed the union of the two ranks' draws (the
    streams of data indices 0 and 1) from the same seed: parameters to
    5e-3 (Adam's sign flips under another summation order)."""
    out = run["out"]
    assert os.listdir(out / "model") == ["snapshot_0.pth.tar"]
    assert "training over mesh {'data': 2, 'model': 1}" in run["logs"][0]
    args = cli_train.build_argparser().parse_args(TRAIN)
    cfg = cli_train.sized_config(18, 32, 8)
    t = Trainer(cfg=cfg, dataset=cli_train.load_split(args, cfg, "training"),
                device="cpu", seed=0, model_dir=str(out / "union"))
    streams = [np.random.RandomState(1000003 * d) for d in (0, 1)]
    union = [np.concatenate([t.dataset.sample_indices(s, 4)
                             for s in streams]) for _ in range(2)]
    t.host_batches = lambda rng, num_steps: map(t.dataset.host_batch,
                                                union[:num_steps])
    t.run_epoch(0, num_steps=2, log_every=100)
    got = torch.load(out / "model" / "snapshot_0.pth.tar")["network"]
    for k, v in t.model.named_parameters():
        np.testing.assert_allclose(got[k].double().numpy(),
                                   v.detach().double().numpy(),
                                   atol=2 * 2.5e-3, err_msg=k)


def test_cli_sweeps_over_the_mesh_equal_one_process(run, tmp_path):
    """cli.test, cli.evaluate and cli.generate_teacher_labels split each
    batch over the two ranks; rank 0's results equal the same CLIs run in
    one process on the same snapshot (metrics and predictions to 1e-5,
    the pseudo-label db's keep set equal)."""
    out = run["out"]
    d = str(tmp_path)
    os.symlink(out / "model", tmp_path / "model")
    summary = [cli.main(argv) for cli, argv in _commands(d, "none")[1:]][0]
    mesh_summary = torch.load(out / "summary.pt", weights_only=False)
    for key in ("pa_mpjpe", "mpjpe"):
        np.testing.assert_allclose(mesh_summary[key], summary[key],
                                   rtol=1e-5)
    preds = [json.load(open(p)) for p in (out / "eval_data=2" / "pred.json",
                                          tmp_path / "eval_none" /
                                          "pred.json")]
    assert len(preds[0]) == len(preds[1])
    for part0, part1 in zip(*preds):      # (xyz, verts) lists
        np.testing.assert_allclose(np.asarray(part0, float),
                                   np.asarray(part1, float), rtol=1e-5,
                                   atol=1e-5)
    a, b = (np.load(p) for p in (out / "labels_data=2.npz",
                                 tmp_path / "labels_none.npz"))
    assert np.array_equal(a["keep"], b["keep"])
    for k in ("joint_cam_normalized", "tprime", "variance"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)
