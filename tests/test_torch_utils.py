"""The port's runner utilities against the JAX package's, on the CPU: the
logger, the timers, the skeleton plots, `cli.find_mean_std`, and what the
Trainer does with them (its own log file, the timers' fields in its log
line, the profiler's trace), plus `cli.visualize_detections --data-dir`.
"""

import json
import logging
import os
import sys
import time
import uuid

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.cli import find_mean_std as jax_mean_std
from hand_integral_pose_estimation_tpu.utils import logger as jax_logger
from hand_integral_pose_estimation_tpu.utils import visualize as jax_vis
from hand_integral_pose_estimation_tpu.utils.timers import Timer as JaxTimer
from hand_integral_pose_estimation_tpu_torch.cli import find_mean_std
from hand_integral_pose_estimation_tpu_torch.config import (
    Config,
    FreiHandJoints,
    ModelConfig,
    TrainConfig,
)
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.training import Trainer
from hand_integral_pose_estimation_tpu_torch.utils import (
    Timer,
    color_logger,
    hand_traces_3d,
    plot_hand,
)
from hand_integral_pose_estimation_tpu_torch.utils import visualize
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "freihand_mini")


def tiny_config(batch_size: int = 2) -> Config:
    return Config(model=ModelConfig(resnet_type=18, input_shape=(32, 32),
                                    output_shape=(8, 8), depth_dim=8,
                                    compute_dtype="float32"),
                  train=TrainConfig(batch_size=batch_size))


def tiny_split(n: int = 8) -> SyntheticFreiHand:
    return SyntheticFreiHand(n=n, image_hw=(32, 32))


def _messages(path: str) -> list[str]:
    """A log file's lines without their timestamps (the first two fields
    of `%(asctime)s`)."""
    with open(path) as f:
        return [line.split(" ", 2)[2] for line in f.read().splitlines()]


@pytest.mark.parametrize("tty", [False, True])
def test_color_logger_matches_jax(tmp_path, monkeypatch, tty):
    """The same file lines (timestamps aside) and the same console
    formatting as the JAX logger, colours only on a TTY; each log_dir its
    own file, and no file without one."""
    monkeypatch.setattr(sys.stderr, "isatty", lambda: tty)
    # a log_name of its own: the JAX logger is cached by log_name alone
    name = f"log_{uuid.uuid4().hex}.txt"
    want = jax_logger.color_logger(str(tmp_path / "jax"), name)
    got = color_logger(str(tmp_path / "port"), name)
    for lg in (want, got):
        lg.info("epoch %d itr %d", 3, 7)
        lg.warning("a %s", "warning")
        for h in lg.handlers:
            h.flush()
    assert _messages(str(tmp_path / "port" / name)) == _messages(
        str(tmp_path / "jax" / name)) == ["INFO epoch 3 itr 7",
                                          "WARNING a warning"]
    record = logging.LogRecord("x", logging.INFO, __file__, 1, "m %d", (5,),
                               None)
    record.created = 0.0
    console = [[h for h in lg.handlers if type(h) is logging.StreamHandler]
               for lg in (want, got)]
    assert [len(c) for c in console] == [1, 1]
    line = console[1][0].format(record)
    assert line == console[0][0].format(record)
    assert line.startswith("\033[32m") == tty and line.endswith("m 5" + (
        "\033[0m" if tty else ""))
    assert got.level == logging.INFO and not got.propagate

    other = color_logger(str(tmp_path / "other"), name)
    bare = color_logger(None, name, name=f"hipe-{uuid.uuid4().hex}")
    assert other is not got and color_logger(str(tmp_path / "port"),
                                             name) is got
    assert not any(isinstance(h, logging.FileHandler) for h in bare.handlers)


def test_trainer_log_files_are_their_own(tmp_path, monkeypatch):
    """Two Trainers with two log_dirs each write only their own lines, with
    no logging set up by the caller (the root logger at WARNING with no
    handlers, whatever earlier tests set up); the epoch line carries the
    timers' fields and the hours an epoch takes."""
    root = logging.getLogger()
    monkeypatch.setattr(root, "level", logging.WARNING)
    monkeypatch.setattr(root, "handlers", [])
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    for epoch, log_dir in zip((0, 5), dirs):
        Trainer(tiny_config(), tiny_split(4), device="cpu",
                log_dir=log_dir).run_epoch(epoch, num_steps=1)
    lines = [_messages(os.path.join(d, "train_logs.txt")) for d in dirs]
    for epoch, own, other in ((0, lines[0], lines[1]),
                              (5, lines[1], lines[0])):
        assert any(f"epoch {epoch} itr 0/1" in m for m in own), own
        assert not any(f"epoch {epoch} itr" in m for m in other), other
        (line,) = [m for m in own if "itr 0/1" in m]
        assert "s/itr (read " in line and line.endswith("h/epoch")


def test_timer_matches_jax(monkeypatch):
    """The same `toc` returns and running averages as the JAX Timer over 15
    calls under one fake clock: the first 10 warm up."""
    durations = np.random.RandomState(0).uniform(0.01, 1.0, 15)

    def run(cls):
        now = [100.0]
        monkeypatch.setattr(time, "perf_counter", lambda: now[0])
        timer = cls()
        out = []
        for i, d in enumerate(durations):
            timer.tic()
            now[0] += d
            out.append((timer.toc(average=i % 3 != 0), timer.average_time,
                        timer.diff, timer.calls, timer.total_time))
        return out

    got, want = run(Timer), run(JaxTimer)
    assert got == want
    assert got[-1][1] == pytest.approx(np.mean(durations[10:]), rel=1e-12)


def _lines(ax):
    return [(line.get_xdata().tolist(), line.get_ydata().tolist(),
             np.asarray(line.get_color()).tolist(), line.get_linewidth(),
             line.get_marker()) for line in ax.lines]


@pytest.mark.parametrize("kw", [
    {},
    {"order": "uv", "vis": np.arange(21) % 4 != 1, "linewidth": "2"},
    {"color_fixed": (1.0, 0.0, 0.0), "draw_kp": False},
], ids=["hw", "uv-vis", "fixed-no-kp"])
def test_plot_hand_matches_jax(kw):
    """The same line data and colours on an Agg axis as the JAX plot."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    coords = np.random.RandomState(1).uniform(0, 224, (21, 2))
    axes = []
    for fn in (plot_hand, jax_vis.plot_hand):
        fig, ax = plt.subplots()
        fn(ax, coords.copy(), **kw)
        axes.append(ax)
        plt.close(fig)
    assert _lines(axes[0]) == _lines(axes[1])
    vis = kw.get("vis", np.ones(21, bool))
    bones = sum(1 for a, b in FreiHandJoints.bones if vis[a] and vis[b])
    assert len(axes[0].lines) == bones + kw.get("draw_kp", True) * vis.sum()
    np.testing.assert_array_equal(visualize.JOINT_COLORS,
                                  jax_vis.JOINT_COLORS)


def test_hand_traces_3d_matches_jax():
    joints = np.random.RandomState(2).normal(0.0, 0.05, (21, 3))
    got = hand_traces_3d(joints, name="left")
    assert got == jax_vis.hand_traces_3d(joints, name="left")
    assert len(got) == 21 and got[-1]["mode"] == "markers"


def test_find_mean_std_matches_jax(capsys):
    """The same samples and the same printout as the JAX pass; the mean
    within 1e-12 of it, and both statistics within 1e-12 of the exact ones
    (integer sums of the same pixels). The JAX pass's std is not: numpy
    adds the 64 x 224^2 rows of x^2 one by one (its pairwise sum runs only
    along a contiguous axis), 1.4e-12 from the exact value, so the port's
    std is held to it by that order's error bound, N eps of the sums."""
    from hand_integral_pose_estimation_tpu_torch.data import (
        SyntheticFreiHand as Split,
    )

    argv = ["--synthetic", "--max-samples", "64"]
    mean, std = find_mean_std.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    want_mean, want_std = jax_mean_std.main(argv)
    assert got_out == capsys.readouterr().out
    assert mean.dtype == std.dtype == np.float64

    pixels = Split(n=64).host_batch(np.arange(64))["image"].reshape(-1, 3)
    n = pixels.shape[0]
    ints = pixels.astype(np.int64)
    exact_mean = ints.sum(0) / (255.0 * n)
    exact_e2 = (ints ** 2).sum(0) / (255.0 ** 2 * n)
    exact_std = np.sqrt(exact_e2 - exact_mean ** 2)
    np.testing.assert_allclose(mean, exact_mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(std, exact_std, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=1e-12)
    eps = np.finfo(np.float64).eps
    bound = n * eps * (exact_e2 + 2 * exact_mean ** 2) / (2 * exact_std)
    assert (np.abs(std - want_std) <= bound).all()


def _train_state(trainer) -> dict:
    out = dict(trainer.model.state_dict())
    for i, p in enumerate(trainer.model.parameters()):
        for k, v in trainer.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return out


def test_profiler_writes_a_trace_and_trains_bitwise(tmp_path):
    """`profile_dir` writes a Chrome trace of the first epoch's first three
    chunks, and the run's metrics and state are bitwise those of the same
    run without it."""
    runs = {}
    for name, profile_dir in (("plain", None),
                              ("profiled", str(tmp_path / "prof"))):
        trainer = Trainer(tiny_config(), tiny_split(), device="cpu",
                          model_dir=str(tmp_path / name), scan_steps=1,
                          profile_dir=profile_dir)
        metrics = [trainer.run_epoch(0, num_steps=5)]
        metrics.append(trainer.run_epoch(1, num_steps=2))
        runs[name] = (metrics, _train_state(trainer))
    assert runs["profiled"][0] == runs["plain"][0]
    want = runs["plain"][1]
    got = runs["profiled"][1]
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace == "trace_rank0.json"
    with open(tmp_path / "prof" / trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") and "conv" in n for n in names)


def test_visualize_detections_data_dir(tmp_path, capsys):
    """`--data-dir` draws the FreiHAND tree's evaluation images (the
    fixture has 3) instead of synthetic ones."""
    pytest.importorskip("matplotlib")
    from hand_integral_pose_estimation_tpu_torch.cli import (
        visualize_detections as cli,
    )

    out = tmp_path / "vis"
    cli.main(["--data-dir", FIXTURE, "--num-images", "4",
              "--detector-resnet", "18", "--detector-scale", "64",
              "--device", "cpu", "--out-dir", str(out)])
    assert sorted(os.listdir(out)) == ["det_0.jpg", "det_1.jpg", "det_2.jpg"]
    assert "wrote 3 visualisations" in capsys.readouterr().out
