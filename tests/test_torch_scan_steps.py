"""The port's chunked Trainer (`scan_steps`), its device-side schedule, its
snapshots across optimizer forms and its metrics writer, on the CPU at a
small size (ResNet-18, 64x64 input, 16x16 x 8 heatmap, float32 compute,
batch 4, as tests/test_training.py sizes the JAX trainer).

On the CPU a chunk of k steps runs as k eager steps, the math of the JAX
Trainer's `lax.scan`; on the card the same chunk is one CUDA-graph replay
(tests/test_torch_cuda.py). The schedule is held to `multistep_factor`
and the JAX package's optax schedule at 1e-6 relative (the rate is a
float32 tensor, 2^-24 relative)."""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.training.state import (
    multistep_schedule as jax_multistep_schedule,
)
from hand_integral_pose_estimation_tpu.utils.metrics_writer import (
    MetricsWriter as JaxMetricsWriter,
)
from hand_integral_pose_estimation_tpu_torch.config import TrainConfig
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.training import (
    Trainer,
    make_optimizer,
    make_train_step,
    multistep_schedule,
)
from hand_integral_pose_estimation_tpu_torch.training.state import (
    multistep_factor,
    optimizer_steps,
)
from hand_integral_pose_estimation_tpu_torch.training.trainer import METRICS
from hand_integral_pose_estimation_tpu_torch.utils import MetricsWriter
from test_torch_train import small_config
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)


def _dataset(n=8, seed=1):
    return SyntheticFreiHand(n=n, image_hw=(64, 64), seed=seed)


def _state(trainer):
    """Parameters, buffers (BatchNorm statistics and counts) and Adam's
    moments and step counts, in a fixed order."""
    out = dict(trainer.model.state_dict())
    for i, p in enumerate(trainer.model.parameters()):
        for k, v in trainer.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return out


def _record_lr(trainer):
    """Wrap the train step to record the learning rate each step runs at."""
    seen, inner = [], trainer.train_step

    def step(batch):
        seen.append(float(trainer.optimizer.param_groups[0]["lr"]))
        return inner(batch)

    trainer.train_step = step
    return seen


@pytest.mark.parametrize("fuse_head,scan_steps", [(True, 4), (False, 3)])
def test_scan_steps_equals_single_steps_bitwise(fuse_head, scan_steps):
    """8 steps from the same seed in chunks of k (4: two full chunks; 3:
    chunks of 3, 3 and 2) and one at a time: the same parameters,
    BatchNorm statistics and Adam state, bit for bit, and the same last
    metrics. The chunking changes neither the host sampling order nor the
    augmentation's draws."""
    kw = dict(cfg=small_config(), dataset=_dataset(), model_dir="unused",
              seed=5, device="cpu", fuse_head=fuse_head)
    chunked = Trainer(scan_steps=scan_steps, **kw)
    single = Trainer(scan_steps=1, **kw)
    m_chunked = chunked.run_epoch(0, num_steps=8, log_every=100)
    m_single = single.run_epoch(0, num_steps=8, log_every=100)
    assert m_chunked == m_single
    assert chunked.global_step == single.global_step == 8
    a, b = _state(chunked), _state(single)
    assert a.keys() == b.keys() and len(a) > 100
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_device_schedule_matches_multistep_factor_and_jax():
    """The schedule gives every step k the rate lr * multistep_factor(k),
    which equals the JAX package's optax schedule, with boundaries at
    epochs 1 and 2 of 3 steps (steps 3 and 6) and a duplicate that
    collapses; it is written on the device from Adam's step count. In a
    Trainer of chunks of 4 the boundary at step 3 falls inside the first
    chunk and the one at 6 inside the second."""
    tcfg = TrainConfig(lr=1e-3, lr_dec_epoch=(1, 2, 2), lr_dec_factor=0.1)
    param = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([param], tcfg)
    sched = multistep_schedule(opt, 3, tcfg.lr_dec_epoch, tcfg.lr_dec_factor)
    jsched = jax_multistep_schedule(tcfg.lr, 3, tcfg.lr_dec_epoch,
                                    tcfg.lr_dec_factor)
    factor = multistep_factor(3, tcfg.lr_dec_epoch, tcfg.lr_dec_factor)
    for k in range(10):
        lr = opt.param_groups[0]["lr"]
        assert lr.dtype == torch.float32 and lr.dim() == 0
        np.testing.assert_allclose(float(lr), tcfg.lr * factor(k), rtol=1e-6)
        np.testing.assert_allclose(float(lr), float(jsched(k)), rtol=1e-6)
        param.grad = torch.full_like(param, 0.5)
        opt.step()
        sched.step()
    assert optimizer_steps(opt) == 10

    cfg = dataclasses.replace(small_config(), train=dataclasses.replace(
        small_config().train, lr_dec_epoch=(1, 2)))
    trainer = Trainer(cfg, _dataset(n=12), model_dir="unused", seed=0,
                      device="cpu", scan_steps=4)
    assert trainer.steps_per_epoch == 3
    seen = _record_lr(trainer)
    trainer.run_epoch(0, num_steps=8, log_every=100)
    want = [cfg.train.lr * factor(k) for k in range(8)]
    np.testing.assert_allclose(seen, want, rtol=1e-6)
    assert want[2] > want[3] > want[6] and want[3] == want[5]
    assert [trainer.lr_at(k) for k in range(8)] == want


@pytest.mark.parametrize("writer_steps,reader_steps", [(4, 1), (1, 4)])
def test_snapshot_resumes_across_chunking(tmp_path, writer_steps,
                                          reader_steps):
    """A snapshot of a chunked Trainer resumes in an eager one (chunks of
    1), and the other way round, at the same step count, rate,
    parameters and moments, and the schedule goes on across its boundary
    at step 6 in the resumed run. The chunked writer's snapshot is given
    the card's layout (groups capturable and fused, as a card Trainer
    writes them): the CPU Trainer resumes it in its own form."""
    cfg = dataclasses.replace(small_config(), train=dataclasses.replace(
        small_config().train, lr_dec_epoch=(3,)))
    kw = dict(cfg=cfg, dataset=_dataset(), model_dir=str(tmp_path), seed=0,
              device="cpu")
    first = Trainer(scan_steps=writer_steps, **kw)
    first.fit(end_epoch=2, steps_per_epoch=2)
    if writer_steps > 1:
        path = tmp_path / "snapshot_1.pth.tar"
        snap = torch.load(path, weights_only=True)
        for g in snap["optimizer"]["param_groups"]:
            g.update(capturable=True, fused=True)
        torch.save(snap, path)
    resumed = Trainer(continue_train=True, scan_steps=reader_steps, **kw)

    group = resumed.optimizer.param_groups[0]
    assert resumed.start_epoch == 2 and resumed.global_step == 4
    assert not group["capturable"] and not group["fused"]
    assert optimizer_steps(resumed.optimizer) == 4
    np.testing.assert_allclose(float(group["lr"]), cfg.train.lr, rtol=1e-6)
    for p, q in zip(resumed.model.parameters(), first.model.parameters()):
        assert torch.equal(p, q)
        a, b = resumed.optimizer.state[p], first.optimizer.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        assert a["step"].device.type == "cpu" and float(a["step"]) == 4
    seen = _record_lr(resumed)
    resumed.run_epoch(2, num_steps=4, log_every=100)
    np.testing.assert_allclose(
        seen, [cfg.train.lr * (0.1 if s >= 6 else 1.0) for s in range(4, 8)],
        rtol=1e-6)
    first.run_epoch(2, num_steps=4, log_every=100)
    for p, q in zip(resumed.model.parameters(), first.model.parameters()):
        assert torch.equal(p, q)


def test_metrics_writer_matches_jax_and_trainer_keys(tmp_path):
    """The port's MetricsWriter writes the JAX writer's records for the
    same calls (time aside); a Trainer with `metrics_dir` and a test split
    writes the records the JAX Trainer writes: after each chunk the step,
    train/<metric> and train/lr, and after each epoch test/loss."""
    calls = [(3, {"loss": 1.5, "lr": 1e-3}, "train"), (3, {"x": 2}, None),
             (7, {"loss": np.float32(0.25)}, "test")]
    recs = {}
    for name, cls in (("jax", JaxMetricsWriter), ("port", MetricsWriter)):
        w = cls(str(tmp_path / name))
        for step, scalars, prefix in calls:
            w.write(step, scalars, prefix=prefix)
        w.close()
        recs[name] = [json.loads(line) for line in
                      (tmp_path / name / "events.jsonl").read_text()
                      .splitlines()]
    for a, b in zip(recs["port"], recs["jax"], strict=True):
        assert a.pop("time") > 0 and b.pop("time") > 0
        assert a == b

    trainer = Trainer(small_config(), _dataset(), model_dir=str(tmp_path),
                      seed=0, device="cpu", scan_steps=2,
                      metrics_dir=str(tmp_path / "run"),
                      test_dataset=_dataset(3, 2))
    trainer.fit(end_epoch=2, steps_per_epoch=4)
    lines = [json.loads(line) for line in
             (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    train_keys = {"step", "time", "train/lr",
                  *(f"train/{k}" for k in METRICS)}
    assert [set(r) for r in lines] == (
        [train_keys] * 2 + [{"step", "time", "test/loss"}]) * 2
    assert [r["step"] for r in lines] == [2, 4, 4, 6, 8, 8]
    assert all(np.isfinite(v) for r in lines for v in r.values())
    assert lines[-2]["train/lr"] == trainer.lr_at(8)


def _fixed_batch_loss(trainer, host):
    """The train-mode loss of the trainer's current weights on one fixed
    augmented batch: a train step with a zero rate on a copy of the
    model."""
    model = copy.deepcopy(trainer.model)
    opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(0.0))
    step = make_train_step(model, opt, multistep_schedule(opt, 1, (), 0.1),
                           trainer.cfg, fuse_head=trainer.fuse_head)
    batch = trainer.preprocess(torch.Generator().manual_seed(0), host)
    return float(step(batch)["loss"])


def test_scan_trainer_loss_falls():
    """The JAX package's TestScanSteps check (tests/test_training.py:545),
    smaller: three epochs of one chunk of 4 steps; the loss falls and the
    optimizer has taken 12 steps. The loss is read on all 8 samples under
    one fixed augmentation, before and after (a single step's loss on 4
    of the 8 samples swings by 2x from step to step here, ~9.2 -> ~8.2 on
    the fixed batch)."""
    t = Trainer(small_config(), _dataset(), model_dir="unused", seed=3,
                device="cpu", scan_steps=4)
    host = t.dataset.host_batch(np.arange(len(t.dataset)))
    before = _fixed_batch_loss(t, host)
    for e in range(3):
        m = t.run_epoch(e, num_steps=4, log_every=100)
    after = _fixed_batch_loss(t, host)
    assert np.isfinite(m["loss"]) and after < 0.95 * before
    assert optimizer_steps(t.optimizer) == t.global_step == 12

