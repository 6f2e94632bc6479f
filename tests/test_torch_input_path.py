"""The input path of the port's runners on the committed mini FreiHAND
fixture (tests/fixtures/freihand_mini): the native batch prefetcher
(`native_prefetch`) and the YUV 4:2:0 transport (`yuv_transport`) give
the host batches, the training state and the test sweep of the plain
`host_batch` path bitwise, each batch decoded once; frames are decoded at
their own 224x224 size whatever the model's input size (the JAX Trainer
decodes at the input size while K and the boxes stay in frame pixels);
an empty split yields nothing; datasets whose records name no JPEG files
never engage the loader; `cli.train --yuv-transport` runs. R18 at 64x64
(96x96 for the input-size case), batch 4, on the CPU."""

import os

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu_torch.config import (
    Config,
    ModelConfig,
    TrainConfig,
)
from hand_integral_pose_estimation_tpu_torch.data import freihand
from hand_integral_pose_estimation_tpu_torch.data.native_loader import (
    NativeLoader,
)
from hand_integral_pose_estimation_tpu_torch.training import Trainer
from hand_integral_pose_estimation_tpu_torch.training import (
    Tester as PortTester,
)
from test_torch_freihand import FIXTURE, SIZES, library  # noqa: F401
from test_torch_panet import _one_torch_thread  # noqa: F401 (autouse)

# the three ways in: the host decodes (prefetch off), the prefetcher
# decodes to RGB, the prefetcher hands over 4:2:0 planes
ARMS = {"host": dict(native_prefetch=False), "prefetch": {},
        "yuv": dict(yuv_transport=True)}


def config(input_hw=64) -> Config:
    return Config(
        model=ModelConfig(resnet_type=18, input_shape=(input_hw, input_hw),
                          output_shape=(input_hw // 4, input_hw // 4),
                          depth_dim=8, compute_dtype="float32"),
        train=TrainConfig(**SIZES))


def split(name="training", cfg=None):
    return freihand.FreiHandDataset(FIXTURE, name, cfg or config())


def counting_loader(monkeypatch):
    """Counts the prefetcher's submits and the host's single decodes."""
    counts = {"submit": 0, "decode": 0}
    submit, read = NativeLoader.submit, freihand.decode_jpeg

    def counted_submit(self, paths):
        counts["submit"] += 1
        return submit(self, paths)

    def counted_decode(*a, **k):
        counts["decode"] += 1
        return read(*a, **k)

    monkeypatch.setattr(NativeLoader, "submit", counted_submit)
    monkeypatch.setattr(freihand, "decode_jpeg", counted_decode)
    return counts


@pytest.mark.parametrize("input_hw", [64, 96])
def test_prefetched_host_batches_are_host_batch(library, monkeypatch,
                                                tmp_path, input_hw):
    """Five steps' batches through the prefetcher equal `host_batch` of the
    same draws bitwise, field for field, at the frame's 224x224 whatever the
    input size; each batch is submitted once and nothing is decoded by the
    host; nothing is left in flight. The YUV batches are the planes, which
    decode on the device to the same frames."""
    from hand_integral_pose_estimation_tpu_torch.ops.yuv import (
        yuv420_to_rgb,
    )

    cfg = config(input_hw)
    ds = split(cfg=cfg)
    rng = np.random.RandomState(7)
    want = [ds.host_batch(ds.sample_indices(rng, 4)) for _ in range(5)]
    host = Trainer(cfg, ds, device="cpu", **ARMS["host"])
    counts = counting_loader(monkeypatch)
    for arm in ("prefetch", "yuv"):
        trainer = Trainer(cfg, ds, model_dir=str(tmp_path), device="cpu",
                          **ARMS[arm])
        assert (trainer.loader.height, trainer.loader.width) == (224, 224)
        got = list(trainer.host_batches(np.random.RandomState(7), 5))
        assert counts == {"submit": 5, "decode": 0}, counts
        assert trainer.loader._pending is None
        for a, b in zip(got, want, strict=True):
            assert set(a) == set(b)
            for k in b:
                if k == "image" and arm == "yuv":
                    assert a[k].shape == (4, 224 * 224 * 3 // 2)
                    a_img = yuv420_to_rgb(torch.from_numpy(a[k]), 224, 224)
                    np.testing.assert_array_equal(a_img.numpy(), b[k])
                elif b[k] is None:
                    assert a[k] is None, k
                else:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        counts.update(submit=0)
        # the device batch of the input size from these frames is the same
        g = torch.Generator().manual_seed(3)
        x = trainer.preprocess(g, got[0])
        y = host.preprocess(torch.Generator().manual_seed(3), want[0])
        assert x.image.shape == (4, input_hw, input_hw, 3)
        for field, a, b in zip(x._fields, x, y):
            if b is not None:
                assert torch.equal(a, b), field


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_training_state_is_the_same_on_every_arm(library, tmp_path,
                                                 scan_steps):
    """Two epochs of `Trainer.fit` (3 steps each) from one seed: the model
    and optimizer state are bitwise equal with the host decoding, the
    prefetcher decoding and the 4:2:0 planes decoded in the step."""
    states = {}
    for arm, kw in ARMS.items():
        trainer = Trainer(config(), split(), scan_steps=scan_steps,
                          model_dir=str(tmp_path / arm), device="cpu", **kw)
        trainer.fit(2, 3)
        states[arm] = (trainer.model.state_dict(),
                       trainer.optimizer.state_dict()["state"])
        assert (trainer.loader is None) == (arm == "host")
    base_model, base_opt = states.pop("host")
    for arm, (model, opt) in states.items():
        for k, v in base_model.items():
            assert torch.equal(model[k], v), (arm, k)
        for i, st in base_opt.items():
            for k, v in st.items():
                assert torch.equal(opt[i][k], v), (arm, i, k)


def test_test_sweep_is_the_same_on_every_arm(library):
    """`Tester.run` over the testing split (4 records, batch 3: one padded
    batch): coords and every kept Batch field bitwise equal on the three
    arms; the evaluation split likewise."""
    model = Trainer(config(), split(), device="cpu").model
    for name in ("testing", "evaluation"):
        ds = split(name)
        outs = {arm: PortTester(config(), ds, model, device="cpu", **kw).run(3)
                for arm, kw in ARMS.items()}
        coords, merged = outs.pop("host")
        assert coords.shape[0] == len(ds)
        for arm, (c, m) in outs.items():
            np.testing.assert_array_equal(c, coords, err_msg=arm)
            for field, a, b in zip(m._fields, m, merged):
                if b is None:
                    assert a is None, (arm, field)
                else:
                    np.testing.assert_array_equal(a, b,
                                                  err_msg=(arm, field))


def test_empty_split_and_the_option_checks(library):
    """An empty file-backed split yields no batch with the YUV transport
    (the JAX Tester raises 'needs a file-backed dataset' there); the YUV
    transport without prefetch raises, and so does a dataset whose records
    name no files."""
    cfg = config().replace(train=TrainConfig(**{**SIZES,
                                                "testing_size": 1}))
    empty = split("testing", cfg)
    assert len(empty) == 0
    model = Trainer(config(), split(), device="cpu").model
    for kw in ARMS.values():
        tester = PortTester(cfg, empty, model, device="cpu", **kw)
        assert list(tester.host_batches(4)) == []
    with pytest.raises(ValueError, match="needs native_prefetch"):
        PortTester(cfg, split(), model, device="cpu", native_prefetch=False,
               yuv_transport=True)
    with pytest.raises(ValueError, match="needs native_prefetch"):
        Trainer(config(), split(), device="cpu", native_prefetch=False,
                yuv_transport=True)


def test_in_memory_records_never_engage_the_loader(monkeypatch):
    """`InMemoryFreiHand` has records with made-up image paths and reads
    its frames from memory: the runners keep `host_batch` (no loader is
    made) and refuse the YUV transport, as they do for the synthetic
    split."""
    monkeypatch.setattr(NativeLoader, "__init__", lambda *a, **k: (
        pytest.fail("a loader was made")))
    cfg = config()
    synthetic = freihand.SyntheticFreiHand(n=8, image_hw=(64, 64), seed=1)
    for ds in (synthetic.as_records(cfg), synthetic):
        trainer = Trainer(cfg, ds, device="cpu")
        assert trainer.loader is None
        assert np.isfinite(trainer.run_epoch(0, 1)["loss"])
        tester = PortTester(cfg, ds, trainer.model, device="cpu")
        assert tester.run(4)[0].shape == (8, 21, 3)
        with pytest.raises(ValueError, match="file-backed"):
            Trainer(cfg, ds, device="cpu", yuv_transport=True)
        with pytest.raises(ValueError, match="file-backed"):
            PortTester(cfg, ds, trainer.model, device="cpu",
                       yuv_transport=True)


def test_cli_train_yuv_transport(library, tmp_path):
    """`cli.train --data-dir ... --yuv-transport` trains two steps and
    writes its snapshot, with the same weights as without the flag."""
    from hand_integral_pose_estimation_tpu_torch.cli import train as cli

    argv = ["--data-dir", FIXTURE, "--training-size", "6", "--epochs", "1",
            "--steps-per-epoch", "2", "--batch-size", "4", "--device", "cpu",
            "--pose-resnet", "18", "--pose-input", "64",
            "--log-dir", str(tmp_path / "log")]
    yuv = cli.main([*argv, "--yuv-transport", "--model-dir",
                    str(tmp_path / "yuv")])
    rgb = cli.main([*argv, "--model-dir", str(tmp_path / "rgb")])
    assert yuv.yuv_transport and yuv.loader.layout == "yuv420"
    assert os.listdir(tmp_path / "yuv") == ["snapshot_0.pth.tar"]
    for k, v in rgb.model.state_dict().items():
        assert torch.equal(yuv.model.state_dict()[k], v), k
