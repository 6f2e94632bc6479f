"""The ImageNet backbone init (`Trainer(imagenet_init=...)`,
`interop.imagenet_init_backbone`, `cli.train --imagenet-init`) against the
JAX package's `imagenet_init_pose_variables`, on the CPU, with a seeded
torchvision-shaped ResNet state dict written by the test."""

import os

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.interop import (
    imagenet_init_pose_variables,
    load_torch_state_dict,
)
from hand_integral_pose_estimation_tpu_torch.cli import train as cli_train
from hand_integral_pose_estimation_tpu_torch.config import (
    Config,
    ModelConfig,
    TrainConfig,
)
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.interop import (
    pose_state_dict_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.training import Trainer
from test_torch_interop import TorchResNet, _randomize
from test_torch_pose_net import randomized_jax_variables

MODEL = ModelConfig(resnet_type=18, input_shape=(32, 32),
                    output_shape=(8, 8), depth_dim=8, compute_dtype="float32")


def config() -> Config:
    return Config(model=MODEL, train=TrainConfig(batch_size=2))


def split() -> SyntheticFreiHand:
    return SyntheticFreiHand(n=4, image_hw=(32, 32))


def imagenet_file(tmp_path, resnet_type: int = 18, seed: int = 31,
                  edit=None) -> tuple[str, dict]:
    """A torchvision-shaped ImageNet ResNet .pth (random weights and BN
    statistics from `seed`, with its fc head) and its state dict."""
    tm = TorchResNet(resnet_type)
    _randomize(tm, seed=seed)
    sd = dict(tm.state_dict())
    g = torch.Generator().manual_seed(seed)
    width = 512 * (1 if resnet_type in (18, 34) else 4)
    sd["fc.weight"] = torch.randn(1000, width, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    if edit is not None:
        edit(sd)
    path = str(tmp_path / f"resnet{resnet_type}-{seed}.pth")
    torch.save(sd, path)
    return path, sd


def test_backbone_matches_jax_and_head_keeps_its_init(tmp_path):
    """The backbone equals the JAX init's (carried across by the weight
    bridge) and the file's tensors bitwise; its `num_batches_tracked` and
    the head are those of a Trainer without the init at the same seed."""
    path, sd = imagenet_file(tmp_path)
    _, jax_vars = randomized_jax_variables(MODEL, seed=3)
    want = pose_state_dict_from_jax(imagenet_init_pose_variables(
        jax_vars, load_torch_state_dict(path), MODEL.resnet_type))
    got = Trainer(config(), split(), device="cpu",
                  imagenet_init=path).model.state_dict()
    fresh = Trainer(config(), split(), device="cpu").model.state_dict()
    assert got.keys() == fresh.keys()
    backbone = [k for k in got if k.startswith("backbone.")
                and not k.endswith("num_batches_tracked")]
    assert len(backbone) == len([k for k in sd if not k.startswith("fc.")
                                 and not k.endswith("num_batches_tracked")])
    for k in backbone:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], sd[k[len("backbone."):]]), k
    for k in got.keys() - set(backbone):
        assert torch.equal(got[k], fresh[k]), k
    assert any(not torch.equal(got[k], fresh[k]) for k in backbone)


def _drop_key(sd):
    del sd["layer2.0.bn1.running_var"]


def _add_key(sd):
    sd["layer5.0.conv1.weight"] = torch.zeros(1)


def _reshape(sd):
    sd["layer1.0.conv1.weight"] = sd["layer1.0.conv1.weight"][:32]


@pytest.mark.parametrize("resnet_type,edit", [
    (50, None), (18, _drop_key), (18, _add_key), (18, _reshape),
], ids=["resnet50", "missing", "extra", "shape"])
def test_mismatch_raises_naming_the_resnet(tmp_path, resnet_type, edit):
    path, _ = imagenet_file(tmp_path, resnet_type, edit=edit)
    with pytest.raises(ValueError, match="resnet18"):
        Trainer(config(), split(), device="cpu", imagenet_init=path)


def test_resume_wins_over_imagenet_init(tmp_path):
    """With `continue_train` and a snapshot in model_dir, the resumed
    weights replace the ImageNet ones, as in the JAX Trainer."""
    model_dir = str(tmp_path / "model")
    first = Trainer(config(), split(), device="cpu", model_dir=model_dir)
    first.fit(end_epoch=1, steps_per_epoch=1)
    path, _ = imagenet_file(tmp_path)
    resumed = Trainer(config(), split(), device="cpu", model_dir=model_dir,
                      imagenet_init=path, continue_train=True)
    assert resumed.start_epoch == 1
    want = first.model.state_dict()
    got = resumed.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_train_cli_imagenet_init(tmp_path):
    """`cli.train --imagenet-init` trains from the file's backbone and logs
    it in `--log-dir/train_logs.txt`."""
    path, sd = imagenet_file(tmp_path, seed=7)
    log_dir = tmp_path / "log"
    trainer = cli_train.main([
        "--synthetic", "--synthetic-size", "4", "--imagenet-init", path,
        "--pose-resnet", "18", "--pose-input", "32", "--batch-size", "2",
        "--epochs", "1", "--steps-per-epoch", "1", "--mesh", "none",
        "--model-dir", str(tmp_path / "model"), "--log-dir", str(log_dir),
        "--device", "cpu"])
    assert os.path.exists(tmp_path / "model" / "snapshot_0.pth.tar")
    with open(log_dir / "train_logs.txt") as f:
        text = f.read()
    assert f"backbone initialised from ImageNet weights ({path})" in text
    assert "epoch 0 itr 0/1" in text
    # one Adam step from the file's weights: near them, not equal
    w = trainer.model.backbone.conv1.weight.detach()
    diff = (w - sd["conv1.weight"]).abs().max().item()
    assert 0 < diff < 1e-2 * np.abs(sd["conv1.weight"].numpy()).max()
