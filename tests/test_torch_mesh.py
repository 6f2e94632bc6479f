"""The port's mesh layout rules against the JAX package's, in one process:
the `--mesh` grammar of cli/mesh_arg.py (the same strings give the same
(data, model) layout or the same SystemExit text), the sharding policy
(`param_sharding_rules` against JAX `_leaf_spec` over the bridge-mapped
parameter names), `head_model_split`, and the `--mesh` flag of the four
CLIs: its default, the JAX text for a layout larger than the world, and
no mesh without a launcher (`auto` trains and tests exactly as without
the flag). The multi-rank runs are in tests/test_torch_mesh_*.py."""

import types

import jax
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.cli import mesh_arg as jax_mesh_arg
from hand_integral_pose_estimation_tpu.interop import convert_pose_snapshot
from hand_integral_pose_estimation_tpu.parallel import (
    head_model_split as jax_head_model_split,
    make_mesh as jax_make_mesh,
)
from hand_integral_pose_estimation_tpu.parallel.mesh import (
    _leaf_spec as jax_leaf_spec,
)
from hand_integral_pose_estimation_tpu_torch.cli import (
    evaluate as cli_evaluate,
    generate_teacher_labels as cli_labels,
    mesh_arg,
    test as cli_test,
    train as cli_train,
)
from hand_integral_pose_estimation_tpu_torch.config import ModelConfig
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.parallel import (
    head_model_split,
    param_sharding_rules,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

SPECS = ["data=2", "model=2", "data=2,model=2", "data=4,model=2", "data=8",
         "model=8", "data=1,model=8", "data=3", "data=9", "model=16",
         "data=3,model=3", "data=0", "model=0", "x=1", "data", "data=a",
         "data=2,model", "data=2;model=2", "model=3"]


def _jax_layout(spec):
    try:
        mesh, mp = jax_mesh_arg.parse_explicit_mesh(spec)
    except SystemExit as e:
        return str(e)
    return (mesh.shape["data"], mesh.shape["model"]), mp


def _port_layout(spec, n_dev):
    try:
        data, model = mesh_arg.mesh_layout(spec, n_dev)
    except SystemExit as e:
        return str(e)
    return (data, model), model


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_arg_matches_jax(spec):
    """The JAX CLI sees the suite's 8 virtual devices; the port's grammar
    is given a world of 8 ranks."""
    assert jax.device_count() == 8
    assert _port_layout(spec, 8) == _jax_layout(spec)


def _stub_mesh(model: int):
    return types.SimpleNamespace(shape={"data": 1, "model": model},
                                 axis_names=("data", "model"))


@pytest.mark.parametrize("model_size", [1, 2, 3, 4, 5, 7, 8])
@pytest.mark.parametrize("joints,depth", [(21, 56), (21, 8), (6, 8)])
def test_param_sharding_rules_match_jax_leaf_spec(model_size, joints,
                                                  depth):
    """Every parameter of an R18 pose net, filled with its own index, goes
    through the weights bridge (convert_pose_snapshot): a JAX leaf is split
    over `model` by `_leaf_spec` exactly where the port splits the
    parameter its values came from (on torch's dim 0, the JAX kernel's
    last axis)."""
    cfg = ModelConfig(resnet_type=18, input_shape=(32, 32),
                      output_shape=(8, 8), num_joints=joints,
                      depth_dim=depth)
    model = get_pose_net(cfg)
    sd = model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    for i, name in enumerate(names):
        sd[name] = torch.full_like(sd[name], float(i + 1))
    params = convert_pose_snapshot(sd, resnet_type=18)["params"]
    jax_split = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        spec = jax_leaf_spec(path, leaf, model_size, "model")
        if any(axis is not None for axis in spec):
            assert spec[-1] == "model" and leaf.ndim - 1 == len(spec) - 1
            jax_split.add(names[int(np.asarray(leaf).flat[0]) - 1])
    rules = param_sharding_rules(_stub_mesh(model_size), model)
    assert {n for n, d in rules.items() if d is not None} == jax_split
    assert all(d in (None, 0) for d in rules.values())
    assert param_sharding_rules(None, model) == dict.fromkeys(names)


@pytest.mark.parametrize("model_size,joints", [(1, 21), (2, 21), (3, 21),
                                               (2, 6), (4, 6), (8, 6)])
def test_head_model_split_matches_jax(model_size, joints):
    """Split only where the joints divide the model axis: at model=2,
    J=21 the head runs data-parallel on the gathered weight."""
    jmesh = jax_make_mesh(model_parallelism=model_size,
                          devices=jax.devices()[:8 // model_size
                                                * model_size])
    assert head_model_split(_stub_mesh(model_size), joints) == \
        jax_head_model_split(jmesh, joints)
    assert not head_model_split(None, joints)


@pytest.mark.parametrize("cli,default", [
    (cli_train, "auto"), (cli_test, "auto"), (cli_evaluate, "auto"),
    (cli_labels, "none")])
def test_cli_mesh_defaults_and_refusals(cli, default, tmp_path):
    """The JAX CLIs' defaults; an explicit layout larger than the world (one
    process) exits with the JAX text before any work, a malformed one with
    the grammar's."""
    assert cli.build_argparser().parse_args(
        ["--synthetic"]).mesh == default
    base = ["--synthetic", "--device", "cpu"]
    with pytest.raises(SystemExit, match=r"--mesh data=2 needs 2 devices, "
                       r"1 visible"):
        cli.main(base + ["--mesh", "data=2"])
    with pytest.raises(SystemExit, match=r"--mesh 'x=1': expected 'auto', "
                       r"'none', or 'data=N\[,model=M\]' \(bad token "
                       r"'x=1'\)"):
        cli.main(base + ["--mesh", "x=1"])


def test_cli_without_launcher_runs_without_a_mesh(tmp_path):
    """No torchrun: `--mesh auto` (the default) trains with no mesh,
    bitwise as `--mesh none`, and an explicit layout of one rank is no
    mesh; cli.test's `auto` scores as `none`; no process group is
    started."""
    assert mesh_arg.parse_explicit_mesh("data=1") == (None, 1)
    assert mesh_arg.parse_explicit_mesh("data=1,model=1") == (None, 1)
    sizing = ["--pose-resnet", "18", "--pose-input", "32", "--synthetic",
              "--synthetic-size", "8", "--device", "cpu"]
    states = []
    for spec in ("auto", "none"):
        trainer = cli_train.main(sizing + [
            "--epochs", "1", "--steps-per-epoch", "1", "--batch-size", "4",
            "--model-dir", str(tmp_path / spec), "--mesh", spec,
            "--log-dir", str(tmp_path / "log")])
        assert trainer.mesh is None
        states.append(trainer.model.state_dict())
    for s in states[1:]:
        for k, v in states[0].items():
            assert torch.equal(v, s[k]), k
    summaries = [cli_test.main(sizing[:-4] + [
        "--synthetic", "--synthetic-size", "3", "--batch-size", "2",
        "--device", "cpu", "--model-dir", str(tmp_path / "auto"),
        "--result-dir", str(tmp_path / f"r{spec}"), "--mesh", spec])
        for spec in ("auto", "none")]
    assert summaries[0]["mpjpe"] == summaries[1]["mpjpe"]
    assert not torch.distributed.is_initialized()
