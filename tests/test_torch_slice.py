"""The port's pose-serving slice end to end on the CPU: the JAX package's
Tester and the port's Tester sweep the same synthetic split with the same
weights, and `evaluate_test_split` scores both; the CLI loads a reference
snapshot natively; and the port imports and runs, serving and training,
with jax, flax, optax, orbax and the JAX package itself blocked."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.data.freihand import (
    SyntheticFreiHand as JaxSynthetic,
)
from hand_integral_pose_estimation_tpu.evaluation import (
    evaluate_test_split as jax_evaluate_test_split,
)
from hand_integral_pose_estimation_tpu.training import (
    Tester as JaxTester,
    create_train_state,
)
from hand_integral_pose_estimation_tpu_torch.config import Config
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.evaluation import (
    evaluate_test_split,
)
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch import training
from test_torch_pose_net import (
    port_model,
    randomized_jax_variables,
    small_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(cls):
    return cls(n=5, image_hw=(64, 64), seed=3, render_joints=True)


@pytest.mark.parametrize("fuse_head", [True, False])
def test_tester_and_metrics_match_jax(fuse_head):
    """R18 at 64x64, 5 samples at batch 2 (the tail batch padded). Both
    packages compute in float32 from the same pixels and weights; measured
    agreement is ~2e-6 on coords and ~1e-6 relative on the metrics, so
    1e-5 and 1e-4 leave room for summation order and still catch any
    geometry or decode fault."""
    cfg = Config(model=small_config(18))
    # the images are 0..255-scale pixels, 100x the pose-net test's input
    net, variables = randomized_jax_variables(cfg.model, seed=18,
                                              final_scale=1e-4)
    state, _ = create_train_state(net, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 64, 64, 3)), cfg.train)
    state = dataclasses.replace(state, params=variables["params"],
                                batch_stats=variables["batch_stats"])
    want_coords, want_batch = JaxTester(
        cfg, _dataset(JaxSynthetic), state, integral_impl="xla",
        native_prefetch=False).run(batch_size=2)
    tester = training.Tester(cfg, _dataset(SyntheticFreiHand),
                             port_model(cfg.model, variables), device="cpu",
                             fuse_head=fuse_head)
    coords, batch = tester.run(batch_size=2)

    assert coords.shape == (5, 21, 3) and batch.image is None
    np.testing.assert_allclose(coords, want_coords, atol=1e-5)
    for name in ("label", "joint_cam", "trans_inv", "tprime", "K", "R",
                 "ref_bone_len", "bbox"):
        np.testing.assert_allclose(getattr(batch, name),
                                   np.asarray(getattr(want_batch, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    got = evaluate_test_split(coords, batch)
    want = jax_evaluate_test_split(want_coords, want_batch)
    for key in ("pa_mpjpe", "mpjpe"):
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    # padding must not change the loss: a batch size that divides n agrees
    np.testing.assert_allclose(tester.mean_loss(2), tester.mean_loss(5),
                               rtol=1e-5)


def test_evaluator_sweeps_the_challenge_split_as_jax_does():
    """The Evaluator's sweep over a split that carries detector boxes (the
    challenge split's crops) against the JAX package's Evaluator with the
    same weights: R18 at 64x64, 5 samples at batch 2 (the tail padded),
    coords to 1e-5 and the boxes the crops used exactly, as
    tests/test_torch_slice.py holds the Tester."""
    from hand_integral_pose_estimation_tpu.training import (
        Evaluator as JaxEvaluator,
    )

    cfg = Config(model=small_config(18))
    net, variables = randomized_jax_variables(cfg.model, seed=18,
                                              final_scale=1e-4)
    state, _ = create_train_state(net, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 64, 64, 3)), cfg.train)
    state = dataclasses.replace(state, params=variables["params"],
                                batch_stats=variables["batch_stats"])
    boxes = (np.array([32.0, 30.0, 44.0, 44.0], np.float32)
             + np.random.default_rng(6).uniform(-4, 4, (5, 4))
             ).astype(np.float32)
    datasets = []
    for cls in (JaxSynthetic, SyntheticFreiHand):
        ds = cls(n=5, image_hw=(64, 64), seed=3, render_joints=True)
        ds.detector_bbox = boxes
        datasets.append(ds)
    want, want_batch = JaxEvaluator(
        cfg, datasets[0], state, integral_impl="xla",
        native_prefetch=False).run(batch_size=2)
    evaluator = training.Evaluator(cfg, datasets[1],
                                   port_model(cfg.model, variables),
                                   device="cpu")
    got, batch = evaluator.run(batch_size=2)
    assert got.shape == (5, 21, 3) and batch.image is None
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(batch.bbox, boxes)
    np.testing.assert_array_equal(batch.bbox, np.asarray(want_batch.bbox))


def _snapshot_model():
    return get_pose_net(Config().model,
                        generator=torch.Generator().manual_seed(5))


def test_cli_loads_reference_snapshot(tmp_path):
    """cli.test --torch-snapshot loads a reference snapshot_*.pth (the
    trainer's {"epoch", "network"} envelope with DataParallel's "module."
    prefix) natively and evaluates it; the result is the in-process
    Tester's on the same weights, and the artifacts are written."""
    from hand_integral_pose_estimation_tpu_torch.cli import test as cli_test

    model = _snapshot_model()
    path = str(tmp_path / "snapshot_3.pth")
    torch.save({"epoch": 3, "network": {f"module.{k}": v for k, v in
                                        model.state_dict().items()}}, path)
    result_dir = str(tmp_path / "result")
    summary = cli_test.main(["--synthetic", "--synthetic-size", "3",
                             "--batch-size", "2", "--torch-snapshot", path,
                             "--device", "cpu", "--result-dir", result_dir])
    coords, batch = training.Tester(Config(), SyntheticFreiHand(n=3), model,
                                    device="cpu").run(batch_size=2)
    want = evaluate_test_split(coords, batch)
    assert summary["pa_mpjpe"] == want["pa_mpjpe"]
    assert summary["mpjpe"] == want["mpjpe"]
    for name in ("ground_truth_test.npy", "pred.npy", "pred_procr.npy",
                 "eval_result.txt"):
        assert os.path.exists(os.path.join(result_dir, name)), name
    with pytest.raises(SystemExit):
        cli_test.main(["--device", "cpu"])


NO_JAX_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax",
               "hand_integral_pose_estimation_tpu"}
    assert not BLOCKED & {m.split(".")[0] for m in sys.modules}, \\
        "the interpreter imported jax before the test began"

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Blocker())

    import hand_integral_pose_estimation_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)

    from hand_integral_pose_estimation_tpu_torch.config import (
        Config, ModelConfig, TrainConfig)
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_test_split)
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch import training
    from hand_integral_pose_estimation_tpu_torch.cli import test as cli_test
    from hand_integral_pose_estimation_tpu_torch.cli import train as cli_train
    from hand_integral_pose_estimation_tpu_torch.geometry import rotation
    from hand_integral_pose_estimation_tpu_torch.training import (
        checkpoint, train_step)
    from hand_integral_pose_estimation_tpu_torch import losses
    import torch

    cfg = Config(model=ModelConfig(resnet_type=18, input_shape=(64, 64),
                                   output_shape=(16, 16), depth_dim=8))
    model = get_pose_net(cfg.model, torch.Generator().manual_seed(0))
    for fuse in (True, False):
        coords, batch = training.Tester(
            cfg, SyntheticFreiHand(n=3, image_hw=(64, 64)), model,
            device="cpu", fuse_head=fuse).run(2)
        evaluate_test_split(coords, batch)
    cli_test.main(["--synthetic", "--synthetic-size", "2", "--batch-size",
                   "2", "--device", "cpu", "--result-dir", sys.argv[1]])
    # the training slice: a Trainer on both arms, then the train and test
    # CLIs through a snapshot
    for fuse in (True, False):
        trainer = training.Trainer(
            cfg.replace(train=TrainConfig(batch_size=2)),
            SyntheticFreiHand(n=4, image_hw=(64, 64)), model_dir=sys.argv[1],
            device="cpu", fuse_head=fuse)
        metrics = trainer.run_epoch(0, num_steps=1)
        assert set(metrics) >= {"loss", "student_mpjpe"}, metrics
    sizing = ["--pose-resnet", "18", "--pose-input", "64"]
    cli_train.main(["--synthetic", "--synthetic-size", "4", "--epochs", "1",
                    "--steps-per-epoch", "1", "--batch-size", "2",
                    "--device", "cpu", "--model-dir", sys.argv[1] + "/m",
                    *sizing])
    assert checkpoint.latest_epoch(sys.argv[1] + "/m") == 0
    cli_test.main(["--synthetic", "--synthetic-size", "2", "--batch-size",
                   "2", "--device", "cpu", "--model-dir", sys.argv[1] + "/m",
                   "--result-dir", sys.argv[1], *sizing])
    # the two-stage serving slice: detector -> crop -> pose, then the
    # challenge CLI with the detector and its crop-box cache
    from hand_integral_pose_estimation_tpu_torch.cli import (
        evaluate as cli_evaluate)
    from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
    from hand_integral_pose_estimation_tpu_torch.detect import build_detector
    from hand_integral_pose_estimation_tpu_torch.inference import (
        TwoStagePipeline)
    import numpy as np
    det_cfg = DetectorConfig(resnet_type=18, test_scale=64, test_max_size=64,
                             rpn_pre_nms_top_n_test=64,
                             rpn_post_nms_top_n_test=16, max_detections=5)
    pipe = TwoStagePipeline(
        cfg.replace(detector=det_cfg), model,
        build_detector(det_cfg, generator=torch.Generator().manual_seed(0)),
        device="cpu")
    ds = SyntheticFreiHand(n=2, image_hw=(64, 64))
    host = ds.host_batch(np.arange(2))
    out = pipe(host["image"], host["K"], host["ref_bone_len"])
    assert out.joints_cam.shape == (2, 21, 3)
    assert bool(torch.isfinite(out.joints_cam).all())
    cli_evaluate.main(["--synthetic", "--synthetic-size", "3", "--batch-size",
                       "2", "--use-detector", "--detector-resnet", "18",
                       "--detector-scale", "64", "--detector-proposals", "16",
                       "--bbox-db", sys.argv[1] + "/bbox.npz", "--result-dir",
                       sys.argv[1] + "/eval", "--model-dir", sys.argv[1] + "/m",
                       "--device", "cpu", *sizing])
    # the semi-supervised slice: the file-backed split on the fixture,
    # PANet and its trainer, the frozen teacher, the teacher-label sweep
    # and its cascade, and a student step with both terms
    import os
    from hand_integral_pose_estimation_tpu_torch.data import (
        FreiHandDataset, apply_filtered_labels)
    from hand_integral_pose_estimation_tpu_torch.distill import (
        CascadeRunner, generate_filtered_labels)
    from hand_integral_pose_estimation_tpu_torch.models import panet
    from hand_integral_pose_estimation_tpu_torch.training import (
        panet_trainer, teacher)
    from hand_integral_pose_estimation_tpu_torch.cli import (
        generate_teacher_labels, panet_data, panet_test, train_panet)
    fixture = os.path.join(sys.argv[2], "fixtures", "freihand_mini")
    ds = FreiHandDataset(fixture, "training", cfg.with_training_size(2))
    assert ds.host_batch(np.arange(2))["image"].shape == (2, 224, 224, 3)
    prior = panet.PANet(21, (16, 8, 4), generator=torch.Generator())
    res = panet_trainer.train_panet(prior, np.random.RandomState(0).randn(
        16, 21, 3) * 0.05, np.zeros((2, 21, 3)), num_steps=2, batch_size=4)
    assert np.isfinite(res.train_losses).all()
    frozen = teacher.frozen_teacher(model, cfg)
    host = SyntheticFreiHand(n=2, image_hw=(64, 64)).host_batch(np.arange(2))
    box = torch.tensor([[32.0, 32.0, 40.0, 40.0]] * 2)
    args = (torch.from_numpy(host["image"]), torch.from_numpy(host["K"]),
            box, torch.from_numpy(host["labelled"]),
            torch.from_numpy(host["joint_cam"]))
    out = generate_filtered_labels(frozen, *args, num_rotations=3,
                                   patch_hw=(64, 64))
    runner = CascadeRunner(frozen, num_rotations=3, pass1_rotations=2,
                           pass2_batch=2, patch_hw=(64, 64), device="cpu")
    runner.add_batch(*args, rows=[0, 1])
    assert (runner.finalize(2)["keep"] == out.keep.numpy()).all()
    trainer = training.Trainer(
        cfg.replace(train=TrainConfig(batch_size=2, lam=0.1)),
        SyntheticFreiHand(n=4, image_hw=(64, 64)), device="cpu",
        teacher_apply=frozen,
        panet_apply=panet.panet_reconstruction_fn(
            prior.requires_grad_(False)))
    assert np.isfinite(trainer.run_epoch(0, num_steps=1)["loss"])
    d = sys.argv[1]
    panet_data.main(["--synthetic", "--synthetic-size", "20", "--out-dir",
                     d + "/pd", "--device", "cpu"])
    train_panet.main(["--train-npy", d + "/pd/hand_train.npy", "--test-npy",
                      d + "/pd/hand_test.npy", "--steps", "2",
                      "--batch-size", "4", "--out", d + "/panet",
                      "--device", "cpu"])
    panet_test.main(["--ckpt", d + "/panet/model_best.pth", "--pts-npy",
                     d + "/pd/hand_test.npy", "--device", "cpu"])
    generate_teacher_labels.main([
        "--data-dir", fixture, "--training-size", "2", "--batch-size", "8",
        "--cascade", "--out", d + "/db.npz", "--model-dir", d + "/m",
        "--device", "cpu", *sizing])
    assert len(apply_filtered_labels(FreiHandDataset(
        fixture, "training", cfg.with_training_size(2)),
        d + "/db.npz")) == int(np.load(d + "/db.npz")["keep"].sum())
    assert rotation.sample_rotation_matrix(torch.Generator(), 2).shape == (
        2, 3, 3)
    assert callable(losses.combined_loss) and callable(
        train_step.make_train_step)
    leaked = BLOCKED & {m.split(".")[0] for m in sys.modules}
    assert not leaked, leaked
    print("NO_JAX_OK", len(names))
""")


def test_port_runs_without_jax(tmp_path):
    """Every module of the port imports, and the CPU slices run (serving:
    both head arms, evaluation, the test CLI; training: the Trainer on both
    arms, the train CLI's snapshot read back by the test CLI; two-stage
    serving: the detector pipeline and the challenge CLI; semi-supervised:
    the file-backed split and its JPEG decode, PANet and its trainer, the
    frozen teacher, the teacher-label sweep and its cascade, a student step
    with both terms, and the four new CLIs), with
    jax/flax/optax/orbax and the JAX package blocked by a sys.meta_path
    finder in a fresh interpreter."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # small shapes: one intra-op thread, so that the suite's parallel
    # workers do not oversubscribe the cores
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX_SCRIPT, str(tmp_path / "result"),
         os.path.join(REPO, "tests")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
