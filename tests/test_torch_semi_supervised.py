"""The semi-supervised path of the port on the CPU: one train step with a
frozen teacher and the PANet term against the JAX step at float64, and
the new CLIs end to end (the recipe of tests/test_semi_supervised_cli.py:
teacher snapshot -> PANet -> student with both terms; teacher labels on
the real-format fixture -> `cli.train --filtered-db`; the cascade CLI
against the single pass on the synthetic split, whose records are about
half unlabelled, where the fixture's are all labelled at its size)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.interop import convert_pose_snapshot
from hand_integral_pose_estimation_tpu.models import panet as jpanet
from hand_integral_pose_estimation_tpu.ops.fused_head import (
    head_projection_integral as jax_head_projection_integral,
)
from hand_integral_pose_estimation_tpu.data import pipeline as jpipeline
from hand_integral_pose_estimation_tpu.training import (
    TrainState,
    make_train_step as jax_make_train_step,
)
from hand_integral_pose_estimation_tpu_torch.data import (
    Batch,
    make_train_batch_with,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    panet_state_dict_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.models import panet
from hand_integral_pose_estimation_tpu_torch.training import (
    checkpoint,
    make_optimizer,
    make_train_step,
    multistep_schedule,
)
from hand_integral_pose_estimation_tpu_torch.training.teacher import (
    frozen_teacher,
)
from test_torch_panet import (  # noqa: F401 (the autouse fixture)
    DICT_SIZES,
    _jax_params,
    _one_torch_thread,
)
from test_torch_pose_net import port_model, randomized_jax_variables
from test_torch_train import (
    _grads_tx,
    _train_inputs,
    got_leaf,
    small_config,
    t,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "freihand_mini")



def test_semi_supervised_train_step_matches_jax():
    """One fused-head train step with a live frozen teacher (other weights
    than the student's) and the PANet term at lam = 0.3, both packages
    from the same weights on the same augmented batch (two labelled, two
    unlabelled rows), at float64: the loss and metrics to 1e-5 relative,
    every student gradient leaf to ||d|| <= 1e-4 ||g||. The teacher's and
    the PANet's parameters take no gradient and stay as they were; the
    teacher's BatchNorm statistics do not move and it stays in eval
    mode."""
    cfg = small_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lam=0.3))
    jcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float64"))
    f64 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), tree)
    net, variables = randomized_jax_variables(jcfg.model, seed=11,
                                              final_scale=1e-4)
    _, tvars = randomized_jax_variables(jcfg.model, seed=12,
                                        final_scale=1e-3)
    variables, tvars = f64(variables), f64(tvars)
    pparams = _jax_params(13)
    J, D = cfg.model.num_joints, cfg.model.depth_dim

    def jax_teacher(images):
        feats = net.apply(tvars, images, train=False, return_features=True)
        Wp, bp = net.final_projection(tvars["params"])
        return jax_head_projection_integral(feats, Wp, bp, J, D, impl="xla")

    jax_panet = jpanet.panet_reconstruction_fn(
        jpanet.PANet(pts_num=21, dict_sizes=DICT_SIZES, dtype=jnp.float64),
        {k: jnp.asarray(v, jnp.float64) for k, v in pparams.items()})

    x = _train_inputs()
    batch = make_train_batch_with(
        t(x["R"]), t(x["color"]), t(x["images"]), t(x["joint_cam"]),
        t(x["K"]), t(x["bbox"]), t(x["labelled"]), t(x["teacher"]),
        t(x["ref_bone_len"]), cfg.augment, cfg.model.input_shape)
    batch = Batch(*[v.double() if v.is_floating_point() else v
                    for v in batch])
    jbatch = jpipeline.Batch(*[jnp.asarray(v.numpy()) for v in batch])
    tx = _grads_tx()
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    new_state, jmetrics = jax_make_train_step(
        net, tx, jcfg, teacher_apply=jax_teacher, panet_apply=jax_panet,
        integral_impl="xla", fuse_head=True)(state, jbatch)

    model = port_model(cfg.model, variables).double()
    teacher_net = port_model(cfg.model, tvars).double()
    teacher_before = {k: v.clone()
                      for k, v in teacher_net.state_dict().items()}
    prior = panet.PANet(21, DICT_SIZES)
    prior.load_state_dict(panet_state_dict_from_jax(pparams))
    prior = prior.double().requires_grad_(False)
    prior_before = {k: v.clone() for k, v in prior.state_dict().items()}
    optimizer = make_optimizer(model.parameters(), cfg.train)
    scheduler = multistep_schedule(optimizer, 1, cfg.train.lr_dec_epoch,
                                   cfg.train.lr_dec_factor)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = make_train_step(
        model, optimizer, scheduler, cfg,
        teacher_apply=frozen_teacher(teacher_net, cfg),
        panet_apply=panet.panet_reconstruction_fn(prior),
        fuse_head=True)(batch)

    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(jmetrics[name]),
                                   rtol=1e-5, err_msg=name)
    # the teacher term is live: its MPJPE is not the cached labels'
    assert float(metrics["teacher_mpjpe"]) != pytest.approx(float(
        torch.linalg.vector_norm(batch.label_teacher - batch.label,
                                 dim=-1).mean()), rel=1e-3)
    grads_sd = dict(before)
    grads_sd.update({n: p.grad for n, p in model.named_parameters()})
    got = convert_pose_snapshot(grads_sd, resnet_type=18)["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(new_state.opt_state):
        g = np.asarray(want)
        d = np.asarray(got_leaf(got, path)) - g
        assert np.linalg.norm(d) <= 1e-4 * np.linalg.norm(g), \
            jax.tree_util.keystr(path)
    assert not teacher_net.training
    for module in (teacher_net, prior):
        assert all(p.grad is None and not p.requires_grad
                   for p in module.parameters())
    for k, v in teacher_net.state_dict().items():
        torch.testing.assert_close(v, teacher_before[k], rtol=0, atol=0)
    for k, v in prior.state_dict().items():
        torch.testing.assert_close(v, prior_before[k], rtol=0, atol=0)


SMALL = ["--pose-resnet", "18", "--pose-input", "32", "--device", "cpu"]


def test_semi_supervised_cli_pipeline(tmp_path):
    """cli.train (a teacher snapshot) -> cli.panet_data -> cli.train_panet
    (.pth files) -> cli.panet_test -> cli.train with --teacher-ckpt,
    --panet-ckpt and --lam, on --synthetic at a small size."""
    from hand_integral_pose_estimation_tpu_torch.cli import (
        panet_data,
        panet_test,
        train,
        train_panet,
    )

    small = ["--synthetic", "--synthetic-size", "8", "--epochs", "1",
             "--batch-size", "4", "--steps-per-epoch", "1", *SMALL,
             "--log-dir", str(tmp_path / "log")]
    teacher_dir = str(tmp_path / "teacher")
    train.main(small + ["--model-dir", teacher_dir])
    data_dir = str(tmp_path / "pd")
    tr, te = panet_data.main(["--synthetic", "--synthetic-size", "40",
                              "--out-dir", data_dir, "--device", "cpu"])
    assert tr.shape == (36, 21, 3) and te.shape == (4, 21, 3)
    # tprime-normalised joints: the root sits at depth tprime / 1000 m
    assert np.all(tr[:, 9, 2] > 0)
    out = str(tmp_path / "panet")
    res = train_panet.main([
        "--train-npy", os.path.join(data_dir, "hand_train.npy"),
        "--test-npy", os.path.join(data_dir, "hand_test.npy"), "--steps",
        "6", "--batch-size", "8", "--out", out, "--device", "cpu"])
    assert np.isfinite(res.best_val_loss)
    for name in ("model_best.pth", "model_cur.pth"):
        assert os.path.exists(os.path.join(out, name))
    mpjpe = panet_test.main(["--ckpt", os.path.join(out, "model_best.pth"),
                             "--pts-npy", os.path.join(data_dir,
                                                       "hand_test.npy"),
                             "--device", "cpu"])
    assert np.isfinite(mpjpe) and mpjpe > 0
    student_dir = str(tmp_path / "student")
    trainer = train.main(small + [
        "--model-dir", student_dir, "--teacher-ckpt", teacher_dir,
        "--panet-ckpt", os.path.join(out, "model_best.pth"), "--lam",
        "0.1"])
    assert trainer.teacher_apply is not None
    assert trainer.panet_apply is not None
    assert trainer.cfg.train.lam == 0.1
    assert checkpoint.latest_epoch(student_dir) == 0


def test_cascade_cli_keeps_the_single_pass_rows(tmp_path):
    """cli.generate_teacher_labels on --synthetic (12 records, about half
    labelled, batch 5: a padded tail batch): --cascade keeps exactly the
    rows the single pass keeps, at a threshold between the two middle
    variances of the unlabelled rows (no row within 1e-3 of it)."""
    from hand_integral_pose_estimation_tpu_torch.cli import (
        generate_teacher_labels as gen,
    )

    common = ["--synthetic", "--synthetic-size", "12", "--batch-size", "5",
              *SMALL, "--model-dir", str(tmp_path / "none")]
    single = gen.main(common + ["--out", str(tmp_path / "single.npz"),
                                "--variance-threshold", "1e9"])
    assert len(single["keep"]) == 12 and single["keep"].all()
    var = np.sort(single["variance"][~single["labelled"]])
    assert len(var) >= 2
    threshold = float(np.sqrt(var[len(var) // 2 - 1] * var[len(var) // 2]))
    assert not (np.abs(single["variance"] / threshold - 1) < 1e-3).any()
    want_keep = single["labelled"] | (single["variance"] < threshold)
    assert want_keep.any() and not want_keep.all()
    casc = gen.main(common + ["--out", str(tmp_path / "casc.npz"),
                              "--cascade", "--cascade-pass1", "5",
                              "--variance-threshold", str(threshold)])
    np.testing.assert_array_equal(casc["keep"], want_keep)
    np.testing.assert_array_equal(casc["name"], single["name"])
    full = ~casc["early_rejected"]
    np.testing.assert_allclose(casc["variance"][full],
                               single["variance"][full], rtol=1e-4)
    kept = want_keep & ~single["labelled"]
    np.testing.assert_allclose(casc["joint_cam_normalized"][kept],
                               single["joint_cam_normalized"][kept],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.skipif(
    not os.path.exists(os.path.join(FIXTURE, "training_K.json")),
    reason="freihand_mini fixture absent")
def test_filtered_db_pipeline_on_the_fixture(tmp_path):
    """cli.generate_teacher_labels on the real-format fixture at
    --training-size 6 (24 records, batch 7: a padded tail batch) writes a
    row and a name for every record; cli.train --filtered-db trains on the
    kept records (the cached labels win over --teacher-ckpt), refuses
    --synthetic, and refuses a db made for another --training-size."""
    from hand_integral_pose_estimation_tpu_torch.cli import (
        generate_teacher_labels as gen,
        train,
    )

    db = str(tmp_path / "db.npz")
    out = gen.main(["--data-dir", FIXTURE, "--training-size", "6",
                    "--batch-size", "7", *SMALL, "--model-dir",
                    str(tmp_path / "none"), "--out", db,
                    "--variance-threshold", "1e9"])
    assert len(out["keep"]) == 24 and out["keep"].all()
    assert len(set(out["name"])) == 24
    trainer = train.main(["--data-dir", FIXTURE, "--training-size", "6",
                          "--filtered-db", db, "--epochs", "1",
                          "--steps-per-epoch", "1", "--batch-size", "4",
                          "--model-dir", str(tmp_path / "m"),
                          "--teacher-ckpt", str(tmp_path / "ignored"),
                          "--log-dir", str(tmp_path / "log"), *SMALL])
    assert len(trainer.dataset) == 24
    assert trainer.teacher_apply is None
    assert all(r.teacher_cam_normalized is not None
               for r in trainer.dataset.records)
    assert checkpoint.latest_epoch(str(tmp_path / "m")) == 0
    with pytest.raises(SystemExit, match="record-backed"):
        train.main(["--synthetic", "--filtered-db", db, *SMALL,
                    "--log-dir", str(tmp_path / "log")])
    with pytest.raises(ValueError, match="different record set"):
        train.main(["--data-dir", FIXTURE, "--training-size", "5",
                    "--filtered-db", db, *SMALL,
                    "--log-dir", str(tmp_path / "log")])
