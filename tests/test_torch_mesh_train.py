"""The port's device mesh in training, over two gloo ranks on the CPU.

One module-scoped spawn of tests/torch_mesh_worker.py (`train`, data=2)
runs every check's rank-side half; the tests compare what each rank wrote
with BatchNorm2d over the whole batch, with the port's one-process run
over the union batch and with the JAX package, as tests/test_multihost.py
holds the JAX package's two-process run:

1. the ranks' sampling streams differ (the seed takes 1000003 x rank);
2. the parameters are bitwise equal across ranks;
3. the run equals the one-process run over the union batch;
4. its first step equals the JAX `make_train_step` over the union batch
   from the same bridged weights.

Sizes as tests/test_multihost.py: R18, 32x32 input, 8x8 x 8 heatmap,
float32 (float64 and 64x64 for the step against JAX), global batch 8."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hand_integral_pose_estimation_tpu.data.freihand import (
    SyntheticFreiHand as JaxSynthetic,
)
from hand_integral_pose_estimation_tpu.geometry import rotation as jrot
from hand_integral_pose_estimation_tpu.interop import convert_pose_snapshot
from hand_integral_pose_estimation_tpu.training import (
    Tester as JaxTester,
    TrainState,
    create_train_state,
    make_train_step as jax_make_train_step,
)
from hand_integral_pose_estimation_tpu_torch.data import (
    SyntheticFreiHand,
    make_train_batch_with,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    pose_state_dict_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.training import (
    Tester,
    Trainer,
    load_checkpoint,
    save_checkpoint,
)
from test_torch_pose_net import jax_pose_net, randomized_jax_variables
from torch_mesh_worker import small_config, spawn

WORLD = 2


def _union_batch(cfg, n=8, seed=2):
    """An augmented float64 batch of n rows, half labelled, with teacher
    joints and detector boxes (test_torch_train._train_inputs at n=8)."""
    ds = JaxSynthetic(n=n, image_hw=(48, 48), seed=seed, render_joints=True)
    rng = np.random.default_rng(seed)
    jc = ds.joint_cam.astype(np.float64)
    K = ds.K.astype(np.float64)
    uvw = np.einsum("bij,bnj->bni", K, jc)
    uv = uvw[..., :2] / uvw[..., 2:3]
    box = np.concatenate([uv.mean(1), np.full((n, 2), 35.0)], axis=1)
    teacher = jc * 0.9 + rng.normal(0, 0.002, jc.shape)
    R = np.asarray(jrot.rodrigues(jnp.asarray(rng.normal(0, 0.3, (n, 3)))))
    t = torch.from_numpy
    batch = make_train_batch_with(
        t(R), t(rng.uniform(0.8, 1.2, (n, 3))),
        t(ds.images.astype(np.float32)), t(jc), t(K), t(box),
        t(np.arange(n) % 2 == 0), t(teacher), t(ds.ref_bone_len),
        cfg.augment, cfg.model.input_shape)
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in batch._asdict().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    cfg = small_config()
    rng = np.random.default_rng(0)
    np.savez(out / "inputs.npz",
             bn_x=rng.normal(1.0, 2.0, (8, 4, 5, 5)),
             bn_cot=rng.normal(size=(8, 4, 5, 5)),
             bn_w=rng.uniform(0.5, 1.5, 4), bn_b=rng.normal(size=4))
    net, variables = randomized_jax_variables(cfg.model, seed=5,
                                              final_scale=1e-4)
    torch.save(pose_state_dict_from_jax(variables), out / "init_pose.pt")
    # the step against JAX at 64x64: at 32x32 layer4's map is 1x1 and the
    # backbone's gradients cancel to float64 noise (1e-15 of the head's)
    cfg64 = small_config(size=64)
    _, variables64 = randomized_jax_variables(cfg64.model, seed=5,
                                              final_scale=1e-4)
    torch.save(pose_state_dict_from_jax(variables64), out / "init64.pt")
    union = _union_batch(cfg64)
    torch.save(union, out / "union_batch.pt")
    # a one-device snapshot for the data=2 resume
    one = Trainer(cfg=cfg, dataset=SyntheticFreiHand(n=16, image_hw=(32, 32),
                                                     seed=4),
                  device="cpu", seed=1, model_dir=str(out / "one_device"))
    one.run_epoch(0, num_steps=1)
    save_checkpoint(one.model_dir, one.model, one.optimizer, 0)
    spawn("train", WORLD, out)
    ranks = [torch.load(out / f"train_rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(out=out, cfg=cfg, net=net, variables=variables, union=union,
                variables64=variables64, cfg64=cfg64, ranks=ranks)


def test_sync_batchnorm_matches_batchnorm_over_the_union(run):
    """SyncBatchNorm over two ranks' rows against nn.BatchNorm2d over the
    concatenated batch, forward and backward, at float64: 1e-10 (the same
    sums in another order)."""
    inputs = np.load(run["out"] / "inputs.npz")
    x = torch.from_numpy(inputs["bn_x"]).requires_grad_(True)
    bn = torch.nn.BatchNorm2d(4).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["bn_w"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn_b"]))
    y = bn(x)
    (y * torch.from_numpy(inputs["bn_cot"])).sum().backward()
    got = run["ranks"]
    for name, want in (("bn_y", y.detach()), ("bn_dx", x.grad)):
        np.testing.assert_allclose(
            torch.cat([r[name] for r in got]).numpy(), want.numpy(),
            rtol=1e-10, atol=1e-10, err_msg=name)
    for r in got:
        for name, want in (("bn_dw", bn.weight.grad), ("bn_db", bn.bias.grad),
                           ("bn_mean", bn.running_mean),
                           ("bn_var", bn.running_var)):
            np.testing.assert_allclose(r[name].numpy(), want.numpy(),
                                       rtol=1e-10, atol=1e-10, err_msg=name)


def _grads_tx():
    """An optax transformation that keeps the step's gradients as its state
    (test_torch_train._grads_tx)."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("fuse_head", [True, False])
def test_first_mesh_step_matches_jax(run, fuse_head):
    """(4) The two-rank step on each rank's rows of the union batch against
    the JAX `make_train_step` on the whole union batch, both at float64 from
    the same bridged weights (test_torch_train.test_train_step_matches_jax's
    tolerances): metrics to 1e-5 relative, each gradient leaf to
    ||d|| <= 1e-4 ||g|| (the JAX gradient is the global mean's; the port's
    is the all-reduced mean of the ranks' means), running means to 1e-5
    and running variances, which torch updates with the unbiased global
    variance, after the JAX update is rescaled by n/(n-1)."""
    cfg = run["cfg64"]
    jcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float64"))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       run["variables64"])
    tx = _grads_tx()
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    from hand_integral_pose_estimation_tpu.data import pipeline as jpipeline
    jbatch = jpipeline.Batch(**{k: jnp.asarray(v.numpy())
                                for k, v in run["union"].items()})
    new_state, jmetrics = jax_make_train_step(
        jax_pose_net(jcfg.model), tx, jcfg, integral_impl="xla",
        fuse_head=fuse_head)(
            state, jbatch)
    for r in run["ranks"]:
        step = r[f"step{int(fuse_head)}"]
        for name, value in step["metrics"].items():
            np.testing.assert_allclose(value, float(jmetrics[name]),
                                       rtol=1e-5, err_msg=name)
        sd = {k: v for k, v in step["buffers"].items()}
        sd.update(step["grads"])
        got = convert_pose_snapshot(sd, resnet_type=18)["params"]
        for path, want in jax.tree_util.tree_leaves_with_path(
                new_state.opt_state):
            g = np.asarray(want)
            leaf = got
            for k in path:
                leaf = leaf[k.key]
            d = np.asarray(leaf) - g
            assert np.linalg.norm(d) <= 1e-4 * np.linalg.norm(g), \
                jax.tree_util.keystr(path)
        n = cfg.train.batch_size * 16 * 16        # the head's last BN
        old = run["variables64"]["batch_stats"]["head"]["_Norm_2"][
            "BatchNorm_0"]
        want = new_state.batch_stats["head"]["_Norm_2"]["BatchNorm_0"]
        np.testing.assert_allclose(
            step["buffers"]["head.deconv_layers.7.running_mean"].numpy(),
            np.asarray(want["mean"]), rtol=1e-5, atol=1e-5)
        old_var = np.asarray(old["var"], np.float64)
        np.testing.assert_allclose(
            step["buffers"]["head.deconv_layers.7.running_var"].numpy(),
            0.9 * old_var + (np.asarray(want["var"]) - 0.9 * old_var)
            * n / (n - 1), rtol=1e-5, atol=1e-5)


def test_sampling_streams_differ(run):
    """(1) Each rank feeds a distinct slice of the global batch."""
    s0, s1 = (r["sampled"] for r in run["ranks"])
    assert run["ranks"][0]["mesh_shape"] == {"data": 2, "model": 1}
    assert run["ranks"][0]["local_batch"] == 4
    assert s0.shape == s1.shape == (2, 4)
    assert not np.array_equal(s0, s1), (s0, s1)


def test_params_bitwise_equal_across_ranks(run):
    """(2) One program, not two drifting copies: the same parameters,
    buffers and losses on both ranks."""
    p0, p1 = (r["params"] for r in run["ranks"])
    assert p0.keys() == p1.keys() and len(p0) > 10
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert run["ranks"][0]["metrics"] == run["ranks"][1]["metrics"]


def test_matches_the_one_process_union_run(run):
    """(3) The port's one-process Trainer fed the union of the two ranks'
    draws (rank 0's rows, then rank 1's) with the same seeds: loss to
    5e-4 relative, parameters to 5e-3 (Adam moves an element by up to
    ~2.5 lr a step where a near-zero gradient's sign flips under another
    summation order), as tests/test_multihost.py holds the JAX run."""
    cfg = run["cfg"]
    t = Trainer(cfg=cfg, dataset=SyntheticFreiHand(n=16, image_hw=(32, 32),
                                                   seed=3),
                device="cpu", seed=0, model_dir=str(run["out"] / "union"))
    union = np.concatenate([r["sampled"] for r in run["ranks"]], axis=1)
    t.host_batches = lambda rng, num_steps: map(t.dataset.host_batch,
                                                union[:num_steps])
    m = t.run_epoch(0, num_steps=2, log_every=100)
    np.testing.assert_allclose(m["loss"], run["ranks"][0]["metrics"]["loss"],
                               rtol=5e-4)
    for k, v in t.model.named_parameters():
        np.testing.assert_allclose(
            run["ranks"][0]["params"][k].double().numpy(),
            v.detach().double().numpy(), atol=2 * 2.5e-3, err_msg=k)


def test_snapshots_across_layouts(run):
    """rank 0 writes the data=2 run's snapshot, which loads on one device
    as its parameters; a one-device snapshot resumes on data=2 (epoch 1)
    with its weights and takes a step with both ranks equal."""
    model = get_pose_net(run["cfg"].model)
    assert load_checkpoint(str(run["out"] / "trained"), model) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, run["ranks"][0]["params"][k]), k
    one = torch.load(run["out"] / "one_device" / "snapshot_0.pth.tar")
    r0, r1 = run["ranks"]
    assert r0["resumed_epoch"] == r1["resumed_epoch"] == 1
    for k, v in one["network"].items():
        assert torch.equal(r0["resumed"][k], v), k
    for k in r0["resumed_params"]:
        assert torch.equal(r0["resumed_params"][k], r1["resumed_params"][k])
    assert np.isfinite(r0["resumed_metrics"]["loss"])


def test_tester_sweep_over_the_mesh(run):
    """Tester(mesh) over 5 samples at batch 2 (each rank one row, the tail
    padded) against the port's one-rank sweep and the JAX Tester on the
    same bridged weights: coords to 1e-5 (test_torch_slice's bound), the
    geometry fields to 1e-6; both ranks return the whole sweep; a batch
    that does not divide the data axis raises the JAX ValueError."""
    cfg = run["cfg"]
    model = get_pose_net(cfg.model)
    model.load_state_dict(torch.load(run["out"] / "init_pose.pt"))

    def ds(cls):
        return cls(n=5, image_hw=(32, 32), seed=3, render_joints=True)
    one_coords, one_batch = Tester(cfg, ds(SyntheticFreiHand), model,
                                   device="cpu").run(batch_size=2)
    net = run["net"]
    state, _ = create_train_state(net, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 32, 32, 3)), cfg.train)
    state = dataclasses.replace(state, params=run["variables"]["params"],
                                batch_stats=run["variables"]["batch_stats"])
    jax_coords, _ = JaxTester(cfg, ds(JaxSynthetic), state,
                              integral_impl="xla",
                              native_prefetch=False).run(batch_size=2)
    for r in run["ranks"]:
        assert r["tester_coords"].shape == (5, 21, 3)
        np.testing.assert_allclose(r["tester_coords"], one_coords, atol=1e-5)
        np.testing.assert_allclose(r["tester_coords"], jax_coords, atol=1e-5)
        for name in ("label", "joint_cam", "trans_inv", "tprime", "K",
                     "bbox", "ref_bone_len", "labelled"):
            np.testing.assert_allclose(r["tester_batch"][name],
                                       getattr(one_batch, name), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        assert r["tester_batch"]["image"] is None
        assert r["tester_error"].startswith(
            "test batch size 3 must divide by the mesh data-axis size 2")
