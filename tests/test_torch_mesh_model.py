"""The model axis of the port's mesh, over four gloo ranks on the CPU
(data=2 x model=2), one module-scoped spawn of tests/torch_mesh_worker.py
(`model`):

- `sharded_head_projection_integral` and `sharded_softmax_integral` at
  J = 6, D = 8 (the joints split over `model`: each rank decodes 3) and at
  J = 3 (a block would split a joint: the weight, or the heatmap's
  channels, are gathered and the head runs data-parallel), coords and
  gradients against the JAX package's `head_projection_integral` and
  `softmax_integral` on the whole batch (Pallas in interpret mode, as
  tests/test_shard_ops.py runs them), rtol 2e-5 / atol 1e-6;
- a Trainer whose final projection is split over `model` (J = 21 on
  model = 2: the data-parallel head over the gathered weight), its
  snapshot restored on one device, and the run against the one-process
  run over the union batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.ops.fused_head import (
    head_projection_integral,
)
from hand_integral_pose_estimation_tpu.ops.integral import softmax_integral
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.training import (
    Trainer,
    load_checkpoint,
)
from torch_mesh_worker import small_config, spawn
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

WORLD, D, F = 4, 8, 16


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_model")
    rng = np.random.default_rng(1)
    arrays = {"feats": rng.normal(size=(8, 4, 4, F)).astype(np.float32)}
    for J in (6, 3):
        arrays[f"w{J}"] = (0.5 * rng.normal(size=(J * D, F))).astype(
            np.float32)
        arrays[f"b{J}"] = (0.1 * rng.normal(size=J * D)).astype(np.float32)
        arrays[f"hm{J}"] = (3 * rng.normal(size=(8, 4, 4, J * D))).astype(
            np.float32)
        arrays[f"cot{J}"] = rng.normal(size=(8, J, 3)).astype(np.float32)
    np.savez(out / "inputs.npz", **arrays)
    spawn("model", WORLD, out)
    ranks = [torch.load(out / f"model_rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(out=out, arrays=arrays, ranks=ranks)


def _jax_head(a, J):
    def loss(f, w, b):
        c = head_projection_integral(f, w, b, J, D, "pallas", True)
        return jnp.sum(c * a[f"cot{J}"]), c
    (_, coords), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(a["feats"]), jnp.asarray(a[f"w{J}"].T),
        jnp.asarray(a[f"b{J}"]))
    return coords, grads


def _jax_decode(a, J):
    def loss(h):
        c = softmax_integral(h, J, D, impl="pallas", interpret=True)
        return jnp.sum(c * a[f"cot{J}"]), c
    (_, coords), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(a[f"hm{J}"]))
    return coords, g


@pytest.mark.parametrize("J", [6, 3])
def test_sharded_head_matches_jax(run, J):
    """Each rank (d, m): coords of its rows (all J joints after the model
    gather), its rows of dfeat (the model-row sum), its block m of dW and
    db (summed over the data column here, the gradient all-reduce's sum)."""
    a = run["arrays"]
    coords, (dfeat, dW, db) = _jax_head(a, J)
    dW = np.asarray(dW).T
    tol = dict(rtol=2e-5, atol=1e-6)
    for r in run["ranks"]:
        d, m = r["coords"]
        rows = slice(4 * d, 4 * (d + 1))
        block = slice(m * J * D // 2, (m + 1) * J * D // 2)
        got = r[f"head{J}"]
        assert r[f"split{J}"] == (J == 6)
        np.testing.assert_allclose(got["coords"].numpy(),
                                   np.asarray(coords)[rows], **tol)
        np.testing.assert_allclose(got["dfeat"].numpy(),
                                   np.asarray(dfeat)[rows], **tol)
        np.testing.assert_allclose(got["dw"].numpy(), dW[block], **tol)
        np.testing.assert_allclose(got["db"].numpy(),
                                   np.asarray(db)[block], **tol)


@pytest.mark.parametrize("J", [6, 3])
def test_sharded_decode_matches_jax(run, J):
    """The decode of each rank's rows and block of heatmap channels: all
    coords of its rows, the gradient of its block."""
    a = run["arrays"]
    coords, dhm = _jax_decode(a, J)
    for r in run["ranks"]:
        d, m = r["coords"]
        rows = slice(4 * d, 4 * (d + 1))
        block = slice(m * J * D // 2, (m + 1) * J * D // 2)
        got = r[f"head{J}"]
        np.testing.assert_allclose(got["hm_coords"].numpy(),
                                   np.asarray(coords)[rows], rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["dhm"].numpy(),
                                   np.asarray(dhm)[rows][..., block],
                                   rtol=2e-5, atol=1e-6)


def test_model_split_trainer_snapshot_on_one_device(run):
    """The Trainer over data=2 x model=2: the final projection's weight
    and bias are split (168 channels), the head runs on the gathered
    weight (21 joints do not divide 2); rank 0 writes the whole snapshot,
    which restores on one device as the row's blocks, concatenated, and
    the other parameters; the data column's ranks hold the same blocks;
    the run equals the one-process run over the union of the two data
    indices' draws (test_torch_mesh_train's tolerances)."""
    r = run["ranks"]
    assert r[0]["mesh_shape"] == {"data": 2, "model": 2}
    assert set(r[0]["split_params"]) == {"head.final_layer.weight",
                                         "head.final_layer.bias"}
    cfg = small_config()
    model = get_pose_net(cfg.model)
    assert load_checkpoint(str(run["out"] / "split"), model) == 0
    sd = model.state_dict()
    for k, v in sd.items():
        if k.startswith("head.final_layer."):
            assert r[0]["params"][k].shape[0] == v.shape[0] // 2
            assert torch.equal(torch.cat([r[0]["params"][k],
                                          r[1]["params"][k]]), v), k
            assert torch.equal(r[0]["params"][k], r[2]["params"][k]), k
        else:
            for q in r:
                assert torch.equal(q["params"][k], v), k

    t = Trainer(cfg=cfg, dataset=SyntheticFreiHand(n=16, image_hw=(32, 32),
                                                   seed=3),
                device="cpu", seed=0, model_dir=str(run["out"] / "union"))
    streams = [np.random.RandomState(1000003 * d) for d in (0, 1)]
    union = [np.concatenate([t.dataset.sample_indices(s, 4)
                             for s in streams]) for _ in range(2)]
    t.host_batches = lambda rng, num_steps: map(t.dataset.host_batch,
                                                union[:num_steps])
    m = t.run_epoch(0, num_steps=2, log_every=100)
    np.testing.assert_allclose(m["loss"], r[0]["metrics"]["loss"],
                               rtol=5e-4)
    for k, v in t.model.named_parameters():
        np.testing.assert_allclose(sd[k].double().numpy(),
                                   v.detach().double().numpy(),
                                   atol=2 * 2.5e-3, err_msg=k)
