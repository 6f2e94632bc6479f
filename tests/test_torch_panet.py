"""The port's PANet, its closest-rotation camera and its trainer against
the JAX package on the CPU, with the same weights carried across by
`interop.panet_state_dict_from_jax`.

Forward values and gradients compare at float64 (the JAX PANet built with
dtype float64 from float32-drawn weights, so both packages hold the same
numbers); the trainers at float32, their own type."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.models import panet as jpanet
from hand_integral_pose_estimation_tpu.training import (
    panet_trainer as jtrainer,
)
from hand_integral_pose_estimation_tpu_torch.interop import (
    panet_state_dict_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.models import panet
from hand_integral_pose_estimation_tpu_torch.training import panet_trainer

DICT_SIZES = (16, 8, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread, so that the suite's
    parallel workers do not oversubscribe the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]


def _camera_inputs(kind: str, rng) -> np.ndarray:
    """(64, 3, 3) float64 matrices, about half of them reflections:
    general; near-degenerate (s1 and s2 1e-4 apart); close to a rotation
    (all three within 2e-6); rank two (s3 = 0, where the closest rotation
    is still unique)."""
    U, V = _rotations(rng, 64), _rotations(rng, 64)
    if kind == "general":
        return rng.normal(size=(64, 3, 3))
    if kind == "near_degenerate":
        S = np.diag([1.0, 1.0 + 1e-4, 0.5])
    elif kind == "close_to_rotation":
        S = np.diag([1.0, 1.0 + 1e-6, 1.0 - 2e-6])
    else:
        assert kind == "rank_two"
        S = np.diag([2.0, 0.7, 0.0])
    flip = np.where(rng.random(64) < 0.5, -1.0, 1.0)[:, None, None]
    return U @ S @ V * flip


@jax.jit
def _jax_orthonormal_and_vjp(M, G):
    """The JAX make_orthonormal of M and the gradient of <G, R> (one
    compiled program for every input kind)."""
    return jpanet.make_orthonormal(M), jax.grad(
        lambda m: (jpanet.make_orthonormal(m) * G).sum())(M)


@pytest.mark.parametrize("kind", ["general", "near_degenerate",
                                  "close_to_rotation", "rank_two"])
def test_make_orthonormal_matches_jax(kind):
    """The capture-safe closest rotation (Jacobi sweeps, closed-form
    backward) against the JAX package's make_orthonormal at float64:
    values to 1e-12, det +1; the gradient of
    <G, R> to 1e-9 of its largest entry (the JAX gradient goes through the
    SVD's U and V gradients, which lose ~eps / (s1 - s2) where singular
    values meet)."""
    rng = np.random.default_rng(3)
    M = _camera_inputs(kind, rng)
    G = rng.normal(size=M.shape)
    want, want_grad = map(np.asarray, _jax_orthonormal_and_vjp(
        jnp.asarray(M), jnp.asarray(G)))
    if kind != "rank_two":      # the SVD's gradient is not defined there
        assert np.isfinite(want_grad).all()
    m = torch.from_numpy(M).requires_grad_()
    got = panet.make_orthonormal(m)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(got.detach().numpy()), 1.0,
                               atol=1e-12)
    if kind != "rank_two":
        (got * torch.from_numpy(G)).sum().backward()
        np.testing.assert_allclose(m.grad.numpy(), want_grad,
                                   atol=1e-9 * np.abs(want_grad).max())


@pytest.mark.parametrize("rank", [0, 1])
def test_make_orthonormal_gives_a_rotation_where_it_is_not_unique(rank):
    """Rank <= 1 (an all-zero code, or a code that relu left rank one): the
    closest rotation is not unique, and the result is still a rotation
    (the zero matrix gives I); the gradient is finite."""
    rng = np.random.default_rng(11)
    a, b = rng.normal(size=(2, 16, 3))
    M = (a[:, :, None] * b[:, None, :]) if rank else np.zeros((16, 3, 3))
    m = torch.from_numpy(M).requires_grad_()
    R = panet.make_orthonormal(m)
    r = R.detach().numpy()
    np.testing.assert_allclose(r @ np.swapaxes(r, -1, -2),
                               np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-12)
    if rank == 0:
        np.testing.assert_array_equal(r, np.broadcast_to(np.eye(3), r.shape))
    else:   # R maps the one direction M has as M does
        mv = M @ (b / np.linalg.norm(b, axis=-1, keepdims=True))[..., None]
        rv = r @ (b / np.linalg.norm(b, axis=-1, keepdims=True))[..., None]
        np.testing.assert_allclose(
            rv, mv / np.linalg.norm(mv, axis=-2, keepdims=True), atol=1e-12)
    R.sum().backward()
    assert torch.isfinite(m.grad).all()


def test_make_orthonormal_batches_any_leading_shape():
    rng = np.random.default_rng(4)
    M = torch.from_numpy(rng.normal(size=(2, 5, 3, 3)))
    got = panet.make_orthonormal(M)
    assert got.shape == (2, 5, 3, 3)
    torch.testing.assert_close(got.reshape(10, 3, 3),
                               panet.make_orthonormal(M.reshape(10, 3, 3)))
    # float32 in, float32 out (the rotation is formed in float64)
    assert panet.make_orthonormal(M.float()).dtype == torch.float32


def _jax_params(seed=0, dict_sizes=DICT_SIZES, encode_with_relu=True):
    model = jpanet.PANet(pts_num=21, dict_sizes=dict_sizes,
                         encode_with_relu=encode_with_relu)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, 21, 3)))[
        "params"]
    # non-zero biases, so every parameter's mapping is exercised; the
    # encoder's keep the codes dense (positive under the relu, negative
    # thresholds under the block shrinkage), so every camera has full rank
    # and its closest rotation is unique
    rng = np.random.default_rng(seed)
    sign = np.float32(1.0 if encode_with_relu else -1.0)

    def bias(k, v):
        b = rng.normal(0, 0.05, v.shape).astype(np.float32)
        return sign * (np.abs(b) + np.float32(0.05)) \
            if k.startswith("bias_enc") else b

    return {k: bias(k, v) if k.startswith("bias") else np.asarray(v)
            for k, v in params.items()}


def _port(params, encode_with_relu=True, dtype=torch.float64):
    model = panet.PANet(21, DICT_SIZES, encode_with_relu)
    model.load_state_dict(panet_state_dict_from_jax(params))
    return model.to(dtype)


def _jax_layout(grads: dict) -> dict:
    """Port parameter gradients in the JAX param layout, at full
    precision."""
    out = {}
    for i in range(len(DICT_SIZES)):
        d = grads[f"sparse_coding_layers.{i}.dictionary"]
        out[f"dict{i}"] = d if i == 0 else d[:, :, 0, 0]
        out[f"bias_enc{i}"] = grads[
            f"sparse_coding_layers.{i}.bias_encode_with_cam"]
        out[f"bias_dec{i}"] = grads[f"sparse_coding_layers.{i}.bias_decode"]
    out["camera_w"] = grads["camera_estimator.linear_comb_layer.weight"
                            ].reshape(-1)
    out["code_w"] = grads["code_estimator.fc_layer.weight"]
    return out


def _points(rng, n):
    pts = rng.normal(0, 0.05, (n, 21, 3))
    return pts - pts.mean(1, keepdims=True)


@pytest.mark.parametrize("encode_with_relu", [True, False])
def test_panet_forward_and_gradient_match_jax(encode_with_relu):
    """Float64: the four outputs to 1e-10 relative, panet_loss and its
    metrics to 1e-10, every parameter gradient and the input gradient to
    ||d|| <= 1e-8 ||g|| (plus 1e-12 of the largest leaf's norm: a leaf
    whose gradient is ~1e-16 compares at rounding level); the cameras
    orthonormal with det +1."""
    params = _jax_params(1, encode_with_relu=encode_with_relu)
    p64 = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    jmodel = jpanet.PANet(pts_num=21, dict_sizes=DICT_SIZES,
                          encode_with_relu=encode_with_relu,
                          dtype=jnp.float64)
    pts = _points(np.random.default_rng(5), 12)
    want = jmodel.apply({"params": p64}, jnp.asarray(pts))
    model = _port(params, encode_with_relu)
    x = torch.from_numpy(pts).requires_grad_()
    got = model(x)
    for name, g, w in zip(("recon", "canonical", "camera", "code"), got,
                          want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    cam = got[2].detach().numpy()
    np.testing.assert_allclose(cam @ np.swapaxes(cam, -1, -2),
                               np.broadcast_to(np.eye(3), cam.shape),
                               atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(cam), 1.0, atol=1e-12)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, q: jpanet.panet_loss(jmodel, p, q), argnums=(0, 1),
        has_aux=True))(p64, jnp.asarray(pts))
    loss, metrics = panet.panet_loss(model, x)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=1e-10, err_msg=k)
    model.zero_grad()
    x.grad = None
    loss.backward()
    got_grads = _jax_layout({n: p.grad.numpy()
                             for n, p in model.named_parameters()})
    floor = 1e-12 * max(np.linalg.norm(g) for g in jgrads[0].values())
    for k, g in jgrads[0].items():
        d = got_grads[k] - np.asarray(g)
        assert np.linalg.norm(d) <= 1e-8 * np.linalg.norm(g) + floor, k
    d = x.grad.numpy() - np.asarray(jgrads[1])
    assert np.linalg.norm(d) <= 1e-8 * np.linalg.norm(jgrads[1])

    per = panet.panet_loss_per_sample(model, x).detach().numpy()
    np.testing.assert_allclose(
        per, np.asarray(jpanet.panet_loss_per_sample(jmodel, p64,
                                                     jnp.asarray(pts))),
        rtol=1e-10)
    recon = panet.panet_reconstruction_fn(model)(x).detach().numpy()
    np.testing.assert_array_equal(recon, got[0].detach().numpy())


def test_state_dict_bridge_round_trip(tmp_path):
    """panet_state_dict_from_jax against the JAX convert_torch_state_dict
    both ways (bitwise), the names and shapes of the reference's
    checkpoint, and a .pth through load_panet (sized from the file)."""
    params = _jax_params(2)
    sd = panet_state_dict_from_jax(params)
    back = jpanet.convert_torch_state_dict(sd)
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]), params[k])
    model = panet.PANet(21, DICT_SIZES)
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in sd.items()]
    assert tuple(sd["sparse_coding_layers.1.dictionary"].shape) == (16, 8, 1,
                                                                      1)
    assert tuple(sd["camera_estimator.linear_comb_layer.weight"].shape) == (
        1, 4, 1, 1)
    path = str(tmp_path / "model_best.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    loaded = panet.load_panet(path)
    assert loaded.dict_sizes == DICT_SIZES and loaded.pts_num == 21
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="orbax"):
        panet.load_panet(str(tmp_path))


def test_block_soft_threshold_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(6, 12, 3, 3))
    x[0, 3] = 0.0                   # a zero block stays zero
    th = rng.random(12) * 2.0 - 0.5
    want = np.asarray(jpanet.block_soft_threshold(jnp.asarray(x),
                                                  jnp.asarray(th)))
    got = panet.block_soft_threshold(torch.from_numpy(x), torch.from_numpy(th))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    assert (got[0, 3] == 0).all()


def test_init_draws_the_jax_distributions():
    """He uniform dictionaries, fan-in uniform camera and code layers,
    zero biases: every weight within the JAX init's bound, the largest
    within 20 % of it."""
    model = panet.PANet(21, (64, 32, 16),
                        generator=torch.Generator().manual_seed(0))
    bounds = {"sparse_coding_layers.0.dictionary": np.sqrt(6 / 63),
              "sparse_coding_layers.1.dictionary": np.sqrt(6 / 64),
              "sparse_coding_layers.2.dictionary": np.sqrt(6 / 32),
              "camera_estimator.linear_comb_layer.weight": 1 / np.sqrt(16),
              "code_estimator.fc_layer.weight": 1 / np.sqrt(16 * 9)}
    for name, v in model.state_dict().items():
        if name in bounds:
            m = float(v.abs().max())
            assert 0.8 * bounds[name] <= m <= bounds[name], name
        else:
            assert (v == 0).all(), name


def test_train_panet_matches_jax_trajectory():
    """train_panet from equal float32 weights for 6 steps, evaluated after
    each (eval_every=1), with the staircase decay at every 2 steps. A
    one-cloud training set makes every minibatch the same in both packages
    whatever their random indices; the validation set has 16 clouds. Train
    and validation losses to 1e-4 relative at each step, the final and the
    best weights to 1e-4 of each leaf's largest entry."""
    rng = np.random.default_rng(7)
    params = _jax_params(3)
    train = _points(rng, 1).astype(np.float32)
    val = _points(rng, 16).astype(np.float32)
    kw = dict(num_steps=6, batch_size=8, lr=1e-2, lr_decay_every=2,
              lr_decay=0.5, eval_every=1)
    jmodel = jpanet.PANet(pts_num=21, dict_sizes=DICT_SIZES)
    want = jtrainer.train_panet(jmodel, train, val, init_params={
        k: jnp.asarray(v) for k, v in params.items()}, **kw)
    got = panet_trainer.train_panet(_port(params, dtype=torch.float32),
                                    train, val, **kw)
    np.testing.assert_allclose(got.train_losses,
                               np.asarray(want.train_losses), rtol=1e-4)
    np.testing.assert_allclose(got.val_losses, np.asarray(want.val_losses),
                               rtol=1e-4)
    np.testing.assert_allclose(got.best_val_loss, float(want.best_val_loss),
                               rtol=1e-4)
    assert got.train_losses[-1] < got.train_losses[0]
    for state, jp in ((got.model.state_dict(), want.params),
                      (got.best_state, want.best_params)):
        mine = _jax_layout({k: v.numpy() for k, v in state.items()})
        for k, v in jp.items():
            v = np.asarray(v)
            np.testing.assert_allclose(mine[k], v,
                                       atol=1e-4 * np.abs(v).max(),
                                       err_msg=k)


def test_train_panet_nan_guard_and_rotation_augmentation():
    """A poisoned (all-nan) training set: every step's loss is nan and the
    guard leaves the weights as they were, in both packages; the
    validation loss stays finite. With rotation augmentation on clean
    data the loss stays finite and the weights move."""
    params = _jax_params(4)
    rng = np.random.default_rng(8)
    val = _points(rng, 8).astype(np.float32)
    poison = np.full((4, 21, 3), np.nan, np.float32)
    kw = dict(num_steps=3, batch_size=4, eval_every=3)
    want = jtrainer.train_panet(jpanet.PANet(pts_num=21,
                                             dict_sizes=DICT_SIZES),
                                poison, val, init_params={
                                    k: jnp.asarray(v)
                                    for k, v in params.items()}, **kw)
    got = panet_trainer.train_panet(_port(params, dtype=torch.float32),
                                    poison, val, **kw)
    assert np.isnan(got.train_losses).all()
    assert np.isnan(np.asarray(want.train_losses)).all()
    np.testing.assert_allclose(got.val_losses, np.asarray(want.val_losses),
                               rtol=1e-5)
    sd = panet_state_dict_from_jax(params)
    for k, v in got.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    for k, v in want.params.items():
        np.testing.assert_array_equal(np.asarray(v), params[k])

    res = panet_trainer.train_panet(_port(params, dtype=torch.float32),
                                    _points(rng, 32).astype(np.float32), val,
                                    augment_rotation=True, **kw)
    assert np.isfinite(res.train_losses).all()
    moved = [not torch.equal(v, sd[k])
             for k, v in res.model.state_dict().items()]
    assert all(moved)


def test_augment_rotation_is_a_per_sample_rotation():
    pts = torch.from_numpy(_points(np.random.default_rng(9), 64))
    g = torch.Generator().manual_seed(0)
    out = panet_trainer._augment_rotation(g, pts)
    # rigid per sample: pairwise distances kept, samples rotated apart
    torch.testing.assert_close(torch.cdist(out, out), torch.cdist(pts, pts))
    R = torch.linalg.lstsq(pts, out).solution
    torch.testing.assert_close(R.mT @ R, torch.eye(3, dtype=R.dtype).expand(
        64, 3, 3), atol=1e-10, rtol=0)
    angles = torch.linalg.vector_norm(
        torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], -1), dim=-1)
    assert float(angles.std()) > 0.05


def test_composite_loss_and_boosting_match_jax():
    """composite_loss_per_sample with two components against the JAX
    function at float64 (1e-10); one boosting round lowers the mean
    composite loss."""
    pa, pb = _jax_params(5), _jax_params(6)
    rng = np.random.default_rng(10)
    pts = _points(rng, 20)
    jmodel = jpanet.PANet(pts_num=21, dict_sizes=DICT_SIZES,
                          dtype=jnp.float64)
    want = jtrainer.composite_loss_per_sample(
        jmodel, [{k: jnp.asarray(v, jnp.float64) for k, v in p.items()}
                 for p in (pa, pb)], jnp.asarray(pts))
    model = _port(pa)
    comps = [_port(p).state_dict() for p in (pa, pb)]
    got = panet_trainer.composite_loss_per_sample(model, comps,
                                                  torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)

    base = _port(pa, dtype=torch.float32)
    res = panet_trainer.train_composite_panet(
        base, base.state_dict(), pts.astype(np.float32), comp_num=2,
        hard_fraction=0.25, num_steps=20, batch_size=5, lr=1e-2,
        eval_every=5)
    assert len(res.components) == 2
    assert res.loss_after.mean() < res.loss_before.mean()
