"""The port's training slice against the JAX package on the CPU: rotation
math and sampling, the two-pass warp, the augmented train batch, both
decode backwards, the losses, one train step on both head arms, Adam with
the step schedule, the Trainer, and the train / test CLIs. Small sizes
(ResNet-18, 64x64 input, 16x16 x 8 heatmap, float32 compute, batch 4, as
tests/test_training.py sizes the JAX trainer); inputs come from numpy
seeds and reach both packages as the same arrays. Each comparison states
its tolerance and why."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hand_integral_pose_estimation_tpu.config as jconfig
from hand_integral_pose_estimation_tpu import losses as jlosses
from hand_integral_pose_estimation_tpu.data import pipeline as jpipeline
from hand_integral_pose_estimation_tpu.data.freihand import (
    SyntheticFreiHand as JaxSynthetic,
)
from hand_integral_pose_estimation_tpu.geometry import rotation as jrot
from hand_integral_pose_estimation_tpu.interop import convert_pose_snapshot
from hand_integral_pose_estimation_tpu.ops import fused_head as jfused
from hand_integral_pose_estimation_tpu.ops import integral as jint
from hand_integral_pose_estimation_tpu.ops import warp as jwarp
from hand_integral_pose_estimation_tpu.training import (
    TrainState,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
    multistep_schedule as jax_multistep_schedule,
)
import hand_integral_pose_estimation_tpu_torch.config as pconfig
from hand_integral_pose_estimation_tpu_torch import losses
from hand_integral_pose_estimation_tpu_torch.config import (
    AugmentConfig,
    Config,
    TrainConfig,
)
from hand_integral_pose_estimation_tpu_torch.data import (
    Batch,
    SyntheticFreiHand,
    make_train_batch,
    make_train_batch_with,
)
from hand_integral_pose_estimation_tpu_torch.geometry import rotation
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.ops import (
    fused_head,
    integral,
    warp,
)
from hand_integral_pose_estimation_tpu_torch.training import (
    Tester as PortTester,
    Trainer,
    compare_state_dicts,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    multistep_schedule,
)
from hand_integral_pose_estimation_tpu_torch.training.state import (
    multistep_factor,
    optimizer_steps,
)
from test_torch_pose_net import port_model, randomized_jax_variables

J_SMALL, D_SMALL = 3, 4


def small_config() -> Config:
    return Config(
        model=pconfig.ModelConfig(resnet_type=18, input_shape=(64, 64),
                                  output_shape=(16, 16), depth_dim=8,
                                  compute_dtype="float32"),
        train=TrainConfig(batch_size=4, lr=1e-3))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("name", ["Config", "ModelConfig", "AugmentConfig",
                                  "TrainConfig", "DetectorConfig",
                                  "PANetConfig", "MeshConfig"])
def test_config_copy_matches_jax(name):
    """The port's config is a copy of the JAX package's dataclasses: every
    field and default is equal, so the two packages cannot drift."""
    got, want = getattr(pconfig, name), getattr(jconfig, name)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())
    assert vars(pconfig.FreiHandJoints).keys() >= {"root_idx", "bones"}
    assert pconfig.FreiHandJoints.bones == jconfig.FreiHandJoints.bones
    if name == "DetectorConfig":
        for ctor in (lambda c: c.native(), lambda c: c().serving(32, "bf16")):
            assert dataclasses.asdict(ctor(got)) == \
                dataclasses.asdict(ctor(want))


# -------------------------------------------------------------- rotation


def test_rotation_math_matches_jax():
    """rodrigues (random, tiny and zero axis-angle vectors) and rotation_z
    at float64: the same closed forms, 1e-12."""
    rng = np.random.default_rng(0)
    rvec = np.concatenate([rng.normal(size=(6, 3)), 1e-10 * np.ones((1, 3)),
                           np.zeros((1, 3))])
    np.testing.assert_allclose(rotation.rodrigues(t(rvec)).numpy(),
                               np.asarray(jrot.rodrigues(jnp.asarray(rvec))),
                               atol=1e-12)
    theta = rng.uniform(-3, 3, 5)
    np.testing.assert_allclose(rotation.rotation_z(t(theta)).numpy(),
                               np.asarray(jrot.rotation_z(jnp.asarray(theta))),
                               atol=1e-12)


def test_rotation_and_colour_sampling_distributions():
    """The generator streams differ from jax.random's; the distributions
    are the reference's (augment.py:246-280). Over 4000 draws the identity
    share is 1 - rot_prob to 0.04 (five binomial standard deviations, 0.0077
    each) in both packages; every R is a rotation; the z angle of R = R1 R2
    lies in +-(z_range + arbitrary_range) and fills it; the colour scale
    lies in [1 - f, 1 + f] with mean 1 to 0.01."""
    n, acfg = 4000, AugmentConfig()
    g = torch.Generator().manual_seed(0)
    R = rotation.sample_rotation_matrix(g, n, acfg.rot_prob, acfg.z_rot_range,
                                        acfg.arbitrary_rot_range,
                                        dtype=torch.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    R_jax = np.asarray(jax.vmap(lambda k: jrot.sample_rotation_matrix(
        k, acfg.rot_prob, acfg.z_rot_range, acfg.arbitrary_rot_range))(keys))
    eye = torch.eye(3, dtype=torch.float64)
    identity = (R == eye).all(dim=(1, 2))
    for share in (float(identity.double().mean()),
                  float(np.all(R_jax == np.eye(3), axis=(1, 2)).mean())):
        assert abs(share - (1 - acfg.rot_prob)) < 0.04, share
    torch.testing.assert_close(R @ R.transpose(1, 2), eye.expand(n, 3, 3),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.linalg.det(R),
                               torch.ones(n, dtype=torch.float64),
                               rtol=0, atol=1e-12)
    rot = R[~identity]
    z = torch.atan2(rot[:, 1, 0], rot[:, 0, 0])
    bound = acfg.z_rot_range + acfg.arbitrary_rot_range
    assert float(z.abs().max()) <= bound
    assert float(z.min()) < -0.45 and float(z.max()) > 0.45
    # the off-z tilt comes from R2 alone: at most arbitrary_range
    assert float(torch.acos(rot[:, 2, 2].clamp(-1, 1)).max()) <= \
        acfg.arbitrary_rot_range + 1e-9

    c = rotation.sample_color_scale(g, n, acfg.color_factor)
    assert c.shape == (n, 3) and c.dtype == torch.float32
    assert float(c.min()) >= 1 - acfg.color_factor
    assert float(c.max()) <= 1 + acfg.color_factor
    assert abs(float(c.mean()) - 1.0) < 0.01
    assert float(c.min()) < 0.81 and float(c.max()) > 1.19


# ------------------------------------------------------------------ warp


def _maps(rotate: bool) -> np.ndarray:
    if not rotate:
        H = np.diag([1.2, 0.9, 1.0])
        H[:2, 2] = [2.5, -1.5]
        return np.stack([H, np.diag([0.8, 1.1, 1.0])])
    out = []
    for a, p in ((0.3, 2e-4), (-0.5, -1e-4)):
        H = np.array([[np.cos(a), -np.sin(a), 3.0],
                      [np.sin(a), np.cos(a), -2.0],
                      [p, 2 * p, 1.0]])
        out.append(H)
    return np.stack(out)


@pytest.mark.parametrize("rotate", [False, True])
def test_warp_twopass_matches_jax(rotate):
    """Float64, against the JAX two-pass warp at HIGHEST precision: the
    same filter (2-tap gathers here, dense relu weights there, equal
    numbers), 1e-9. "auto" takes it for a CPU tensor."""
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 255, (2, 30, 34, 3))
    H = _maps(rotate)
    want = np.stack([np.asarray(jwarp.warp_perspective_twopass(
        jnp.asarray(im), jnp.asarray(h), (20, 24),
        precision=jax.lax.Precision.HIGHEST)) for im, h in zip(images, H)])
    got = warp.warp_perspective_twopass(t(images), t(H), (20, 24))
    assert got.dtype == torch.float64 and got.shape == (2, 20, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)
    torch.testing.assert_close(
        warp.warp_perspective_batch(t(images), t(H), (20, 24)), got,
        rtol=0, atol=0)
    # the inverse map given directly gives the same image
    Hi = np.linalg.inv(H)
    np.testing.assert_allclose(
        warp.warp_perspective_twopass(t(images), t(Hi), (20, 24),
                                      inverse=True).numpy(), want, atol=1e-9)


def test_warp_twopass_matches_the_pallas_kernel():
    """Float32, against the TPU kernel in interpret mode as
    tests/test_warp_pipeline.py holds it: 1e-3 on the 0..255 scale (the
    kernel forms its weights in float32). Both take the same float32
    dst -> src maps (inverse=True): a float32 LU in either framework would
    move the source positions by a few ulps, ~5e-3 on this scale."""
    rng = np.random.RandomState(20260816)
    imgs = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    Hs = []
    for _ in range(2):
        H = np.eye(3)
        H[:2, :2] *= 0.8 + 0.1 * rng.rand()
        H[0, 1] = 0.2 * rng.randn()
        H[:2, 2] = rng.randn(2) * 4
        H[2, :2] = rng.randn(2) * 1e-4
        Hs.append(np.linalg.inv(H))
    Hs = np.stack(Hs).astype(np.float32)
    want = jwarp.warp_perspective_pallas(jnp.asarray(imgs), jnp.asarray(Hs),
                                         (64, 64), inverse=True,
                                         interpret=True)
    got = warp.warp_perspective_batch(t(imgs), t(Hs), (64, 64), inverse=True,
                                      method="twopass")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_perspective_batch(t(imgs), t(Hs), (64, 64), method="kernel")


# ----------------------------------------------------------- train batch


def _train_inputs(n=4, hw=(96, 96), seed=2):
    ds = JaxSynthetic(n=n, image_hw=hw, seed=seed, render_joints=True)
    rng = np.random.default_rng(seed)
    jc = ds.joint_cam.astype(np.float64)
    K = ds.K.astype(np.float64)
    uvw = np.einsum("bij,bnj->bni", K, jc)
    uv = uvw[..., :2] / uvw[..., 2:3]
    box = np.concatenate([uv.mean(1), np.full((n, 2), 70.0)], axis=1)
    teacher = jc * 0.9 + rng.normal(0, 0.002, jc.shape)
    rv = np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.3, (n - 1, 3))])
    R = np.asarray(jrot.rodrigues(jnp.asarray(rv)))
    color = rng.uniform(0.8, 1.2, (n, 3))
    labelled = np.array([True, False, True, False][:n])
    return dict(images=ds.images.astype(np.float32), joint_cam=jc, K=K,
                bbox=box, teacher=teacher, R=R, color=color,
                labelled=labelled, ref_bone_len=ds.ref_bone_len)


@pytest.mark.parametrize("with_boxes", [True, False])
def test_make_train_batch_matches_jax(with_boxes):
    """The explicit-R train batch against the JAX package's `_labels_one` +
    two-pass warp (HIGHEST) + `_normalise` with the same R and colour: a
    detector box and teacher joints, or neither. Geometry at float64 to
    1e-9; the float32 patch to 1e-3 on the 0..255 scale (float32 taps)."""
    x = _train_inputs()
    acfg, hw = AugmentConfig(), (64, 64)
    bb = x["bbox"] if with_boxes else None
    teacher = x["teacher"] if with_boxes else None

    def per_sample(jc, Ki, bd, tj, R):
        return jpipeline._labels_one(jc, Ki, bd, tj, R, acfg, hw)

    in_axes = (0, 0, 0 if with_boxes else None, 0 if with_boxes else None, 0)
    out, label_teacher, jbb, H_total = jax.vmap(per_sample,
                                                in_axes=in_axes)(
        x["joint_cam"], x["K"], bb, teacher, x["R"])
    patch = jwarp.warp_perspective_batch(
        jnp.asarray(x["images"]), H_total, hw, method="twopass",
        precision=jax.lax.Precision.HIGHEST)
    patch = jpipeline._normalise(patch, jnp.asarray(x["color"])[:, None, None,
                                                                 :], acfg)

    got = make_train_batch_with(
        t(x["R"]), t(x["color"]), t(x["images"]), t(x["joint_cam"]),
        t(x["K"]), None if bb is None else t(bb), t(x["labelled"]),
        None if teacher is None else t(teacher), t(x["ref_bone_len"]),
        acfg, hw)
    assert got.image.dtype == torch.float32 and got.image.shape == (4, 64, 64,
                                                                    3)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(patch),
                               atol=1e-3)
    for name, want in (("label", out.label), ("label_teacher", label_teacher),
                       ("joint_cam_normalized", out.joint_cam_normalized),
                       ("tprime", out.tprime), ("trans", out.trans),
                       ("trans_inv", out.trans_inv), ("bbox", jbb)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(want), atol=1e-9,
                                   err_msg=name)
    if not with_boxes:
        assert not got.label_teacher.any()
    np.testing.assert_array_equal(got.R.numpy(), x["R"])
    np.testing.assert_array_equal(got.labelled.numpy(), x["labelled"])
    assert (got.label_weight == 1).all()


def test_make_train_batch_draws_from_the_generator():
    """The sampling entry point: reproducible from the generator's seed,
    different for another seed, R in K's dtype."""
    x = _train_inputs()
    args = (t(x["images"]), t(x["joint_cam"]).float(), t(x["K"]).float(),
            None, t(x["labelled"]), None, t(x["ref_bone_len"]),
            AugmentConfig(rot_prob=1.0), (32, 32))
    a = make_train_batch(torch.Generator().manual_seed(3), *args)
    b = make_train_batch(torch.Generator().manual_seed(3), *args)
    c = make_train_batch(torch.Generator().manual_seed(4), *args)
    assert torch.equal(a.image, b.image) and torch.equal(a.R, b.R)
    assert not torch.equal(a.R, c.R)
    assert a.R.dtype == torch.float32 and bool(torch.isfinite(a.image).all())


# ------------------------------------------------------------- backwards


DECODE_SHAPES = [(2, 8, 8, 3, 4), (1, 8, 8, 21, 56)]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_softmax_integral_backward_matches_jax(shape, impl):
    """The closed-form backward against jax.grad through the JAX
    soft-argmax (its XLA branch, or the Pallas kernels in interpret mode),
    float32: 1e-5 of the largest entry plus 1e-4 relative (the Pallas
    branch folds the constants, the port does not)."""
    B, H, W, J, D = shape
    rng = np.random.default_rng(3)
    hm = (rng.normal(size=(B, H, W, J * D)) * 2).astype(np.float32)
    cot = rng.normal(size=(B, J, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda h: jint.softmax_integral(
        h, J, D, impl=impl, interpret=True), jnp.asarray(hm))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    h = t(hm).requires_grad_()
    got, = torch.autograd.grad(integral.softmax_integral(h, J, D), h, t(cot))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_softmax_integral_backward_bf16_and_gradcheck():
    """A bf16 heatmap gets a bf16 gradient (the unfused arm's case),
    within one bf16 ulp of the JAX package's; and the Function passes
    torch.autograd.gradcheck at float64."""
    J, D = J_SMALL, D_SMALL
    rng = np.random.default_rng(4)
    hm32 = (rng.normal(size=(2, 6, 5, J * D)) * 2).astype(np.float32)
    cot = rng.normal(size=(2, J, 3)).astype(np.float32)
    hm = t(hm32).to(torch.bfloat16).requires_grad_()
    got, = torch.autograd.grad(integral.softmax_integral(hm, J, D), hm,
                               t(cot))
    assert got.dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda h: jint.softmax_integral(h, J, D, impl="xla"),
                     jnp.asarray(hm.detach().float().numpy()).astype(
                         jnp.bfloat16))
    want = np.asarray(vjp(jnp.asarray(cot))[0].astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-6)
    h64 = t(rng.normal(size=(2, 5, 4, J * D))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: integral.softmax_integral(x, J, D), (h64,))
    flat = integral.softmax_integral_flat(h64, J, D)
    assert flat.shape == (2, J * 3)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_fused_head_backward_matches_jax(shape, impl):
    """dfeat, dW and db of the fused head against jax.grad of the JAX
    head_projection_integral (non-Pallas branch, or the Pallas kernels in
    interpret mode), float32. JAX's kernel is (F, J*D), the port's weight
    (J*D, F): dW is compared transposed. 1e-5 of the largest entry plus
    1e-4 relative: sums over J*D channels or B*H*W rows in another
    order."""
    B, H, W, J, D = shape
    F = 16
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(B, H, W, F)).astype(np.float32)
    Wk = (0.3 * rng.normal(size=(F, J * D))).astype(np.float32)
    bias = rng.normal(size=(J * D,)).astype(np.float32)
    cot = rng.normal(size=(B, J, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda f, w, b: jfused.head_projection_integral(
        f, w, b, J, D, impl, True), jnp.asarray(feats), jnp.asarray(Wk),
        jnp.asarray(bias))
    want = [np.asarray(v) for v in vjp(jnp.asarray(cot))]
    args = [t(feats).requires_grad_(), t(Wk.T.copy()).requires_grad_(),
            t(bias).requires_grad_()]
    got = torch.autograd.grad(fused_head.head_projection_integral(
        *args, J, D), args, t(cot))
    for g, w, name in zip(got, (want[0], want[1].T, want[2]),
                          ("dfeat", "dW", "db")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_fused_head_backward_dtypes_and_gradcheck():
    """bf16 features with float32 params (the train step's call, outside
    autocast) give a bf16 dfeat and float32 dW, db; the Function passes
    gradcheck at float64."""
    J, D, F = J_SMALL, D_SMALL, 8
    g = torch.Generator().manual_seed(6)
    feats = torch.randn(2, 4, 5, F, generator=g).to(
        torch.bfloat16).requires_grad_()
    w = (0.3 * torch.randn(J * D, F, generator=g)).requires_grad_()
    b = torch.randn(J * D, generator=g).requires_grad_()
    dfeat, dW, db = torch.autograd.grad(
        fused_head.head_projection_integral(feats, w, b, J, D).sum(),
        (feats, w, b))
    assert (dfeat.dtype, dW.dtype, db.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    args = (torch.randn(2, 4, 3, F, dtype=torch.float64,
                        generator=g).requires_grad_(),
            (0.3 * torch.randn(J * D, F, dtype=torch.float64,
                               generator=g)).requires_grad_(),
            torch.randn(J * D, dtype=torch.float64,
                        generator=g).requires_grad_())
    assert torch.autograd.gradcheck(
        lambda *a: fused_head.head_projection_integral(*a, J, D), args)


# ----------------------------------------------------------------- losses


def _loss_inputs(seed=7):
    rng = np.random.default_rng(seed)
    x = _train_inputs()
    B, J = x["joint_cam"].shape[:2]
    acfg = AugmentConfig()
    batch = make_train_batch_with(
        t(x["R"]), t(x["color"]), t(x["images"]), t(x["joint_cam"]),
        t(x["K"]), t(x["bbox"]), t(x["labelled"]), t(x["teacher"]),
        t(x["ref_bone_len"]), acfg, (64, 64))
    coords = batch.label.numpy() + rng.normal(0, 0.02, (B, J, 3))
    teacher = batch.label_teacher.numpy()
    vis = rng.uniform(0.5, 1.0, (B, J, 3))
    return batch, coords, teacher, vis


@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_combined_loss_matches_jax(lam):
    """Float64 on the same inputs, with and without a PANet term (a linear
    stand-in for the NRSfM forward): the five outputs and the gradient in
    the coords to 1e-12."""
    batch, coords, teacher, vis = _loss_inputs()
    panet = (lambda p: 0.5 * p + 0.01) if lam else None
    geo = (batch.labelled, batch.trans_inv, batch.tprime, batch.K)

    def jax_loss(c):
        return jlosses.combined_loss(
            c, jnp.asarray(teacher), jnp.asarray(batch.label.numpy()),
            jnp.asarray(vis), *(jnp.asarray(v.numpy()) for v in geo),
            panet_apply=panet, lam=lam, patch_width=64, patch_height=64)

    want = jax_loss(jnp.asarray(coords))
    want_grad = np.asarray(jax.grad(lambda c: jax_loss(c).loss)(
        jnp.asarray(coords)))
    c = t(coords).requires_grad_()
    got = losses.combined_loss(c, t(teacher), batch.label, t(vis), *geo,
                               panet_apply=panet, lam=lam, patch_width=64,
                               patch_height=64)
    for name in got._fields:
        np.testing.assert_allclose(float(getattr(got, name).detach()),
                                   float(getattr(want, name)), rtol=1e-12,
                                   err_msg=name)
    assert not got.student_mpjpe.requires_grad
    grad, = torch.autograd.grad(got.loss, c)
    np.testing.assert_allclose(grad.numpy(), want_grad, atol=1e-12)
    np.testing.assert_allclose(
        float(losses.compute_mpjpe(t(coords), batch.label)),
        float(jlosses.compute_mpjpe(jnp.asarray(coords),
                                    jnp.asarray(batch.label.numpy()))),
        rtol=1e-12)


def test_camera_space_diagnostic_and_heatmap_loss_match_jax():
    """Float64: the camera-space error and the label round-trip
    consistency to 1e-12 relative (the consistency itself is ~1e-13);
    heatmap_joint_loss through the soft-argmax to 1e-9."""
    batch, coords, _, _ = _loss_inputs(8)
    args = (batch.joint_cam_normalized, batch.trans_inv, batch.tprime,
            batch.K, batch.R)
    want = jlosses.camera_space_diagnostic(
        jnp.asarray(coords), jnp.asarray(batch.label.numpy()),
        *(jnp.asarray(a.numpy()) for a in args), 64, 64)
    got = losses.camera_space_diagnostic(t(coords), batch.label, *args, 64,
                                         64)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-12)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-12)
    assert float(got[1]) < 1e-9

    rng = np.random.default_rng(9)
    hm = rng.normal(size=(4, 6, 6, 21 * 4))
    np.testing.assert_allclose(
        float(losses.heatmap_joint_loss(t(hm), batch.label, t(np.ones(
            (4, 21, 3))), 21, 4)),
        float(jlosses.heatmap_joint_loss(jnp.asarray(hm), jnp.asarray(
            batch.label.numpy()), jnp.ones((4, 21, 3)), 21, 4, impl="xla")),
        rtol=1e-9)


# ------------------------------------------------------------- train step


def _grads_tx():
    """An optax transformation whose state keeps the step's gradients and
    whose update is zero: the JAX train step then hands back its own
    gradients in `opt_state`."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _bn_counts(model):
    """Hooks recording n = B*H*W of every BatchNorm2d's input."""
    counts, handles = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            def hook(mod, inp, out, name=name):
                counts[name] = inp[0].numel() // inp[0].shape[1]
            handles.append(m.register_forward_hook(hook))
    return counts, handles


@pytest.mark.parametrize("fuse_head", [True, False])
def test_train_step_matches_jax(fuse_head):
    """One train step of both packages from the same weights on the same
    augmented batch (two labelled, two unlabelled rows), at float64: at
    float32 the two frameworks' convolutions differ by ~1e-6, enough to
    flip ReLU masks at near-zero activations and move some gradient leaves
    by 1e-3, which would hide a real fault. The loss and metrics to 1e-5
    relative; every gradient leaf to ||d|| <= 1e-4 ||g||; BatchNorm running
    means to 1e-5. (a) Running variances: flax updates them with the biased
    batch variance, torch with the unbiased one, so the JAX update is
    rescaled by n/(n-1) before the comparison (1e-5)."""
    cfg = small_config()
    jcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float64"))
    net, variables = randomized_jax_variables(jcfg.model, seed=11,
                                              final_scale=1e-4)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       variables)
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
        net, tx, jcfg, integral_impl="xla", fuse_head=fuse_head)(state,
                                                                 jbatch)

    model = port_model(cfg.model, variables).double()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = make_optimizer(model.parameters(), cfg.train)
    scheduler = multistep_schedule(optimizer, 1, cfg.train.lr_dec_epoch,
                                   cfg.train.lr_dec_factor)
    counts, handles = _bn_counts(model)
    metrics = make_train_step(model, optimizer, scheduler, cfg,
                              fuse_head=fuse_head)(batch)
    for h in handles:
        h.remove()

    for name, value in metrics.items():
        assert value.dtype == torch.float64
        np.testing.assert_allclose(float(value), float(jmetrics[name]),
                                   rtol=1e-5, err_msg=name)
    assert optimizer_steps(optimizer) == 1

    grads_sd = dict(before)
    grads_sd.update({n: p.grad for n, p in model.named_parameters()})
    got = convert_pose_snapshot(grads_sd, resnet_type=18)["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(new_state.opt_state):
        g = np.asarray(want)
        d = np.asarray(got_leaf(got, path)) - g
        assert np.linalg.norm(d) <= 1e-4 * np.linalg.norm(g), \
            jax.tree_util.keystr(path)

    after = model.state_dict()
    jstats = convert_pose_snapshot(after, resnet_type=18)["batch_stats"]
    for path, want in jax.tree_util.tree_leaves_with_path(
            new_state.batch_stats):
        got_v = np.asarray(got_leaf(jstats, path))
        want = np.asarray(want)
        if path[-1].key == "var":
            old = np.asarray(got_leaf(convert_pose_snapshot(
                before, resnet_type=18)["batch_stats"], path))
            n = counts[bn_module_name(path)]
            want = 0.9 * old + (want - 0.9 * old) * n / (n - 1)
        np.testing.assert_allclose(got_v, want, rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def got_leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def bn_module_name(path) -> str:
    """JAX batch_stats path -> the port's BatchNorm2d module name (the
    layout rule of interop/jax_params.py)."""
    keys = [k.key for k in path][:-1]          # drop mean / var
    part, rest = keys[0], keys[1:]
    norm = int(rest[-2].split("_")[-1])        # _Norm_k
    if part == "head":
        return f"head.deconv_layers.{3 * norm + 1}"
    if len(rest) == 2:                          # the stem's _Norm_0
        return "backbone.bn1"
    stage, block = rest[0][len("layer"):].split("_")
    prefix = f"backbone.layer{stage}.{block}"
    n_main = 2                                  # ResNet-18 basic blocks
    return (f"{prefix}.downsample.1" if norm == n_main
            else f"{prefix}.bn{norm + 1}")


# ------------------------------------------------------------ optimiser


def test_adam_and_schedule_match_jax():
    """Adam with L2 decay and the step schedule against the JAX package's
    optax chain over three identical gradients with the decay boundary at
    step 1 (steps b-1, b, b+1): parameters to 1e-6, the learning rate of
    every step to 1e-6 relative. (e) The gradients are kept away from 0,
    where Adam's first step, about lr * sign(g), would amplify rounding."""
    tcfg = TrainConfig(lr=1e-2, lr_dec_epoch=(1,), lr_dec_factor=0.1,
                       weight_decay=1e-2)
    rng = np.random.default_rng(10)
    p0 = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(5,))}
    grads = [{k: np.sign(v) * (0.5 + np.abs(v)) for k, v in
              ((k, rng.normal(size=v.shape)) for k, v in p0.items())}
             for _ in range(3)]
    tx = jax_make_optimizer(dataclasses.replace(tcfg), 1)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    sched = jax_multistep_schedule(tcfg.lr, 1, tcfg.lr_dec_epoch,
                                   tcfg.lr_dec_factor)

    params = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt = make_optimizer(params.values(), tcfg)
    sch = multistep_schedule(opt, 1, tcfg.lr_dec_epoch, tcfg.lr_dec_factor)
    for step, g in enumerate(grads):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(sched(step)), rtol=1e-6)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = t(g[k])
        opt.step()
        sch.step()
        for k in p0:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=f"{k} after step {step}")
    for step in (0, 1, 2, 299, 300, 301):
        np.testing.assert_allclose(
            tcfg.lr * multistep_factor(100, (3,), 0.1)(step),
            float(jax_multistep_schedule(tcfg.lr, 100, (3,), 0.1)(step)),
            rtol=1e-6)
    # resuming the schedule at step 2 gives the rate it had reached
    resumed = torch.optim.Adam(params.values(), lr=tcfg.lr)
    resumed.load_state_dict(opt.state_dict())
    multistep_schedule(resumed, 1, tcfg.lr_dec_epoch, tcfg.lr_dec_factor)
    assert optimizer_steps(resumed) == 3
    assert resumed.param_groups[0]["lr"] == opt.param_groups[0]["lr"]


# ---------------------------------------------------------------- Trainer


def _dataset(n=8, seed=1):
    return SyntheticFreiHand(n=n, image_hw=(64, 64), seed=seed)


def test_trainer_loss_decreases():
    """Mirror of tests/test_training.py's JAX trainer test: eight
    synthetic samples at batch 4 and lr 1e-3, the last of six two-step
    epochs ends below the first."""
    trainer = Trainer(small_config(), _dataset(), model_dir="unused",
                      seed=0, device="cpu")
    m0 = trainer.run_epoch(0, num_steps=2, log_every=100)
    for e in range(1, 6):
        m = trainer.run_epoch(e, num_steps=2, log_every=100)
    assert set(m) == {"loss", "loss_supervised", "loss_unsupervised",
                      "student_mpjpe", "teacher_mpjpe"}
    assert np.isfinite(m["loss"]) and m["loss"] < m0["loss"]


def test_trainer_checkpoint_round_trip(tmp_path):
    """fit writes snapshot_0.pth.tar ({epoch, network, optimizer}); a
    --continue Trainer restores epoch, step, parameters, optimizer moments
    and learning rate, and its next epoch is bit-identical to the
    uninterrupted run's (the unfused arm, with the epoch-end test sweep,
    which leaves the training state alone). The schedule's boundary is at
    step 2, where the resumed Trainer starts."""
    cfg = small_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr_dec_epoch=(1,)))
    kw = dict(cfg=cfg, dataset=_dataset(), model_dir=str(tmp_path), seed=0,
              device="cpu", fuse_head=False, test_dataset=_dataset(3, 2))
    first = Trainer(**kw)
    first.fit(end_epoch=1, steps_per_epoch=2)
    assert sorted(os.listdir(tmp_path)) == ["snapshot_0.pth.tar"]
    ckpt = torch.load(tmp_path / "snapshot_0.pth.tar", weights_only=True)
    assert set(ckpt) == {"epoch", "network", "optimizer"}

    resumed = Trainer(continue_train=True, **kw)
    assert resumed.start_epoch == 1
    assert optimizer_steps(resumed.optimizer) == 2
    assert torch.equal(resumed.optimizer.param_groups[0]["lr"],
                       first.optimizer.param_groups[0]["lr"])
    assert resumed.lr_at(2) == cfg.train.lr * cfg.train.lr_dec_factor
    # the rate is float32 on the optimizer, lr_at's a Python float
    assert float(resumed.optimizer.param_groups[0]["lr"]) == pytest.approx(
        resumed.lr_at(2), rel=1e-6)
    assert compare_state_dicts(resumed.model.state_dict(),
                               first.model.state_dict()) == 0.0
    for p, q in zip(resumed.model.parameters(), first.model.parameters()):
        a, b = resumed.optimizer.state[p], first.optimizer.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    first.run_epoch(1, num_steps=1)
    resumed.fit(end_epoch=2, steps_per_epoch=1)
    assert compare_state_dicts(resumed.model.state_dict(),
                               first.model.state_dict()) == 0.0
    assert sorted(os.listdir(tmp_path)) == ["snapshot_0.pth.tar",
                                            "snapshot_1.pth.tar"]
    fresh = get_pose_net(cfg.model)
    assert load_checkpoint(str(tmp_path), fresh) == 1
    assert compare_state_dicts(fresh.state_dict(),
                               first.model.state_dict()) == 0.0


def test_cli_train_then_test(tmp_path, capsys):
    """cli.train --synthetic writes snapshot_0; cli.test --model-dir loads
    it and scores it as the in-process Tester scores the same weights."""
    from hand_integral_pose_estimation_tpu_torch.cli import test as cli_test
    from hand_integral_pose_estimation_tpu_torch.cli import train as cli_train

    model_dir = str(tmp_path / "model")
    sizing = ["--pose-resnet", "18", "--pose-input", "64"]
    trainer = cli_train.main(["--synthetic", "--synthetic-size", "8",
                              "--epochs", "1", "--steps-per-epoch", "2",
                              "--batch-size", "4", "--device", "cpu",
                              "--model-dir", model_dir, "--log-dir",
                              str(tmp_path / "log"), *sizing])
    assert os.listdir(model_dir) == ["snapshot_0.pth.tar"]
    summary = cli_test.main(["--synthetic", "--synthetic-size", "3",
                             "--batch-size", "2", "--model-dir", model_dir,
                             "--device", "cpu", "--result-dir",
                             str(tmp_path / "result"), *sizing])
    coords, batch = PortTester(trainer.cfg, SyntheticFreiHand(n=3),
                           trainer.model, device="cpu").run(batch_size=2)
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_test_split,
    )
    want = evaluate_test_split(coords, batch)
    assert np.isfinite(summary["pa_mpjpe"])
    assert summary["pa_mpjpe"] == want["pa_mpjpe"]
    assert summary["mpjpe"] == want["mpjpe"]
    # as the JAX CLI: no snapshot in --model-dir evaluates a fresh model
    # and says so
    fresh = cli_test.main(["--synthetic", "--synthetic-size", "2",
                           "--batch-size", "2", "--model-dir",
                           str(tmp_path / "none"), "--device", "cpu",
                           "--result-dir", str(tmp_path / "fresh"), *sizing])
    assert "no snapshot found" in capsys.readouterr().out
    assert np.isfinite(fresh["mpjpe"])
    with pytest.raises(SystemExit):
        cli_train.main(["--device", "cpu"])


def test_cli_test_takes_the_jax_command_line():
    """One command line through both packages' cli.test parsers: the same
    model dir (output/model_dump by default), epoch (`--test-epoch`, the
    JAX name, is an alias of the port's `--epoch`), batch, sizes and
    snapshot."""
    from hand_integral_pose_estimation_tpu.cli import test as jax_cli
    from hand_integral_pose_estimation_tpu_torch.cli import test as cli_test

    for argv in ([], ["--synthetic", "--model-dir", "m", "--test-epoch", "3",
                      "--batch-size", "4", "--synthetic-size", "8",
                      "--result-dir", "r", "--torch-snapshot", "s.pth"]):
        a = cli_test.build_argparser().parse_args(argv)
        b = jax_cli.build_argparser().parse_args(argv)
        fields = ("model_dir", "batch_size", "synthetic_size", "result_dir",
                  "torch_snapshot", "synthetic", "data_dir")
        assert [getattr(a, f) for f in fields] == [getattr(b, f)
                                                   for f in fields], argv
        assert a.epoch == b.test_epoch
    assert cli_test.build_argparser().parse_args(["--epoch", "2"]).epoch == 2


def test_train_step_returns_scalars_and_keeps_its_gradients():
    """The step returns five device scalars and leaves the step's
    gradients in .grad; a Batch missing a teacher trains against zeros on
    unlabelled rows (teacher_mpjpe is the labels' own norm)."""
    cfg = small_config()
    model = get_pose_net(cfg.model, torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), cfg.train)
    step = make_train_step(model, opt, multistep_schedule(opt, 1, (30,), 0.1),
                           cfg)
    x = _train_inputs()
    batch = make_train_batch_with(
        t(x["R"]).float(), t(x["color"]).float(), t(x["images"]),
        t(x["joint_cam"]).float(), t(x["K"]).float(), None,
        t(x["labelled"]), None, t(x["ref_bone_len"]).float(), cfg.augment,
        cfg.model.input_shape)
    assert isinstance(batch, Batch)
    metrics = step(batch)
    assert all(v.dim() == 0 and not v.requires_grad for v in metrics.values())
    assert model.training
    assert all(p.grad is not None for p in model.parameters())
    np.testing.assert_allclose(
        float(metrics["teacher_mpjpe"]),
        float(torch.linalg.vector_norm(batch.label, dim=-1).mean()),
        rtol=1e-6)
