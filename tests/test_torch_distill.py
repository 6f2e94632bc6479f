"""The port's rotation-variance teacher filter and its cascade against the
JAX package on the CPU.

The JAX sweep off the TPU warps with the single-pass bilinear filter
(`warp_perspective_batch(method="auto")` picks "gather" there); the port's
sweep takes the two-pass filter of the TPU kernel on every device. So the
JAX side runs here with its `warp_perspective_batch` patched to
method="twopass" wherever the sweep leaves the method to "auto" (its
axis-aligned base crop keeps "affine"); nothing in the JAX package
changes. The teachers are deterministic functions of the patch content,
written once for each package, or a small pose net with the same weights
in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.config import AugmentConfig as JAug
from hand_integral_pose_estimation_tpu.distill import cascade as jcascade
from hand_integral_pose_estimation_tpu.distill import teacher_labels as jtl
from hand_integral_pose_estimation_tpu.ops.fused_head import (
    head_projection_integral as jax_head_projection_integral,
)
from hand_integral_pose_estimation_tpu_torch.config import AugmentConfig
from hand_integral_pose_estimation_tpu_torch.distill import (
    CascadeRunner,
    filter_precision_curve,
    generate_filtered_labels,
    pass1_rotation_indices,
    rotation_sweep_camera,
    sweep_patches,
    teacher_error_vs_variance,
)
from hand_integral_pose_estimation_tpu_torch.training.teacher import (
    frozen_teacher,
)
from test_torch_panet import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_pose_net import port_model, randomized_jax_variables
from test_torch_train import small_config
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

PATCH = (32, 32)
#: between the ~1e-2 back-projection variance of constant rows and the
#: ~1e0 content variance of ramp rows (the groups sit decades apart)
THRESHOLD = 0.05
#: rows whose variance lies within this relative distance of the
#: threshold may flip between packages; the fixture has none
MARGIN = 1e-3



@pytest.fixture
def twopass_jax(monkeypatch):
    orig = jtl.warp_perspective_batch

    def patched(images, H, out_hw, inverse=False, method="auto"):
        return orig(images, H, out_hw, inverse,
                    method="twopass" if method == "auto" else method)

    monkeypatch.setattr(jtl, "warp_perspective_batch", patched)


def _teacher_jax(patches):
    corner = patches[:, :8, :8, 0].mean(axis=(1, 2)) / 255.0
    full = patches[..., 0].mean(axis=(1, 2)) / 255.0
    diff = 20.0 * (corner - full)
    base = jnp.stack([diff, -diff, corner], axis=-1)
    return base[:, None, :] * jnp.linspace(0.2, 1.0, 21)[None, :, None] + 0.25


def _teacher_torch(patches):
    corner = patches[:, :8, :8, 0].mean(dim=(1, 2)) / 255.0
    full = patches[..., 0].mean(dim=(1, 2)) / 255.0
    diff = 20.0 * (corner - full)
    base = torch.stack([diff, -diff, corner], dim=-1)
    return (base[:, None, :] * torch.linspace(
        0.2, 1.0, 21, dtype=patches.dtype)[None, :, None] + 0.25)


def _mixed(B=6, hw=96, seed=0):
    """Even rows constant images (kept), odd rows ramps that rotate hard
    (rejected); boxes near the centre; float64 geometry."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw, 0:hw].astype(np.float32) * (255.0 / hw)
    ramp = np.stack([x, y, (x + y) / 2], axis=-1)
    imgs = np.stack([np.full((hw, hw, 3), 40.0 + 20.0 * b, np.float32)
                     if b % 2 == 0 else ramp for b in range(B)])
    K = np.broadcast_to(np.asarray([[200.0, 0, hw / 2], [0, 200.0, hw / 2],
                                    [0, 0, 1]]), (B, 3, 3)).copy()
    bbox = np.concatenate([hw / 2 + rng.uniform(-4, 4, (B, 2)),
                           rng.uniform(28, 36, (B, 2))], axis=1)
    joints = np.array([0, 0, 0.45]) + rng.uniform(-0.03, 0.03, (B, 21, 3))
    return imgs.round().astype(np.uint8), K, bbox, joints


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("mode", ["factored", "composed"])
def test_sweep_matches_jax(twopass_jax, mode):
    """rotation_sweep_camera over 5 rotations of 4 rows (float64 geometry,
    float32 patches): the crops to 1e-4 on the 255 scale (both two-pass;
    the JAX one forms its weights in float32 as dense matrices, the port
    its positions in the maps' float64: they differ by ~5e-5), the
    camera-frame predictions to 3e-5 (the teacher scales a crop's corner
    contrast by 20 / 255, the back-projection by the patch size) and
    tprime to 1e-12."""
    imgs, K, bbox, _ = _mixed(4)
    thetas = np.linspace(-0.52, 0.52, 5)
    jp = {}

    def capture(p):
        jp["p"] = p
        return _teacher_jax(p)

    want_cam, want_tp = jtl.rotation_sweep_camera(
        capture, jnp.asarray(imgs), jnp.asarray(K), jnp.asarray(bbox), JAug(),
        thetas, 0.52, PATCH, mode)
    ti, tK, tb = _t(imgs, K, bbox)
    patches = sweep_patches(ti, tK, tb, AugmentConfig(), thetas, 0.52, PATCH,
                            mode)
    assert patches.shape == (20, *PATCH, 3) and patches.dtype == torch.float32
    np.testing.assert_allclose(patches.numpy(), np.asarray(jp["p"]),
                               atol=1e-4)
    cam, tp = rotation_sweep_camera(_teacher_torch, ti, tK, tb,
                                    AugmentConfig(), thetas, 0.52, PATCH,
                                    mode)
    np.testing.assert_allclose(cam.numpy(), np.asarray(want_cam), atol=3e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want_tp), rtol=1e-12)
    assert cam.dtype == torch.float64 and cam.shape == (4, 5, 21, 3)


def test_generate_filtered_labels_matches_jax(twopass_jax):
    """Six rows, two of them labelled, 9 rotations: the pseudo-labels and
    per-rotation predictions (to 3e-5, as the sweep above), the variances
    (to 1e-4 relative) and the keep set exactly (no row within 1e-3 of the
    threshold); labelled rows keep their GT normalisation and are
    kept."""
    imgs, K, bbox, joints = _mixed(6)
    labelled = np.array([False, False, False, True, False, True])
    kw = dict(num_rotations=9, variance_threshold=THRESHOLD,
              patch_hw=PATCH)
    want = jtl.generate_filtered_labels(
        _teacher_jax, jnp.asarray(imgs), jnp.asarray(K), jnp.asarray(bbox),
        jnp.asarray(labelled), jnp.asarray(joints), JAug(), **kw)
    got = generate_filtered_labels(_teacher_torch, *_t(imgs, K, bbox,
                                                       labelled, joints),
                                   AugmentConfig(), **kw)
    var = np.asarray(want.variance)
    near = np.abs(var / THRESHOLD - 1.0) < MARGIN
    print(f"rows within {MARGIN} of the threshold: {int(near.sum())}")
    assert not near.any()
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    keep = got.keep.numpy()
    assert keep.any() and not keep.all() and keep[labelled].all()
    np.testing.assert_allclose(got.variance.numpy(), var, rtol=1e-4,
                               atol=1e-12)
    for name in ("joint_cam_normalized", "per_rotation", "tprime"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=3e-5, err_msg=name)
    v, m = teacher_error_vs_variance(got.per_rotation,
                                     got.joint_cam_normalized)
    jv, jm = jtl.teacher_error_vs_variance(want.per_rotation,
                                           want.joint_cam_normalized)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
    ths = np.array([1e-3, 1e-2, 0.1, 1.0, 10.0])
    for a, b in zip(filter_precision_curve(v, m, torch.from_numpy(ths), 0.05),
                    jtl.filter_precision_curve(jv, jm, jnp.asarray(ths),
                                               0.05)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_pose_net_teacher_sweep_matches_jax(twopass_jax):
    """The frozen R18 teacher at a 64² patch (the fused decode's plain
    version) against the JAX net with the same weights and its
    head_projection_integral, factored sweep over 3 rotations of 2 rows,
    float32: per-rotation camera-frame predictions to 2e-5."""
    cfg = small_config()
    net, variables = randomized_jax_variables(cfg.model, seed=3,
                                              final_scale=1e-3)
    J, D = cfg.model.num_joints, cfg.model.depth_dim

    def jax_teacher(patches):
        feats = net.apply(variables, patches, train=False,
                          return_features=True)
        Wp, bp = net.final_projection(variables["params"])
        return jax_head_projection_integral(feats, Wp, bp, J, D)

    net_port = port_model(cfg.model, variables)
    teacher = frozen_teacher(net_port, cfg)
    imgs, K, bbox, joints = _mixed(2, hw=128)
    bbox[:, 2:] = 60.0
    K, bbox = K.astype(np.float32), bbox.astype(np.float32)
    kw = dict(num_rotations=3, patch_hw=(64, 64))
    want = jtl.generate_filtered_labels(
        jax.jit(jax_teacher), jnp.asarray(imgs), jnp.asarray(K),
        jnp.asarray(bbox), jnp.zeros(2, bool), jnp.asarray(joints), JAug(),
        **kw)
    got = generate_filtered_labels(
        teacher, *_t(imgs, K, bbox, np.zeros(2, bool), joints),
        AugmentConfig(), **kw)
    assert not net_port.training
    assert not any(p.requires_grad for p in net_port.parameters())
    np.testing.assert_allclose(got.per_rotation.numpy(),
                               np.asarray(want.per_rotation), atol=2e-5)


def _cascade(pass1, labelled, T=9):
    imgs, K, bbox, joints = _mixed(6)
    runner = CascadeRunner(_teacher_torch, num_rotations=T,
                           variance_threshold=THRESHOLD,
                           pass1_rotations=pass1, pass2_batch=3,
                           patch_hw=PATCH, device="cpu")
    # two batches of 3, the second padded with a duplicate row
    runner.add_batch(imgs[:3], K[:3], bbox[:3], labelled[:3], joints[:3],
                     rows=[0, 1, 2])
    cat = np.concatenate
    runner.add_batch(cat([imgs[3:], imgs[5:]]), cat([K[3:], K[5:]]),
                     cat([bbox[3:], bbox[5:]]),
                     cat([labelled[3:], labelled[5:]]),
                     cat([joints[3:], joints[5:]]), rows=[3, 4, 5, -1])
    single = generate_filtered_labels(
        _teacher_torch, *_t(imgs, K, bbox, labelled, joints),
        AugmentConfig(), num_rotations=T, variance_threshold=THRESHOLD,
        patch_hw=PATCH)
    return single, runner.finalize(6), runner


@pytest.mark.parametrize("pass1,labelled", [
    (3, [False] * 6),
    (3, [True, False, True, False, False, False]),
    (9, [False] * 6),
])
def test_cascade_keep_set_equals_the_single_pass(pass1, labelled):
    """CascadeRunner (3 of 9 rotations in pass 1, or all 9: no pass 2)
    keeps exactly the single pass's rows; kept pseudo-labels and full
    variances agree (float64 host combine against the device's), an
    early-rejected row stores a lower bound of its variance, labelled
    rows finish in pass 1."""
    labelled = np.asarray(labelled)
    single, merged, runner = _cascade(pass1, labelled)
    keep = single.keep.numpy()
    var = single.variance.numpy()
    assert not (np.abs(var / THRESHOLD - 1.0) < MARGIN).any()
    np.testing.assert_array_equal(merged["keep"], keep)
    assert keep.any() and not keep.all()
    s = runner.stats
    assert s["total"] == 6 and s["labelled"] == labelled.sum()
    assert s["kept"] == keep.sum()
    if pass1 < 9:
        assert s["early_rejected"] >= 1, s
        assert s["early_rejected"] + s["pass2"] + s["labelled"] == 6
    else:       # one pass decides every row exactly
        assert s["pass2"] == 0 and s["early_rejected"] == (~keep).sum()
    np.testing.assert_array_equal(merged["labelled"], labelled)
    np.testing.assert_allclose(merged["joint_cam_normalized"][keep],
                               single.joint_cam_normalized.numpy()[keep],
                               rtol=1e-5, atol=1e-7)
    full = ~merged["early_rejected"]
    np.testing.assert_allclose(merged["variance"][full], var[full],
                               rtol=1e-5, atol=1e-9)
    er = merged["early_rejected"]
    assert np.all(merged["variance"][er] <= var[er] * (1 + 1e-6))
    np.testing.assert_array_equal(merged["pass1_bound"][labelled], 0.0)


def test_pass1_indices_match_jax():
    for T, n in ((21, 5), (21, 2), (9, 9), (9, 3), (21, 1)):
        np.testing.assert_array_equal(pass1_rotation_indices(T, n),
                                      jcascade.pass1_rotation_indices(T, n))
    for bad in (0, 22):
        with pytest.raises(ValueError):
            pass1_rotation_indices(21, bad)
    runner = CascadeRunner(_teacher_torch, device="cpu")
    with pytest.raises(ValueError, match="never fed"):
        runner.finalize(1)
