"""The port's geometry and eval batch against the JAX package at float64 on
the CPU (tests/conftest.py enables x64 for JAX): every function of the
slice, and every field of `make_eval_batch`'s Batch, to atol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.data import pipeline as jpipe
from hand_integral_pose_estimation_tpu.data.freihand import (
    SyntheticFreiHand as JaxSynthetic,
)
from hand_integral_pose_estimation_tpu.geometry import (
    bbox as jbbox,
    camera as jcam,
    labels as jlbl,
    procrustes as jproc,
    transforms as jtf,
)
from hand_integral_pose_estimation_tpu_torch.data import (
    SyntheticFreiHand,
    make_eval_batch,
    padded_batches,
)
from hand_integral_pose_estimation_tpu_torch.geometry import (
    bbox,
    camera,
    labels,
    procrustes,
    transforms,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

ATOL = 1e-10


def _close(got, want, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotations(rng, B):
    q, r = np.linalg.qr(rng.normal(size=(B, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


@pytest.fixture
def scene():
    """A batch of FreiHAND-like samples: intrinsics, small rotations and
    hand-sized joint clouds ~0.5 m in front of the camera."""
    rng = np.random.default_rng(11)
    B, J = 4, 21
    K = np.tile(np.array([[531.9, 0.0, 112.0], [0.0, 532.2, 112.0],
                          [0.0, 0.0, 1.0]]), (B, 1, 1))
    K[:, 0, 0] += rng.uniform(-20, 20, B)
    joints = (np.array([0.01, -0.005, 0.47])
              + rng.uniform(-0.04, 0.04, (B, J, 3)))
    a = rng.uniform(-0.3, 0.3, B)
    R = np.stack([[np.cos(a), -np.sin(a), 0 * a], [np.sin(a), np.cos(a), 0 * a],
                  [0 * a, 0 * a, 1 + 0 * a]]).transpose(2, 0, 1)
    return {"K": K, "joints": joints, "R": R, "rng": rng}


def test_camera(scene):
    K, xyz, R = scene["K"], scene["joints"], scene["R"]
    for g, w in zip(camera.project_points(_t(xyz), _t(R), _t(K)),
                    jcam.project_points(xyz, R, K)):
        _close(g, w)
    pix = np.asarray(jcam.cam2pixel(xyz, K))
    _close(camera.cam2pixel(_t(xyz), _t(K)), pix)
    _close(camera.pixel2cam(_t(pix), _t(K)), jcam.pixel2cam(pix, K))


def test_transforms(scene):
    rng = scene["rng"]
    src = rng.uniform(0, 200, (3, 4, 2))
    dst = src + rng.uniform(-20, 20, (3, 4, 2))
    _close(transforms.get_perspective_transform(_t(src), _t(dst)),
           jtf.get_perspective_transform(src, dst), atol=1e-8)
    box = [rng.uniform(80, 140, 3), rng.uniform(80, 140, 3),
           rng.uniform(50, 120, 3), rng.uniform(50, 120, 3)]
    for g, w in zip(transforms.patch_corner_points(*map(_t, box), 224, 200,
                                                   scale=1.1),
                    jtf.patch_corner_points(*box, 224, 200, scale=1.1)):
        _close(g, w)
    for inv in (False, True):
        _close(transforms.trans_from_patch(*map(_t, box), 224, 200,
                                           scale=1.1, inv=inv),
               jtf.trans_from_patch(*map(jnp.asarray, box), 224, 200,
                                    scale=1.1, inv=inv))
    _close(transforms.rotation_homography(_t(scene["K"]), _t(scene["R"])),
           jtf.rotation_homography(scene["K"], scene["R"]))
    Hm = np.asarray(jtf.get_perspective_transform(src, dst))
    pts = rng.uniform(0, 200, (3, 21, 2))
    _close(transforms.transform_points_2d(_t(pts), _t(Hm)),
           jtf.transform_points_2d(pts, Hm), atol=1e-8)


def test_bbox(scene):
    rng = scene["rng"]
    uv = rng.uniform(20, 200, (4, 21, 2))
    vis = (rng.uniform(size=(4, 21)) > 0.2).astype(np.float64)
    for g, w in zip(bbox.kpt_bound(_t(uv), _t(vis)),
                    jbbox.kpt_bound(uv, vis)):
        _close(g, w)
    _close(bbox.bbox_from_keypoints(_t(uv), _t(vis)),
           jbbox.bbox_from_keypoints(uv, vis))
    boxes = np.concatenate([rng.uniform(0, 100, (4, 5, 2)),
                            rng.uniform(120, 220, (4, 5, 2)),
                            rng.uniform(0, 1, (4, 5, 1))], axis=-1)
    _close(bbox.bbox_from_detection(_t(boxes)),
           jbbox.bbox_from_detection(boxes))
    bb = np.asarray(jbbox.bbox_from_keypoints(uv, vis))
    _close(bbox.scale_bbox(_t(bb), aspect_ratio=0.8, pad_factor=1.3),
           jbbox.scale_bbox(bb, aspect_ratio=0.8, pad_factor=1.3))
    _close(bbox.tprime_from_bbox(_t(bb), _t(scene["K"])),
           jbbox.tprime_from_bbox(bb, scene["K"]))


def test_labels(scene):
    K, jc, R = scene["K"], scene["joints"], scene["R"]
    uv, _, _ = jcam.project_points(jc, R, K)
    bb = np.asarray(jbbox.bbox_from_keypoints(uv, np.ones(uv.shape[:2])))
    want = jax.vmap(lambda a, r, k, b: jlbl.compute_patch_labels(
        a, r, k, b, scale=1.1))(jc, R, K, bb)
    got = labels.compute_patch_labels(_t(jc), _t(R), _t(K), _t(bb),
                                      scale=1.1)
    for name in labels.PatchLabels._fields:
        _close(getattr(got, name), getattr(want, name))
    _close(labels.compute_patch_labels_from_normalized(
        got.joint_cam_normalized, got.tprime, _t(R), _t(K), _t(bb)),
        jax.vmap(jlbl.compute_patch_labels_from_normalized)(
            want.joint_cam_normalized, want.tprime, R, K, bb))
    _close(labels.patch_label_to_camera(got.label, got.trans_inv, got.tprime,
                                        _t(K), _t(R)),
           jlbl.patch_label_to_camera(want.label, want.trans_inv, want.tprime,
                                      K, R))
    _close(labels.decode_labels(labels.encode_labels(_t(jc), 224, 200),
                                224, 200), jc)


def test_labels_one_with_rotation_and_teacher(scene):
    """The per-batch label pass with a rotation and cached teacher joints:
    patch labels, teacher label, crop box and the composed homography
    (image -> rotated image -> patch), against the JAX per-sample pass
    vmapped."""
    from hand_integral_pose_estimation_tpu_torch.config import AugmentConfig
    from hand_integral_pose_estimation_tpu_torch.data import pipeline

    K, jc, R = scene["K"], scene["joints"], scene["R"]
    teacher = jc + scene["rng"].normal(0, 0.002, jc.shape)
    acfg = AugmentConfig()
    want = jax.vmap(lambda a, k, t, r: jpipe._labels_one(
        a, k, None, t, r, acfg, (224, 224)))(jc, K, teacher, R)
    got = pipeline._labels_one(_t(jc), _t(K), None, _t(teacher), _t(R),
                               acfg, (224, 224))
    for name in labels.PatchLabels._fields:
        _close(getattr(got[0], name), getattr(want[0], name))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


@pytest.mark.parametrize("optimal_scale", [True, False])
def test_procrustes(scene, optimal_scale):
    rng = scene["rng"]
    X = rng.normal(size=(5, 21, 3))
    Y = (X @ _rotations(rng, 5)) * 1.3 + 0.2 + rng.normal(size=X.shape) * 0.05
    # a mirrored prediction exercises the reflection fix (det(T) < 0)
    Y[0] = X[0] * np.array([1.0, 1.0, -1.0])
    want = jproc.compute_similarity_transform(X, Y, optimal_scale)
    got = procrustes.compute_similarity_transform(_t(X), _t(Y), optimal_scale)
    assert float(np.linalg.det(np.asarray(want.T)[0])) > 0
    for name in procrustes.SimilarityTransform._fields:
        _close(getattr(got, name), getattr(want, name), atol=1e-9)
    _close(procrustes.procrustes_align(_t(X), _t(Y)),
           jproc.procrustes_align(X, Y), atol=1e-9)


@pytest.mark.parametrize("with_detector_bbox", [False, True])
def test_make_eval_batch(with_detector_bbox):
    """Every field of the eval batch. Both packages crop in float32 by
    design (make_eval_batch casts the image), and each output pixel is a sum
    of at most four exactly rounded products, so the patch agrees to 1e-10
    as well."""
    ds = SyntheticFreiHand(n=3, image_hw=(48, 40), seed=5, render_joints=True)
    host = ds.host_batch(np.arange(3))
    jc, K = host["joint_cam"].astype(np.float64), host["K"].astype(np.float64)
    det = None
    if with_detector_bbox:
        det = np.array([[20.0, 22.0, 30.0, 30.0], [18.0, 25.0, 24.0, 26.0],
                        [21.0, 21.0, 35.0, 33.0]])
    bone = host["ref_bone_len"].astype(np.float64)
    want = jpipe.make_eval_batch(jnp.asarray(host["image"]), jc, K, det, bone,
                                 patch_hw=(32, 28))
    got = make_eval_batch(_t(host["image"]), _t(jc), _t(K),
                          None if det is None else _t(det), _t(bone),
                          patch_hw=(32, 28))
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.numpy().dtype == w.dtype, name
        assert tuple(g.shape) == w.shape, name
        _close(g, w)


def test_synthetic_dataset_is_the_jax_packages():
    """The copied numpy dataset yields the JAX package's arrays from the
    same seed, and the sweep helper pads the tail batch the same way."""
    ours = SyntheticFreiHand(n=6, image_hw=(32, 32), seed=2,
                             render_joints=True).host_batch(np.arange(6))
    theirs = JaxSynthetic(n=6, image_hw=(32, 32), seed=2,
                          render_joints=True).host_batch(np.arange(6))
    for key, value in theirs.items():
        if value is None:
            assert ours[key] is None
        else:
            np.testing.assert_array_equal(ours[key], value)
    assert [list(i) for i in padded_batches(5, 2)] == [[0, 1], [2, 3], [4, 4]]
