"""The port's serving paths under a device mesh, over two gloo ranks on
the CPU (one module-scoped spawn of tests/torch_mesh_worker.py, `serve`):
`TwoStagePipeline(mesh=...)` in float and in int8 (calibrated without the
mesh), and the teacher labels' rotation sweep, single pass and cascade,
with `mesh=`, each against the same call on one rank. The TINY R18
detector and the R18 pose net at 64x64 of tests/test_torch_quantize.py."""

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu_torch.config import (
    Config,
    DetectorConfig,
)
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.detect import build_detector
from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels import (
    camera_project,
)
from hand_integral_pose_estimation_tpu_torch.geometry import bbox as bb
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from test_torch_detector import TINY, tiny_images
from test_torch_pose_net import small_config
from torch_mesh_worker import spawn
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_serve")
    cfg = Config(model=small_config(18), detector=DetectorConfig(**TINY))
    pose = get_pose_net(cfg.model, torch.Generator().manual_seed(1))
    det = build_detector(cfg.detector,
                         generator=torch.Generator().manual_seed(2))
    K = np.broadcast_to(np.array([[100.0, 0, 32], [0, 100.0, 32],
                                  [0, 0, 1.0]], np.float32), (4, 3, 3)).copy()
    ds = SyntheticFreiHand(n=4, image_hw=(64, 64), seed=5,
                           render_joints=True)
    host = ds.host_batch(np.arange(4))
    jc, Ks = torch.from_numpy(host["joint_cam"]), torch.from_numpy(host["K"])
    uv, _, _ = camera_project(jc, Ks)
    box = bb.bbox_from_keypoints(uv, torch.ones_like(uv[..., 0]),
                                 pad_factor=cfg.augment.pad_factor)
    torch.save({
        "cfg": cfg, "pose": pose.state_dict(), "det": det.state_dict(),
        "images": tiny_images(B=4), "K": K, "ref": np.ones(4, np.float32),
        "sweep": {"images": torch.from_numpy(host["image"]), "K": Ks,
                  "bbox": box, "joint_cam": jc,
                  "labelled": torch.tensor([True, False, False, False])},
    }, out / "serve_case.pt")
    spawn("serve", 2, out)
    return [torch.load(out / f"serve_rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_two_stage_pipeline_over_the_mesh(run, mode):
    """Each rank detects, crops and decodes 2 of the 4 frames and returns
    all 4: equal to the one-rank pipeline on all 4 to 1e-5 (CPU convs at
    batch 2 and 4 may sum in another order; int8 products are exact). The
    scales of int8 agree over the ranks (calibrated without the mesh)."""
    for r in run:
        got, want = r[f"{mode}_mesh"], r[f"{mode}_one"]
        assert got.joints_cam.shape == (4, 21, 3)
        for name in got._fields:
            np.testing.assert_allclose(
                getattr(got, name).numpy(), getattr(want, name).numpy(),
                rtol=1e-5, atol=1e-5, err_msg=name)
    assert r["refused_1"] == ("split_detector does not compose with mesh "
                              "(as in the JAX package)")
    assert r["refused_0"] == "batch 3 must divide by the mesh 'data'-axis " \
        "size 2"


def test_teacher_labels_over_the_mesh(run):
    """The rotation sweep of 4 images (2 a rank) against one rank's, single
    pass and cascade: variances, pseudo-labels and tprime to 1e-5, the
    keep sets equal."""
    for r in run:
        got, want = r["labels_mesh"], r["labels_one"]
        for name in ("joint_cam_normalized", "tprime", "variance",
                     "per_rotation"):
            np.testing.assert_allclose(got[name].numpy(),
                                       want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        assert torch.equal(got["keep"], want["keep"])
        c, w = r["cascade_mesh"], r["cascade_one"]
        for name in w:
            np.testing.assert_allclose(c[name], w[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
