"""The port's file-backed FreiHAND split against the JAX package's on the
committed mini fixture (tests/fixtures/freihand_mini, the download's
on-disk layout): records field for field, decoded batches bitwise, the
biased sampler index for index, and the filtered pseudo-label db attached
(or refused) alike."""

import os

import numpy as np
import pytest

from hand_integral_pose_estimation_tpu.config import Config as JConfig
from hand_integral_pose_estimation_tpu.config import TrainConfig as JTrain
from hand_integral_pose_estimation_tpu.data import freihand as jfreihand
from hand_integral_pose_estimation_tpu.data import native_loader as jnative
from hand_integral_pose_estimation_tpu_torch.config import Config, TrainConfig
from hand_integral_pose_estimation_tpu_torch.data import freihand
from hand_integral_pose_estimation_tpu_torch.data import native_loader
from test_torch_panet import _one_torch_thread  # noqa: F401 (autouse)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "freihand_mini")
SIZES = dict(training_size=6, testing_size=2, labelled_data_range=2,
             batch_size=4)



@pytest.fixture
def library():
    """The decoder library, which tests/test_torch_native_lib.py builds
    while the suite is collected; decided when the test runs."""
    if not os.path.exists(native_loader.LIB_PATH):
        pytest.skip("native/libhipe_io.so is not built (make -C native)")


def _both(split):
    return (freihand.FreiHandDataset(FIXTURE, split,
                                     Config(train=TrainConfig(**SIZES))),
            jfreihand.FreiHandDataset(FIXTURE, split,
                                      JConfig(train=JTrain(**SIZES))))


def _same_records(got, want):
    assert len(got.records) == len(want.records)
    for a, b in zip(got.records, want.records):
        for field in ("img_path", "ref_bone_len", "labelled", "version",
                      "idx", "teacher_tprime"):
            assert getattr(a, field) == getattr(b, field), field
        for field in ("K", "joint_cam", "mano", "teacher_cam_normalized"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), field
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=field)
    assert (got.num_labelled, got.num_unlabelled) == (want.num_labelled,
                                                      want.num_unlabelled)


@pytest.mark.parametrize("split", ["training", "testing", "evaluation"])
def test_splits_match_jax_record_for_record(split):
    """The training split (6 indices x 4 versions, labelled first), the
    testing split (the reference's off-by-one start) and the label-free
    evaluation split; every image file exists."""
    got, want = _both(split)
    _same_records(got, want)
    assert all(os.path.exists(r.img_path) for r in got.records)
    n = {"training": 24, "testing": 4, "evaluation": 3}[split]
    assert len(got) == n
    for idx, version in ((0, "gs"), (5, "auto"), (7, "hom")):
        assert freihand.version_map_id(idx, version) == \
            jfreihand.version_map_id(idx, version)


def test_host_batches_and_sampling_match_jax(library):
    """Biased sampling from equal RandomStates gives equal indices (also
    with an empty pool), and the host batches of those indices are equal,
    the decoded images bitwise; batch_iterator likewise."""
    got, want = _both("training")
    idx = got.sample_indices(np.random.RandomState(3), 8)
    np.testing.assert_array_equal(
        idx, want.sample_indices(np.random.RandomState(3), 8))
    assert (idx < got.num_labelled).any() and (idx >= got.num_labelled).any()
    a, b = got.host_batch(idx), want.host_batch(idx)
    assert set(a) == set(b)
    for k in a:
        if b[k] is None:
            assert a[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["image"].shape == (8, 224, 224, 3)
    it_a = freihand.batch_iterator(got, 4, 2, seed=5)
    it_b = jfreihand.batch_iterator(want, 4, 2, seed=5)
    for x, y in zip(it_a, it_b):
        np.testing.assert_array_equal(x["image"], y["image"])
        np.testing.assert_array_equal(x["joint_cam"], y["joint_cam"])
    ev, ev_j = _both("evaluation")
    idx = ev.sample_indices(np.random.RandomState(1), 4)
    np.testing.assert_array_equal(
        idx, ev_j.sample_indices(np.random.RandomState(1), 4))


def test_decode_matches_jax_and_a_missing_library_says_how_to_build(
        library, monkeypatch, tmp_path):
    path = os.path.join(FIXTURE, "evaluation", "rgb", "00000001.jpg")
    for hw in ((224, 224), (100, 60)):
        np.testing.assert_array_equal(native_loader.decode_jpeg(path, *hw),
                                      jnative.decode_jpeg(path, *hw))
    with pytest.raises(IOError):
        native_loader.decode_jpeg(str(tmp_path / "missing.jpg"))
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "LIB_PATH",
                        str(tmp_path / "libhipe_io.so"))
    with pytest.raises(FileNotFoundError, match="make -C"):
        native_loader.decode_jpeg(path)


def _db(path, n, keep, names):
    rng = np.random.default_rng(0)
    np.savez(path, keep=keep,
             joint_cam_normalized=rng.normal(size=(n, 21, 3)).astype(
                 np.float32),
             tprime=rng.uniform(50, 150, n).astype(np.float32),
             variance=np.zeros(n, np.float32), labelled=np.zeros(n, bool),
             name=names)


def test_apply_filtered_labels_matches_jax(tmp_path):
    """A db over the 24 training records keeping every other one: the
    kept records, their pseudo-labels and tprimes equal the JAX package's;
    a db made for another --training-size (other names and length) is
    refused by both; a db without names attaches positionally."""
    from hand_integral_pose_estimation_tpu_torch.data.detector_db import (
        _record_names,
    )

    got, want = _both("training")
    keep = np.arange(24) % 2 == 0
    path = str(tmp_path / "db.npz")
    _db(path, 24, keep, _record_names(got))
    _same_records(freihand.apply_filtered_labels(got, path),
                  jfreihand.apply_filtered_labels(want, path))
    assert len(got) == 12 and got.records[0].teacher_tprime is not None

    other = freihand.FreiHandDataset(FIXTURE, "training", Config(
        train=TrainConfig(**{**SIZES, "training_size": 5})))
    bad = str(tmp_path / "bad.npz")
    _db(bad, 20, np.ones(20, bool), _record_names(other))
    for pkg, cfg in ((freihand, Config(train=TrainConfig(**SIZES))),
                     (jfreihand, JConfig(train=JTrain(**SIZES)))):
        with pytest.raises(ValueError, match="different record set"):
            pkg.apply_filtered_labels(
                pkg.FreiHandDataset(FIXTURE, "training", cfg), bad)

    anon = str(tmp_path / "anon.npz")
    db = dict(np.load(path))
    del db["name"]
    np.savez(anon, **db)
    got, want = _both("training")
    _same_records(freihand.apply_filtered_labels(got, anon),
                  jfreihand.apply_filtered_labels(want, anon))


def test_synthetic_records_take_a_filtered_db(tmp_path):
    """SyntheticFreiHand.as_records: record i is sample i, labelled records
    first, and its host batches are the synthetic split's rows; a db named
    after its records attaches through apply_filtered_labels (the kept
    rows' pseudo-labels ride the host batch, the sampler draws labelled
    rows with labelled_selection_prob) and a db for another record set is
    refused."""
    from hand_integral_pose_estimation_tpu_torch.data.detector_db import (
        _record_names,
    )

    cfg = Config(train=TrainConfig(**SIZES))
    synthetic = freihand.SyntheticFreiHand(n=10, image_hw=(16, 16), seed=3)
    recs = synthetic.as_records(cfg)
    order = np.asarray([r.idx for r in recs.records])
    lab = synthetic.labelled[order]
    assert sorted(order) == list(range(10))
    assert lab[:recs.num_labelled].all() and not lab[recs.num_labelled:].any()
    assert 0 < recs.num_labelled < 10
    a, b = recs.host_batch(np.arange(10)), synthetic.host_batch(order)
    for k in ("image", "joint_cam", "K", "ref_bone_len", "labelled"):
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["teacher_cam_normalized"] is None

    names = _record_names(recs)
    assert len(set(names)) == 10
    keep = np.arange(10) % 3 != 1
    path = str(tmp_path / "db.npz")
    _db(path, 10, keep, names)
    db = np.load(path)
    assert freihand.apply_filtered_labels(recs, path) is recs
    assert len(recs) == keep.sum()
    np.testing.assert_array_equal([r.idx for r in recs.records],
                                  order[keep])
    assert recs.num_labelled == lab[keep].sum()
    host = recs.host_batch(np.arange(len(recs)))
    np.testing.assert_array_equal(host["teacher_cam_normalized"],
                                  db["joint_cam_normalized"][keep])
    np.testing.assert_array_equal([r.teacher_tprime for r in recs.records],
                                  db["tprime"][keep])
    idx = recs.sample_indices(np.random.RandomState(0), 2000)
    share = float((idx < recs.num_labelled).mean())
    assert abs(share - cfg.train.labelled_selection_prob) < 0.05

    with pytest.raises(ValueError, match="different record set"):
        freihand.apply_filtered_labels(
            freihand.SyntheticFreiHand(n=9, seed=3).as_records(cfg), path)
