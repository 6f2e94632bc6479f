"""The pose path's learning gate (`chip_smoke.py` phase 8d) on the CPU: the
semi-supervised study's data and arms are the JAX study's
(cli/semi_supervised_study.py of both packages), the gate
(`chip_smoke.pose_learning_gate`) passes the JAX record and fails each
planted fault's measured records (`scripts/pose_convergence_study.py` on
an H100) on the check named for it, and `run_study` returns the untrained
net's MPJPE while `main` prints the lines it printed before."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.cli import (
    semi_supervised_study as jstudy,
)
from hand_integral_pose_estimation_tpu.data.freihand import (
    SyntheticFreiHand as JaxSyntheticFreiHand,
)
from hand_integral_pose_estimation_tpu_torch.cli import semi_supervised_study
from hand_integral_pose_estimation_tpu_torch.data import (
    SyntheticFreiHand,
    make_eval_batch,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

HW = (224, 224)
# the study's defaults: the pool, the held-out split (seed + 7919), K
POOL = (512, 0)
HELD_OUT = (128, 7919)
LABELLED = 24
FIELDS = ("images", "joint_cam", "K", "ref_bone_len")


@pytest.fixture(scope="module")
def pools():
    """Both packages' rendered-joint sets at the study's sizes, by (n,
    seed)."""
    return {(n, seed): (
        SyntheticFreiHand(n=n, image_hw=HW, seed=seed, render_joints=True),
        JaxSyntheticFreiHand(n=n, image_hw=HW, seed=seed,
                             render_joints=True))
        for n, seed in (POOL, HELD_OUT)}


@pytest.mark.parametrize("split", [POOL, HELD_OUT],
                         ids=["pool_512_seed_0", "held_out_128_seed_7919"])
def test_study_data_match_jax_bitwise(pools, split):
    """The study's training pool and held-out split at 224^2: images,
    joints, cameras and reference bone lengths bitwise the JAX package's."""
    port, jax_ds = pools[split]
    for name in FIELDS:
        got, want = getattr(port, name), getattr(jax_ds, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def jax_arms(pool):
    """The three arms' splits as the JAX CLI's main builds them."""
    n, K = pool.n, LABELLED
    semi = np.zeros(n, bool)
    semi[:K] = True
    return {"teacher": jstudy.subset_view(pool, np.arange(n),
                                          np.ones(n, bool)),
            "baseline": jstudy.subset_view(pool, np.arange(K),
                                           np.ones(K, bool)),
            "distilled": jstudy.subset_view(pool, np.arange(n), semi)}


def test_study_arms_match_jax(pools):
    """Each arm's split of the pool (its images, joints, labelled mask and
    counts) equals the JAX CLI's `subset_view` of the same pool, and the
    Trainer's host batches (the rng of epoch 0 at the seed, batch 32; the
    baseline's 24 images under a batch of 32 drawn with replacement) are
    the JAX Trainer's draws."""
    port_pool, jax_pool = pools[POOL]
    got = semi_supervised_study.arm_datasets(port_pool, LABELLED)
    want = jax_arms(jax_pool)
    assert set(got) == set(want) == set(semi_supervised_study.ARMS)
    for arm in got:
        g, w = got[arm], want[arm]
        assert (g.n, g.num_labelled, g.num_unlabelled) == (
            w.n, w.num_labelled, w.num_unlabelled), arm
        for name in (*FIELDS, "labelled"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name),
                                          err_msg=f"{arm}: {name}")
        # the Trainers' sampling streams: RandomState(seed * 100003 + epoch)
        rg, rw = (np.random.RandomState(POOL[1] * 100003) for _ in range(2))
        for _ in range(3):
            idx = g.sample_indices(rg, 32)
            np.testing.assert_array_equal(idx, w.sample_indices(rw, 32))
            assert idx.max() < g.n
            hg, hw = g.host_batch(idx), w.host_batch(idx)
            for k in ("image", "joint_cam", "K", "ref_bone_len", "labelled"):
                np.testing.assert_array_equal(hg[k], hw[k], err_msg=k)
    assert got["baseline"].n == LABELLED < 32


def test_held_out_split_admits_little_learning(pools):
    """Why the held-out MPJPE cannot gate learning (chip_smoke.py's
    POSE_TEACHER_MAX): the set's joints are drawn at random and told apart
    only by colour (joint % 3) and brightness, so on images a net has not
    seen, an oracle that knows the label-space position of every blob but
    not which joint of its colour it is (the median of its colour's
    blobs, the best guess under an L1 loss) is only ~10 % below the
    constant predictor (the split's mean label) in label-space MPJPE."""
    port, _ = pools[HELD_OUT]
    t = torch.from_numpy
    label = make_eval_batch(
        t(port.images), t(port.joint_cam).double(), t(port.K).double(), None,
        t(port.ref_bone_len).double()).label.numpy()
    const = np.linalg.norm(label.mean(0) - label, axis=-1).mean()
    oracle = np.empty_like(label)
    for colour in range(3):
        same = np.arange(colour, label.shape[1], 3)
        oracle[:, same] = np.median(label[:, same], axis=1, keepdims=True)
    ratio = np.linalg.norm(oracle - label, axis=-1).mean() / const
    assert abs(const - 0.2515) < 1e-3, const
    assert 0.88 < ratio < 0.91, ratio


def fits_of(constant, teacher, baseline, distilled):
    """`chip_smoke.pose_label_fits`'s fits from the printed values: the
    constant predictor's by split (pool, pool turned, held-out, labelled,
    labelled turned, unlabelled), the teacher's (pool, pool turned,
    held-out), the baseline's (labelled, labelled turned, unlabelled,
    held-out) and the distilled student's (labelled, unlabelled,
    held-out)."""
    return {
        "constant": dict(zip(("pool", "pool_turned", "held_out", "labelled",
                              "labelled_turned", "unlabelled"), constant)),
        "teacher": dict(zip(("pool", "pool_turned", "held_out"), teacher)),
        "baseline": dict(zip(("labelled", "labelled_turned", "unlabelled",
                              "held_out"), baseline)),
        "distilled": dict(zip(("labelled", "unlabelled", "held_out"),
                              distilled)),
    }


# The measured records of scripts/pose_convergence_study.py --seeds 0 1 2
# (on an H100 80GB HBM3 at 700 W; the faults at seed 0, whose constant
# predictor and untrained net are the sound seed 0's): held-out MPJPE of
# the teacher, the baseline and the distilled student, the untrained
# net's, and the label-space fits.
CONSTANT_0 = (0.25235, 0.22784, 0.25148, 0.24051, 0.21885, 0.25272)
TEACHER_0 = (0.16144, 0.20365, 0.26203)
BASELINE_0 = (0.03304, 0.0527, 0.27803, 0.27738)
SOUND = {
    0: ((0.48277, 0.68131, 0.63261, 20643.91406), fits_of(
        CONSTANT_0, TEACHER_0, BASELINE_0, (0.20098, 0.21176, 0.25056))),
    1: ((0.45545, 0.71547, 0.72375, 5656.76611), fits_of(
        (0.25444, 0.22817, 0.25464, 0.24797, 0.22144, 0.2544),
        (0.16264, 0.20965, 0.26356), (0.03405, 0.04129, 0.28066, 0.28162),
        (0.2017, 0.20431, 0.25327))),
    2: ((0.51921, 0.4878, 0.35315, 1607.30957), fits_of(
        (0.25245, 0.22823, 0.24981, 0.24436, 0.21967, 0.25256),
        (0.19148, 0.20743, 0.25059), (0.0356, 0.04687, 0.28065, 0.27827),
        (0.21752, 0.22489, 0.24791))),
}
# by fault: its records, the check the gate is named to fail for it and
# every check it fails (indices into CHECKS)
FAULTS = {
    "F1_dfeat_zeroed": (
        (218.36816, 3.66334, 285.01855, 20643.91406),
        fits_of(CONSTANT_0, (0.25302, 0.22856, 0.25273),
                (0.246, 0.22371, 0.25416, 0.25363),
                (0.2463, 0.25335, 0.25273)),
        4, {1, 2, 4, 5, 6}),
    "F2_labels_under_transpose": (
        (0.54664, 1.04446, 0.70742, 20643.91406),
        fits_of(CONSTANT_0, (0.14814, 0.22038, 0.25781),
                (0.03199, 0.14876, 0.27632, 0.27506),
                (0.20311, 0.21331, 0.25375)),
        6, {6}),
    "F3_teacher_term_off": (
        (0.48277, 0.68131, 2.74273, 20643.91406),
        fits_of(CONSTANT_0, TEACHER_0, BASELINE_0,
                (0.23241, 0.26823, 0.26859)),
        5, {2, 5}),
    "F4_untrained_teacher": (
        (0.48277, 0.68131, 785.33099, 20643.91406),
        fits_of(CONSTANT_0, TEACHER_0, BASELINE_0,
                (0.2466, 0.25377, 0.2529)),
        5, {2, 5}),
}


def result_of(teacher, baseline, distilled, untrained, fits=None, pa=0.01):
    """A phase 8d result with these held-out MPJPEs and label-space fits
    (the sound study's at seed 0 by default)."""
    out = {arm: {"mpjpe": v, "pa_mpjpe": pa} for arm, v in
           (("teacher", teacher), ("baseline", baseline),
            ("distilled", distilled))}
    out["untrained"] = {"mpjpe": untrained, "pa_mpjpe": float("nan")}
    out["fits"] = {arm: dict(f) for arm, f in (fits or SOUND[0][1]).items()}
    return out


CHECKS = list(chip_smoke.pose_learning_gate(result_of(1, 1, 1, 1)))


def test_pose_gate_passes_the_jax_record():
    """The JAX package's TPU record (PERFORMANCE.md:736-751; the untrained
    net about 3.6, PERFORMANCE.md:725), beside the sound fits, passes
    every check."""
    gate = chip_smoke.pose_learning_gate(result_of(0.348, 0.995, 0.262, 3.6))
    assert all(gate.values()), gate


@pytest.mark.parametrize("seed", sorted(SOUND))
def test_pose_gate_passes_the_sound_runs(seed):
    """The sound study's measured records at each seed pass every check
    (the limits were set from them, with a margin)."""
    mpjpe, fits = SOUND[seed]
    gate = chip_smoke.pose_learning_gate(result_of(*mpjpe, fits=fits))
    assert all(gate.values()), gate


@pytest.mark.parametrize("arm,field", [
    (arm, field) for arm in ("teacher", "baseline", "distilled")
    for field in ("mpjpe", "pa_mpjpe")] + [("untrained", "mpjpe")])
def test_pose_gate_fails_on_nan(arm, field):
    """A nan in any arm's MPJPE or PA-MPJPE, or in the untrained MPJPE,
    fails the first check."""
    result = result_of(0.348, 0.995, 0.262, 3.6)
    result[arm][field] = float("nan")
    gate = chip_smoke.pose_learning_gate(result)
    assert not gate[CHECKS[0]]
    assert not all(gate.values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_pose_gate_fails_each_fault(fault):
    """Each fault's measured records fail the gate on the check named for
    it, and on exactly the checks its run failed."""
    mpjpe, fits, named, failing = FAULTS[fault]
    gate = chip_smoke.pose_learning_gate(result_of(*mpjpe, fits=fits))
    assert not gate[CHECKS[named]], (fault, CHECKS[named])
    assert {i for i, name in enumerate(CHECKS) if not gate[name]} == failing


def test_run_study_tiny_returns_untrained_and_main_prints_as_before(
        capsys, monkeypatch):
    """`main` at the tiny setting of tests/test_torch_studies.py prints
    the lines it printed before `run_study` was factored out of it (one
    JSON record per arm with the same keys in the same order, then the
    summary line) and returns the three records; the `run_study` result
    behind it also holds the untrained net's MPJPE, each arm's ms per
    train step and its launches (none on the CPU)."""
    seen = {}
    run_study = semi_supervised_study.run_study

    def spy(*args, **kwargs):
        seen.update(run_study(*args, **kwargs))
        return seen

    monkeypatch.setattr(semi_supervised_study, "run_study", spy)
    results = semi_supervised_study.main(
        ["--n", "12", "--labelled", "4", "--test-n", "6", "--teacher-steps",
         "2", "--student-steps", "2", "--batch-size", "4", "--pose-resnet",
         "18", "--pose-input", "32", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [list(rec) for rec in lines[:3]] == [
        ["arm", "steps", "train_images", "labelled", "mpjpe", "pa_mpjpe",
         "wall_s"]] * 3
    assert [rec["arm"] for rec in lines[:3]] == list(
        semi_supervised_study.ARMS)
    assert list(lines[3]) == ["summary", "teacher_mpjpe", "baseline_mpjpe",
                              "distilled_mpjpe", "improvement_pct",
                              "distillation_helps"]
    assert len(lines) == 4
    assert results == {rec["arm"]: rec for rec in lines[:3]}
    assert lines[3] == seen["summary"]
    assert np.isfinite(seen["untrained"]["mpjpe"])
    assert set(seen["train_ms_per_step"]) == set(results)
    assert all(v > 0 for v in seen["train_ms_per_step"].values())
    assert all(n == 0 for arm in seen["launches"].values()
               for n in arm.values())
