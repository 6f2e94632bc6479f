"""The distillation filter's gate (`chip_smoke.py` phase 8e) on the CPU.

The gate (`chip_smoke.cascade_gate`) passes a sound result and fails a
result shaped like each planted fault of `scripts/filter_cascade_gate_
study.py` (G1-G4, measured on an H100); a tiny run of the study through
`chip_smoke.run_cascade_study` (R18 at 32^2, a pool of 16) keeps the
cascade's bound and its keep set, and two of the faults, planted as the
script plants them, break what they must at that size; the study's pool
batches are the JAX CLI's and, with one teacher's weights carried across,
its per-row variances, keep sets and pass-1 bounds are the JAX filter's
and cascade's."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.cli import (
    filter_cascade_study as jstudy,
)
from hand_integral_pose_estimation_tpu.config import Config as JConfig
from hand_integral_pose_estimation_tpu.data.freihand import (
    SyntheticFreiHand as JaxSyntheticFreiHand,
)
from hand_integral_pose_estimation_tpu.distill import cascade as jcascade
from hand_integral_pose_estimation_tpu.distill import teacher_labels as jtl
from hand_integral_pose_estimation_tpu.ops.fused_head import (
    head_projection_integral as jax_head_projection_integral,
)
from hand_integral_pose_estimation_tpu_torch.cli import filter_cascade_study
from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
from hand_integral_pose_estimation_tpu_torch.distill import (
    CascadeRunner,
    cascade,
    generate_filtered_labels,
    teacher_labels,
)
from hand_integral_pose_estimation_tpu_torch.training import teacher
from hand_integral_pose_estimation_tpu_torch.training.teacher import (
    frozen_teacher,
)
from test_torch_distill import twopass_jax  # noqa: F401 (fixture)
from test_torch_pose_net import port_model, randomized_jax_variables
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import chip_smoke as cs  # noqa: E402
import filter_cascade_gate_study as study  # noqa: E402

#: the study at the CPU's size: R18 at 32^2, 8 training images, a pool of
#: 16 in batches of 4
TINY = ["--n", "8", "--pool", "16", "--teacher-steps", "2", "--batch-size",
        "4", "--pose-resnet", "18", "--pose-input", "32", "--device", "cpu"]
POOL_N, POOL_BATCH, HW = 16, 4, (32, 32)
#: the tolerance of test_torch_distill.py::
#: test_generate_filtered_labels_matches_jax on the variances
VAR_RTOL = 1e-4
#: rows whose variance lies within this relative distance of a threshold
#: may flip between the packages; they are counted, not compared
MARGIN = 1e-3
#: the faults' measures in `scripts/filter_cascade_gate_study.py` at seed
#: 0 on an H100: G1's median row variance of check 7 (the sound runs'
#: largest 2.4e-15), G3's fit over the constant predictor's (sound
#: 1.0014-1.0026, their starting nets' 1.0025-1.0054) and its teacher
#: against the trained net (check 8)
G1_ORACLE = 4.3334e-3
G3_FIT = 1.0054
G3_TEACHER_ERR = 2.283e-3


# ------------------------------------------------------------ the gate


def curve_rows(n, keep_rates, rng):
    """n variances whose keep rates at the gate's thresholds are
    `keep_rates` ({threshold: rate}, rising): each row drawn log-uniform
    inside its slot between two thresholds."""
    edges = [1e-7, *sorted(keep_rates), 1e-2]
    counts = np.diff([0, *[round(n * keep_rates[t])
                          for t in sorted(keep_rates)], n])
    return rng.permutation(np.concatenate([
        np.exp(rng.uniform(np.log(lo), np.log(hi), c))
        for lo, hi, c in zip(edges, edges[1:], counts)]))


def result_of(variance, ratio=0.32, fit=1.0, untrained=1.01, equal=True,
              coord_err=1e-7, differ=0, oracle=3e-16, teacher_err=0.0):
    """A `run_cascade_study` result with what the gate reads: the pool's
    variances, each row's pass-1 bound at `ratio` of its variance, the
    teacher's fit and its starting net's over the constant predictor's,
    the keep-set flag, check 6's numbers, check 7's variances (`oracle` a
    row) and check 8's difference."""
    variance = np.asarray(variance, np.float64)
    return {"variance": variance.astype(np.float32),
            "merged": {"pass1_bound": (variance * ratio).astype(np.float32),
                       "labelled": np.zeros(len(variance), bool)},
            "safety": 1e-3, "keep_sets_equal": equal,
            "fit": {"teacher": fit * 0.05, "constant": 0.05,
                    "untrained": untrained * 0.05},
            "kernel_vs_plain": {"coord_err": coord_err, "near": 0,
                                "differ": differ,
                                "teacher_err": teacher_err},
            "oracle_variance": np.full(len(variance), oracle)}


def sound_result():
    """The band's middles of the keep curve over 512 rows."""
    rng = np.random.default_rng(0)
    mid = {t: (lo + hi) / 2 for t, (lo, hi) in cs.CASCADE_KEEP_BANDS.items()}
    return result_of(curve_rows(512, mid, rng))


def fault_results():
    """Results shaped like each planted fault (scripts/filter_cascade_gate_
    study.py), by name: the checks each must fail."""
    sound = sound_result()
    var = sound["variance"].astype(np.float64)
    return {
        # the pool's variances as the sound run's (the teacher does not
        # follow the rotation); exact labels spread by the rotation undone
        # twice over
        "G1": (result_of(var, oracle=G1_ORACLE), "oracle_steady"),
        # 21 copies of one crop: every variance 0, every row kept
        "G2": (result_of(np.zeros_like(var)), "keep_curve"),
        # an untrained teacher: near the sound teacher's fit, which learns
        # no more than the mean pose, but the starting net's own fit, and
        # not the net that was trained
        "G3": (result_of(var, fit=G3_FIT, untrained=G3_FIT,
                         teacher_err=G3_TEACHER_ERR),
               "teacher_is_trained", "teacher_improved"),
        # the bound without n / T: Var_5 ~ 1.3 Var_21 > Var_21
        "G4": (result_of(var, ratio=0.32 * 21 / 5, equal=False),
               "bound_holds"),
    }


@pytest.mark.parametrize("name", ["sound", "G1", "G2", "G3", "G4"])
def test_cascade_gate_passes_sound_and_fails_each_fault(name):
    """The sound result passes every check; each fault's fails the checks
    named for it."""
    if name == "sound":
        gate = cs.cascade_gate(sound_result())
        assert all(gate.values()), gate
        return
    result, *checks = fault_results()[name]
    gate = cs.cascade_gate(result)
    assert not any(gate[c] for c in checks), gate


@pytest.mark.parametrize("field", ["variance", "fit", "coord_err"])
def test_cascade_gate_fails_on_nan(field):
    result = sound_result()
    if field == "variance":
        result["variance"][:] = np.nan
    elif field == "fit":
        result["fit"]["teacher"] = float("nan")
    else:
        result["kernel_vs_plain"]["coord_err"] = float("nan")
    assert not all(cs.cascade_gate(result).values())


def test_cascade_gate_holds_kernel_vs_plain():
    """A keep flip outside the margin or coords past COORD_TOL fail check
    6; a falling keep curve fails check 5."""
    var = sound_result()["variance"]
    assert not cs.cascade_gate(result_of(var, differ=1))["kernel_vs_plain"]
    assert not cs.cascade_gate(result_of(
        var, coord_err=2 * cs.COORD_TOL))["kernel_vs_plain"]
    # survival below the keep rate: a bound above its row's variance
    gate = cs.cascade_gate(result_of(var, ratio=2.0))
    assert not gate["survival_covers_keep"] and not gate["bound_holds"]


# ------------------------------------------------------------ tiny runs


@pytest.fixture(scope="module")
def tiny_result():
    return cs.run_cascade_study(0, log=lambda line: None, argv=TINY)


def test_tiny_study_keeps_the_bound_and_the_keep_set(tiny_result):
    """On the CPU at R18 32^2 over a pool of 16: the cascade keeps the
    single pass's rows, every pass-1 bound lies below its row's variance
    (within CASCADE_BOUND_TOL) and pass-1 survival covers the keep rate at
    every threshold of the grid; check 6's arms agree; no kernel ran."""
    r = tiny_result
    gate = cs.cascade_gate(r)
    assert gate["keep_sets_equal"] and r["keep_sets_equal"]
    assert gate["bound_holds"], cs.cascade_bound_ratio(r)
    assert gate["survival_covers_keep"], cs.cascade_curve(r)
    assert gate["kernel_vs_plain"], r["kernel_vs_plain"]
    assert 0.0 < cs.cascade_bound_ratio(r) <= 1.0
    assert r["variance"].shape == r["keep"].shape == (POOL_N,)
    assert r["pseudo_label"].shape == r["gt_label"].shape == (POOL_N, 21, 3)
    assert r["oracle_variance"].shape == (POOL_N,)
    assert gate["oracle_steady"], r["oracle_variance"].max()
    assert np.isfinite(r["fit"]["teacher"]) and r["fit"]["images"] == 8
    assert np.isfinite(r["fit"]["untrained"])
    assert r["fit"]["untrained"] != r["fit"]["teacher"]
    assert not any(r["launches"].values())
    lines = cs.cascade_report(r)
    assert gate["teacher_is_trained"], r["kernel_vs_plain"]
    assert len(lines) == 8 and all(isinstance(x, str) for x in lines)


@pytest.mark.parametrize("fault", ["G1", "G2", "G3", "G4"])
def test_planted_faults_break_the_tiny_study(fault):
    """The script's G1 spreads the exact labels of check 7 by twice the
    sweep's angles (rounding alone without it); its G2 makes every crop
    of a row one crop (variance 0, every row kept); its G3 runs a teacher
    that is not the trained net; its G4 lifts the bound to the pass-1
    variance, over the full variance for the rows whose
    spread grows with |theta|, and the cascade then rejects rows the
    single pass keeps."""
    planted = {name[:2]: ctx for name, ctx in study.faults(0).items()}
    patched = (teacher_labels.lbl, teacher_labels.sweep_thetas,
               cascade.sweep_thetas, teacher.make_frozen_teacher,
               CascadeRunner.__init__)
    with planted[fault]:
        r = cs.run_cascade_study(0, log=lambda line: None, argv=TINY)
    gate = cs.cascade_gate(r)
    if fault == "G1":
        assert r["oracle_variance"].min() > 1e-6
        assert not gate["oracle_steady"]
    elif fault == "G3":
        assert r["kernel_vs_plain"]["teacher_err"] > cs.COORD_TOL
        assert r["fit"]["teacher"] == r["fit"]["untrained"]
        assert not gate["teacher_is_trained"]
        assert not gate["teacher_improved"]
    elif fault == "G2":
        assert not r["variance"].any() and r["keep"].all()
        assert not gate["keep_curve"]
    else:
        assert cs.cascade_bound_ratio(r) > 1.2
        assert not gate["bound_holds"]
    # the patch is gone after the block
    assert patched == (teacher_labels.lbl, teacher_labels.sweep_thetas,
                       cascade.sweep_thetas, teacher.make_frozen_teacher,
                       CascadeRunner.__init__)


def test_main_prints_the_lines_it_printed(capsys):
    """`main` returns the filter line's record and prints the teacher's,
    the filter's, the threshold sweep's and the summary line."""
    rec = filter_cascade_study.main(TINY)
    out = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert [line.split('"', 2)[1] for line in out] == [
        "phase", "phase", "phase", "summary"]
    assert rec["phase"] == "filter" and rec["keep_sets_equal"] is True


# ------------------------------------------------------------ the JAX study


@pytest.fixture(scope="module")
def pools():
    seed = 0 + 104729
    return (SyntheticFreiHand(n=POOL_N, image_hw=HW, seed=seed,
                              render_joints=True),
            JaxSyntheticFreiHand(n=POOL_N, image_hw=HW, seed=seed,
                                 render_joints=True))


def test_pool_batches_match_jax(pools):
    """The study's pool batches (padded to the batch, rows < 0 marking the
    padding) are the JAX CLI's `_pool_batches`: images, cameras, joints and
    rows bitwise, the boxes from the projected joints to 1e-4 px."""
    port, jax_pool = pools
    got = filter_cascade_study.pool_batches(
        port, tiny_config(), POOL_BATCH, "cpu")
    want = jstudy._pool_batches(jax_pool, JConfig(), POOL_BATCH)
    assert len(got) == len(want) == POOL_N // POOL_BATCH
    for g, w in zip(got, want):
        for i in (0, 1, 4):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w[i]))
        np.testing.assert_allclose(g[2].numpy(), np.asarray(w[2]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(g[3].numpy(), np.asarray(w[3]))
        np.testing.assert_array_equal(g[5], w[5])


def tiny_config():
    import dataclasses

    cfg = filter_cascade_study.study_config(
        filter_cascade_study.build_argparser().parse_args(TINY))
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 compute_dtype="float32"))


class TrainerSeen(Exception):
    """Raised by `seen_trainer` once it holds the Trainer's config."""


def seen_trainer(seen):
    def trainer(cfg, **kwargs):
        seen.append(cfg)
        raise TrainerSeen
    return trainer


def test_teacher_trains_at_the_jax_clis_config(monkeypatch):
    """Both CLIs at the study's flags (`--batch-size 8`) hand their
    Trainer one config: the teacher trains at Config's batch (32), which
    `--batch-size` does not size in the JAX CLI, with the flags' ResNet,
    input, rate and no rate decay."""
    import dataclasses

    import hand_integral_pose_estimation_tpu.training as jtraining
    import hand_integral_pose_estimation_tpu_torch.training as training

    got, want = [], []
    monkeypatch.setattr(training, "Trainer", seen_trainer(got))
    monkeypatch.setattr(jtraining, "Trainer", seen_trainer(want))
    flags = ["--n", "4", "--pool", "4", "--pose-resnet", "18",
             "--pose-input", "32", "--lr", "3e-4"]
    with pytest.raises(TrainerSeen):
        filter_cascade_study.main(flags + ["--device", "cpu"])
    with pytest.raises(TrainerSeen):
        jstudy.main(flags)
    (cfg,), (jcfg,) = got, want
    assert cfg.train.batch_size == jcfg.train.batch_size == 32
    for part in ("train", "model"):
        mine = dataclasses.asdict(getattr(cfg, part))
        theirs = dataclasses.asdict(getattr(jcfg, part))
        common = sorted(set(mine) & set(theirs))
        assert {k: mine[k] for k in common} == {
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in ((k, theirs[k]) for k in common)}, part


def carried_teachers(cfg):
    """One R18 teacher at 32^2 in both packages: random weights and BN
    statistics drawn for the JAX net, carried into the port's by the
    weights bridge (float32)."""
    J, D = cfg.model.num_joints, cfg.model.depth_dim
    net, variables = randomized_jax_variables(cfg.model, seed=5,
                                              final_scale=1e-3)

    def jax_teacher(patches):
        feats = net.apply(variables, patches, train=False,
                          return_features=True)
        Wp, bp = net.final_projection(variables["params"])
        return jax_head_projection_integral(feats, Wp, bp, J, D)

    return (jax.jit(jax_teacher),
            frozen_teacher(port_model(cfg.model, variables), cfg))


def test_filter_and_cascade_match_jax_over_the_pool(pools, twopass_jax):
    """Over the study's pool (16 images at 32^2, batches of 4, 21
    rotations, factored) with one teacher in both packages: the single
    pass's per-row variances agree to VAR_RTOL; the keep sets at the
    study's threshold and at one between the middle variances agree on
    every row outside MARGIN of it; the cascade's pass-1 bounds agree to
    VAR_RTOL and its keep sets equal its own single pass's in both
    packages."""
    cfg = tiny_config()
    jax_teacher, teacher = carried_teachers(cfg)
    _, jax_pool = pools
    batches = filter_cascade_study.pool_batches(pools[0], cfg, POOL_BATCH,
                                                "cpu")
    jbatches = jstudy._pool_batches(jax_pool, JConfig(), POOL_BATCH)
    kw = dict(num_rotations=21, rotation_range=0.52, patch_hw=HW,
              rotation_mode="factored")
    var, jvar = [], []
    for (im, K, bb, lab, jc, _), (jim, jK, jbb, jlab, jjc, _) in zip(
            batches, jbatches):
        with torch.no_grad():
            var.append(generate_filtered_labels(
                teacher, im, K, bb, lab, jc, cfg.augment,
                **kw).variance.numpy())
        jvar.append(np.asarray(jtl.generate_filtered_labels(
            jax_teacher, jim, jK, jbb, jlab, jjc, JConfig().augment,
            **kw).variance))
    var, jvar = np.concatenate(var), np.concatenate(jvar)
    np.testing.assert_allclose(var, jvar, rtol=VAR_RTOL, atol=0)
    srt = np.sort(jvar)
    middle = float(np.sqrt(srt[POOL_N // 2 - 1] * srt[POOL_N // 2]))
    for thr in (1e-4, middle):
        near = np.abs(jvar / thr - 1) < MARGIN
        print(f"threshold {thr:.3e}: {int(near.sum())} rows within "
              f"{MARGIN:g}, kept {int((jvar < thr).sum())} of {POOL_N}")
        np.testing.assert_array_equal((var < thr)[~near],
                                      (jvar < thr)[~near])

    runner = CascadeRunner(teacher, cfg.augment, variance_threshold=middle,
                           pass2_batch=POOL_BATCH, device="cpu", **kw)
    jrunner = jcascade.CascadeRunner(jax_teacher, JConfig().augment,
                                     variance_threshold=middle,
                                     pass2_batch=POOL_BATCH, **kw)
    for b, jb in zip(batches, jbatches):
        runner.add_batch(*b)
        jrunner.add_batch(*jb)
    merged, jmerged = runner.finalize(POOL_N), jrunner.finalize(POOL_N)
    np.testing.assert_allclose(merged["pass1_bound"], jmerged["pass1_bound"],
                               rtol=VAR_RTOL, atol=0)
    near = np.abs(jvar / middle - 1) < MARGIN
    np.testing.assert_array_equal(merged["keep"][~near], (var < middle)[~near])
    np.testing.assert_array_equal(jmerged["keep"][~near],
                                  (jvar < middle)[~near])
    assert 0 < merged["keep"].sum() < POOL_N
    assert (merged["pass1_bound"] <= var * (1 + cs.CASCADE_BOUND_TOL)).all()
