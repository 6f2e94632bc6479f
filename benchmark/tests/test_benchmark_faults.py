"""Each cell's check, driven through a whole run at a tiny size on the CPU
with the timed path broken underneath, comes out not correct; the same run
unbroken comes out correct. The control, the reference in the precision
below the configuration's put in the port's place, is judged too.

A run's sound readings at these sizes are taken with the port in float32,
so that they lie far below the cells' limits, which were set on the card
at the cells' own sizes."""

import pytest

from benchmark import harness
from conftest import tiny

FAULTS = [("pose_r50_224.train_b32", "unchanged"),
          ("pose_r50_224.train_b32", "half_batch"),
          ("pose_r50_224.train_b32", "head_grad"),
          ("pose_r50_224.eval_b32", "altered"),
          ("two_stage_r101c4_600.serve_b4", "altered")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = tiny(name, dtype="float32")
    broken = harness.run_cell(name, 4000000007, 0.2, trace=False,
                              device="cpu", cell=cell, fault=fault)
    assert not broken["correct"], broken["checks"]


@pytest.mark.parametrize("name", sorted({n for n, _ in FAULTS}))
def test_a_sound_run_is_correct(name):
    cell = tiny(name, dtype="float32")
    sound = harness.run_cell(name, 4000000007, 0.2, trace=False,
                             device="cpu", cell=cell)
    assert sound["correct"], sound["checks"]
    assert list(sound)[-1] == "checks"


CONTROLS = [("pose_r50_224.train_b32", "fp8"),
            ("pose_r50_224.eval_b32", "fp8"),
            ("two_stage_r101c4_600.serve_b4", "tf32,fp8")]


@pytest.mark.parametrize("name,precision", CONTROLS)
def test_the_control_is_not_correct(name, precision):
    """The reference in the precision below the configuration's, put in the
    port's place, fails the cell's limits (on the card at the cell's size:
    `calibrate.py --control`, readings in PERF.md)."""
    cell = tiny(name)
    driver = harness.make_driver(cell, 4000000009, "cpu")
    driver.setup()
    driver.window(0.2)
    driver.release()
    correct, checks = harness.judge(
        {k: v for k, v in driver.control(precision).items()
         if k in cell.limits}, cell.limits)
    assert not correct, checks
