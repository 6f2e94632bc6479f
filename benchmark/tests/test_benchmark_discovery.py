"""A configuration, a traffic mix, a cell and a metric are added as new
files and entries, with no file already there edited, and the harness finds
and runs them."""

import json
import os
import shutil

from benchmark import harness
from conftest import TINY_POSE

READER = '''"""A metric a later change adds: the window's completed units."""

UNIT = "units"
LAYER = "runner"
MOVES = "train_images_per_s"


def read(run):
    return float(run.window.units)
'''


def test_added_files_are_found_and_run(tmp_path):
    root = tmp_path
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    manifest = harness.load_manifest()
    # a configuration (a small copy of the pose one) ...
    config = json.loads((bench / "configs" / "pose_r50_224.json").read_text())
    config["name"] = "pose_tiny"
    config["model"].update(TINY_POSE)
    config["data"].update(training_size=24)
    (bench / "configs" / "pose_tiny.json").write_text(json.dumps(config))
    # ... a mix, a cell's limits and a metric
    mix = json.loads((bench / "traffic" / "train_b32.json").read_text())
    mix["batch_size"] = 4
    (bench / "traffic" / "train_b4.json").write_text(json.dumps(mix))
    limits = json.loads(
        (bench / "limits" / "pose_r50_224.train_b32.json").read_text())
    (bench / "limits" / "pose_tiny.train_b4.json").write_text(json.dumps(
        {k: {"limit": 10.0} for k in limits}))
    (bench / "metrics" / "units_done.py").write_text(READER)
    manifest["configs"].append({
        "name": "pose_tiny", "source": "test", "reduced": [], "why": "test",
        "file": "benchmark/configs/pose_tiny.json"})
    manifest["workloads"].append({
        "name": "pose_tiny.train_b4", "config": "pose_tiny",
        "traffic": "train_b4", "chips": 1, "why": "test"})
    manifest["end_to_end"][1]["workloads"].append("pose_tiny.train_b4")
    manifest["per_layer"].append({
        "name": "units_done", "unit": "units", "better": "higher",
        "source": "program_counter", "layer": "runner",
        "moves": "train_images_per_s", "workloads": ["pose_tiny.train_b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.find_cell("pose_tiny.train_b4", str(root))
    assert cell.config["model"]["resnet_type"] == 18
    assert [m["name"] for m in cell.per_layer] == ["units_done"]
    result = harness.run_cell("pose_tiny.train_b4", 7, 0.2, trace=True,
                              device="cpu", root=str(root))
    assert result["metrics"]["units_done"]["value"] == result["attempted"]
    assert result["correct"]
    e2e = harness.run_cell("pose_tiny.train_b4", 8, 0.2, trace=False,
                           device="cpu", root=str(root))
    assert set(e2e["metrics"]) == {"setup_s", "train_images_per_s"}
    after = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == data for p, data in before.items()
               if "__pycache__" not in p.parts)
