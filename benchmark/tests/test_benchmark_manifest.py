"""BENCHMARK.json against the rules of its format (keys, names, sizes), and
every name it holds against the files the harness finds by that name."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"][:2] == ["python3", "benchmark/run.py"]
    assert all(one_line(w) for w in MANIFEST["command"])
    assert MANIFEST["paths"] == ["benchmark"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text():
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    for w in MANIFEST["workloads"]:
        names += [w["config"], w["traffic"]]
        assert w["chips"] in (1, 4) and one_line(w["why"])
    for c in MANIFEST["configs"]:
        names += c["reduced"]
        assert len(c["reduced"]) <= 16
        assert one_line(c["source"]) and one_line(c["why"])
    assert all(NAME.match(n) for n in names), [n for n in names
                                               if not NAME.match(n)]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = [e["name"] for e in MANIFEST[group]]
        assert len(entries) == len(set(entries))


def test_entries_have_only_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert one_line(m["layer"])


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    end_to_end = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in end_to_end
    for cell in cells:
        e2e = {m["name"] for m in MANIFEST["end_to_end"]
               if harness.applies(m, cell)}
        layer = [m for m in MANIFEST["per_layer"] if harness.applies(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            # a per-layer metric moves an end-to-end metric its cells report
            assert m["moves"] in e2e
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("spec", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_matches_its_entry(spec):
    reader = harness.load_reader(spec["name"])
    assert reader.UNIT == spec["unit"]
    if "moves" in spec:
        assert (reader.LAYER, reader.MOVES) == (spec["layer"], spec["moves"])
    assert callable(reader.read)


@pytest.mark.parametrize("workload", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(workload):
    cell = harness.find_cell(workload["name"])
    assert cell.config["name"] == workload["config"]
    assert os.path.exists(os.path.join(
        harness.BENCH_DIR, "drivers", f"{cell.traffic['driver']}.py"))
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    entry = configs[workload["config"]]
    assert entry["file"].startswith("benchmark/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        assert json.load(f)["reduced"] == entry["reduced"]
