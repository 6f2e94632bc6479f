"""A whole run of each cell on the card, short: the result line's shape
and the device it names."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", "2147483711", "--seconds", "2",
                        "--trace", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert list(result)[-1] == "checks"
