"""The import guard and the run's refusals: no JAX, no card, no port."""

import os
import shutil
import subprocess
import sys

from benchmark import guard, harness

ROOT = harness.ROOT


def test_top_level_names_are_compared_whole():
    assert guard.forbidden(["hand_integral_pose_estimation_tpu_torch",
                            "hand_integral_pose_estimation_tpu_torch.ops",
                            "jaxtyping", "numpy"]) == []
    assert guard.forbidden(["hand_integral_pose_estimation_tpu",
                            "hand_integral_pose_estimation_tpu.config",
                            "jax.numpy", "jaxlib", "flax.linen",
                            "optax"]) == [
        "flax.linen", "hand_integral_pose_estimation_tpu",
        "hand_integral_pose_estimation_tpu.config", "jax.numpy", "jaxlib",
        "optax"]


def _run(code: str, cwd: str = ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_a_run_with_jax_loaded_prints_no_result():
    p = _run("import sys, runpy; sys.modules['jax.numpy'] = object(); "
             "sys.argv = ['run.py', '--workload', 'pose_r50_224.train_b32', "
             "'--seed', '1', '--seconds', '1']; "
             "runpy.run_path('benchmark/run.py', run_name='__main__')")
    assert p.returncode != 0 and p.stdout == ""
    assert "jax.numpy" in p.stderr


def test_a_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "pose_r50_224.train_b32", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "pose_r50_224.train_b32", "--seed", "3",
                        "--seconds", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_the_reference_imports_neither_jax_nor_the_port():
    p = _run("import sys; sys.path.insert(0, '.'); "
             "import benchmark.reference.pose, benchmark.reference.detector; "
             "bad = [m for m in sys.modules if m.split('.')[0] in ("
             "'jax', 'jaxlib', 'flax', 'optax', "
             "'hand_integral_pose_estimation_tpu', "
             "'hand_integral_pose_estimation_tpu_torch')]; print(bad)")
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr
