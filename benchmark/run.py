"""Run one cell of the benchmark of `hand_integral_pose_estimation_tpu_torch`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. The last line
of standard output is the result as one JSON object; the compared numbers
and their limits are the last lines of standard error. Without a card, or
with a module of JAX or of the JAX package loaded, it prints no result and
exits with a code other than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark import guard  # noqa: E402


def refuse(message: str, code: int) -> None:
    print(f"benchmark: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def check_guard(when: str) -> None:
    found = guard.loaded_forbidden()
    if found:
        refuse(f"forbidden modules loaded {when}: {', '.join(found)}", 4)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    check_guard("at start")

    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    chips = next(w["chips"] for w in harness.load_manifest()["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available():
        refuse("torch.cuda.is_available() is false", 3)
    if torch.cuda.device_count() < chips:
        refuse(f"{args.workload} needs {chips} cards, "
               f"{torch.cuda.device_count()} visible", 3)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0,
                              cell=cell)
    check_guard("after the window")
    for name, seconds in result.pop("setup_phases"):
        print(f"setup {name} {seconds:.3f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
