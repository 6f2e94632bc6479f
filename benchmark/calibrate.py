"""Readings for the limits of a cell's compared numbers, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--control fp8|tf32] [--control-seeds 3] [--faults f ...]
        [--fault-seeds 3] [--seconds 3]

For each seed, in one process: the port's run (set-up and, for a served
cell, a short window at the cell's own load) and the numbers its check
compares (the lower reading comes from these); for the first
`--control-seeds` seeds the control, the plain reference computed in the
lower precision and put in the port's place (the upper reading); for the
first `--fault-seeds` seeds each planted fault. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def reading(cell, seed, seconds, device, fault=None, control=None) -> dict:
    t = time.perf_counter()
    driver = harness.make_driver(cell, seed, device, fault)
    driver.setup()
    if cell.traffic["driver"] != "train":
        driver.window(seconds)
    driver.release()
    numbers = (driver.control(control) if control
               else getattr(driver, "readings", driver.check)())
    return {"cell": cell.name, "seed": seed,
            "kind": control or fault or "program", "numbers": numbers,
            "seconds": time.perf_counter() - t}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=())
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        runs = [{}]
        if args.control and i < args.control_seeds:
            runs.append({"control": args.control})
        if i < args.fault_seeds:
            runs += [{"fault": f} for f in args.faults]
        for kw in runs:
            print(json.dumps(reading(cell, seed, args.seconds, "cuda",
                                     **kw)), flush=True)


if __name__ == "__main__":
    main()
