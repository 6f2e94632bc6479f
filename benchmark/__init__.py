"""The benchmark of `hand_integral_pose_estimation_tpu_torch` on one GPU.

`run.py` runs one cell of `BENCHMARK.json`. Everything a cell needs is
found by name: its configuration in `configs/`, its traffic mix in
`traffic/`, its limits in `limits/`, and each metric's reader in
`metrics/`. The general code (drivers, reference, counters, trace
reduction) imports nothing of the JAX package; the plain reference in
`reference/` imports nothing of the port either.
"""
