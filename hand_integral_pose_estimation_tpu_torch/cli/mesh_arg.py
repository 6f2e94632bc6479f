"""Shared `--mesh` argument handling for the CLIs.

Port of hand_integral_pose_estimation_tpu/cli/mesh_arg.py, with the same
grammar everywhere: 'auto' | 'none' | '1' | 'data=N[,model=M]', and the
same SystemExit texts. The visible devices are the ranks of the process
group: under `torchrun` its world (each rank one GPU, or one CPU rank with
`--device cpu`), else this one process. Training (cli/train.py) resolves
'auto' through the Trainer's auto mesh; the evaluation and serving CLIs
resolve it here.
"""

from __future__ import annotations

import os
from typing import Optional


def launched() -> bool:
    """Whether this process was started by `torchrun` (or a launcher that
    sets its environment)."""
    return "WORLD_SIZE" in os.environ


def join_launcher(device: str) -> str:
    """Under `torchrun`, join its process group and return this rank's
    device (`parallel.init_distributed`); otherwise return `device`."""
    if not launched():
        return device
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        init_distributed,
    )
    return str(init_distributed(device))


def mesh_layout(arg: str, n_dev: int) -> tuple[int, int]:
    """'data=N[,model=M]' (either axis alone infers the other from the
    `n_dev` visible devices) -> (data, model). Raises SystemExit on a
    malformed spec or one that exceeds the visible devices."""
    spec = {}
    for kv in arg.split(","):
        key, eq, val = kv.partition("=")
        if not eq or key not in ("data", "model") \
                or not val.isdigit() or int(val) < 1:
            raise SystemExit(
                f"--mesh {arg!r}: expected 'auto', 'none', or "
                f"'data=N[,model=M]' (bad token {kv!r})")
        spec[key] = int(val)
    model_par = spec.get("model", 1)
    data_n = spec.get("data", n_dev // model_par)
    if data_n < 1:
        raise SystemExit(
            f"--mesh {arg}: model={model_par} leaves no devices "
            f"for the data axis ({n_dev} visible)")
    if data_n * model_par > n_dev:
        raise SystemExit(
            f"--mesh {arg} needs {data_n * model_par} devices, "
            f"{n_dev} visible")
    return data_n, model_par


def parse_explicit_mesh(arg: str):
    """'data=N[,model=M]' -> (mesh over the first N*M ranks, model
    parallelism). A layout of one rank in a process without a group is
    no mesh (None): there is nothing to shard over."""
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        make_mesh,
        world_size,
    )
    data_n, model_par = mesh_layout(arg, world_size())
    if data_n * model_par == 1 and not launched():
        return None, model_par
    return make_mesh(model_par, ranks=range(data_n * model_par)), model_par


def resolve_eval_mesh(arg: str, batch_size: int,
                      log=print) -> Optional[object]:
    """`--mesh` for evaluation/serving CLIs -> Mesh or None.

    'auto': data-parallel over the largest rank prefix whose size divides
    `batch_size` (None when that is one rank: nothing to shard over).
    'none'/'1': no mesh. Explicit 'data=N[,model=M]': the batch must
    divide the data axis (SystemExit otherwise, matching Tester.run's
    ValueError but failing at argument time)."""
    if arg in ("none", "1"):
        return None
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        make_mesh,
        world_size,
    )

    if arg == "auto":
        n_dev = world_size()
        if n_dev <= 1:
            return None
        data_n = next(d for d in range(min(n_dev, batch_size), 0, -1)
                      if batch_size % d == 0)
        if data_n <= 1:
            return None
        mesh = make_mesh(ranks=range(data_n))
        log(f"eval mesh: data-parallel over {data_n} devices")
        return mesh
    mesh, _ = parse_explicit_mesh(arg)
    if mesh is not None and batch_size % mesh.shape["data"]:
        raise SystemExit(
            f"--mesh {arg}: batch size {batch_size} must divide by the "
            f"data-axis size {mesh.shape['data']}")
    return mesh
