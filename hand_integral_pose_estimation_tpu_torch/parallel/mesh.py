"""The device mesh over `torch.distributed` ranks.

Port of hand_integral_pose_estimation_tpu/parallel/mesh.py. The JAX
package lays its devices out as a (data, model) `jax.sharding.Mesh` and
lets XLA insert the collectives. Here one process drives one GPU (or, on
the CPU, one rank of a gloo group), and a `Mesh` is the same (data, model)
grid of ranks with one process group per data column (the ranks that
share a model coordinate: the gradient and sync-BatchNorm reductions run
over it) and one per model row (the ranks that share a data slice: the
final projection's output channels split over it). The collectives
themselves are in `parallel.collectives`.

The layout rules are the JAX package's:
- the global batch splits over `data` in rank-major order, which equals
  `make_multihost_mesh`'s process-major rows;
- everything is replicated but the final 1x1 heatmap projection, whose
  J*D output channels split over `model` when they divide it (`_leaf_spec`,
  `param_sharding_rules`);
- each rank feeds only its slice of the global batch (`process_batch_size`,
  `shard_host_batch`).

Ranks outside the mesh's grid (a layout smaller than the world, as the
JAX package takes a prefix of its devices) are not members: they belong
to no group of the mesh and take no part in its programs.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import socket
import subprocess
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "model")
#: the module whose weight and bias split over `model` (JAX: "final")
FINAL_PROJECTION = "head.final_layer"


#: the directory that holds the port's package: put on a spawned rank's
#: PYTHONPATH so that `python -m` finds the package from any cwd
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(command: Sequence[str], world: int, cwd: str,
                timeout: float = 600,
                env: Optional[dict] = None) -> list[str]:
    """Run `world` processes of `command` in `cwd`, each with torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT on a free localhost port) over
    this one's, plus `env`, and wait for all of them. Every rank still
    running when the group fails or outlives `timeout` seconds is killed.
    Raises RuntimeError with the failing ranks' output tails if any rank
    exits non-zero; returns each rank's output (stdout and stderr)."""
    port = free_port()
    procs = []
    for rank in range(world):
        rank_env = dict(os.environ, MASTER_ADDR="localhost",
                        MASTER_PORT=str(port), RANK=str(rank),
                        WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                        LOCAL_WORLD_SIZE=str(world),
                        PYTHONPATH=os.pathsep.join(
                            p for p in (_ROOT, os.environ.get("PYTHONPATH"))
                            if p))
        rank_env.update(env or {})
        procs.append(subprocess.Popen(
            list(command), env=rank_env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, timed_out = [], False
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # what the ranks not yet read wrote before they ended or were killed
    logs += [p.communicate()[0] for p in procs[len(logs):]]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"ranks {bad} of {world} failed"
            + (f" (the group outlived {timeout} s)" if timed_out else "")
            + "\n" + "\n".join(f"--- rank {r}\n{logs[r][-4000:]}"
                                 for r in bad))
    return logs


def init_distributed(device: str | torch.device = "cuda") -> torch.device:
    """Join the process group that `torchrun`'s environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) and return
    this rank's device: `cuda:LOCAL_RANK` (modulo the cards there are) or
    the CPU. Without that environment the group is this one process, on a
    free localhost port. Calling it again returns the device and joins
    nothing.

    The backend is `nccl` on CUDA and `gloo` on the CPU, or when the ranks
    of this host outnumber its cards: NCCL refuses two ranks on one GPU.
    With NCCL, async error handling is switched off before the group
    starts (unless the environment sets it), as a CUDA graph that captures
    collectives needs (PyTorch's CUDA-graphs notes on DDP)."""
    device = torch.device(device)
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    world = int(os.environ.get("WORLD_SIZE", 1))
    rank = int(os.environ.get("RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = ("nccl" if device.type == "cuda"
               and local_world <= torch.cuda.device_count() else "gloo")
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    if "MASTER_ADDR" in os.environ:
        init_method = "env://"
    else:
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            device_id=device if backend == "nccl" else None)
    return device


def world_size() -> int:
    """The ranks there are: the process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes logs, metrics and snapshots: rank 0, or
    the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (data, model) grid of ranks (`make_mesh`). `shape` maps each axis
    name to its size, as a JAX mesh's does; `devices` is the grid of
    ranks. For a member rank: its grid coordinates and the groups it
    reduces over; for other ranks those are None."""

    devices: np.ndarray
    rank: int
    group: Optional[dist.ProcessGroup]
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def member(self) -> bool:
        return self.group is not None

    @property
    def coords(self) -> tuple[int, int]:
        """(data index, model index) of this rank."""
        d, m = np.argwhere(self.devices == self.rank)[0]
        return int(d), int(m)

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    @property
    def src(self) -> int:
        """The global rank that holds the mesh's first grid cell."""
        return int(self.devices[0, 0])


def make_mesh(model_parallelism: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """(data, model) mesh over all ranks of the process group (or the
    given ones, in order), model-major within a data row:
    `model_parallelism=1` is pure data parallelism. Every rank of the
    world must call it, in the same order as every other group it makes
    (`torch.distributed.new_group`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.init_distributed() first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if model_parallelism < 1 or n % model_parallelism:
        raise ValueError(f"model_parallelism {model_parallelism} must be "
                         f">= 1 and divide the {n} ranks of the mesh")
    grid = np.array(ranks).reshape(n // model_parallelism,
                                   model_parallelism)
    me = dist.get_rank()
    # every rank makes every group, in one order
    group = dist.new_group(ranks)
    columns = [dist.new_group(grid[:, m].tolist())
               for m in range(grid.shape[1])]
    rows = [dist.new_group(grid[d, :].tolist())
            for d in range(grid.shape[0])]
    if me not in ranks:
        return Mesh(grid, me, None, None, None)
    d, m = np.argwhere(grid == me)[0]
    return Mesh(grid, me, group, columns[m], rows[d])


def make_multihost_mesh(model_parallelism: int = 1) -> Mesh:
    """The mesh over every rank with the JAX package's multi-host layout:
    a model group stays on one host (over NVLink) and the data axis spans
    hosts. With one process per GPU and `torchrun`'s host-major ranks,
    that is `make_mesh` over all ranks once the host's rank count divides
    by the model axis."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    if local % model_parallelism:
        raise ValueError(f"model_parallelism {model_parallelism} must "
                         f"divide the {local} ranks of a host")
    return make_mesh(model_parallelism)


def process_batch_size(global_batch: int, mesh: Optional[Mesh]) -> int:
    """This rank's slice of a global batch: the batch over the data axis
    (the ranks of a model row feed the same rows)."""
    if mesh is None:
        return global_batch
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(f"batch_size {global_batch} must divide by the "
                         f"data-axis size {n}")
    return global_batch // n


def _rows(n: int, mesh: Mesh) -> slice:
    b = n // mesh.shape["data"]
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def shard_host_batch(mesh: Optional[Mesh], batch, batch_axis: int = 0):
    """This rank's rows of a global host batch: a dict or tuple of arrays or
    tensors (None kept), sliced on `batch_axis` (1 for a stacked
    (k, B, ...) chunk). Without a mesh the batch is returned as is."""
    if mesh is None:
        return batch

    def take(x):
        if x is None:
            return None
        index = (slice(None),) * batch_axis + (
            _rows(x.shape[batch_axis], mesh),)
        return x[index]
    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        items = [take(v) for v in batch]
        return type(batch)(*items) if hasattr(batch, "_fields") else tuple(
            items)
    return take(batch)


def _leaf_spec(name: str, shape: tuple, model_size: int) -> Optional[int]:
    """THE sharding policy (JAX `_leaf_spec`): everything replicated but
    the final projection's weight (J*D, F, 1, 1) and bias (J*D,), whose
    output channels (torch's dim 0, the JAX kernel's last axis) split over
    `model` when they divide it. Returns the split dimension or None."""
    if (model_size > 1 and name.startswith(FINAL_PROJECTION + ".")
            and len(shape) >= 1 and shape[0] % model_size == 0):
        return 0
    return None


def param_sharding_rules(mesh: Optional[Mesh], model: nn.Module
                         ) -> dict[str, Optional[int]]:
    """{parameter name: the dimension split over `model`, or None} for
    every parameter of `model` at its whole shapes."""
    size = 1 if mesh is None else mesh.shape["model"]
    return {name: _leaf_spec(name, tuple(p.shape), size)
            for name, p in model.named_parameters()}


def model_slice(mesh: Mesh, n: int) -> slice:
    """This rank's block of `n` channels split over `model`."""
    b = n // mesh.shape["model"]
    return slice(mesh.model_index * b, (mesh.model_index + 1) * b)


def split_params(model: nn.Module) -> dict[str, int]:
    """{parameter name: dimension} of the parameters that `place_state`
    cut to this rank's block (empty for a model laid out whole)."""
    return getattr(model, "_mesh_split", {})


@torch.no_grad()
def place_state(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Lay `model` out on the mesh, in place, before its optimizer is made
    (JAX `place_state`): every parameter and buffer is broadcast from the
    mesh's first rank, then the final projection keeps this rank's block
    of its output channels where `_leaf_spec` splits them, and its input
    gets the model-axis gradient sum (`collectives.copy_to_model`), since
    each rank then projects only its block. Returns `model`."""
    from hand_integral_pose_estimation_tpu_torch.parallel.collectives import (
        copy_to_model,
    )
    for t in itertools.chain(model.parameters(), model.buffers()):
        dist.broadcast(t.data, mesh.src, group=mesh.group)
    split = {name: dim for name, dim in
             param_sharding_rules(mesh, model).items() if dim is not None}
    for name in split:
        module_name, _, pname = name.rpartition(".")
        module = model.get_submodule(module_name)
        p = getattr(module, pname)
        setattr(module, pname, nn.Parameter(
            p.data[model_slice(mesh, p.shape[0])].clone()))
    if split:
        model._mesh_split = split
        model.get_submodule(FINAL_PROJECTION).register_forward_pre_hook(
            lambda mod, args: (copy_to_model(args[0], mesh),))
    return model
