"""CUDA-graph replay of the runners' device programs.

The counterpart of the JAX Trainer's `_make_scan_train` (`scan_steps`
train steps as one `lax.scan` program, training/trainer.py:242-255) and of
its jitted eval step. A `CapturedStep` wraps a function of a dict of
device tensors: the host arrays it is given (numpy, fixed shapes) are
packed into one pinned buffer and copied to static device buffers with one
host-to-device copy, and the function runs as one replay of a captured
`torch.cuda.CUDAGraph`. For the Trainer the arrays are a stacked chunk laid
out (k, B, ...) as JAX's `stacked_host`, and the function runs k train
steps; for the Tester they are one batch and the function is the eval step.

The first call at each input layout runs the function eagerly on a side
stream: it builds the kernel library, creates the optimizer's state and
settles cuDNN's choice of algorithms, and its result is a real one. The
second call captures the function once and replays it; later calls only
copy and replay. A graph reads its static buffers and the parameters,
buffers and optimizer state in place, so replays follow the training
state. Random draws come from generators registered with each graph, so
replays draw what eager calls would draw, and a `manual_seed` between
replays takes effect. A capture or replay that fails raises: nothing is
retried eagerly.
"""

from __future__ import annotations

import collections
import gc
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from hand_integral_pose_estimation_tpu_torch.ops import kernels


def _map_tensors(fn: Callable[[torch.Tensor], object], tree):
    """`fn` applied to a tensor, or to each tensor of a nest of tuples and
    NamedTuples (None kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_map_tensors(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree


def _layout(host: Mapping[str, Optional[np.ndarray]]) -> tuple:
    return tuple((k, None if v is None else (v.shape, v.dtype.str))
                 for k, v in host.items())


class _Staging:
    """Static device buffers for one input layout, packed into one byte
    buffer (16-byte aligned slots) so one copy fills them all."""

    def __init__(self, host: Mapping[str, Optional[np.ndarray]],
                 device: torch.device):
        self.slots = {}
        size = 0
        for key, v in host.items():
            if v is not None:
                self.slots[key] = (size, v.nbytes, v.dtype, v.shape)
                size += -(-v.nbytes // 16) * 16
        self.size = size
        self.buffer = torch.empty(size, dtype=torch.uint8, device=device)
        self.tensors = {key: None for key in host}
        for key, (off, n, dtype, shape) in self.slots.items():
            tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
            self.tensors[key] = self.buffer[off:off + n].view(tdtype).view(
                shape)

    def fill(self, host: Mapping[str, Optional[np.ndarray]]) -> None:
        """Pack `host` into a fresh pinned buffer and copy it to the card
        on the current stream. The pinned block is not reused before the
        copy is done (the host allocator records the copy's event)."""
        pinned = torch.empty(self.size, dtype=torch.uint8, pin_memory=True)
        staged = pinned.numpy()
        for key, (off, n, dtype, shape) in self.slots.items():
            np.copyto(staged[off:off + n].view(dtype).reshape(shape),
                      host[key], casting="no")
        self.buffer.copy_(pinned, non_blocking=True)


class CapturedStep:
    """`fn(tensors) -> outputs` on the card, one CUDA-graph replay a call
    (see the module docstring). `fn` takes a dict of device tensors (None
    where the host array is None) and returns a tensor or tensors in
    tuples and NamedTuples; each call returns copies of them.
    `generators`: the CUDA generators `fn` draws from. `graphs` maps each
    captured input layout to its graph, `replays` counts each one's
    replays."""

    def __init__(self, fn: Callable[[dict], object], device: torch.device,
                 generators: Iterable[torch.Generator] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.replays: collections.Counter = collections.Counter()
        self.graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self._staging: dict[tuple, _Staging] = {}
        self._outputs: dict[tuple, object] = {}

    def __call__(self, host: Mapping[str, Optional[np.ndarray]]):
        layout = _layout(host)
        staging = self._staging.get(layout)
        first = staging is None
        if first:
            staging = self._staging[layout] = _Staging(host, self.device)
        with torch.cuda.device(self.device):
            staging.fill(host)
            if first:
                return self._eager(staging.tensors)
            graph = self.graphs.get(layout)
            if graph is None:
                graph = self._capture(layout, staging.tensors)
            graph.replay()
            self.replays[layout] += 1
            return _map_tensors(torch.clone, self._outputs[layout])

    def kernel_launches(self) -> dict[str, int]:
        """Launches of each kernel entry point (by C symbol) that the
        replays so far made: each graph's kernel nodes
        (`kernels.graph_launches`) times its replays. The wrappers' own
        counters see only the eager calls."""
        total = collections.Counter()
        for layout, n in self.replays.items():
            for symbol, per in kernels.graph_launches(
                    self.graphs[layout]).items():
                total[symbol] += n * per
        return {k.symbol: total[k.symbol] for k in kernels.KERNELS}

    def _eager(self, tensors: dict):
        """The warm-up: one eager call on a side stream, as
        torch.cuda.graph asks before a capture."""
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(tensors)
        current.wait_stream(side)
        # copies, as a replay's: outputs may be the static input buffers
        return _map_tensors(lambda t: (t.record_stream(current),
                                       t.clone())[1], out)

    def _capture(self, layout: tuple, tensors: dict) -> torch.cuda.CUDAGraph:
        # keep_graph: the graph's nodes stay readable (kernels.graph_launches)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self.generators:
            graph.register_generator_state(g)
        # no garbage collection while capturing: an unreachable graph or
        # pinned buffer freed mid-capture would make a call that capture
        # forbids (torch.cuda.graph collects before it begins)
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = self.fn(tensors)
        finally:
            if enabled:
                gc.enable()
        self.graphs[layout] = graph
        self._outputs[layout] = out
        return graph
