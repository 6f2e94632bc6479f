"""The general drivers of the port's entries. A traffic mix names its driver
(`"driver"` in `traffic/<mix>.json`); each module here defines `Driver`,
built from the configuration, the mix, the seed and the device, with
`setup()`, `window(seconds, spans)`, `release()` and `check()`."""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch


@dataclasses.dataclass
class Window:
    """What a measured stretch did: its wall seconds, the units of work it
    completed (train steps, frames swept or requests), the images in them
    (no padding rows), the device batches it ran and their size (padding
    rows included), the units whose outputs were not finite, per-request
    latencies, the host's read time, and benchmark spans by name (ms per
    call)."""

    seconds: float
    units: int
    images: int
    batches: int
    batch: int
    failed: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    read_s: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)


class Phases:
    """Seconds of each named phase of a set-up, in order: each `mark`
    closes the phase that began at the last one."""

    def __init__(self):
        self.seconds: list = []
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds.append((name, now - self._last))
        self._last = now


def configure_precision(precision: dict) -> None:
    """The TF32 switches the configuration states, for both products."""
    tf32 = bool(precision.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def port_config(config: dict, traffic: dict):
    """The port's `Config` for a configuration file and a mix."""
    from hand_integral_pose_estimation_tpu_torch.config import (
        Config,
        DetectorConfig,
        ModelConfig,
        TrainConfig,
    )

    m = dict(config["model"])
    for key in ("input_shape", "output_shape"):
        m[key] = tuple(m[key])
    train = dict(config.get("train", {}))
    if "lr_dec_epoch" in train:
        train["lr_dec_epoch"] = tuple(train["lr_dec_epoch"])
    train["batch_size"] = traffic["batch_size"]
    det = DetectorConfig()
    if "detector" in config:
        d = dict(config["detector"])
        for key, v in d.items():
            if isinstance(v, list):
                d[key] = tuple(v)
        det = dataclasses.replace(det, **d)
    return Config(model=ModelConfig(**m), train=TrainConfig(**train),
                  detector=det)


def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gap(got: dict, want: dict, keep=None, reduce=max,
             floor=None) -> float:
    """The worst leaf's gap between two norms (or the leaves' gaps reduced
    by `reduce`): |got - want| over the larger of the reference's norm of
    that leaf and `floor`, by default the median leaf's of those that
    count. `keep` names the leaves that count (all where None); a leaf
    missing from `got` (one the optimizer never stepped) reads 0."""
    names = [k for k in want if keep is None or k in keep]
    if floor is None:
        floor = statistics.median(want[k] for k in names)
    return float(reduce([abs(got.get(k, 0.0) - want[k])
                         / max(want[k], floor, 1e-30) for k in names]))


def norms(tensors: dict) -> dict:
    """Each tensor's 2-norm, in float64 on the host."""
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def release_device() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
