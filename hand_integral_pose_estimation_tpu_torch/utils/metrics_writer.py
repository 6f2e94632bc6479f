"""Scalar metrics logging: JSONL always, TensorBoard when available.

A copy of hand_integral_pose_estimation_tpu/utils/metrics_writer.py (it
imports no JAX, but the port imports nothing of the JAX package):
observability parity with the reference's pycrayon bridge (base.py:21) and
the PANet trainer's tensorboardX SummaryWriter
(train_pytorch/train_kernel.py:213-235).
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional


class MetricsWriter:
    """Append-mode scalar sink: `events.jsonl` plus tensorboardX if
    importable. Values are coerced to float on write."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "events.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def write(self, step: int, scalars: Mapping[str, float],
              prefix: Optional[str] = None):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}/{k}" if prefix else k
            val = float(v)
            rec[name] = val
            if self._tb is not None:
                self._tb.add_scalar(name, val, int(step))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
