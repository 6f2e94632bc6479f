"""tic/toc timers with warmup.

A copy of hand_integral_pose_estimation_tpu/utils/timers.py (the
reference's common/timer.py:20-38). The Trainer keeps three for its life
(total, read, step; JAX training/trainer.py:218-220), so the first
`warmup` chunks, which on the card hold the eager warm-up and the CUDA
graph's capture (`training.graphs`), stay out of the averages it logs.
"""

from __future__ import annotations

import time


class Timer:
    """Running average that ignores the first `warmup` measurements."""

    def __init__(self, warmup: int = 10):
        self.warmup = warmup
        self.reset()

    def reset(self):
        self.calls = 0
        self.total_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0
        self._start = 0.0

    def tic(self):
        self._start = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        """Seconds since `tic`. Returns the running average (`average`) or
        this measurement; while warming up, the average is this
        measurement."""
        self.diff = time.perf_counter() - self._start
        self.calls += 1
        if self.calls <= self.warmup:
            # warmup: report instantaneous time, don't pollute the average
            self.average_time = self.diff
            return self.diff if not average else self.average_time
        self.total_time += self.diff
        self.average_time = self.total_time / (self.calls - self.warmup)
        return self.average_time if average else self.diff
