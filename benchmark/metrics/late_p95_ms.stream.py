"""How late the stream's requests were handed to the pipeline: the 95th
percentile, over the window, of the wait between a request's due time and
its hand-over (the one before it still running)."""

import numpy as np

UNIT = "ms"
LAYER = "runner"
MOVES = "serve_p95_ms"


def read(run):
    late = run.window.spans.get("late_ms")
    return float(np.percentile(late, 95)) if late else None
