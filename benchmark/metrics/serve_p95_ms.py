"""The 95th percentile of the latency of every request in the window, from
the moment it is handed to the pipeline until its joints are on the host."""

import numpy as np

UNIT = "ms"
LAYER = "end to end"
MOVES = None


def read(run):
    lat = run.window.latencies_ms
    return float(np.percentile(lat, 95)) if lat else None
