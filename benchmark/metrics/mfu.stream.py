"""A stream request's share of the card's peak: the least time of its
forward (the pose net at the bf16 peak, the float32 detector at the
float32 peak, counted from the configuration's shapes) over the median
time the pipeline took to serve a request (hand-over to joints on the
host) in the window."""

import numpy as np

from benchmark import flops

UNIT = "%"
LAYER = "model step"
MOVES = "serve_p95_ms"


def read(run):
    service = run.window.spans.get("service_ms")
    if not service:
        return None
    config = run.cell.config
    least = (flops.pose_forward_flops(config["model"])
             / flops.PEAK_FLOPS[config["model"]["compute_dtype"]])
    det = config["detector"]
    least += (flops.detector_forward_flops(det, config["data"]["frame_hw"])
              / flops.PEAK_FLOPS[det["compute_dtype"]])
    per_request = least * run.cell.traffic["batch_size"]
    return 100.0 * per_request / (1e-3 * float(np.median(service)))
