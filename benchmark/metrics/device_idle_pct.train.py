"""Share of the traced window's wall time in which no operation ran on the
device (the union of the trace's kernel, copy and fill intervals)."""

UNIT = "%"
LAYER = "device"
MOVES = "train_images_per_s"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
