"""Frames whose outputs reached the host in the window, over the window's
wall time; padding rows do not count. Not read in a cell whose mix offers
a fixed rate (the rate would pin it)."""

UNIT = "images/s"
LAYER = "end to end"
MOVES = None


def read(run):
    if run.cell.traffic["driver"] == "train" or "rate_per_s" in run.cell.traffic:
        return None
    return run.window.images / run.window.seconds
