"""Images of every train step completed in the window, over the window's
wall time; the window ends in the synchronisation that brings the last
step's metrics to the host."""

UNIT = "images/s"
LAYER = "end to end"
MOVES = None


def read(run):
    if run.cell.traffic["driver"] != "train":
        return None
    return run.window.images / run.window.seconds
