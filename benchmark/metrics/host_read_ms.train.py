"""The host's read of a training batch (sampling the rows and stacking
them), the Trainer's own `read_timer`, per step of the window."""

UNIT = "ms"
LAYER = "runner"
MOVES = "train_images_per_s"


def read(run):
    if run.cell.traffic["driver"] != "train":
        return None
    return 1e3 * run.window.read_s / run.window.units
