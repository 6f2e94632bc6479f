"""The whole training step's share of the card's bf16 peak: the model
operations of a step (the forward and the backward) counted from the
configuration's shapes, at the rate of the untraced window."""

from benchmark import flops

UNIT = "%"
LAYER = "model step"
MOVES = "train_images_per_s"


def read(run):
    if run.cell.traffic["driver"] != "train":
        return None
    model = run.cell.config["model"]
    per_image = flops.pose_train_flops(model)
    rate = run.window.images / run.window.seconds
    return 100.0 * per_image * rate / flops.PEAK_FLOPS["bfloat16"]
