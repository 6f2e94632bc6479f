"""The served forward's share of the card's bf16 peak: the least time of
one image's pose forward, counted from the configuration's shapes, over
the measured time per image of the untraced window."""

from benchmark import flops

UNIT = "%"
LAYER = "model step"
MOVES = "serve_images_per_s"


def read(run):
    if run.cell.traffic["driver"] == "train" or "rate_per_s" in run.cell.traffic:
        return None
    model = run.cell.config["model"]
    least = (flops.pose_forward_flops(model)
             / flops.PEAK_FLOPS[model["compute_dtype"]])
    return 100.0 * least * run.window.images / run.window.seconds
