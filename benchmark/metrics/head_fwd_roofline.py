"""Kernel 3, the fused head's forward (ops/fused_head.py,
csrc/head_projection_integral_mma.cu): the roofline's least time of its
work (one product at the bf16 peak, or its bytes at the memory's) over the
device time of its kernels in the traced window."""

from benchmark import flops

UNIT = "%"
LAYER = "kernels"
MOVES = "serve_images_per_s"
KERNELS = ("hp_fwd_", "merge_chunks")


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    if busy == 0.0:
        return None
    w = run.traced_window
    least = flops.least_seconds(*flops.head_projection(
        w.batch, run.cell.config["model"]), "bfloat16")
    return 100.0 * w.batches * least / busy
