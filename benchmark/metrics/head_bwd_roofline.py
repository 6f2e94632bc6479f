"""Kernel 4, the fused head's backward (ops/fused_head.py,
csrc/head_projection_integral_bwd_mma.cu): the roofline's least time of its
work (the logits, dfeat and dW products at the bf16 peak, or its bytes at
the memory's, whichever is longer) over the device time of its kernels in
the traced window."""

from benchmark import flops

UNIT = "%"
LAYER = "kernels"
MOVES = "train_images_per_s"
KERNELS = ("hp_bwd_",)


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    if busy == 0.0:
        return None
    w = run.traced_window
    least = flops.least_seconds(*flops.head_projection(
        w.batch, run.cell.config["model"], backward=True), "bfloat16")
    return 100.0 * w.batches * least / busy
