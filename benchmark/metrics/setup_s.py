"""Set-up: from the process's start to the first timed unit of work
(imports, the kernel library's load or build, frames and weights drawn on
the device, the port's objects built, the cell's own shapes warmed and
captured)."""

UNIT = "s"
LAYER = "end to end"
MOVES = None


def read(run):
    return run.setup_s
