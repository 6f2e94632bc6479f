"""The import guard: no module of JAX, its libraries or the JAX package may
be loaded in a benchmark process.

Names are compared by their top-level part (before the first dot), whole:
`hand_integral_pose_estimation_tpu_torch` is the port and passes, though
its name begins with the JAX package's.
"""

from __future__ import annotations

import sys
from typing import Iterable

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax",
                       "hand_integral_pose_estimation_tpu"})


def forbidden(names: Iterable[str]) -> list[str]:
    """The names among `names` whose top-level part is forbidden, sorted."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def loaded_forbidden() -> list[str]:
    """The forbidden modules this process has loaded."""
    return forbidden(list(sys.modules))
