"""What phase 8e's gate sees: the PyTorch port's cascade-filter study on one
CUDA card, sound and with planted faults.

`chip_smoke.py` (phase 8e) runs `cli/filter_cascade_study.run_study` at
the JAX record's setting (an R50 teacher at 224^2 trained 1 500 steps at
batch 32 on 256 rendered-joint images, then an unseen pool of 512 images
filtered in batches of 8 over 21 rotations at the threshold 1e-4, by the
single pass and by the cascade) and gates it with
`chip_smoke.cascade_gate`. This script runs the same study
(`chip_smoke.run_cascade_study`) sound at each seed given, then at the
first seed with each fault planted by patching the port's functions in
this process (the package's files stay as they are):

- G1, the sweep's rotation undone with the wrong sign:
  `distill/teacher_labels.py:rotation_sweep_camera` passes Rz(-theta) to
  `patch_label_to_camera`;
- G2, a sweep that never rotates: `sweep_thetas` returns zeros, so the 21
  crops of a row are one crop;
- G3, a teacher that was never trained: `training/teacher.py:
  make_frozen_teacher` returns the net at the initial weights of the seed
  and loads no snapshot (as `scripts/pose_convergence_study.py`'s F4);
- G4, the cascade's bound without its n / T factor:
  `distill/cascade.py:CascadeRunner` bounds a row's variance by its
  pass-1 variance itself.

Each run prints the study's lines, the gate's values beside its limits,
ms per train step and which of the gate's checks fail. Run from the repo
root on a machine with a CUDA card:

    python3 scripts/filter_cascade_gate_study.py [--seeds 0 1 2]
"""

import argparse
import contextlib
import os
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from hand_integral_pose_estimation_tpu_torch.distill import (  # noqa: E402
    cascade,
    teacher_labels,
)
from hand_integral_pose_estimation_tpu_torch.ops import kernels  # noqa: E402
from hand_integral_pose_estimation_tpu_torch.training import (  # noqa: E402
    teacher,
)
from pose_convergence_study import (  # noqa: E402
    patched,
    untrained_teacher,
)


def rotation_undone_by_minus_theta(real):
    """`teacher_labels.lbl` whose `patch_label_to_camera` undoes Rz(-theta)
    (the transpose) where the sweep turned the crop by Rz(theta)."""
    def patch_label_to_camera(label, trans_inv, tprime, K, R, *args):
        return real.patch_label_to_camera(label, trans_inv, tprime, K,
                                          R.transpose(-1, -2), *args)
    return types.SimpleNamespace(patch_label_to_camera=patch_label_to_camera)


def no_rotation(_real):
    def sweep_thetas(num_rotations, rotation_range):
        return np.zeros(num_rotations)
    return sweep_thetas


def bound_without_factor(real):
    def __init__(self, *args, **kwargs):
        real(self, *args, **kwargs)
        # the bound is var1 * (n1 / T): n1 = T drops the factor
        self.n1 = self.num_rotations
    return __init__


@contextlib.contextmanager
def both(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def faults(seed):
    """Fresh contexts for the planted faults (a context is used once)."""
    return {
        "G1, the rotation undone with the wrong sign": patched(
            teacher_labels, "lbl", rotation_undone_by_minus_theta),
        "G2, a sweep that never rotates": both(
            patched(teacher_labels, "sweep_thetas", no_rotation),
            patched(cascade, "sweep_thetas", no_rotation)),
        "G3, an untrained teacher": patched(
            teacher, "make_frozen_teacher", untrained_teacher(seed)),
        "G4, the cascade's bound without n / T": patched(
            cascade.CascadeRunner, "__init__", bound_without_factor),
    }


def verdict(name, result, card):
    failed = [n for n, ok in cs.cascade_gate(result).items() if not ok]
    for line in cs.cascade_report(result):
        print(f"[cascade study] {name}: {line}", flush=True)
    print(f"[cascade study] {name}: teacher "
          f"{result['train_ms_per_step']:.3f} ms a train step (host clock), "
          f"cascade stats {result['runner'].stats}; phase 8e's gate "
          f"{'fails: ' + ', '.join(failed) if failed else 'passes'}; on "
          f"{card}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2],
                        help="the sound study's seeds (the faults run at "
                             "the first)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this study needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    card = cs.card_line()
    print(f"[cascade study] {card}", flush=True)
    runs = [(f"sound, seed {s}", s, contextlib.nullcontext())
            for s in args.seeds]
    runs += [(f"{name}, seed {args.seeds[0]}", args.seeds[0], planted)
             for name, planted in faults(args.seeds[0]).items()]
    for name, seed, planted in runs:
        with planted:
            result = cs.run_cascade_study(
                seed=seed,
                log=lambda line, n=name: print(f"[cascade study] {n}: {line}",
                                               flush=True))
            verdict(name, result, card)
        del result
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
