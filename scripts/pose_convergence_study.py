"""What phase 8d's learning gate sees that phases 5 and 8 cannot: the
PyTorch port's semi-supervised pose study on one CUDA card, sound and with
planted faults.

`chip_smoke.py` (phase 8d) runs `cli/semi_supervised_study.run_study` at
the JAX record's setting (R50 at 224^2 in bf16, a teacher of 3 000 steps on
512 rendered-joint images, a baseline of 1 500 steps on 24 of them, a
distilled student of 1 500 steps on those 24 and 488 unlabelled images
against the frozen teacher; held-out MPJPE on 128 images) and gates it
with `chip_smoke.pose_learning_gate`. This script runs the same study
(`chip_smoke.run_pose_study`) sound at each seed given, then at the first
seed with each fault planted by patching the port's functions in this
process (the package's files stay as they are):

- F1, kernel 4's feature gradient zeroed: the fused head's backward
  (`ops/fused_head.py:head_projection_integral_bwd_cuda`) returns dfeat
  x 0, so only the final projection learns;
- F2, the labels out of the image's frame: `data/pipeline.py:_labels_one`
  forms the labels, the crop box and the teacher label under the
  transposed rotation R^T while kernel 5 still warps the image by the
  homography of R (eval batches, R = I, are unchanged);
- F3, the teacher term off: `losses.combined_loss` weights the unlabelled
  rows' loss 0;
- F4, a teacher that was never trained: `training/teacher.py:
  make_frozen_teacher` returns the net at the initial weights of the seed
  and loads no snapshot.

Each run prints the study's records and summary line, the untrained
MPJPE, the label-space fits (`chip_smoke.pose_label_fits`), ms per train
step of each arm and which of the gate's checks fail.
Run from the repo root on a machine with a CUDA card:

    python3 scripts/pose_convergence_study.py [--seeds 0 1 2]
"""

import argparse
import contextlib
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from hand_integral_pose_estimation_tpu_torch import losses  # noqa: E402
from hand_integral_pose_estimation_tpu_torch.data import (  # noqa: E402
    pipeline,
)
from hand_integral_pose_estimation_tpu_torch.models import (  # noqa: E402
    get_pose_net,
)
from hand_integral_pose_estimation_tpu_torch.ops import (  # noqa: E402
    fused_head,
    kernels,
)
from hand_integral_pose_estimation_tpu_torch.training import (  # noqa: E402
    teacher,
)


@contextlib.contextmanager
def patched(module, name, make):
    """`module.name` replaced by `make(the original)` inside the block."""
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def dfeat_zeroed(real):
    def bwd(*args):
        dfeat, dW, db = real(*args)
        return dfeat * 0, dW, db
    return bwd


def labels_under_transpose(real):
    def labels_one(jc, K, bb_det, teacher_jcn, R, acfg, patch_hw):
        out, label_teacher, bb, _ = real(jc, K, bb_det, teacher_jcn,
                                         R.transpose(-1, -2), acfg, patch_hw)
        H_total = real(jc, K, bb_det, teacher_jcn, R, acfg, patch_hw)[3]
        return out, label_teacher, bb, H_total
    return labels_one


def teacher_term_off(real):
    def combined_loss(coord_out, *args, **kwargs):
        out = real(coord_out, *args, **kwargs)
        return out._replace(loss=(out.loss_supervised
                                  + 0.0 * out.loss_unsupervised)
                            / coord_out.shape[0])
    return combined_loss


def untrained_teacher(seed):
    def make(_real):
        def make_frozen_teacher(cfg, model_dir, epoch=None, device="cuda"):
            model = get_pose_net(cfg.model, generator=torch.Generator()
                                 .manual_seed(seed)).to(device)
            return teacher.frozen_teacher(model, cfg)
        return make_frozen_teacher
    return make


def faults(seed):
    """Fresh contexts for the planted faults (a context is used once)."""
    return {
        "F1, kernel 4's dfeat x 0": patched(
            fused_head, "head_projection_integral_bwd_cuda", dfeat_zeroed),
        "F2, the labels under R^T": patched(
            pipeline, "_labels_one", labels_under_transpose),
        "F3, the teacher term weighted 0": patched(
            losses, "combined_loss", teacher_term_off),
        "F4, an untrained teacher": patched(
            teacher, "make_frozen_teacher", untrained_teacher(seed)),
    }


def verdict(name, result, card):
    mp = {arm: result[arm]["mpjpe"] for arm in ("teacher", "baseline",
                                                "distilled")}
    failed = [n for n, ok in cs.pose_learning_gate(result).items() if not ok]
    gain = (1 - mp["distilled"] / mp["baseline"]
            if math.isfinite(mp["baseline"]) and mp["baseline"] else
            float("nan"))
    print(f"[pose study] {name}: held-out MPJPE teacher {mp['teacher']}, "
          f"baseline {mp['baseline']}, distilled {mp['distilled']} "
          f"({100 * gain:.1f} % below the baseline), untrained "
          f"{result['untrained']['mpjpe']:.5f}; label-space MPJPE by arm "
          f"and split "
          f"{ {a: {k: round(v, 5) for k, v in f.items()} for a, f in result['fits'].items()} }"
          f"; ms per train step "
          f"{ {a: round(v, 3) for a, v in result['train_ms_per_step'].items()} }"
          f"; phase 8d's gate "
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
    print(f"[pose study] {card}", flush=True)
    runs = [(f"sound, seed {s}", s, contextlib.nullcontext())
            for s in args.seeds]
    runs += [(f"{name}, seed {args.seeds[0]}", args.seeds[0], planted)
             for name, planted in faults(args.seeds[0]).items()]
    for name, seed, planted in runs:
        with planted:
            result = cs.run_pose_study(
                seed=seed,
                log=lambda line, n=name: print(f"[pose study] {n}: {line}",
                                               flush=True))
        verdict(name, result, card)
        del result
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
