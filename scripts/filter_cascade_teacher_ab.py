"""The cascade-filter study's teacher in the JAX package and in the port, on
the CPU at one cut setting: does each package's Trainer move the net off the
constant predictor on the study's data, and do the two agree?

Both packages' `cli/filter_cascade_study` train the teacher with their own
`Trainer` on `SyntheticFreiHand(n, seed, render_joints=True)` (bitwise equal
in both packages: tests/test_torch_pose_convergence.py), whose
`labelled_fraction` of 0.5 leaves about half the images without a label
(their loss term pulls the net toward its own output), at `Config`'s batch
32 with Adam at 1e-3 and no decay (the two CLIs hand their Trainers one
config: tests/test_torch_cascade_gate.py). This script builds that Trainer
in one package (`--arm jax | torch`, one a process), trains it, reads its
log lines (`train_logs.txt`, the train-mode s_mpjpe of every 20th step)
and prints one JSON line: the mean s_mpjpe over each window of 100 steps.

The setting is the study's (256 images of seed 0, batch 32, lr 1e-3) cut
to CPU size: R18 at 64^2 (an input/4 heatmap of input/4 depth slots, as
the CLI sizes it), float32 compute in both arms, and 600 of the study's
1 500 steps (the JAX package's train step takes seconds on a CPU). Run
from the repo root, both arms at once:

    JAX_PLATFORMS=cpu taskset -c 0-3 python3 \\
        scripts/filter_cascade_teacher_ab.py --arm jax
    OMP_NUM_THREADS=2 taskset -c 4-5 python3 \\
        scripts/filter_cascade_teacher_ab.py --arm torch
"""

import argparse
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTING = dict(n=256, seed=0, steps=600, resnet=18, hw=64, lr=1e-3,
               compute_dtype="float32")
WINDOW = 100
LINE = re.compile(r"itr (\d+)/\d+ .* s_mpjpe ([0-9.]+)")


def jax_trainer(work):
    import dataclasses

    from hand_integral_pose_estimation_tpu.config import Config
    from hand_integral_pose_estimation_tpu.data.freihand import (
        SyntheticFreiHand,
    )
    from hand_integral_pose_estimation_tpu.training import Trainer

    s, hw = SETTING, (SETTING["hw"], SETTING["hw"])
    cfg = Config()
    # as the JAX CLI sizes its config (cli/filter_cascade_study.py:123-131)
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, resnet_type=s["resnet"], input_shape=hw,
            output_shape=(hw[0] // 4, hw[1] // 4), depth_dim=hw[0] // 4,
            compute_dtype=s["compute_dtype"]),
        train=dataclasses.replace(cfg.train, lr=s["lr"], lr_dec_epoch=()))
    ds = SyntheticFreiHand(n=s["n"], image_hw=hw, seed=s["seed"],
                           render_joints=True)
    return Trainer(cfg=cfg, dataset=ds, model_dir=f"{work}/model",
                   log_dir=work, seed=s["seed"])


def torch_trainer(work):
    import dataclasses

    from hand_integral_pose_estimation_tpu_torch.cli import (
        filter_cascade_study,
    )
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.training import Trainer

    s = SETTING
    args = filter_cascade_study.build_argparser().parse_args(
        ["--pose-resnet", str(s["resnet"]), "--pose-input", str(s["hw"]),
         "--lr", str(s["lr"]), "--seed", str(s["seed"]), "--n", str(s["n"])])
    cfg = filter_cascade_study.study_config(args)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype=s["compute_dtype"]))
    ds = SyntheticFreiHand(n=s["n"], image_hw=cfg.model.input_shape,
                           seed=s["seed"], render_joints=True)
    return Trainer(cfg=cfg, dataset=ds, model_dir=f"{work}/model",
                   log_dir=work, seed=s["seed"], device="cpu")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arm", choices=("jax", "torch"), required=True)
    arm = parser.parse_args().arm
    with tempfile.TemporaryDirectory() as work:
        trainer = (jax_trainer if arm == "jax" else torch_trainer)(work)
        t0 = time.perf_counter()
        trainer.fit(end_epoch=1, steps_per_epoch=SETTING["steps"])
        seconds = time.perf_counter() - t0
        with open(os.path.join(work, "train_logs.txt")) as f:
            points = [(int(m[1]), float(m[2]))
                      for m in map(LINE.search, f) if m]
    windows = {}
    for itr, err in points:
        windows.setdefault(itr // WINDOW * WINDOW, []).append(err)
    print(json.dumps({
        "arm": arm, **SETTING, "batch": trainer.cfg.train.batch_size,
        "fit_s": round(seconds, 1),
        "s_mpjpe_by_window": {w: round(sum(v) / len(v), 4)
                              for w, v in sorted(windows.items())}}),
        flush=True)


if __name__ == "__main__":
    main()
