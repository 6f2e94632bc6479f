"""Semi-supervised improvement study: does teacher distillation beat
label-starved supervised training? (The reference's core recipe,
main/train.py:83-99 with generate_filtered_teacher_labels.py, end to end.)

    python -m hand_integral_pose_estimation_tpu_torch.cli.semi_supervised_study \
        --teacher-steps 3000 --student-steps 1500 --labelled 24 --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.semi_supervised_study \
        --n 12 --labelled 4 --test-n 6 --teacher-steps 2 --student-steps 2 \
        --batch-size 4 --pose-resnet 18 --pose-input 32 --device cpu

Port of hand_integral_pose_estimation_tpu/cli/semi_supervised_study.py, on
the synthetic rendered-joint set (SyntheticFreiHand render_joints=True:
the joints are painted as depth-coded blobs, so pose is learnable from the
pixels):

  1. TEACHER: train on all n labelled images.
  2. BASELINE: train a fresh student on only the K labelled images.
  3. DISTILLED: train a fresh student on the same K labelled images plus
     the other n - K as unlabelled rows whose loss is L1 against the frozen
     teacher (the live-teacher arm, `load_regressor_teacher`,
     main/train.py:83-99).

Both students run the same number of steps; held-out MPJPE (Tester.run ->
evaluate_test_split at the model's input size) decides. Prints one JSON
line per arm and a summary line.
"""

from __future__ import annotations

import argparse
import copy
import json
import tempfile
import time


def subset_view(ds, indices, labelled_mask=None):
    """A shallow per-sample-array subset of a SyntheticFreiHand-contract
    dataset, optionally overriding the labelled mask."""
    import numpy as np

    sub = copy.copy(ds)
    idx = np.asarray(indices)
    sub.images = ds.images[idx]
    sub.joint_cam = ds.joint_cam[idx]
    sub.K = ds.K[idx]
    sub.ref_bone_len = ds.ref_bone_len[idx]
    sub.labelled = (np.asarray(labelled_mask)
                    if labelled_mask is not None else ds.labelled[idx])
    sub.n = len(idx)
    sub.num_labelled = int(sub.labelled.sum())
    sub.num_unlabelled = sub.n - sub.num_labelled
    sub.detector_bbox = (None if ds.detector_bbox is None
                         else ds.detector_bbox[idx])
    return sub


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--n", type=int, default=512,
                   help="total images (labelled pool for the teacher)")
    p.add_argument("--labelled", type=int, default=24,
                   help="labels available to the students (K)")
    p.add_argument("--test-n", type=int, default=128)
    p.add_argument("--teacher-steps", type=int, default=3000)
    p.add_argument("--student-steps", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--pose-resnet", type=int, default=50)
    p.add_argument("--pose-input", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def study_config(args):
    """Config() sized by the flags (cli.train's sizing), the flags' rate
    and no rate decay."""
    import dataclasses

    from hand_integral_pose_estimation_tpu_torch.cli.train import (
        sized_config,
    )

    cfg = sized_config(args.pose_resnet, args.pose_input, args.batch_size)
    return cfg.replace(train=dataclasses.replace(cfg.train, lr=args.lr,
                                                 lr_dec_epoch=()))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import numpy as np

    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_test_split,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester,
        Trainer,
    )
    from hand_integral_pose_estimation_tpu_torch.training.teacher import (
        make_frozen_teacher,
    )

    cfg = study_config(args)
    hw = cfg.model.input_shape
    pool = SyntheticFreiHand(n=args.n, image_hw=hw, seed=args.seed,
                             render_joints=True)
    test_ds = SyntheticFreiHand(n=args.test_n, image_hw=hw,
                                seed=args.seed + 7919, render_joints=True)
    K = args.labelled
    results = {}

    def mpjpe_of(model):
        tester = Tester(cfg, test_ds, model, device=args.device)
        coords, merged = tester.run(batch_size=args.batch_size)
        s = evaluate_test_split(coords, merged, patch_hw=hw)
        return s["mpjpe"], s["pa_mpjpe"]

    def train_arm(name, ds, steps, model_dir, teacher_apply=None):
        t0 = time.time()
        trainer = Trainer(cfg=cfg, dataset=ds, model_dir=model_dir,
                          seed=args.seed, teacher_apply=teacher_apply,
                          device=args.device)
        trainer.fit(end_epoch=1, steps_per_epoch=steps)
        mp, pa = mpjpe_of(trainer.model)
        rec = {"arm": name, "steps": steps, "train_images": ds.n,
               "labelled": int(ds.num_labelled), "mpjpe": round(mp, 5),
               "pa_mpjpe": round(pa, 6),
               "wall_s": round(time.time() - t0, 1)}
        print(json.dumps(rec), flush=True)
        results[name] = rec

    with tempfile.TemporaryDirectory() as work:
        # 1. teacher: every image labelled
        teacher_dir = f"{work}/teacher"
        train_arm("teacher", subset_view(pool, np.arange(args.n),
                                         np.ones(args.n, bool)),
                  args.teacher_steps, teacher_dir)
        # 2. baseline: the K labelled images only
        train_arm("baseline", subset_view(pool, np.arange(K),
                                          np.ones(K, bool)),
                  args.student_steps, f"{work}/baseline")
        # 3. distilled: K labelled + n - K unlabelled with the teacher
        semi_labelled = np.zeros(args.n, bool)
        semi_labelled[:K] = True
        train_arm("distilled", subset_view(pool, np.arange(args.n),
                                           semi_labelled),
                  args.student_steps, f"{work}/distilled",
                  teacher_apply=make_frozen_teacher(cfg, teacher_dir,
                                                    device=args.device))

    ok = results["distilled"]["mpjpe"] < results["baseline"]["mpjpe"]
    print(json.dumps({
        "summary": "semi_supervised_study",
        "teacher_mpjpe": results["teacher"]["mpjpe"],
        "baseline_mpjpe": results["baseline"]["mpjpe"],
        "distilled_mpjpe": results["distilled"]["mpjpe"],
        "improvement_pct": round(100 * (1 - results["distilled"]["mpjpe"]
                                        / results["baseline"]["mpjpe"]), 1),
        "distillation_helps": bool(ok)}), flush=True)
    return results


if __name__ == "__main__":
    main()
