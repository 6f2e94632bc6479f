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
line per arm and a summary line. `run_study` also returns the untrained
net's held-out MPJPE, each arm's ms per train step and its kernel launches
(what `chip_smoke.py`'s phase 8d gates and prints).
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


ARMS = ("teacher", "baseline", "distilled")


def arm_datasets(pool, labelled: int) -> dict:
    """Each arm's training split of the pool, by arm: the teacher's every
    image labelled, the baseline's the first `labelled` images alone, the
    distilled student's every image with only those labelled."""
    import numpy as np

    n = pool.n
    semi_labelled = np.zeros(n, bool)
    semi_labelled[:labelled] = True
    return {
        "teacher": subset_view(pool, np.arange(n), np.ones(n, bool)),
        "baseline": subset_view(pool, np.arange(labelled),
                                np.ones(labelled, bool)),
        "distilled": subset_view(pool, np.arange(n), semi_labelled),
    }


def run_study(args, log=lambda line: print(line, flush=True)):
    """The study at the parsed flags `args`: logs one JSON line per arm and
    the summary line (what `main` prints) and returns

      {"teacher" | "baseline" | "distilled": each arm's logged record,
       "untrained": {"mpjpe", "pa_mpjpe"} of the initial model every
         arm's Trainer starts from (drawn from the seed), scored as the
         arms are,
       "summary": the summary line's fields,
       "train_ms_per_step": {arm: the Trainer's total timer per step, its
         first 10 chunks (the warm-up and the capture) left out; host
         clock},
       "launches": {arm: {kernel symbol: launches}} of the arm's train
         steps and held-out sweep: the wrappers' counts (eager calls) plus
         each captured graph's kernel nodes times its replays,
       "models": {arm: the trained model}}."""
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_test_split,
    )
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
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
    results = {"train_ms_per_step": {}, "launches": {}, "models": {}}

    def counts():
        return {k.symbol: k.launches for k in kernels.KERNELS}

    def mpjpe_of(model, captured):
        tester = Tester(cfg, test_ds, model, device=args.device)
        coords, merged = tester.run(batch_size=args.batch_size)
        captured.append(tester.graphs)
        s = evaluate_test_split(coords, merged, patch_hw=hw)
        return s["mpjpe"], s["pa_mpjpe"]

    def train_arm(name, ds, steps, model_dir, teacher_apply=None):
        t0 = time.time()
        before = counts()
        trainer = Trainer(cfg=cfg, dataset=ds, model_dir=model_dir,
                          seed=args.seed, teacher_apply=teacher_apply,
                          device=args.device)
        captured = [trainer.graphs]
        if name == "teacher":
            # the initial model, outside the arm's wall time
            t_eval = time.time()
            mp, pa = mpjpe_of(trainer.model, captured)
            results["untrained"] = {"mpjpe": mp, "pa_mpjpe": pa}
            t0 += time.time() - t_eval
        trainer.fit(end_epoch=1, steps_per_epoch=steps)
        mp, pa = mpjpe_of(trainer.model, captured)
        rec = {"arm": name, "steps": steps, "train_images": ds.n,
               "labelled": int(ds.num_labelled), "mpjpe": round(mp, 5),
               "pa_mpjpe": round(pa, 6),
               "wall_s": round(time.time() - t0, 1)}
        log(json.dumps(rec))
        results[name] = rec
        results["models"][name] = trainer.model
        results["train_ms_per_step"][name] = (
            trainer.total_timer.average_time * 1e3
            / max(1, trainer.scan_steps))
        launches = {k: v - before[k] for k, v in counts().items()}
        for step in filter(None, captured):
            for k, v in step.kernel_launches().items():
                launches[k] += v
        results["launches"][name] = launches

    arms = arm_datasets(pool, args.labelled)
    with tempfile.TemporaryDirectory() as work:
        # 1. teacher: every image labelled
        teacher_dir = f"{work}/teacher"
        train_arm("teacher", arms["teacher"], args.teacher_steps,
                  teacher_dir)
        # 2. baseline: the K labelled images only
        train_arm("baseline", arms["baseline"], args.student_steps,
                  f"{work}/baseline")
        # 3. distilled: K labelled + n - K unlabelled with the teacher
        train_arm("distilled", arms["distilled"], args.student_steps,
                  f"{work}/distilled",
                  teacher_apply=make_frozen_teacher(cfg, teacher_dir,
                                                    device=args.device))

    ok = results["distilled"]["mpjpe"] < results["baseline"]["mpjpe"]
    results["summary"] = {
        "summary": "semi_supervised_study",
        "teacher_mpjpe": results["teacher"]["mpjpe"],
        "baseline_mpjpe": results["baseline"]["mpjpe"],
        "distilled_mpjpe": results["distilled"]["mpjpe"],
        "improvement_pct": round(100 * (1 - results["distilled"]["mpjpe"]
                                        / results["baseline"]["mpjpe"]), 1),
        "distillation_helps": bool(ok)}
    log(json.dumps(results["summary"]))
    return results


def main(argv=None):
    result = run_study(build_argparser().parse_args(argv))
    return {arm: result[arm] for arm in ARMS}


if __name__ == "__main__":
    main()
