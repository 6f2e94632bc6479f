"""Cascade-filter study: the pass-1 survival rate, and the speedup, of the
exact early-reject cascade (distill/cascade.py) with a trained teacher.

    python -m hand_integral_pose_estimation_tpu_torch.cli.filter_cascade_study \
        --teacher-steps 1500 --n 256 --pool 512 --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.filter_cascade_study \
        --n 8 --pool 16 --teacher-steps 2 --batch-size 4 --pose-resnet 18 \
        --pose-input 32 --device cpu

Port of hand_integral_pose_estimation_tpu/cli/filter_cascade_study.py, in
the synthetic rendered-joint world of cli.semi_supervised_study:

  1. Train a teacher on `--n` labelled images (or reuse `--model-dir`).
  2. Filter an unseen pool of `--pool` unlabelled images twice, (a) single
     pass, all 21 rotations for every sample, and (b) the cascade
     (`--cascade-pass1` rotations, then the exact early-reject bound); each
     sweep runs twice and the second, warm, is timed: with CUDA events on
     the card (from before the first batch to after the last, the host's
     work between batches included), with the host clock on the CPU. The
     keep sets must be equal.
  3. Report the keep rate, the pass-1 survival f, both times, and a
     threshold sweep (keep rate and survival against the variance
     threshold) from the stored variances and pass-1 lower bounds.

Prints one JSON line per phase and a summary line.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--n", type=int, default=256,
                   help="labelled images the teacher trains on")
    p.add_argument("--pool", type=int, default=512,
                   help="unlabelled images to filter")
    p.add_argument("--teacher-steps", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--cascade-pass1", type=int, default=5)
    p.add_argument("--variance-threshold", type=float, default=1e-4)
    p.add_argument("--rotation-mode", choices=("factored", "composed"),
                   default="factored")
    p.add_argument("--pose-resnet", type=int, default=50)
    p.add_argument("--pose-input", type=int, default=224)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-dir", default=None,
                   help="reuse an existing teacher snapshot dir instead of "
                        "training one")
    p.add_argument("--device", default="cuda")
    return p


def pool_batches(ds, cfg, batch_size: int, device):
    """Fixed-shape (images, K, bbox, labelled, joint_cam, rows) device
    batches of the whole pool (the tail padded; rows < 0 mark padding), the
    boxes from the projected gt joints as cli.generate_teacher_labels makes
    them."""
    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.data import padded_batches
    from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels \
        import camera_project
    from hand_integral_pose_estimation_tpu_torch.geometry import bbox as bb

    out = []
    for idx in padded_batches(len(ds), batch_size):
        start = int(idx[0])
        host = ds.host_batch(idx)
        images, K, joint_cam = (
            torch.from_numpy(np.ascontiguousarray(host[k])).to(device)
            for k in ("image", "K", "joint_cam"))
        if host["bbox_detector"] is not None:
            box = torch.from_numpy(host["bbox_detector"]).to(device)
        else:
            uv, _, _ = camera_project(joint_cam, K)
            box = bb.bbox_from_keypoints(uv, torch.ones_like(uv[..., 0]),
                                         pad_factor=cfg.augment.pad_factor)
        rows = np.where(idx == start + np.arange(batch_size), idx, -1)
        out.append((images, K, box,
                    torch.zeros(batch_size, dtype=torch.bool, device=device),
                    joint_cam, rows))
    return out


def timed(fn, device):
    """(fn(), seconds): CUDA events around the call on the card, the host
    clock otherwise."""
    import torch

    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.cli.semi_supervised_study \
        import study_config
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.distill import (
        CascadeRunner,
        generate_filtered_labels,
    )
    from hand_integral_pose_estimation_tpu_torch.training import Trainer
    from hand_integral_pose_estimation_tpu_torch.training.teacher import (
        make_frozen_teacher,
    )

    cfg = study_config(args)
    hw = cfg.model.input_shape
    device = torch.device(args.device)

    with tempfile.TemporaryDirectory() as work:
        # 1. the teacher
        model_dir = args.model_dir
        if model_dir is None:
            t0 = time.time()
            train_ds = SyntheticFreiHand(n=args.n, image_hw=hw,
                                         seed=args.seed, render_joints=True)
            model_dir = f"{work}/teacher"
            Trainer(cfg=cfg, dataset=train_ds, model_dir=model_dir,
                    seed=args.seed, device=device).fit(
                end_epoch=1, steps_per_epoch=args.teacher_steps)
            print(json.dumps({"phase": "teacher",
                              "steps": args.teacher_steps, "images": args.n,
                              "wall_s": round(time.time() - t0, 1)}),
                  flush=True)
        teacher_apply = make_frozen_teacher(cfg, model_dir, device=device)

    # 2. the unlabelled pool (an unseen seed)
    pool = SyntheticFreiHand(n=args.pool, image_hw=hw,
                             seed=args.seed + 104729, render_joints=True)
    batches = pool_batches(pool, cfg, args.batch_size, device)
    t = cfg.train
    sweep = dict(num_rotations=t.teacher_num_rotations,
                 rotation_range=t.teacher_rotation_range,
                 variance_threshold=args.variance_threshold,
                 patch_hw=hw, rotation_mode=args.rotation_mode)

    @torch.no_grad()
    def sweep_single():
        outs = [(generate_filtered_labels(teacher_apply, im, K, bb, lab, jc,
                                          cfg.augment, **sweep), rows)
                for im, K, bb, lab, jc, rows in batches]
        keep = np.concatenate([o.keep.cpu().numpy()[rows >= 0]
                               for o, rows in outs])
        var = np.concatenate([o.variance.cpu().numpy()[rows >= 0]
                              for o, rows in outs])
        return keep, var

    runner = CascadeRunner(teacher_apply, cfg.augment,
                           pass1_rotations=args.cascade_pass1,
                           pass2_batch=args.batch_size, device=device,
                           **sweep)

    def sweep_cascade():
        runner.reset()
        for im, K, bb, lab, jc, rows in batches:
            runner.add_batch(im, K, bb, lab, jc, rows)
        return runner.finalize(args.pool)

    # warm both, then time the second sweep of each
    sweep_single()
    (keep1, var1), wall_single = timed(sweep_single, device)
    sweep_cascade()
    merged, wall_cascade = timed(sweep_cascade, device)
    if not np.array_equal(merged["keep"], keep1):
        raise AssertionError(
            f"cascade keep set diverged from single-pass: "
            f"{int((merged['keep'] != keep1).sum())} rows differ")

    f = float(1.0 - merged["early_rejected"].mean())
    rec = {
        "phase": "filter",
        "pool": args.pool,
        "rotations": t.teacher_num_rotations,
        "pass1_rotations": args.cascade_pass1,
        "variance_threshold": args.variance_threshold,
        "keep_rate": round(float(keep1.mean()), 4),
        "pass1_survival": round(f, 4),
        "keep_sets_equal": True,
        "timer": "cuda events" if device.type == "cuda" else "host clock",
        "wall_single_s": round(wall_single, 4),
        "wall_cascade_s": round(wall_cascade, 4),
        "wall_speedup": round(wall_single / wall_cascade, 2),
    }
    print(json.dumps(rec), flush=True)

    # threshold sweep from the stored per-sample quantities (no device
    # work): keep rate from the single pass's exact variance, pass-1
    # survival from the cascade's stored lower bound (a row survives pass 1
    # at threshold t iff bound <= t (1 + safety))
    bound = merged["pass1_bound"]
    grid = sorted({args.variance_threshold * s
                   for s in (0.1, 0.3, 1.0, 3.0, 10.0)})
    print(json.dumps({"phase": "threshold_sweep", "grid": [
        {"threshold": float(f"{th:.2g}"),
         "keep_rate": round(float((var1 < th).mean()), 4),
         "pass1_survival": round(
             float((bound <= th * (1 + runner.safety)).mean()), 4)}
        for th in grid]}), flush=True)
    print(json.dumps({
        "summary": "filter_cascade_study",
        "keep_rate": rec["keep_rate"],
        "pass1_survival": rec["pass1_survival"],
        "wall_speedup": rec["wall_speedup"]}), flush=True)
    return rec


if __name__ == "__main__":
    main()
