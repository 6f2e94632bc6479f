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

Prints one JSON line per phase and a summary line. `run_study` also
returns the per-row variances, keep flags and pass-1 bounds, the teacher
and the pool (what `chip_smoke.py`'s phase 8e gates).
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


def study_config(args):
    """Config() sized by the flags as the JAX CLI sizes it: the ResNet
    depth, a square input with an input/4 heatmap of input/4 depth slots,
    the flags' rate and no rate decay. `--batch-size` sizes the pool's
    batches and pass 2 alone: the teacher trains at Config's batch (32),
    as the JAX CLI's does."""
    import dataclasses

    from hand_integral_pose_estimation_tpu_torch.cli.train import (
        sized_config,
    )

    cfg = sized_config(args.pose_resnet, args.pose_input)
    return cfg.replace(train=dataclasses.replace(cfg.train, lr=args.lr,
                                                 lr_dec_epoch=()))


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


def run_study(args, log=lambda line: print(line, flush=True)):
    """The study at the parsed flags `args`: logs the lines `main` prints
    (the teacher's, the filter's, the threshold sweep's and the summary)
    and returns what they were made from:

      {"filter": the filter line's record, "grid": the threshold sweep's
         rows, "summary": the summary line's fields,
       "keep_sets_equal": whether the cascade kept the single pass's rows,
       "keep", "variance": the single pass's per-row keep flags and
         variances over the pool (numpy),
       "pseudo_label", "gt_label": the warm-up single pass's per-row
         pseudo-labels (the mean over the rotations) and the ground truth
         normalised as a labelled row's (numpy),
       "merged": `CascadeRunner.finalize` of the timed cascade sweep
         (`pass1_bound`, `early_rejected`, ...), "runner": the runner,
       "teacher_apply": the frozen teacher the filter ran,
       "teacher_model": the trained net (the snapshot's with
         `--model-dir`), "cfg": the study's Config,
       "batches": the pool's device batches (`pool_batches`),
       "wall_single_s", "wall_cascade_s": both warm sweeps' times,
       "train_ms_per_step": the teacher Trainer's total timer per step,
         its first 10 chunks (the warm-up and the capture) left out; host
         clock, and "train_s" the whole fit's time, as the sweeps' are
         timed (both None with `--model-dir`),
       "launches": {kernel symbol: launches} of the study: the wrappers'
         counts plus the Trainer's graph kernel nodes times replays}.

    A keep set that differs between the sweeps is returned, not raised:
    `main` raises on it."""
    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.distill import (
        CascadeRunner,
        generate_filtered_labels,
    )
    from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels \
        import gt_normalized
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.training import (
        Trainer,
        teacher,
    )

    cfg = study_config(args)
    hw = cfg.model.input_shape
    device = torch.device(args.device)
    before = {k.symbol: k.launches for k in kernels.KERNELS}
    launches = dict.fromkeys(before, 0)
    train_ms = train_s = None

    with tempfile.TemporaryDirectory() as work:
        # 1. the teacher
        model_dir = args.model_dir
        if model_dir is None:
            t0 = time.time()
            train_ds = SyntheticFreiHand(n=args.n, image_hw=hw,
                                         seed=args.seed, render_joints=True)
            model_dir = f"{work}/teacher"
            trainer = Trainer(cfg=cfg, dataset=train_ds, model_dir=model_dir,
                              seed=args.seed, device=device)
            _, train_s = timed(lambda: trainer.fit(
                end_epoch=1, steps_per_epoch=args.teacher_steps), device)
            teacher_model = trainer.model
            train_ms = (trainer.total_timer.average_time * 1e3
                        / max(1, trainer.scan_steps))
            if trainer.graphs is not None:
                launches = trainer.graphs.kernel_launches()
            log(json.dumps({"phase": "teacher",
                            "steps": args.teacher_steps, "images": args.n,
                            "wall_s": round(time.time() - t0, 1)}))
        else:
            teacher_model = teacher.load_teacher_model(cfg, model_dir,
                                                       device=device)
        teacher_apply = teacher.make_frozen_teacher(cfg, model_dir,
                                                    device=device)

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
    def sweep_single(labels=False):
        outs = []
        for im, K, bb, lab, jc, rows in batches:
            o = generate_filtered_labels(teacher_apply, im, K, bb, lab, jc,
                                         cfg.augment, **sweep)
            outs.append([rows >= 0, o.keep, o.variance])
            if labels:
                outs[-1] += [o.joint_cam_normalized,
                             gt_normalized(jc.to(K.dtype), K, o.tprime)]
        return [np.concatenate([x[i].cpu().numpy()[x[0]] for x in outs])
                for i in range(1, len(outs[0]))]

    runner = CascadeRunner(teacher_apply, cfg.augment,
                           pass1_rotations=args.cascade_pass1,
                           pass2_batch=args.batch_size, device=device,
                           **sweep)

    def sweep_cascade():
        runner.reset()
        for im, K, bb, lab, jc, rows in batches:
            runner.add_batch(im, K, bb, lab, jc, rows)
        return runner.finalize(args.pool)

    # warm both, then time the second sweep of each (the warm-up's
    # pseudo-labels and ground truth are kept, outside the timed sweep)
    _, _, pseudo, gt = sweep_single(labels=True)
    (keep1, var1), wall_single = timed(sweep_single, device)
    sweep_cascade()
    merged, wall_cascade = timed(sweep_cascade, device)
    equal = bool(np.array_equal(merged["keep"], keep1))

    f = float(1.0 - merged["early_rejected"].mean())
    rec = {
        "phase": "filter",
        "pool": args.pool,
        "rotations": t.teacher_num_rotations,
        "pass1_rotations": args.cascade_pass1,
        "variance_threshold": args.variance_threshold,
        "keep_rate": round(float(keep1.mean()), 4),
        "pass1_survival": round(f, 4),
        "keep_sets_equal": equal,
        "timer": "cuda events" if device.type == "cuda" else "host clock",
        "wall_single_s": round(wall_single, 4),
        "wall_cascade_s": round(wall_cascade, 4),
        "wall_speedup": round(wall_single / wall_cascade, 2),
    }
    log(json.dumps(rec))

    # threshold sweep from the stored per-sample quantities (no device
    # work): keep rate from the single pass's exact variance, pass-1
    # survival from the cascade's stored lower bound (a row survives pass 1
    # at threshold t iff bound <= t (1 + safety))
    bound = merged["pass1_bound"]
    grid = sorted({args.variance_threshold * s
                   for s in (0.1, 0.3, 1.0, 3.0, 10.0)})
    rows = [{"threshold": float(f"{th:.2g}"),
             "keep_rate": round(float((var1 < th).mean()), 4),
             "pass1_survival": round(
                 float((bound <= th * (1 + runner.safety)).mean()), 4)}
            for th in grid]
    log(json.dumps({"phase": "threshold_sweep", "grid": rows}))
    summary = {"summary": "filter_cascade_study",
               "keep_rate": rec["keep_rate"],
               "pass1_survival": rec["pass1_survival"],
               "wall_speedup": rec["wall_speedup"]}
    log(json.dumps(summary))
    after = {k.symbol: k.launches for k in kernels.KERNELS}
    return {"filter": rec, "grid": rows, "summary": summary,
            "keep_sets_equal": equal, "keep": keep1, "variance": var1,
            "pseudo_label": pseudo, "gt_label": gt, "merged": merged,
            "runner": runner, "teacher_apply": teacher_apply,
            "teacher_model": teacher_model, "cfg": cfg, "batches": batches,
            "wall_single_s": wall_single, "wall_cascade_s": wall_cascade,
            "train_ms_per_step": train_ms, "train_s": train_s,
            "launches": {k: launches[k] + after[k] - before[k]
                         for k in after}}


def main(argv=None):
    result = run_study(build_argparser().parse_args(argv))
    if not result["keep_sets_equal"]:
        raise AssertionError(
            f"cascade keep set diverged from single-pass: "
            f"{int((result['merged']['keep'] != result['keep']).sum())} "
            f"rows differ")
    return result["filter"]


if __name__ == "__main__":
    main()
