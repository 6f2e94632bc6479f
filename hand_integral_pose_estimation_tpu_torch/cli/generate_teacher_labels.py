"""Filtered teacher-label generation (reference:
main/generate_filtered_teacher_labels.py).

    python -m hand_integral_pose_estimation_tpu_torch.cli.generate_teacher_labels \
        --data-dir /path/to/FreiHAND --model-dir output/teacher --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.generate_teacher_labels \
        --synthetic --synthetic-size 6 --batch-size 4 --pose-resnet 18 \
        --pose-input 64 --device cpu

Port of hand_integral_pose_estimation_tpu/cli/generate_teacher_labels.py
on one device. The frozen teacher (the latest snapshot under
`--model-dir`, or a reference snapshot_*.pth; a fresh model from `--seed`
when there is none) runs under 21 z-rotations of every record, one
batched forward per batch; records whose prediction variance is below the
threshold are kept. Writes the pseudo-label db (npz: joint_cam_normalized,
tprime, variance, keep, labelled and the record names), which `cli.train
--filtered-db` reads. `--cascade` gives the same keep set with the exact
early-reject cascade. `--teacher-dtype` sets the teacher's compute dtype;
`int8` runs its convs as int8 products, calibrated on the first batch's
own sweep patches (`distill.quantized_teacher_apply`). `--mesh` (default
`none`, as in the JAX CLI) splits each batch's sweep over the ranks of a
`torchrun` launch, one GPU each; rank 0 writes the db.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", type=int, default=32)
    p.add_argument("--training-size", type=int, default=None,
                   help="override cfg.train.training_size (partial "
                        "downloads, mini fixtures); must match the "
                        "training run that reads the db")
    p.add_argument("--model-dir", default="output/teacher_model",
                   help="teacher snapshot dir, or a reference "
                        "snapshot_*.pth (config.py:79)")
    p.add_argument("--out", default="output/filtered_teacher_labels.npz")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--variance-threshold", type=float, default=1e-4)
    p.add_argument("--rotation-mode", choices=("factored", "composed"),
                   default="factored",
                   help="factored: one shared crop per record, then the "
                        "rotated crops from it; composed: one warp of the "
                        "full frame per rotation")
    p.add_argument("--teacher-dtype",
                   choices=("float32", "bfloat16", "int8"), default=None,
                   help="teacher compute dtype (default: the config's, "
                        "bfloat16); the decode and the filter accumulate in "
                        "float32 either way. 'int8' runs the teacher's convs "
                        "as s8 x s8 -> s32 products calibrated on the first "
                        "batch's sweep patches")
    p.add_argument("--cascade", action="store_true",
                   help="two-pass exact early-reject filter "
                        "(distill/cascade.py): the same keep set")
    p.add_argument("--cascade-pass1", type=int, default=5,
                   help="rotations in the early-reject pass (endpoints "
                        "included)")
    p.add_argument("--pose-resnet", type=int, default=None)
    p.add_argument("--pose-input", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the fresh teacher when no snapshot exists")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", default="none",
                   help="'auto' | 'none' | 'data=N[,model=M]': split each "
                        "generation batch's sweep over the mesh's data axis "
                        "(the reference's DataParallel teacher filter loop, "
                        "generate_filtered_teacher_labels.py:403-509); "
                        "--batch-size must divide by the data-axis size")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.cli.mesh_arg import (
        join_launcher,
        resolve_eval_mesh,
    )
    from hand_integral_pose_estimation_tpu_torch.cli.train import (
        load_split,
        sized_config,
    )
    from hand_integral_pose_estimation_tpu_torch.data import padded_batches
    from hand_integral_pose_estimation_tpu_torch.data.detector_db import (
        _record_names,
    )
    from hand_integral_pose_estimation_tpu_torch.distill import (
        CascadeRunner,
        generate_filtered_labels,
        quantized_teacher_apply,
    )
    from hand_integral_pose_estimation_tpu_torch.geometry import bbox as bb
    from hand_integral_pose_estimation_tpu_torch.distill.teacher_labels \
        import camera_project
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.parallel import is_writer
    from hand_integral_pose_estimation_tpu_torch.training.teacher import (
        frozen_teacher,
        load_teacher_model,
    )

    args.device = join_launcher(args.device)
    mesh = resolve_eval_mesh(args.mesh, args.batch_size)
    cfg = sized_config(args.pose_resnet, args.pose_input)
    if args.training_size:
        cfg = cfg.with_training_size(args.training_size)
    if args.teacher_dtype in ("float32", "bfloat16"):
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype=args.teacher_dtype))
    dataset = load_split(args, cfg, "training")
    device = torch.device(args.device)
    try:
        teacher = load_teacher_model(cfg, args.model_dir, device=device)
        print(f"teacher from {args.model_dir}")
    except FileNotFoundError:
        print(f"no teacher snapshot: a fresh model (seed {args.seed})")
        teacher = get_pose_net(
            cfg.model, torch.Generator().manual_seed(args.seed)).to(device)

    def device_batch(host):
        """Host batch -> (images, K, joint_cam, labelled, bbox) on the
        device; the cached detector box, else the keypoint box."""
        images, K, joint_cam, labelled = (
            torch.from_numpy(np.ascontiguousarray(host[k])).to(device)
            for k in ("image", "K", "joint_cam", "labelled"))
        if host["bbox_detector"] is not None:
            box = torch.from_numpy(host["bbox_detector"]).to(device)
        else:
            uv, _, _ = camera_project(joint_cam, K)
            box = bb.bbox_from_keypoints(uv, torch.ones_like(uv[..., 0]),
                                         pad_factor=cfg.augment.pad_factor)
        return images, K, joint_cam, labelled, box

    t = cfg.train
    sweep = dict(num_rotations=t.teacher_num_rotations,
                 rotation_range=t.teacher_rotation_range,
                 variance_threshold=args.variance_threshold,
                 patch_hw=cfg.model.input_shape,
                 rotation_mode=args.rotation_mode)
    if args.teacher_dtype == "int8":
        images, K, _, _, box = device_batch(dataset.host_batch(
            next(padded_batches(len(dataset), args.batch_size))))
        teacher_apply, q8 = quantized_teacher_apply(
            teacher, images, K, box, cfg.augment, cfg.model.num_joints,
            cfg.model.depth_dim, num_rotations=t.teacher_num_rotations,
            rotation_range=t.teacher_rotation_range,
            patch_hw=cfg.model.input_shape, rotation_mode=args.rotation_mode)
        print(f"int8 teacher: {len(q8.paths)} modules quantized "
              f"(calibrated on the first batch's sweep patches)")
    else:
        teacher_apply = frozen_teacher(teacher, cfg)
    runner = (CascadeRunner(teacher_apply, cfg.augment,
                            pass1_rotations=args.cascade_pass1,
                            pass2_batch=args.batch_size, device=device,
                            mesh=mesh, **sweep)
              if args.cascade else None)
    results = {k: [] for k in ("joint_cam_normalized", "tprime",
                               "variance", "keep", "labelled")}
    n, bs = len(dataset), args.batch_size
    for idx in padded_batches(n, bs):
        # the tail batch is padded to a fixed shape and trimmed below, so
        # every record gets its db row
        start = int(idx[0])
        images, K, joint_cam, labelled, box = device_batch(
            dataset.host_batch(idx))
        if runner is not None:
            rows = np.where(idx == start + np.arange(bs), idx, -1)
            runner.add_batch(images, K, box, labelled, joint_cam, rows)
        else:
            with torch.no_grad():
                out = generate_filtered_labels(
                    teacher_apply, images, K, box, labelled, joint_cam,
                    cfg.augment, mesh=mesh, **sweep)
            for k in ("joint_cam_normalized", "tprime", "variance", "keep"):
                results[k].append(getattr(out, k).cpu().numpy())
            results["labelled"].append(labelled.cpu().numpy())
        if start % (20 * bs) == 0:
            print(f"{min(start + bs, n)}/{n} processed")

    if runner is not None:
        merged = runner.finalize(n)
        s = runner.stats
        print(f"cascade: {s['early_rejected']}/{s['total']} early-rejected "
              f"after {args.cascade_pass1} rotations, {s['pass2']} took the "
              f"full sweep, {s['labelled']} labelled")
    else:
        merged = {k: np.concatenate(v)[:n] for k, v in results.items()}
    # rows are positional: the names let apply_filtered_labels refuse a db
    # made for another record set
    merged["name"] = _record_names(dataset)
    if not is_writer():
        return merged
    np.savez(args.out, **merged)
    print(f"kept {int(merged['keep'].sum())}/{len(merged['keep'])} samples "
          f"-> {args.out}")
    return merged


if __name__ == "__main__":
    main()
