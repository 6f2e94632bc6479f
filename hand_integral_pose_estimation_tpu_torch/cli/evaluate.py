"""FreiHAND-challenge prediction dump (reference: main/evaluate.py).

Sweeps the label-free evaluation split and writes pred.json
([xyz_list, verts_list]) for the challenge server, plus
evaluation_predictions.npy. Port of
hand_integral_pose_estimation_tpu/cli/evaluate.py on one device, on the
synthetic split or the evaluation split of a FreiHAND tree (`--data-dir`):

    python -m hand_integral_pose_estimation_tpu_torch.cli.evaluate \
        --synthetic --use-detector --device cuda
    python -m hand_integral_pose_estimation_tpu_torch.cli.evaluate \
        --synthetic --synthetic-size 5 --batch-size 2 --use-detector \
        --detector-resnet 18 --detector-scale 64 --detector-proposals 16 \
        --pose-resnet 18 --pose-input 64 --device cpu

With `--use-detector` the crop boxes come from the hand detector, as in
the reference's `load_evaluation_data` (FreiHand.py:286-341): each batch
runs `inference.TwoStagePipeline` (detect -> crop -> pose). A matching
`--bbox-db` cache skips the detector and the pose net crops with the
cached boxes, as the reference's pickle cache does (FreiHand.py:286-293);
after a detector sweep the boxes are written there. Without the detector
the synthetic split crops with the boxes of its projected joints; the
evaluation split has no joints, so there the detector always runs (or its
cached boxes crop).

Detector weights are random from `--seed` unless `--detector-ckpt` names a
reference faster_rcnn_*.pth; the pose net's come from the latest
snapshot under `--model-dir` (or `--evaluate-epoch`) when there is one.

`--int8` runs both nets of the two-stage sweep with int8 post-training
quantization (`quantize/ptq.py`), calibrated on the first batch; with
`--int8-db PREFIX` the bundles are written to PREFIX.pose.npz and
PREFIX.det.npz, and read from there when both exist.

`--mesh` (default `auto`) splits each batch of the sweep (the two-stage
pipeline or the Tester) over the ranks of a `torchrun` launch, one GPU
each (`auto`: the largest rank prefix that divides `--batch-size`; none in
a single process); rank 0 writes pred.json. `--split-detector` does not
compose with an explicit `--mesh`, as in the JAX CLI.
"""

from __future__ import annotations

import argparse


def build_argparser():
    from hand_integral_pose_estimation_tpu_torch.detect.config_compat import (
        add_override_flags,
    )

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", default=None,
                   help="FreiHAND root (evaluation_K.json etc.)")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on SyntheticFreiHand instead of --data-dir")
    p.add_argument("--synthetic-size", type=int, default=64)
    p.add_argument("--model-dir", default="output/model_dump")
    p.add_argument("--result-dir", default="output/result/evaluation")
    p.add_argument("--evaluate-epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--use-detector", action="store_true",
                   help="two-stage detect -> crop -> pose")
    p.add_argument("--detector-ckpt", default=None,
                   help="a reference faster_rcnn_*.pth (random weights from "
                        "--seed if absent)")
    p.add_argument("--detector-style", choices=("torchvision", "caffe"),
                   default=None,
                   help="ResNet block variant; default: caffe for .pth "
                        "checkpoints (the reference's weights need it), "
                        "else torchvision")
    p.add_argument("--bbox-db", default=None,
                   help="npz cache of detector crop boxes; reused when it "
                        "matches the dataset, written after a detector sweep "
                        "otherwise")
    p.add_argument("--detector-native", action="store_true",
                   help="DetectorConfig.native serving preset: detect at the "
                        "input's resolution (224) with R18, GroupNorm and 64 "
                        "proposals instead of the reference's short-side-600 "
                        "blob; explicit flags still override")
    p.add_argument("--detector-resnet", type=int, default=None)
    p.add_argument("--detector-scale", type=int, default=None)
    p.add_argument("--detector-proposals", type=int, default=None)
    p.add_argument("--detector-norm", choices=("batch", "group"),
                   default=None,
                   help="must match the checkpoint: 'batch' (reference) or "
                        "'group'")
    p.add_argument("--split-detector", action="store_true",
                   help="run the detector as its upstream and downstream "
                        "halves (detect_split)")
    p.add_argument("--pose-resnet", type=int, default=50)
    p.add_argument("--pose-input", type=int, default=224)
    p.add_argument("--pose-depth", type=int, default=None,
                   help="heatmap depth bins (default: pose-input // 4)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights of a model without a "
                        "checkpoint")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh", default="auto",
                   help="device mesh for the sharded sweep (both the "
                        "two-stage serving pipeline and the Tester path): "
                        "'auto', 'none', or 'data=N[,model=M]'")
    p.add_argument("--int8", action="store_true",
                   help="int8 post-training quantization of both nets of the "
                        "two-stage sweep (per-channel weights, input scales "
                        "calibrated on the first batch, s8 x s8 -> s32 "
                        "products); needs the detector path")
    p.add_argument("--int8-db", default=None,
                   help="path prefix of the int8 bundles (PREFIX.pose.npz, "
                        "PREFIX.det.npz): read when both exist, written "
                        "after calibration otherwise")
    add_override_flags(p)
    return p


def resolve_detector_cfg(args, base):
    """Detector config from the flags: `--detector-native` starts from the
    `DetectorConfig.native` preset instead of `base`; explicit per-field
    flags override either; `--cfg-file` then `--set` apply last."""
    import dataclasses

    from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig
    from hand_integral_pose_estimation_tpu_torch.detect.config_compat import (
        overrides_from_args,
    )
    from hand_integral_pose_estimation_tpu_torch.detect.load import (
        default_resnet_style,
    )

    if args.detector_native:
        det_cfg = DetectorConfig.native(args.detector_scale or 224,
                                        args.detector_resnet or 18)
    else:
        det_cfg = base
    scale = args.detector_scale or det_cfg.test_scale
    norm = args.detector_norm or det_cfg.norm
    det_cfg = dataclasses.replace(
        det_cfg, resnet_type=args.detector_resnet or det_cfg.resnet_type,
        norm=norm,
        resnet_style=args.detector_style or default_resnet_style(
            args.detector_ckpt),
        freeze_bn=norm == "batch",
        test_scale=scale,
        test_max_size=(det_cfg.test_max_size if scale == det_cfg.test_scale
                       else scale),
        rpn_post_nms_top_n_test=(args.detector_proposals
                                 or det_cfg.rpn_post_nms_top_n_test))
    return overrides_from_args(det_cfg, args)


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import dataclasses
    import os

    import numpy as np
    import torch

    from hand_integral_pose_estimation_tpu_torch.cli.mesh_arg import (
        join_launcher,
        resolve_eval_mesh,
    )
    from hand_integral_pose_estimation_tpu_torch.cli.train import load_split
    from hand_integral_pose_estimation_tpu_torch.config import Config
    from hand_integral_pose_estimation_tpu_torch.data import (
        detector_db,
        padded_batches,
    )
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_challenge,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.parallel import is_writer
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester,
        load_checkpoint,
    )

    if args.split_detector and args.mesh not in ("auto", "none"):
        raise SystemExit("--split-detector is a single-chip latency knob; "
                         "it does not compose with an explicit --mesh")
    args.device = join_launcher(args.device)
    mesh = (None if args.split_detector else
            resolve_eval_mesh(args.mesh, args.batch_size))
    cfg = Config()
    hw = args.pose_input
    cfg = cfg.replace(
        detector=resolve_detector_cfg(args, cfg.detector),
        model=dataclasses.replace(
            cfg.model, resnet_type=args.pose_resnet, input_shape=(hw, hw),
            output_shape=(hw // 4, hw // 4),
            depth_dim=args.pose_depth or hw // 4))
    dataset = load_split(args, cfg, "evaluation")
    # the evaluation split has no joints to crop around
    use_detector = args.use_detector or not args.synthetic

    model = get_pose_net(cfg.model,
                         generator=torch.Generator().manual_seed(args.seed))
    try:
        epoch = load_checkpoint(args.model_dir, model,
                                epoch=args.evaluate_epoch)
        print(f"loaded snapshot_{epoch}")
    except FileNotFoundError:
        print(f"no snapshot found: evaluating a fresh model (seed "
              f"{args.seed})")

    if use_detector and args.bbox_db and os.path.exists(args.bbox_db):
        names, bboxes = detector_db.load_bbox_db(args.bbox_db)
        detector_db.attach_detector_bboxes(dataset, bboxes, names)
        print(f"attached {len(bboxes)} cached crop boxes from {args.bbox_db}")
        use_detector = False

    if args.int8 and not use_detector:
        raise SystemExit("--int8 runs through the two-stage detector "
                         "pipeline; pass --use-detector (and no matching "
                         "--bbox-db cache)")
    if args.int8 and args.split_detector:
        raise SystemExit("--split-detector does not compose with --int8 "
                         "(as in the JAX package)")

    if use_detector:
        from hand_integral_pose_estimation_tpu_torch.detect.load import (
            build_detector,
        )
        from hand_integral_pose_estimation_tpu_torch.inference import (
            TwoStagePipeline,
        )
        from hand_integral_pose_estimation_tpu_torch.quantize import (
            load_quantized,
            save_quantized,
        )

        detector = build_detector(
            cfg.detector, args.detector_ckpt,
            generator=torch.Generator().manual_seed(args.seed))
        n = len(dataset)
        int8_calib, loaded = None, False
        files = ((args.int8_db + ".pose.npz", args.int8_db + ".det.npz")
                 if args.int8 and args.int8_db else None)
        if files and all(os.path.exists(f) for f in files):
            int8_calib = (load_quantized(files[0], type(model)),
                          load_quantized(files[1], type(detector)))
            loaded = True
            print(f"int8: loaded the bundles {args.int8_db}.*")
        elif args.int8:
            # calibrate the input scales on the first padded batch
            host = dataset.host_batch(next(padded_batches(n,
                                                          args.batch_size)))
            int8_calib = (host["image"], host["K"], host["ref_bone_len"])
        pipe = TwoStagePipeline(cfg, model, detector, device=args.device,
                                split_detector=args.split_detector,
                                int8_calib=int8_calib, mesh=mesh)
        if args.int8:
            q_pose, q_det = pipe.quantized
            print(f"int8: quantized {len(q_pose.paths)} pose + "
                  f"{len(q_det.paths)} detector modules")
            if files and not loaded and is_writer():
                save_quantized(files[0], q_pose)
                save_quantized(files[1], q_det)
                print(f"int8: wrote the bundles {args.int8_db}.*")
        coords_all, bbox_all, K_all, ref_all = [], [], [], []
        for idx in padded_batches(n, args.batch_size):
            host = dataset.host_batch(idx)
            out = pipe(host["image"], host["K"], host["ref_bone_len"])
            coords_all.append(out.coords_label.cpu().numpy())
            bbox_all.append(out.crop_bbox.cpu().numpy())
            K_all.append(host["K"])
            ref_all.append(host["ref_bone_len"])
        coords = np.concatenate(coords_all)[:n]
        bbox = np.concatenate(bbox_all)[:n]
        K = np.concatenate(K_all)[:n]
        ref = np.concatenate(ref_all)[:n]
        if args.bbox_db and is_writer():
            detector_db.save_bbox_db(args.bbox_db, dataset, bbox)
            print(f"cached crop boxes -> {args.bbox_db}")
    else:
        tester = Tester(cfg=cfg, dataset=dataset, model=model,
                        device=args.device, mesh=mesh)
        coords, batch = tester.run(batch_size=args.batch_size)
        bbox, K, ref = batch.bbox, batch.K, batch.ref_bone_len

    if not is_writer():
        return None
    preds = evaluate_challenge(coords, bbox, K, ref,
                               result_dir=args.result_dir,
                               patch_hw=cfg.model.input_shape)
    print(f"dumped {preds.shape[0]} predictions to "
          f"{args.result_dir}/pred.json")
    return preds


if __name__ == "__main__":
    main()
