"""Entry points of the port: a forward step of the flagship model, and a
dry run of the whole user path over several ranks.

    python -m hand_integral_pose_estimation_tpu_torch.entry [--device cpu]
    python -m hand_integral_pose_estimation_tpu_torch.entry --dryrun 2 [--device cpu]

The twins of `entry` and `dryrun_multichip` in the repository's
`__graft_entry__.py` (:45 and :65), which drive the JAX package. Both
run on the card unless given `device="cpu"` (`--device cpu`): the dry
run's ranks then are CPU processes over gloo, as the JAX dry run forces a
virtual CPU mesh; on the card they share it over gloo, or take one card
each over NCCL where the host has a card for every rank.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device: str | torch.device = "cuda"):
    """The ResNet-50 integral pose net of `ModelConfig()` (weights drawn
    from seed 0) in eval mode, and a forward step that decodes its head's
    features with the fused projection + soft-argmax (kernel 3 on the
    card). Returns (fn, example_args): `fn(model, images)` maps (B, 224,
    224, 3) float32 images to (B, 21, 3) normalised coords; the example
    images are 8 zero images."""
    from hand_integral_pose_estimation_tpu_torch.config import ModelConfig
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
        head_projection_integral,
    )

    cfg = ModelConfig()
    device = torch.device(device)
    model = get_pose_net(cfg, torch.Generator().manual_seed(0)).to(
        device).eval()
    x = torch.zeros((8, *cfg.input_shape, 3), dtype=torch.float32,
                    device=device)

    @torch.inference_mode()
    def fn(model, images):
        feats = model(images, return_features=True)
        weight, bias = model.final_projection()
        return head_projection_integral(feats, weight, bias,
                                        model.cfg.num_joints,
                                        model.cfg.depth_dim)

    return fn, (model, x)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     timeout: float = 600) -> str:
    """Run the whole user path over `n_devices` ranks, at tiny shapes:
    `Trainer.fit` over a (data, model) mesh (layout, state placement, each
    rank's slice of the host batch, the train step, the snapshot), one more
    `run_epoch` step, then the mesh's `Tester` sweep and
    `evaluate_test_split`. Two arms, so that both fused-head layouts run:
    J = 21, which a model axis of 2 does not divide (the whole projection
    on every rank), and, when `n_devices` is even, J = 20 at model=2 (the
    projection split over the model axis).

    The ranks are processes of this module (`--dryrun-rank`) on `device`
    (`parallel.init_distributed`: on the card over NCCL, or over gloo when
    the ranks outnumber the cards, and then the chunks run eagerly; on the
    CPU over gloo). Raises RuntimeError if CUDA is asked for and missing,
    or with the ranks' output if any rank fails or the group outlives
    `timeout` seconds. Prints and returns rank 0's lines."""
    from hand_integral_pose_estimation_tpu_torch.parallel import spawn_ranks

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: CUDA was asked for and is not "
                           "available (pass device='cpu' for CPU ranks)")
    try:
        logs = spawn_ranks(
            [sys.executable, "-m",
             "hand_integral_pose_estimation_tpu_torch.entry",
             "--dryrun-rank", "--device", device.type],
            n_devices, cwd=_ROOT, timeout=timeout,
            env={"OMP_NUM_THREADS": "1"} if device.type == "cpu" else None)
    except RuntimeError as e:
        raise RuntimeError(f"dryrun_multichip({n_devices}, "
                           f"{device.type!r}): {e}") from None
    out = "\n".join(line for line in logs[0].splitlines()
                    if line.startswith("dryrun_multichip"))
    print(out, flush=True)
    return out


def _dryrun_rank(device: str) -> None:
    """One rank of `dryrun_multichip` on `device` ("cuda" or "cpu"): joins
    the group from torchrun's environment and runs both arms; rank 0
    prints one line an arm, with its hand-written kernels' launches as the
    wrappers count them (eager calls and captures, not graph replays;
    none on the CPU)."""
    import tempfile

    from hand_integral_pose_estimation_tpu_torch.config import (
        Config,
        ModelConfig,
        TrainConfig,
    )
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_test_split,
    )
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        head_model_split,
        init_distributed,
        is_writer,
        make_mesh,
        world_size,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester,
        Trainer,
    )

    device = init_distributed(device)
    n = world_size()
    model_par = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(model_par)
    for J in (21, 20) if model_par > 1 else (21,):
        cfg = Config(
            model=ModelConfig(resnet_type=18, input_shape=(32, 32),
                              output_shape=(8, 8), depth_dim=8,
                              compute_dtype="float32", num_joints=J),
            train=TrainConfig(batch_size=2 * n, test_batch_size=2 * n))
        ds = SyntheticFreiHand(n=2 * n, image_hw=(32, 32), num_joints=J)
        for k in kernels.KERNELS:
            k.launches = 0
        with tempfile.TemporaryDirectory() as model_dir:
            trainer = Trainer(cfg=cfg, dataset=ds, model_dir=model_dir,
                              device=device, mesh=mesh)
            trainer.fit(end_epoch=1, steps_per_epoch=1)
            loss = trainer.run_epoch(0, num_steps=1)["loss"]
            coords, merged = Tester(cfg, ds, trainer.model, device=device,
                                    mesh=mesh).run()
        summary = evaluate_test_split(coords, merged, patch_hw=(32, 32))
        if not (np.isfinite(loss) and coords.shape[0] == len(ds)
                and np.isfinite(coords).all()
                and np.isfinite(summary["pa_mpjpe"])):
            raise RuntimeError(f"J={J}: loss {loss}, coords {coords.shape}, "
                               f"summary {summary}")
        path = ("model-sharded (projection consumed in place)"
                if head_model_split(mesh, J)
                else "data-parallel fallback (replicated weights)")
        launches = ",".join(f"{k.symbol}:{k.launches}"
                            for k in kernels.KERNELS if k.launches) or "none"
        if is_writer():
            print(f"dryrun_multichip({n}): mesh {mesh.shape} J={J} "
                  f"loss={loss:.5f} eval_pa_mpjpe={summary['pa_mpjpe']:.5f} "
                  f"launches={launches} fused-head path: {path}", flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, for entry() and the dry "
                        "run's ranks")
    p.add_argument("--dryrun", type=int, default=None, metavar="N",
                   help="run dryrun_multichip(N) instead of entry()")
    p.add_argument("--dryrun-rank", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dryrun_rank:
        _dryrun_rank(args.device)
    elif args.dryrun:
        dryrun_multichip(args.dryrun, args.device)
    else:
        fn, fn_args = entry(args.device)
        out = fn(*fn_args)
        print("entry():", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()
