"""One rank of chip_smoke.py's mesh phase: several processes share the one
card over a gloo group (NCCL refuses two ranks on one GPU).

    python -m hand_integral_pose_estimation_tpu_torch.parallel._smoke_worker \
        <job> <case.pt> <out_dir> [cuda|cpu]

with the environment `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT). chip_smoke.py writes the
case (config, weights, batches) and compares what each rank writes to
<out_dir>/<job>_rank<r>.pt with its own one-rank runs; a rank that fails
exits non-zero and fails the phase. Jobs:

- `pair` (2 ranks): the Trainer over data=2 (eager: gloo cannot be
  captured), `Tester(mesh)`, one step over data=1 x model=2 (21 joints on
  2: the head on the gathered weight), and `TwoStagePipeline(mesh)` in
  float and int8 against the same pipeline on this rank alone;
- `model3` (3 ranks, data=1 x model=3): the final projection split 7
  joints a rank, its eval coords and one train step's gradients.

Each rank also writes its kernels' launch counts (`Kernel.launches`) of
its main-path runs. With `cpu` (a rehearsal at small sizes) the ranks
run on the CPU. Importing the module does nothing.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from hand_integral_pose_estimation_tpu_torch.ops import kernels


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts() -> dict[str, int]:
    return {k.symbol: k.launches for k in kernels.KERNELS}


def _reset() -> None:
    for k in kernels.KERNELS:
        k.launches = 0


def _set_projection(model, weight: torch.Tensor, mesh) -> None:
    """The phase's scaled projection (whole, on the host) into `model`'s
    final layer, or this rank's block of it; zero bias."""
    from hand_integral_pose_estimation_tpu_torch.parallel.mesh import (
        model_slice,
    )
    final = model.head.final_layer
    with torch.no_grad():
        n = weight.shape[0]
        block = (model_slice(mesh, n) if final.weight.shape[0] < n
                 else slice(None))
        final.weight.copy_(weight[block].to(final.weight.device))
        final.bias.zero_()


def _host(x):
    return x.detach().cpu() if torch.is_tensor(x) else x


def _pair(case, device, rank):
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.inference import (
        TwoStagePipeline,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.detect import build_detector
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        head_model_split, make_mesh, split_params,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester, Trainer,
    )
    cfg, seed = case["cfg"], case["seed"]
    out = {}
    mesh = make_mesh()

    # b. the Trainer over data=2, eager, from the union's seeds
    train_data = SyntheticFreiHand(n=case["n_train"], render_joints=True,
                                   seed=seed)
    with tempfile.TemporaryDirectory() as d:
        t = Trainer(cfg, train_data, model_dir=d, seed=seed, device=device,
                    scan_steps=case["steps"], mesh=mesh)
        assert t.graphs is None, "a gloo step was given a CUDA graph"
        rng = np.random.RandomState(seed * 100003 + 1000003 * mesh.data_index)
        out["sampled"] = np.stack([train_data.sample_indices(rng,
                                                             t.local_batch)
                                   for _ in range(case["steps"])])
        _reset()
        _sync(device)
        t0 = time.perf_counter()
        out["metrics"] = t.run_epoch(0, num_steps=case["steps"])
        _sync(device)
        out["train_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                    / case["steps"])
        out["train_launches"] = _counts()
        out["params"] = {k: _host(v) for k, v in
                         t.model.state_dict().items()} if rank == 0 else None

        # the Tester over the mesh on the trained weights, the projection
        # scaled
        test_data = SyntheticFreiHand(n=case["n_test"], render_joints=True,
                                      seed=seed + 1)
        _set_projection(t.model, case["final_weight"], mesh)
        _reset()
        t0 = time.perf_counter()
        coords, _ = Tester(cfg, test_data, t.model, device=device,
                           mesh=mesh).run(batch_size=case["test_batch"])
        out["test_ms"] = (time.perf_counter() - t0) * 1e3
        out["test_launches"] = _counts()
        out["tester_coords"] = coords
        del t

    # c'. data=1 x model=2 at 21 joints: no split of the joints, the head
    # runs on the gathered weight
    mesh2 = make_mesh(model_parallelism=2)
    out["split_21_on_2"] = head_model_split(mesh2, cfg.model.num_joints)
    with tempfile.TemporaryDirectory() as d:
        small = cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=case["model_batch"]))
        t2 = Trainer(small, train_data, model_dir=d, seed=seed,
                     device=device, mesh=mesh2)
        _set_projection(t2.model, case["final_weight"], mesh2)
        out["model2_split_shapes"] = {n: tuple(p.shape) for n, p in
                                      t2.model.named_parameters()
                                      if n in split_params(t2.model)}
        _reset()
        out["model2_metrics"] = t2.run_epoch(0, num_steps=1)
        out["model2_launches"] = _counts()
        del t2

    # d. the two-stage pipeline over data=2, float and int8, against this
    # rank alone on the same frames
    pcfg = case["pipe_cfg"]
    pose = get_pose_net(pcfg.model)
    pose.load_state_dict(case["pose"])
    det = build_detector(pcfg.detector)
    det.load_state_dict(case["det"])
    frames = case["frames"]
    K, ref = frames["K"], frames["ref_bone_len"]
    n, bs = len(K), case["pipe_batch"]
    calib = (frames["image"][:bs], K[:bs], ref[:bs])
    out["pipe_launches"] = {}
    for name, int8 in (("float", None), ("int8", calib)):
        for m in (mesh, None):
            key = f"{name}_{'mesh' if m is not None else 'one'}"
            pipe = TwoStagePipeline(pcfg, pose, det, device=device, mesh=m,
                                    int8_calib=int8)
            _reset()
            _sync(device)
            t0 = time.perf_counter()
            outs = [pipe(frames["image"][i:i + bs], K[i:i + bs],
                         ref[i:i + bs]) for i in range(0, n, bs)]
            _sync(device)
            out[f"{key}_ms_per_batch"] = ((time.perf_counter() - t0) * 1e3
                                          / (n // bs))
            if m is not None:
                out["pipe_launches"][name] = _counts()
            out[key] = {f: torch.cat([getattr(o, f) for o in outs]).cpu()
                        for f in outs[0]._fields}
            del pipe
    return out


def _model3(case, device, rank):
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        convert_sync_batchnorm, head_model_split, make_mesh, place_state,
        split_params,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        make_eval_fn, make_optimizer, make_train_step, multistep_schedule,
    )
    cfg, seed = case["cfg"], case["seed"]
    mesh = make_mesh(model_parallelism=3)
    model = get_pose_net(cfg.model, generator=torch.Generator().manual_seed(
        seed)).to(device)
    place_state(mesh, convert_sync_batchnorm(model, mesh))
    _set_projection(model, case["final_weight"], mesh)
    out = {"split": head_model_split(mesh, cfg.model.num_joints),
           "block_shapes": {n: tuple(p.shape) for n, p in
                            model.named_parameters()
                            if n in split_params(model)}}
    batch = type(case["eval_batch"])(*[
        None if v is None else v.to(device) for v in case["eval_batch"]])
    _reset()
    out["coords"] = make_eval_fn(model, cfg, True, mesh)(batch)[0].cpu()
    opt = make_optimizer(model.parameters(), cfg.train)
    sched = multistep_schedule(opt, 1, cfg.train.lr_dec_epoch,
                               cfg.train.lr_dec_factor)
    batch = type(case["train_batch"])(*[
        None if v is None else v.to(device) for v in case["train_batch"]])
    metrics = make_train_step(model, opt, sched, cfg, mesh=mesh)(batch)
    _sync(device)
    out["launches"] = _counts()
    out["loss"] = float(metrics["loss"])
    out["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()
                    if rank == 0 or n in split_params(model)}
    return out


JOBS = {"pair": _pair, "model3": _model3}


def main(argv=None) -> None:
    job, case_path, out_dir, *rest = argv or sys.argv[1:]
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        init_distributed,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed(rest[0] if rest else "cuda")
    rank = dist.get_rank()
    case = torch.load(case_path, weights_only=False)
    out = JOBS[job](case, device, rank)
    torch.save(out, os.path.join(out_dir, f"{job}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
