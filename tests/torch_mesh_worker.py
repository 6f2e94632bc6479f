"""One rank of a gloo process group for the port's mesh tests.

The tests/test_torch_mesh_*.py files each start one group of these on the
CPU (a free localhost port, `spawn` below) and compare what every rank
wrote with a one-process run and with the JAX package:

    python tests/torch_mesh_worker.py <job> <port> <rank> <world> <dir>

Jobs: `train` (2 ranks: sync-BN, the train step from bridged weights, the
Trainer, snapshots across layouts, the Tester sweep), `model` (4 ranks,
data=2 x model=2: the sharded head and decode, a model-split Trainer's
snapshot) and `serve` (2 ranks: the two-stage pipeline, float and int8,
and the teacher labels). Inputs come from <dir>/inputs.npz and the .pt
files the test writes there; each rank writes <dir>/<job>_rank<r>.pt.
The worker imports torch and the port only.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(job: str, world: int, out_dir, timeout: float = 600,
          command=None, port=None):
    """Start `world` ranks of `command` (default: this worker's `job`) with
    torchrun's environment on a free localhost port; wait for all and fail
    with the logs if any rank fails. Returns the logs."""
    port = port or free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        cmd = command or [sys.executable, os.path.abspath(__file__), job,
                          str(port), str(rank), str(world), str(out_dir)]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=str(out_dir), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError("mesh ranks %s failed:\n%s" % (
            bad, "\n".join(logs[i][-4000:] for i in bad)))
    return logs


# ---------------------------------------------------------------- jobs


def small_config(batch=8, size=32):
    """R18 at size x size input, size/4 output, depth 8, float32 (as
    tests/test_multihost.py sizes the JAX run)."""
    from hand_integral_pose_estimation_tpu_torch.config import (
        Config, ModelConfig, TrainConfig,
    )
    model = ModelConfig(resnet_type=18, input_shape=(size, size),
                        output_shape=(size // 4, size // 4), depth_dim=8,
                        compute_dtype="float32")
    return Config(model=model, train=TrainConfig(batch_size=batch, lr=1e-3,
                                                 test_batch_size=4))


def _sync_bn(inputs, mesh, out):
    """Sync-BN over the ranks' rows against the whole batch (the test
    runs BatchNorm2d over it)."""
    import torch
    import torch.distributed as dist
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        SyncBatchNorm, shard_host_batch,
    )
    x = torch.from_numpy(shard_host_batch(mesh, inputs["bn_x"]))
    cot = torch.from_numpy(shard_host_batch(mesh, inputs["bn_cot"]))
    bn = SyncBatchNorm(x.shape[1]).double()
    bn.group = mesh.data_group
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["bn_w"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn_b"]))
    x.requires_grad_(True)
    y = bn(x)
    (y * cot).sum().backward()
    dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
    dist.all_reduce(dw, group=mesh.data_group)
    dist.all_reduce(db, group=mesh.data_group)
    out.update(bn_y=y.detach(), bn_dx=x.grad, bn_dw=dw, bn_db=db,
               bn_mean=bn.running_mean.clone(), bn_var=bn.running_var.clone())


def _jax_step(out_dir, mesh, cfg, out):
    """One mesh train step per head arm from the bridged weights on the
    rows of a union batch; the gradients after the all-reduce, the metrics
    and the BatchNorm running statistics."""
    import torch
    from hand_integral_pose_estimation_tpu_torch.data import Batch
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        convert_sync_batchnorm, place_state, shard_host_batch,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        make_optimizer, make_train_step, multistep_schedule,
    )
    init = torch.load(os.path.join(out_dir, "init64.pt"))
    union = torch.load(os.path.join(out_dir, "union_batch.pt"))
    batch = Batch(**shard_host_batch(mesh, union))
    for fuse in (True, False):
        model = get_pose_net(cfg.model)
        model.load_state_dict(init)
        model = model.double()
        place_state(mesh, convert_sync_batchnorm(model, mesh))
        opt = make_optimizer(model.parameters(), cfg.train)
        sched = multistep_schedule(opt, 1, cfg.train.lr_dec_epoch,
                                   cfg.train.lr_dec_factor)
        metrics = make_train_step(model, opt, sched, cfg, fuse_head=fuse,
                                  mesh=mesh)(batch)
        out[f"step{int(fuse)}"] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def _trainer(cfg, **kw):
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.training import Trainer
    ds = SyntheticFreiHand(n=16, image_hw=(32, 32), seed=3)
    return Trainer(cfg=cfg, dataset=ds, device="cpu", seed=0, **kw)


def job_train(out_dir, rank, world):
    import numpy as np
    import torch
    from hand_integral_pose_estimation_tpu_torch.data import SyntheticFreiHand
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.parallel import make_mesh
    from hand_integral_pose_estimation_tpu_torch.training import (
        Tester, save_checkpoint,
    )
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    cfg = small_config()
    out = {}
    mesh = make_mesh()
    _sync_bn(inputs, mesh, out)
    _jax_step(out_dir, mesh, small_config(size=64), out)

    # the Trainer: auto mesh, two steps of epoch 0, its sampling stream
    t = _trainer(cfg, auto_mesh=True,
                 model_dir=os.path.join(out_dir, "trained"))
    rng = np.random.RandomState(t.seed * 100003 + 0
                                + 1000003 * t.mesh.data_index)
    out["sampled"] = np.stack([t.dataset.sample_indices(rng, t.local_batch)
                               for _ in range(2)])
    out["local_batch"] = t.local_batch
    out["mesh_shape"] = t.mesh.shape
    out["metrics"] = t.run_epoch(0, num_steps=2, log_every=100)
    out["params"] = {k: v.clone() for k, v in t.model.state_dict().items()}
    save_checkpoint(t.model_dir, t.model, t.optimizer, 0, mesh=t.mesh)

    # one device -> data=2: a snapshot the test wrote, resumed here
    r = _trainer(cfg, mesh=mesh, continue_train=True,
                 model_dir=os.path.join(out_dir, "one_device"))
    out["resumed_epoch"] = r.start_epoch
    out["resumed"] = {k: v.clone() for k, v in r.model.state_dict().items()}
    out["resumed_metrics"] = r.run_epoch(r.start_epoch, num_steps=1,
                                         log_every=100)
    out["resumed_params"] = {k: v.clone()
                             for k, v in r.model.state_dict().items()}

    # the Tester over the mesh: 5 samples at batch 2 (tail padded), the
    # bridged weights of the test
    model = get_pose_net(cfg.model)
    model.load_state_dict(torch.load(os.path.join(out_dir, "init_pose.pt")))
    ds = SyntheticFreiHand(n=5, image_hw=(32, 32), seed=3,
                           render_joints=True)
    coords, batch = Tester(cfg, ds, model, device="cpu", mesh=mesh).run(
        batch_size=2)
    out["tester_coords"] = coords
    out["tester_batch"] = batch._asdict()
    try:
        Tester(cfg, ds, model, device="cpu", mesh=mesh).run(batch_size=3)
    except ValueError as e:
        out["tester_error"] = str(e)
    return out


def job_model(out_dir, rank, world):
    """data=2 x model=2: the sharded head and decode at J = 6 (split) and
    J = 3 (the weight gathered), then a model-split Trainer's snapshot."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        head_model_split, make_mesh, shard_host_batch,
        sharded_head_projection_integral, sharded_softmax_integral,
        split_params,
    )
    from hand_integral_pose_estimation_tpu_torch.parallel.mesh import (
        model_slice,
    )
    from hand_integral_pose_estimation_tpu_torch.training import (
        save_checkpoint,
    )
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mesh = make_mesh(model_parallelism=2)
    out = {"coords": mesh.coords}
    D = 8
    for J in (6, 3):
        out[f"split{J}"] = head_model_split(mesh, J)
        feats = torch.from_numpy(shard_host_batch(mesh, inputs["feats"]))
        hm = torch.from_numpy(shard_host_batch(mesh, inputs[f"hm{J}"]))
        cot = torch.from_numpy(shard_host_batch(mesh, inputs[f"cot{J}"]))
        block = model_slice(mesh, J * D)
        w = torch.from_numpy(inputs[f"w{J}"][block].copy())
        b = torch.from_numpy(inputs[f"b{J}"][block].copy())
        for t in (feats, hm, w, b):
            t.requires_grad_(True)
        coords = sharded_head_projection_integral(feats, w, b, J, D, mesh)
        (coords * cot).sum().backward()
        dw, db = w.grad.clone(), b.grad.clone()
        dist.all_reduce(dw, group=mesh.data_group)
        dist.all_reduce(db, group=mesh.data_group)
        hm_coords = sharded_softmax_integral(hm[..., block], J, D, mesh)
        (hm_coords * cot).sum().backward()
        out[f"head{J}"] = dict(coords=coords.detach(), dfeat=feats.grad,
                               dw=dw, db=db, hm_coords=hm_coords.detach(),
                               dhm=hm.grad[..., block])

    cfg = small_config()
    t = _trainer(cfg, model_parallelism=2,
                 model_dir=os.path.join(out_dir, "split"))
    out["mesh_shape"] = t.mesh.shape
    out["split_params"] = split_params(t.model)
    out["metrics"] = t.run_epoch(0, num_steps=2, log_every=100)
    out["params"] = {k: v.clone() for k, v in t.model.state_dict().items()}
    save_checkpoint(t.model_dir, t.model, t.optimizer, 0, mesh=t.mesh)
    return out


def job_serve(out_dir, rank, world):
    """Two ranks: TwoStagePipeline(mesh), float and int8, and the teacher
    labels (single pass and cascade) with `mesh=`, each against the same
    call without a mesh on this rank."""
    import torch
    from hand_integral_pose_estimation_tpu_torch.detect import (
        build_detector,
    )
    from hand_integral_pose_estimation_tpu_torch.distill import (
        CascadeRunner, generate_filtered_labels,
    )
    from hand_integral_pose_estimation_tpu_torch.inference import (
        TwoStagePipeline,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.parallel import make_mesh
    from hand_integral_pose_estimation_tpu_torch.training.teacher import (
        frozen_teacher,
    )
    case = torch.load(os.path.join(out_dir, "serve_case.pt"),
                      weights_only=False)
    cfg = case["cfg"]
    pose = get_pose_net(cfg.model)
    pose.load_state_dict(case["pose"])
    det = build_detector(cfg.detector)
    det.load_state_dict(case["det"])
    mesh = make_mesh()
    im, K, ref = case["images"], case["K"], case["ref"]
    out = {}
    for name, calib in (("float", None), ("int8", (im, K, ref))):
        for m in (mesh, None):
            pipe = TwoStagePipeline(cfg, pose, det, device="cpu", mesh=m,
                                    int8_calib=calib)
            out[f"{name}_{'mesh' if m else 'one'}"] = pipe(im, K, ref)
    for bad in (dict(split_detector=True), dict()):
        try:
            TwoStagePipeline(cfg, pose, det, device="cpu", mesh=mesh,
                             **bad)(im[:3], K[:3], ref[:3])
        except ValueError as e:
            out[f"refused_{len(bad)}"] = str(e)

    teacher = frozen_teacher(pose, cfg)
    sw = case["sweep"]
    for m in (mesh, None):
        key = "mesh" if m else "one"
        out[f"labels_{key}"] = generate_filtered_labels(
            teacher, sw["images"], sw["K"], sw["bbox"], sw["labelled"],
            sw["joint_cam"], cfg.augment, variance_threshold=1e-2,
            patch_hw=cfg.model.input_shape, mesh=m)._asdict()
        runner = CascadeRunner(teacher, cfg.augment, variance_threshold=1e-2,
                               patch_hw=cfg.model.input_shape, pass2_batch=2,
                               device="cpu", mesh=m)
        runner.add_batch(sw["images"], sw["K"], sw["bbox"], sw["labelled"],
                         sw["joint_cam"], torch.arange(4))
        out[f"cascade_{key}"] = runner.finalize(4)
    return out


def main():
    job, port, rank, world, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    torch.set_num_threads(1)
    from hand_integral_pose_estimation_tpu_torch.parallel import (
        init_distributed,
    )
    init_distributed("cpu")
    out = {"train": job_train, "model": job_model,
           "serve": job_serve}[job](out_dir, rank, world)
    torch.save(out, os.path.join(out_dir, f"{job}_rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
