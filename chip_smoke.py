"""Smoke test of the PyTorch / CUDA port's pose-serving path on one GPU.

    python3 chip_smoke.py

Four phases, each printing what it found; any failure exits non-zero
before the result line.

1. device: requires CUDA (there is no CPU fallback), prints the card, its
   power limit, the torch and CUDA versions and the TF32 switches (both set
   off, so float32 matmuls and convs run in full float32);
2. build: compiles the CUDA kernels from `csrc/` and prints the seconds;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and at a small ragged shape;
4. slice: the flagship model (ModelConfig(): ResNet-50, 224x224, bf16,
   21 joints x 56 depth x 56x56) with seeded random weights sweeps 80
   synthetic samples through `Tester.run` at batch 32 (three batches, the
   last padded) on both head arms, then `evaluate_test_split`; it checks
   the launch counts, the finite metrics and the coords against the plain
   head, and times the slice and both kernels with CUDA events.

The line before the last is the card's name and power limit; the last line
is the JSON result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 32
N_SAMPLES = 80
SEED = 0
# Coords are means of positions in [-0.5, 0.5] weighted by softmax terms
# that kernel and plain version compute from the same float32 logits; only
# the summation order differs (~1e-6 relative over 175k terms), so 1e-4 is
# far from both the noise and any indexing or scaling fault.
COORD_TOL = 1e-4
S_REL_TOL = 1e-4
# The unfused arm decodes the bf16 heatmap of the bf16 final conv, where
# the fused arm forms float32 logits from float32 weights. bf16 keeps 8
# bits: at logit magnitudes up to ~30 the rounding moves a logit by up to
# ~0.1, which reweights near-tied peaks by ~10%; a joint whose mass sits on
# peaks far apart can move by that share of their distance.
ARMS_MEAN_TOL = 1e-2
ARMS_MAX_TOL = 0.1
# logit spread the head is scaled to, so each joint's softmax is peaked
LOGIT_STD = 6.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, kernel_fn, plain_fn):
    """Run the kernel, synchronise, run the plain version; max abs error of
    coords and m, max relative error of s."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    e_c = float((got[0] - want[0]).abs().max())
    e_m = float((got[1] - want[1]).abs().max())
    e_s = float(((got[2] - want[2]) / want[2]).abs().max())
    ok = e_c <= COORD_TOL and e_m <= COORD_TOL and e_s <= S_REL_TOL
    print(f"[kernels] {name}: max|d coords| {e_c:.3e} (tol {COORD_TOL:g}), "
          f"max|d m| {e_m:.3e}, max rel d s {e_s:.3e} (tol {S_REL_TOL:g}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    check(ok, f"{name} disagrees with its plain version")
    return e_c


def time_pair(kernel_fn, plain_fn, iters=10):
    """Kernel vs plain version in turns (plain, kernel, kernel, plain)."""
    for fn in (kernel_fn, plain_fn):
        fn()
    torch.cuda.synchronize()
    p1 = event_ms(plain_fn, iters)
    k1 = event_ms(kernel_fn, iters)
    k2 = event_ms(kernel_fn, iters)
    p2 = event_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA GPU")

    from hand_integral_pose_estimation_tpu_torch.config import Config
    from hand_integral_pose_estimation_tpu_torch.data import (
        SyntheticFreiHand,
        make_eval_batch,
    )
    from hand_integral_pose_estimation_tpu_torch.evaluation import (
        evaluate_test_split,
    )
    from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
    from hand_integral_pose_estimation_tpu_torch.ops import kernels
    from hand_integral_pose_estimation_tpu_torch.ops.fused_head import (
        head_projection_integral_cuda,
        head_projection_integral_reference,
    )
    from hand_integral_pose_estimation_tpu_torch.ops.integral import (
        softmax_integral_cuda,
        softmax_integral_reference,
    )
    from hand_integral_pose_estimation_tpu_torch.training import Tester

    # ---- 1. device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"[build] {lib_path.name} from {kernels.CSRC.name}/ in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. kernels against their plain versions
    g = torch.Generator(device=dev).manual_seed(SEED)
    cfg = Config()
    J, D = cfg.model.num_joints, cfg.model.depth_dim
    Ho, Wo = cfg.model.output_shape
    F = cfg.model.deconv_channels
    err = {"softmax_integral_fwd": 0.0, "head_projection_integral_fwd": 0.0}
    for (B, H, W, j, d, f) in ((BATCH, Ho, Wo, J, D, F), (1, 8, 8, 3, 4, 40)):
        for dt in (torch.float32, torch.bfloat16):
            hm = (3 * torch.randn(B, H, W, j * d, device=dev,
                                  generator=g)).to(dt)
            e = compare(f"softmax_integral_fwd {(B, H, W, j * d)} {dt}",
                        lambda: softmax_integral_cuda(hm, j, d),
                        lambda: softmax_integral_reference(hm, j, d))
            err["softmax_integral_fwd"] = max(err["softmax_integral_fwd"], e)
        feats = torch.randn(B, H, W, f, device=dev,
                            generator=g).to(torch.bfloat16)
        w = 0.3 * torch.randn(j * d, f, device=dev, generator=g)
        b = torch.randn(j * d, device=dev, generator=g)
        e = compare(f"head_projection_integral_fwd {(B, H, W, f)}x"
                    f"{(j * d, f)} bf16/f32",
                    lambda: head_projection_integral_cuda(feats, w, b, j, d),
                    lambda: head_projection_integral_reference(feats, w, b, j,
                                                               d))
        err["head_projection_integral_fwd"] = max(
            err["head_projection_integral_fwd"], e)

    # ---- 4. the slice
    model = get_pose_net(cfg.model,
                         generator=torch.Generator().manual_seed(SEED))
    dataset = SyntheticFreiHand(n=N_SAMPLES, render_joints=True, seed=SEED)
    fused = Tester(cfg, dataset, model, device=dev, fuse_head=True)
    unfused = Tester(cfg, dataset, model, device=dev, fuse_head=False)
    probe = fused.preprocess(dataset.host_batch(np.arange(BATCH)))
    # the reference init N(0, 0.001) leaves every joint's softmax flat and
    # every decode near 0, where a broken kernel would still pass: scale the
    # projection to a LOGIT_STD logit spread instead
    with torch.inference_mode():
        feats = model(probe.image, return_features=True).float()
        rms = float(feats.pow(2).sum(-1).mean().sqrt())
    with torch.no_grad():
        final = model.head.final_layer
        final.weight.normal_(0.0, LOGIT_STD / rms,
                             generator=torch.Generator(dev).manual_seed(SEED))
        final.bias.zero_()

    for k in kernels.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    coords_f, batch_f = fused.run(batch_size=BATCH)
    coords_u, batch_u = unfused.run(batch_size=BATCH)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels.KERNELS}
    n_batches = math.ceil(N_SAMPLES / BATCH)
    print(f"[slice] swept {N_SAMPLES} samples in {n_batches} batches of "
          f"{BATCH} per arm ({sweep_s:.2f} s host clock, first calls "
          f"included); launches {launches}", flush=True)
    check(kernels.HEAD_PROJECTION_INTEGRAL_FWD.launches == n_batches,
          f"fused-head kernel launched "
          f"{kernels.HEAD_PROJECTION_INTEGRAL_FWD.launches} times, expected "
          f"{n_batches}")
    check(kernels.SOFTMAX_INTEGRAL_FWD.launches == n_batches,
          f"soft-argmax kernel launched "
          f"{kernels.SOFTMAX_INTEGRAL_FWD.launches} times, expected "
          f"{n_batches}")

    for name, coords, batch in (("fused", coords_f, batch_f),
                                ("unfused", coords_u, batch_u)):
        check(coords.shape == (N_SAMPLES, J, 3), f"{name} coords shape "
              f"{coords.shape}")
        check(bool(np.isfinite(coords).all()), f"{name} coords not finite")
        check(bool((np.abs(coords) <= 0.5).all()),
              f"{name} coords outside [-0.5, 0.5]")
        summary = evaluate_test_split(coords, batch)
        print(f"[slice] {name} arm: PA-MPJPE {summary['pa_mpjpe']:.6f} m, "
              f"MPJPE {summary['mpjpe']:.6f} m, coords std "
              f"{coords.std():.4f}", flush=True)
        check(math.isfinite(summary["pa_mpjpe"])
              and math.isfinite(summary["mpjpe"]),
              f"{name} metrics not finite: {summary}")
    check(coords_f.std() > 0.02, f"decoded coords are degenerate (std "
          f"{coords_f.std():.4f}): the heads are not peaked")

    with torch.inference_mode():
        feats = model(probe.image, return_features=True)
        weight, bias = model.final_projection()
        got = head_projection_integral_cuda(feats, weight, bias, J, D)
        want = head_projection_integral_reference(feats, weight, bias, J, D)
        torch.cuda.synchronize()
    e_ref = float((got[0] - want[0]).abs().max())
    e_run = float(np.abs(got[0].cpu().numpy() - coords_f[:BATCH]).max())
    peak = float((1.0 / want[2]).median())
    print(f"[slice] model + fused kernel vs model + plain head on batch 0: "
          f"max|d coords| {e_ref:.3e} (tol {COORD_TOL:g}); vs the sweep "
          f"{e_run:.3e}; median peak softmax mass 1/s {peak:.3f}", flush=True)
    check(e_ref <= COORD_TOL and e_run <= COORD_TOL,
          "fused kernel disagrees with the plain head on the model")
    d_arms = np.abs(coords_f - coords_u)
    print(f"[slice] unfused (bf16 heatmap) vs fused arm: mean|d| "
          f"{d_arms.mean():.3e} (tol {ARMS_MEAN_TOL:g}), max|d| "
          f"{d_arms.max():.3e} (tol {ARMS_MAX_TOL:g})", flush=True)
    check(d_arms.mean() <= ARMS_MEAN_TOL and d_arms.max() <= ARMS_MAX_TOL,
          "unfused and fused arms disagree")

    # ---- timing. One batch at a time between CUDA events (the device
    # waits while the host issues the batch's ops), then 20 batches back to
    # back on the host clock, ending in a synchronize (host issue overlaps
    # device work). Host batches are already on the card.
    host = {k: (None if v is None else torch.from_numpy(
        np.ascontiguousarray(v)).to(dev))
        for k, v in dataset.host_batch(np.arange(BATCH)).items()}
    for name, tester in (("fused", fused), ("unfused", unfused)):
        def step():
            batch = make_eval_batch(host["image"], host["joint_cam"],
                                    host["K"], host["bbox_detector"],
                                    host["ref_bone_len"], cfg.augment,
                                    cfg.model.input_shape)
            tester.eval_step(batch)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        times = [event_ms(step, 1) for _ in range(20)]
        med = statistics.median(times)
        print(f"[slice] {name} arm, crop + R50 + head + decode at batch "
              f"{BATCH}: median {med:.3f} ms/batch over {len(times)} "
              f"batches (min {min(times):.3f}, max {max(times):.3f}), "
              f"{BATCH / med * 1e3:.1f} img/s on {card}", flush=True)
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / 20 * 1e3
        print(f"[slice] {name} arm back to back: {per:.3f} ms/batch over 20 "
              f"batches (host clock), {BATCH / per * 1e3:.1f} img/s on "
              f"{card}", flush=True)

    hm = (3 * torch.randn(BATCH, Ho, Wo, J * D, device=dev,
                          generator=g)).to(torch.bfloat16)
    hm32 = hm.float()
    feats = torch.randn(BATCH, Ho, Wo, F, device=dev,
                        generator=g).to(torch.bfloat16)
    w = 0.1 * torch.randn(J * D, F, device=dev, generator=g)
    b = torch.randn(J * D, device=dev, generator=g)
    times = {
        "softmax_integral_fwd": time_pair(
            lambda: softmax_integral_cuda(hm, J, D),
            lambda: softmax_integral_reference(hm, J, D)),
        "head_projection_integral_fwd": time_pair(
            lambda: head_projection_integral_cuda(feats, w, b, J, D),
            lambda: head_projection_integral_reference(feats, w, b, J, D)),
    }
    k32, p32 = time_pair(lambda: softmax_integral_cuda(hm32, J, D),
                         lambda: softmax_integral_reference(hm32, J, D))
    for name, (k, p) in times.items():
        print(f"[slice] {name} at the serving shape: kernel {k:.4f} ms, "
              f"plain {p:.4f} ms on {card}", flush=True)
    print(f"[slice] softmax_integral_fwd with a float32 heatmap: kernel "
          f"{k32:.4f} ms, plain {p32:.4f} ms on {card}", flush=True)

    meta = {
        "softmax_integral_fwd": (
            "hand_integral_pose_estimation_tpu_torch/csrc/softmax_integral.cu",
            "hand_integral_pose_estimation_tpu/ops/integral.py:75"),
        "head_projection_integral_fwd": (
            "hand_integral_pose_estimation_tpu_torch/csrc/"
            "head_projection_integral.cu",
            "hand_integral_pose_estimation_tpu/ops/fused_head.py:40"),
    }
    symbol = {"softmax_integral_fwd": kernels.SOFTMAX_INTEGRAL_FWD.symbol,
              "head_projection_integral_fwd":
                  kernels.HEAD_PROJECTION_INTEGRAL_FWD.symbol}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": launches[symbol[name]],
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in meta]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
