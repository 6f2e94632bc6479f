"""Time the fused head's backward (kernel 4; 4f with float32 features) on
the card at the serving shape, batch 32 x 56 x 56 positions, 21 joints x
56 depth slots, at the widths F given: CUDA events over `--iters` calls in
turns with its plain PyTorch version (plain, kernel, kernel, plain), beside
the bound (the three 1x1 projections' operations at the tensor-core rate
of the dtype's bf16 split: 989/3 TFLOP/s for bf16 features, 989/6 for
float32 ones), and one call's device time by kernel from a profiler trace:
the split of the operands into bf16 planes (s), `channel_constants`'
kernels, dfeat (a), the dW and db partials (b) and their sum (c).

`--root` imports the port from another checkout, so that two trees can be
timed on one card in one call, in turns:

    python scripts/fused_head_bwd_times.py --widths 260 512 1024
    python scripts/fused_head_bwd_times.py --root /path/to/parent --label parent

Each run prints a line per width and dtype and, last, one JSON object of
its times. It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

BATCH, HW, J, D = 32, 56, 21, 56
HBM_BYTES_PER_S = 3.35e12
RATES = {"bfloat16": 989e12 / 3, "float32": 989e12 / 6}


def kernel_group(name: str) -> str:
    """The step of the backward a device kernel belongs to."""
    if "hp_split" in name:
        return "s"
    if "hp_bwd_dfeat" in name:
        return "a"
    if "hp_bwd_dweight" in name:
        return "b"
    if "hp_bwd_reduce" in name:
        return "c"
    return "channel_constants"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--widths", type=int, nargs="+", default=[260, 512, 1024])
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_head_bwd_times.py needs a CUDA device")
    from hand_integral_pose_estimation_tpu_torch.ops import fused_head as fh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def event_ms(fn, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    out = {"label": args.label, "root": os.path.abspath(args.root),
           "card": card, "times": []}
    for f in args.widths:
        feats = torch.randn(BATCH, HW, HW, f, device=dev, generator=g)
        w = (0.1 * 16 / math.sqrt(f)) * torch.randn(J * D, f, device=dev,
                                                     generator=g)
        b = 0.1 * torch.randn(J * D, device=dev, generator=g)
        cot = torch.randn(BATCH, J, 3, device=dev, generator=g)
        for name in ("bfloat16", "float32"):
            x = feats.to(getattr(torch, name))
            coords, m, s = fh.head_projection_integral_cuda(x, w, b, J, D)

            def kernel():
                return fh.head_projection_integral_bwd_cuda(
                    x, w, b, m, s, coords, cot, J, D)

            def plain():
                return fh.head_projection_integral_bwd_reference(
                    x, w, b, m, s, coords, cot, J, D)

            kernel(), plain()
            torch.cuda.synchronize()
            p1 = event_ms(plain, args.iters)
            k1 = event_ms(kernel, args.iters)
            k2 = event_ms(kernel, args.iters)
            p2 = event_ms(plain, args.iters)
            flops = 3 * 2.0 * x.numel() * w.shape[0]
            fbytes = 2 * (x.numel() * x.element_size() + w.numel() * 4)
            bound = max(flops / RATES[name], fbytes / HBM_BYTES_PER_S) * 1e3
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                kernel()
                torch.cuda.synchronize()
            by_step: dict[str, float] = {}
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                t = getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3
                step = kernel_group(e.key)
                by_step[step] = by_step.get(step, 0.0) + t
            row = {"F": f, "dtype": name, "kernel_ms": (k1 + k2) / 2,
                   "kernel_ms_turns": [k1, k2], "plain_ms": (p1 + p2) / 2,
                   "bound_ms": bound, "device_ms_by_step": by_step}
            out["times"].append(row)
            steps = ", ".join(f"({k}) {v:.4f}" for k, v in sorted(
                by_step.items()))
            print(f"[bwd times] {args.label}: F = {f} {name}: kernel "
                  f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
                  f"bound {bound:.4f} ms (operations), "
                  f"{100 * bound / ((k1 + k2) / 2):.1f} % of it; device ms "
                  f"by step: {steps}; on {card}", flush=True)
            del x, coords, m, s
        del feats, w
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
