"""What the fused head's backward past 256 features (the ring kernels of
`csrc/k_slices.cuh`) could gain from moving fewer bytes, or from faster
products: build two altered copies of the port and time their backward
beside this tree's, with `scripts/fused_head_bwd_times.py`, in turns
(this tree, no copies, no products, this tree).

- "no copies": the ring's bulk copies move nothing and each stage's
  barrier completes at once, so the products read whatever shared memory
  holds. Its time is the kernels' time with unlimited bandwidth from L2:
  no cut of the bytes (a multicast of the weight slices over a cluster,
  say) can bring them below it.
- "no products": the ring's logits, dfeat and dW products issue no
  wgmma. Its time is that of the copies, the waits, the exchange of the
  partial logits and g's arithmetic alone.

Both give wrong results; only their times mean something. The copies are
built under `hand_integral_pose_estimation_tpu_torch/_build/variants/`.
Needs a CUDA device:

    python scripts/fused_head_bwd_probe.py --widths 260 512
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "hand_integral_pose_estimation_tpu_torch"

# (file in csrc/, text, replacement) of each variant
VARIANTS = {
    "no copies": [
        ("k_slices.cuh",
         '"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(\n'
         '          smem_addr(bar)),\n      "r"(bytes)',
         '"mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(\n'
         '          smem_addr(bar))'),
        ("k_slices.cuh",
         '  asm volatile(\n'
         '      "cp.async.bulk.shared::cluster.global.mbarrier::'
         'complete_tx::bytes "',
         '  if (bytes == 0) asm volatile(\n'
         '      "cp.async.bulk.shared::cluster.global.mbarrier::'
         'complete_tx::bytes "'),
    ],
    "no products": [
        ("k_slices.cuh", "      wgmma_64x64x16(xs, core_desc(",
         "      if (kProbeProducts) wgmma_64x64x16(xs, core_desc("),
        ("k_slices.cuh", "      wgmma_64x64x16_rs(\n          acc, a[s]",
         "      if (kProbeProducts) wgmma_64x64x16_rs(\n          acc, a[s]"),
        ("k_slices.cuh",
         "    wgmma_64x64x16_rs(acc, a[s][0], core_desc_mn(hi, kSlice));\n"
         "    wgmma_64x64x16_rs(acc, a[s][0],\n"
         "                      core_desc_mn(hi + kSlicePlaneBytes, kSlice));\n"
         "    wgmma_64x64x16_rs(acc, a[s][1], core_desc_mn(hi, kSlice));",
         "    if (kProbeProducts) {\n"
         "    wgmma_64x64x16_rs(acc, a[s][0], core_desc_mn(hi, kSlice));\n"
         "    wgmma_64x64x16_rs(acc, a[s][0],\n"
         "                      core_desc_mn(hi + kSlicePlaneBytes, kSlice));\n"
         "    wgmma_64x64x16_rs(acc, a[s][1], core_desc_mn(hi, kSlice)); }"),
        ("k_slices.cuh", "constexpr int kSlice = 64;",
         "constexpr bool kProbeProducts = false;\nconstexpr int kSlice = 64;"),
    ],
}


def build_variant(name: str) -> Path:
    """A copy of the port with `name`'s patch applied; returns its root."""
    root = ROOT / PKG / "_build" / "variants" / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in VARIANTS[name]:
        path = root / PKG / "csrc" / fname
        text = path.read_text()
        if text.count(old) < 1:
            sys.exit(f"variant {name!r}: {fname} has no {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return root


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", type=int, nargs="+", default=[260, 512])
    args = ap.parse_args()
    roots = {"this tree": ROOT}
    for name in VARIANTS:
        roots[name] = build_variant(name)
    # the three trees' kernels, built at once
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         f"from {PKG}.ops import kernels; kernels.build()", str(root)])
        for root in roots.values()]
    if any(b.wait() for b in builds):
        sys.exit("a build failed")
    times = ROOT / "scripts" / "fused_head_bwd_times.py"
    for label in ("this tree", "no copies", "no products", "this tree"):
        subprocess.run([sys.executable, str(times), "--root",
                        str(roots[label]), "--label", label, "--widths",
                        *map(str, args.widths)], check=True)


if __name__ == "__main__":
    main()
