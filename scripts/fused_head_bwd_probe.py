"""What the fused head past 256 features (the slice-walking kernels of
`csrc/k_slices.cuh`, forward and backward) could gain from moving fewer
bytes, or from faster products: build two altered copies of the port and
time them beside the unaltered tree, with `scripts/fused_head_bwd_times.py`,
in turns (unaltered, no copies, no products, unaltered).

- "no copies": the rings' bulk copies move nothing and each stage's
  barrier completes at once (in a tree whose slice forward still stages
  with cp.async, `hp_fwd_slices_kernel`, its copies are not issued), so
  the products read whatever shared memory holds. Its time is the
  kernels' time with unlimited bandwidth from L2: no cut of the bytes (a
  multicast of the slices over a cluster, say) can bring them below it.
- "no products": the logits', dfeat's and dW's products issue no wgmma.
  Its time is that of the copies, the waits, the exchange of the partial
  logits and the arithmetic around the products alone.
Both give wrong results; only their times mean something. A patch whose
text a tree lacks is skipped, and a variant none of whose patches applies
is left out, so that `--root` can probe an older tree as well. The copies are built under
`hand_integral_pose_estimation_tpu_torch/_build/variants/` of this tree.
Needs a CUDA device:

    python scripts/fused_head_bwd_probe.py --widths 260 512
    python scripts/fused_head_bwd_probe.py --root /path/to/parent --directions fwd
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "hand_integral_pose_estimation_tpu_torch"

# (file in the package, text, replacement) of each variant
VARIANTS = {
    "no copies": [
        ("head_projection_integral_mma.cu",
         "    copy_plane_slice(st, wblock,",
         "    if (false) copy_plane_slice(st, wblock,"),
        ("head_projection_integral_mma.cu",
         "    copy_tile_slice<kParts>(feats, b,",
         "    if (false) copy_tile_slice<kParts>(feats, b,"),
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
        ("k_slices.cuh", "        wgmma_64x128x16(xs, a, b,",
         "        if (kProbeProducts) wgmma_64x128x16(xs, a, b,"),
        ("k_slices.cuh", "        wgmma_64x64x16(xs, a, b,",
         "        if (kProbeProducts) wgmma_64x64x16(xs, a, b,"),
        ("k_slices.cuh", "constexpr int kSlice = 64;",
         "constexpr bool kProbeProducts = false;\nconstexpr int kSlice = 64;"),
    ],
}


def build_variant(source: Path, name: str) -> Path | None:
    """A copy of the port in tree `source` with the patches of `name` that
    its sources hold applied; returns the copy's root, or None where none
    applies."""
    root = ROOT / PKG / "_build" / "variants" / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(source / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    applied = 0
    for fname, old, new in VARIANTS[name]:
        path = root / PKG / "csrc" / fname
        text = path.read_text()
        if old in text:
            path.write_text(text.replace(old, new))
            applied += 1
    print(f"[probe] {name}: {applied} of {len(VARIANTS[name])} patches "
          f"applied to {source}", flush=True)
    return root if applied else None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", type=int, nargs="+", default=[260, 512])
    ap.add_argument("--directions", nargs="+", choices=("fwd", "bwd"),
                    default=["fwd", "bwd"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the tree to probe (default: this one)")
    args = ap.parse_args()
    source = args.root.resolve()
    roots = {"unaltered": source}
    for name in VARIANTS:
        root = build_variant(source, name)
        if root is not None:
            roots[name] = root
    # the trees' kernels, built at once
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         f"from {PKG}.ops import kernels; kernels.build()", str(root)])
        for root in roots.values()]
    if any(b.wait() for b in builds):
        sys.exit("a build failed")
    times = ROOT / "scripts" / "fused_head_bwd_times.py"
    for label in (*roots, "unaltered"):
        subprocess.run([sys.executable, str(times), "--root",
                        str(roots[label]), "--label", label, "--widths",
                        *map(str, args.widths), "--directions",
                        *args.directions, "--iters", str(args.iters)],
                       check=True)


if __name__ == "__main__":
    main()
