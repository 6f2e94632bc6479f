"""Build, load and launch the hand-written CUDA kernels in `csrc/`.

The sources are compiled with `nvcc` for Hopper (`sm_90a`), one process per
source file and all at once, and linked into one shared library with a
plain C interface, loaded with `ctypes`. The build happens at the first
launch, never at import, into `_build/` beside this package; the library's
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.

Each :class:`Kernel` counts its successful launches in `launches`, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-shared",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def cuda_tool(name: str) -> str | None:
    """Path of a CUDA toolkit program (`nvcc`, `cuobjdump`), or None."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", name)
    return path if os.path.exists(path) else None


def _nvcc() -> str:
    path = cuda_tool("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on first use and need the CUDA toolkit")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libhipe_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/*.cu` into the hashed library unless it exists: one
    `nvcc -c` per source, started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        sources = [p for p in _sources() if p.suffix == ".cu"]
        objects = [work / f"{p.stem}.o" for p in sources]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", str(src), "-o",
                                   str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objects)]
        failed = []
        for src, proc in zip(sources, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = work / out.name
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


#: the tensor-core kernels of the fused head (kernels 3 and 4, bf16 path)
MMA_KERNELS = ("hp_fwd_mma_kernel", "hp_bwd_dfeat_mma_kernel",
               "hp_bwd_dweight_mma_kernel")


def tensor_core_instructions(names=MMA_KERNELS) -> dict[str, int]:
    """The number of tensor-core product instructions (HMMA, HGMMA) in the
    SASS of each named kernel of the built library, from `cuobjdump
    --dump-sass`; a name matches the kernels whose mangled names hold it.
    Raises if `cuobjdump` is missing or a name matches no kernel."""
    tool = cuda_tool("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found")
    sass = subprocess.run([tool, "--dump-sass", str(build())],
                          capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            symbol = line.split("Function :", 1)[1].strip()
            current = next((n for n in names if n in symbol), None)
            if current is not None:
                counts.setdefault(current, 0)
        elif current is not None and ("HMMA" in line or "HGMMA" in line):
            counts[current] += 1
    missing = [n for n in names if n not in counts]
    if missing:
        raise RuntimeError(f"no kernel named {missing} in the library")
    return counts


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.hipe_error_string.argtypes = [ctypes.c_int]
            lib.hipe_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One C entry point of the library. Arguments are Python ints: data
    pointers and the stream as `c_void_p`, sizes and dtype codes as
    `c_int`. The C function returns `cudaGetLastError()` after its launch;
    a non-zero code raises, so a refused launch is never silent."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0

    def __call__(self, *args) -> None:
        lib = library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} "
                               f"({lib.hipe_error_string(rc).decode()})")
        self.launches += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: (hm, dtype, coords, m, s, B, H, W, J, D, stream)
SOFTMAX_INTEGRAL_FWD = Kernel(
    "hipe_softmax_integral_fwd", [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P])
#: (feats, dtype, weight, bias, coords, m, s, ws, B, H, W, F, J, D,
#:  chunks per image, stream)
HEAD_PROJECTION_INTEGRAL_FWD = Kernel(
    "hipe_head_projection_integral_fwd",
    [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])

#: (hm, dtype, m, T, A, B, grad, B, H*W, W, J*D, stream)
SOFTMAX_INTEGRAL_BWD = Kernel(
    "hipe_softmax_integral_bwd",
    [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
#: (feats, dtype, weight, bias, m, T, A, B, dfeat, dW, db, ws, ws_db,
#:  B, H, W, F, J, D, chunks per image, stream)
HEAD_PROJECTION_INTEGRAL_BWD = Kernel(
    "hipe_head_projection_integral_bwd",
    [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
     _I, _I, _I, _I, _I, _I, _I, _P])
#: (images, coef, tmp, out, B, Hs, Ws, Ho, Wo, C, stream)
WARP_TWOPASS = Kernel(
    "hipe_warp_twopass", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])

#: (feats, rois, out, B, H, W, C, R, pooled, sampling ratio,
#:  spatial scale, stream)
ROI_ALIGN_FWD = Kernel(
    "hipe_roi_align_fwd", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P])
#: (boxes, alive, mask, keep, B, N, iou threshold, plus one, stop after,
#:  stream)
NMS = Kernel("hipe_nms", [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P])

KERNELS = (SOFTMAX_INTEGRAL_FWD, HEAD_PROJECTION_INTEGRAL_FWD,
           SOFTMAX_INTEGRAL_BWD, HEAD_PROJECTION_INTEGRAL_BWD, WARP_TWOPASS,
           ROI_ALIGN_FWD, NMS)
