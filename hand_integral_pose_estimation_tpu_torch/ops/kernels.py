"""Build, load and launch the hand-written CUDA kernels in `csrc/`.

The sources are compiled with `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with `ctypes`. The build happens at
the first launch, never at import, into `_build/` beside this package; the
library's file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on first use and need the CUDA toolkit")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libhipe_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/*.cu` into the hashed library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


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


_P, _I = ctypes.c_void_p, ctypes.c_int

#: (hm, dtype, coords, m, s, B, H, W, J, D, stream)
SOFTMAX_INTEGRAL_FWD = Kernel(
    "hipe_softmax_integral_fwd", [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P])
#: (feats, dtype, weight, bias, coords, m, s, B, H, W, F, J, D, stream)
HEAD_PROJECTION_INTEGRAL_FWD = Kernel(
    "hipe_head_projection_integral_fwd",
    [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])

KERNELS = (SOFTMAX_INTEGRAL_FWD, HEAD_PROJECTION_INTEGRAL_FWD)
