"""Build the JAX package's native IO library once, atomically, before the
suite's workers collect tests/test_yuv.py.

tests/test_yuv.py calls `native_loader.load_library()` while it is
collected, and `load_library` runs `make` when `native/libhipe_io.so` is
missing. With several pytest-xdist workers collecting at once, each starts
its own `make` into the same file, and a worker can `dlopen` a library
another worker is still writing ("file too short"). Its collection then
differs from the others', and xdist aborts the whole run. Every worker
imports this module first (files are collected in name order), so the
library is built here by one worker under a file lock, in a private
directory with the repo's own Makefile, and moved into place with one
atomic rename; the others wait on the lock and find it whole.

The port itself does not use this library; its kernel builds
(`ops/kernels.py`) are atomic the same way.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile

import pytest

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
LIB = os.path.join(NATIVE, "libhipe_io.so")


def _build_once() -> None:
    lock_path = os.path.join(tempfile.gettempdir(), "hipe_io_build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(LIB):
            return
        with tempfile.TemporaryDirectory() as tmp:
            for name in ("Makefile", "hipe_io.cpp"):
                shutil.copy(os.path.join(NATIVE, name), tmp)
            proc = subprocess.run(["make", "-C", tmp], capture_output=True,
                                  timeout=300)
            built = os.path.join(tmp, "libhipe_io.so")
            # a failed build leaves nothing: test_yuv.py then fails to build
            # it in every worker alike and skips consistently
            if proc.returncode == 0 and os.path.exists(built):
                staged = LIB + f".tmp{os.getpid()}"
                shutil.copy(built, staged)
                os.replace(staged, LIB)


_build_once()


def test_native_library_is_whole_when_present():
    if not os.path.exists(LIB):
        pytest.skip("native/libhipe_io.so could not be built here")
    lib = ctypes.CDLL(LIB)
    assert hasattr(lib, "hipe_decode_jpeg")
