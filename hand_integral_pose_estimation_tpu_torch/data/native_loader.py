"""ctypes binding of the native JPEG decoder (native/hipe_io.cpp).

Port of `load_library` and `decode_jpeg` of
hand_integral_pose_estimation_tpu/data/native_loader.py: numpy and ctypes
over `native/libhipe_io.so`, the one file the port shares with the JAX
package at run time. There is no cv2 fallback, and the library is not
built on import or on first use: where it is missing, `load_library`
raises and says how to build it (`make -C native`, which needs the libjpeg
headers). The prefetching `NativeLoader` is not ported yet.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libhipe_io.so")

_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """The decoder library, loaded once; raises FileNotFoundError when
    `native/libhipe_io.so` has not been built."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(LIB_PATH):
        raise FileNotFoundError(
            f"{LIB_PATH} is missing: build it with `make -C {NATIVE_DIR}` "
            f"(needs g++ and the libjpeg headers)")
    lib = ctypes.CDLL(LIB_PATH)
    lib.hipe_decode_jpeg.restype = ctypes.c_int
    lib.hipe_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int]
    _lib = lib
    return lib


def decode_jpeg(path: str, height: int = 224, width: int = 224
                ) -> np.ndarray:
    """Decode one JPEG to an RGB (height, width, 3) uint8 array, resized
    bilinearly when the file has another size."""
    lib = load_library()
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.hipe_decode_jpeg(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height, width)
    if rc != 0:
        raise IOError(f"hipe_decode_jpeg({path}) -> {rc}")
    return out
