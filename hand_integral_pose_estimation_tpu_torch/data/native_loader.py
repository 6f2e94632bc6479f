"""ctypes binding of the native JPEG decoder and its batch prefetcher
(native/hipe_io.cpp).

Port of hand_integral_pose_estimation_tpu/data/native_loader.py: numpy and
ctypes over `native/libhipe_io.so`, the one file the port shares with the
JAX package at run time. `decode_jpeg` decodes one file to RGB,
`decode_jpeg_yuv420` to its packed 4:2:0 planes (finished on the device by
`ops.yuv.yuv420_to_rgb`, bitwise equal to the RGB decode), and
`NativeLoader` decodes whole batches on a C++ thread pool with
submit / wait double buffering, so that the next batch decodes while the
device runs the current one (the reference's DataLoader workers,
common/base.py:141-145).

There is no cv2 fallback, and the library is not built on import or on
first use: where it is missing, `load_library` raises and says how to
build it (`make -C native`, which needs the libjpeg headers).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from hand_integral_pose_estimation_tpu_torch.ops.yuv import planar_sizes

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libhipe_io.so")
LAYOUTS = ("rgb", "yuv420")

_lib: Optional[ctypes.CDLL] = None
_u8p = ctypes.POINTER(ctypes.c_uint8)


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
    for name in ("hipe_decode_jpeg", "hipe_decode_jpeg_yuv420"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_int, ctypes.c_int]
    for name in ("hipe_loader_create", "hipe_loader_create_yuv420"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] * 4
    lib.hipe_loader_destroy.restype = None
    lib.hipe_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.hipe_loader_submit.restype = ctypes.c_int
    lib.hipe_loader_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.hipe_loader_wait.restype = ctypes.c_int
    lib.hipe_loader_wait.argtypes = [ctypes.c_void_p, _u8p]
    _lib = lib
    return lib


def decode_jpeg(path: str, height: int = 224, width: int = 224
                ) -> np.ndarray:
    """Decode one JPEG to an RGB (height, width, 3) uint8 array, resized
    bilinearly when the file has another size."""
    lib = load_library()
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.hipe_decode_jpeg(path.encode(), out.ctypes.data_as(_u8p),
                              height, width)
    if rc != 0:
        raise IOError(f"hipe_decode_jpeg({path}) -> {rc}")
    return out


def decode_jpeg_yuv420(path: str, height: int = 224, width: int = 224
                       ) -> np.ndarray:
    """Decode one 4:2:0 JPEG to its packed planes: (height*width*3//2,)
    uint8, the Y plane, then Cb (h/2, w/2), then Cr. Raises ValueError for
    odd sizes and IOError when the file is not a (height, width) 4:2:0
    JPEG (there is no resize in this mode)."""
    lib = load_library()
    ny, nc, _ = planar_sizes(height, width)
    out = np.empty((ny + 2 * nc,), np.uint8)
    rc = lib.hipe_decode_jpeg_yuv420(path.encode(), out.ctypes.data_as(_u8p),
                                     height, width)
    if rc != 0:
        raise IOError(f"hipe_decode_jpeg_yuv420({path}) -> {rc} "
                      "(-3 = not a matching 4:2:0 JPEG)")
    return out


class NativeLoader:
    """Double-buffered batch decoder::

        loader = NativeLoader(batch=32)
        loader.submit(paths0)
        while ...:
            images = loader.wait()      # (n, H, W, 3) uint8 RGB
            loader.submit(next_paths)   # decodes while the device runs

    With `layout="yuv420"` batches stay in the files' own subsampled
    planar form, (n, H*W*3//2) uint8, half the bytes of RGB, and the
    consumer finishes the decode on the device with
    `ops.yuv.yuv420_to_rgb`; every file must then be an (H, W) 4:2:0
    JPEG. RGB mode resizes files of another size bilinearly, as
    `decode_jpeg` does. A batch with a missing, corrupt or (in YUV mode)
    mismatched file raises IOError from `wait`; the loader stays usable.
    `close()` (or leaving a `with` block) frees the native loader."""

    def __init__(self, batch: int, height: int = 224, width: int = 224,
                 num_threads: Optional[int] = None, layout: str = "rgb"):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got "
                             f"{layout!r}")
        if layout == "yuv420":
            planar_sizes(height, width)     # raises on odd sizes
        self.batch = batch
        self.height = height
        self.width = width
        self.layout = layout
        self._lib = load_library()
        self._pending: Optional[list[str]] = None
        threads = num_threads or min(os.cpu_count() or 8, 16)
        create = (self._lib.hipe_loader_create_yuv420 if layout == "yuv420"
                  else self._lib.hipe_loader_create)
        self._handle = create(threads, height, width, batch)
        if not self._handle:
            raise ValueError(
                f"hipe_loader_create{'_yuv420' if layout == 'yuv420' else ''}"
                f" refused batch {batch} of {height}x{width} with {threads} "
                f"threads (each must be positive, and even sizes in YUV "
                f"mode)")

    @property
    def row_bytes(self) -> int:
        """Bytes of one decoded image in this layout."""
        if self.layout == "rgb":
            return self.height * self.width * 3
        return sum(planar_sizes(self.height, self.width))

    def submit(self, paths: Sequence[str]) -> None:
        """Start decoding `paths` (1 to `batch` files) on the pool."""
        if self._handle is None:
            raise RuntimeError("the loader is closed")
        if not 0 < len(paths) <= self.batch:
            raise ValueError(f"a batch holds 1 to {self.batch} paths, got "
                             f"{len(paths)}")
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        if self._lib.hipe_loader_submit(self._handle, arr, len(paths)) != 0:
            raise RuntimeError("a batch is already in flight: wait() for it "
                               "first")
        self._pending = list(paths)

    def wait(self) -> np.ndarray:
        """The submitted batch, decoded: (n, H, W, 3) RGB or
        (n, H*W*3//2) planes, uint8."""
        if self._pending is None:
            raise RuntimeError("no batch submitted")
        n = len(self._pending)
        self._pending = None
        # the native side copies its whole staging buffer
        out = np.empty((self.batch, self.row_bytes), np.uint8)
        errs = self._lib.hipe_loader_wait(self._handle,
                                          out.ctypes.data_as(_u8p))
        if errs:
            raise IOError(f"{errs} decode errors in batch")
        if self.layout == "rgb":
            out = out.reshape(self.batch, self.height, self.width, 3)
        return out[:n]

    def discard(self) -> None:
        """Wait for the batch in flight, if any, and drop it (decode
        errors included), so that the next `submit` is accepted."""
        if self._pending is not None:
            self._pending = None
            scratch = np.empty((self.batch, self.row_bytes), np.uint8)
            self._lib.hipe_loader_wait(self._handle,
                                       scratch.ctypes.data_as(_u8p))

    def close(self) -> None:
        """Free the native loader. A batch still in flight is waited for
        first: its decode tasks write into the loader's staging buffer."""
        if getattr(self, "_handle", None):
            self.discard()
            self._lib.hipe_loader_destroy(self._handle)
        self._handle = None

    def __enter__(self) -> "NativeLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
