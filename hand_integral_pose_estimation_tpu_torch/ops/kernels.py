"""Build, load and launch the hand-written CUDA kernels in `csrc/`.

The sources are compiled with `nvcc` for Hopper (`sm_90a`), one process per
source file and all at once, and linked into one shared library with a
plain C interface, loaded with `ctypes`. The build happens at the first
launch, never at import, into `_build/` beside this package; the library's
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.

Each :class:`Kernel` counts its successful launches in `launches`, so a run
can show that its main path went through the kernel. A call made while
the stream is being captured into a CUDA graph launches nothing and is not
counted; `graph_launches` counts the kernel's nodes in the captured graph,
which each replay launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

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
#: the float32-feature route of kernels 3 and 4 on the tensor cores
F32_MMA_KERNELS = ("hp_fwd_f32_kernel", "hp_bwd_dfeat_f32_kernel",
                   "hp_bwd_dweight_f32_kernel")
#: kernels 3 and 4 at F > 256 (both feature dtypes, one template each;
#: fed through rings of bulk copies)
SLICE_MMA_KERNELS = ("hp_fwd_ring_kernel", "hp_bwd_dfeat_ring_kernel",
                     "hp_bwd_dweight_ring_kernel")


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

    def __init__(self, symbol: str, argtypes: list,
                 device_kernels: tuple[str, ...]):
        self.symbol = symbol
        self.argtypes = argtypes
        # the device kernels of which one call launches exactly one (an
        # entry's other kernels, such as a merge, are not counted); "name<k>"
        # is the instantiation of a template kernel at int argument k
        self.device_kernels = device_kernels
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} "
                               f"({library().hipe_error_string(rc).decode()})")
        if not torch.cuda.is_current_stream_capturing():
            self.launches += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(index: int) -> int:
    """The handle of PyTorch's current CUDA stream on device `index`, read
    without building a `torch.cuda.Stream` (a few microseconds of host time
    a launch)."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan_entry():
    fn = library().hipe_softmax_integral_fwd_chunks
    fn.argtypes = [_P, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def softmax_integral_fwd_chunks(hm: int, dtype: int, batch: int, rows: int,
                                channels: int, device: int) -> int:
    """Chunks per image of kernel 1's vectorised path for a heatmap at
    address `hm` of (batch, rows, channels), dtype code `dtype` (0 float32,
    1 bfloat16), on CUDA device `device`; 0 where it takes the generic
    path. The C library owns the plan (`hipe_softmax_integral_fwd_chunks`);
    it launches nothing."""
    out = ctypes.c_int(0)
    rc = _plan_entry()(hm, dtype, batch, rows, channels, device,
                       ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"hipe_softmax_integral_fwd_chunks: CUDA error "
                           f"{rc} ({library().hipe_error_string(rc).decode()})")
    return out.value


@functools.lru_cache(maxsize=None)
def _planes_entry():
    fn = library().hipe_head_projection_integral_workspace
    fn.argtypes = [_I, _I, _I, _I, _I, _I, _I]
    fn.restype = ctypes.c_longlong
    return fn


def head_projection_workspace(dtype: torch.dtype, batch: int, height: int,
                              width: int, feats: int, joints: int,
                              depth: int) -> int:
    """Bytes of the workspace of split bf16 planes that kernels 3 and 4
    take for features of `dtype` (one layout for both directions): up to
    256 features float32 features' and the weight's, none for bf16 ones;
    past that the features and the weight laid out slice by slice
    (`csrc/k_slices.cuh`), bf16 features as one plane. The C library owns
    the layout. It launches nothing."""
    return int(_planes_entry()(int(dtype == torch.float32), batch, height,
                               width, feats, joints, depth))


@functools.lru_cache(maxsize=None)
def _roi_workspace_entry():
    fn = library().hipe_roi_align_bwd_workspace
    fn.argtypes = [_I, _I, _I, _I, _I]
    fn.restype = ctypes.c_longlong
    return fn


def roi_align_bwd_workspace(batch: int, rois: int, height: int, width: int,
                            pooled: int) -> int:
    """Bytes of the workspace the ROIAlign backward kernel takes (each
    RoI's tables); the C library owns the layout. It launches nothing."""
    return int(_roi_workspace_entry()(batch, rois, height, width, pooled))


#: (hm, dtype, coords, m, s, ws, B, H, W, J, D, chunks per image (0: the
#:  generic path, no workspace), stream)
SOFTMAX_INTEGRAL_FWD = Kernel(
    "hipe_softmax_integral_fwd",
    [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ("softmax_integral_partial_kernel", "softmax_integral_fwd_kernel"))
#: (feats, weight, bias, coords, m, s, ws, planes, B, H, W, F, J, D,
#:  chunks per image, stream): bf16 features on the tensor cores; planes
#:  is the workspace of `head_projection_workspace` bytes (the features'
#:  and the weight's slices at F > 256)
HEAD_PROJECTION_INTEGRAL_FWD = Kernel(
    "hipe_head_projection_integral_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ("hp_fwd_mma_kernel", "hp_fwd_ring_kernel<1>"))
#: float32 features on the tensor cores: the same arguments, planes the
#: features' and the weight's split planes
HEAD_PROJECTION_INTEGRAL_FWD_F32 = Kernel(
    "hipe_head_projection_integral_fwd_f32",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ("hp_fwd_f32_kernel", "hp_fwd_ring_kernel<3>"))

#: (hm, dtype, m, s, coords, cot, grad, B, H, W, J, D, stream)
SOFTMAX_INTEGRAL_BWD = Kernel(
    "hipe_softmax_integral_bwd",
    [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ("softmax_integral_bwd_vec_kernel", "softmax_integral_bwd_kernel"))
#: (feats, weight, bias, m, T, A, B, dfeat, dW, db, ws, ws_db, planes,
#:  B, H, W, F, J, D, chunks per image, stream): bf16 features; planes as
#:  for the forward
HEAD_PROJECTION_INTEGRAL_BWD = Kernel(
    "hipe_head_projection_integral_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
     _I, _I, _I, _I, _I, _I, _I, _P],
    ("hp_bwd_dfeat_mma_kernel", "hp_bwd_dfeat_ring_kernel<1>"))
#: float32 features, on the tensor cores as well: the same arguments
HEAD_PROJECTION_INTEGRAL_BWD_F32 = Kernel(
    "hipe_head_projection_integral_bwd_f32",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
     _I, _I, _I, _I, _I, _I, _I, _P],
    ("hp_bwd_dfeat_f32_kernel", "hp_bwd_dfeat_ring_kernel<3>"))
#: (images, image dtype (0 float32, 1 uint8), maps, map dtype (0 float32,
#:  1 float64), map strides (3), inverse, colour or NULL, host means and
#:  stds or NULL, out, B, Hs, Ws, Ho, Wo, C, stream)
WARP_TWOPASS = Kernel(
    "hipe_warp_twopass", [_P, _I, _P, _I, _L, _L, _L, _I, _P, _P, _P, _I,
                          _I, _I, _I, _I, _I, _P], ("warp_kernel",))

#: (feats, rois, out, B, H, W, C, R, pooled, sampling ratio,
#:  spatial scale, stream)
ROI_ALIGN_FWD = Kernel(
    "hipe_roi_align_fwd", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ("roi_align_fwd_kernel",))
#: (g, rois, grad, workspace (`roi_align_bwd_workspace` bytes), B, H, W,
#:  C, R, pooled, sampling ratio, spatial scale, stream)
ROI_ALIGN_BWD = Kernel(
    "hipe_roi_align_bwd",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ("roi_align_bwd_kernel",))
#: (boxes, alive, mask, keep, B, N, iou threshold, plus one, stop after,
#:  stream)
NMS = Kernel("hipe_nms", [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
             ("nms_sweep_kernel",))

KERNELS = (SOFTMAX_INTEGRAL_FWD, HEAD_PROJECTION_INTEGRAL_FWD,
           SOFTMAX_INTEGRAL_BWD, HEAD_PROJECTION_INTEGRAL_BWD, WARP_TWOPASS,
           ROI_ALIGN_FWD, NMS, ROI_ALIGN_BWD, HEAD_PROJECTION_INTEGRAL_FWD_F32,
           HEAD_PROJECTION_INTEGRAL_BWD_F32)


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of libcuda."""
    _fields_ = [("func", _P), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("kernel_params", _P), ("extra", _P), ("kern", _P),
                ("ctx", _P)]


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    return ctypes.CDLL("libcuda.so.1")


def graph_kernel_names(graph: "torch.cuda.CUDAGraph") -> list[str]:
    """The (mangled) function names of the kernel nodes of a captured
    `torch.cuda.CUDAGraph`, read through libcuda (`cuGraphGetNodes`,
    `cuGraphKernelNodeGetParams`, `cuFuncGetName`): every device kernel a
    replay launches. The graph must be made with `keep_graph=True`."""
    cuda = _libcuda()

    def call(name, *args):
        rc = getattr(cuda, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name}: libcuda error {rc}")

    handle = _P(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", handle, None, ctypes.byref(n))
    nodes = (_P * max(1, n.value))()
    call("cuGraphGetNodes", handle, nodes, ctypes.byref(n))
    names = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", _P(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", _P(node), ctypes.byref(params))
        func = _P(params.func)
        if not params.func:
            call("cuKernelGetFunction", ctypes.byref(func), _P(params.kern))
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), func)
        names.append(name.value.decode())
    return names


def graph_launches(graph: "torch.cuda.CUDAGraph",
                   kernels=None) -> dict[str, int]:
    """Calls of each entry point (by C symbol) that one replay of `graph`
    launches: the kernel nodes whose function is one of the entry's
    `device_kernels` (matched by `mangled_name`)."""
    names = graph_kernel_names(graph)
    return {k.symbol: sum(any(mangled_name(d) in n for d in k.device_kernels)
                          for n in names)
            for k in (KERNELS if kernels is None else kernels)}


def mangled_name(name: str) -> str:
    """The part of a kernel's mangled name that identifies it: the
    length-prefixed identifier, and for "name<k>" the int template
    argument after it."""
    ident, _, arg = name.partition("<")
    return f"{len(ident)}{ident}" + (f"ILi{arg[:-1]}E" if arg else "")
