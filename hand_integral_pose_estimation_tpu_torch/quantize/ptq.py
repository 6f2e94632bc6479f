"""Post-training int8 quantization (PTQ) for serving.

Port of hand_integral_pose_estimation_tpu/quantize/ptq.py. The scheme is
the JAX package's, operation for operation:

* weights: symmetric per-output-channel int8,
  ``s_w = max(max|W| / 127, 1e-12)`` over every axis but the output
  channel, ``round(W / s_w)`` clipped to +-127 (round half to even);
* activations: symmetric per-tensor int8 with a static scale from a
  calibration pass, ``s_x = max|x| / 127`` over the calibration batches,
  ``round(x.float() * (1 / s_x))`` clipped to +-127;
* products s8 x s8 -> s32, dequantized once per layer as
  ``y.float() * (s_x * s_w) + b`` and handed back in the layer's compute
  dtype (the autocast dtype inside the models' autocast regions, else the
  input's), so BatchNorm, ReLU and the fused head run unchanged.

Flax method interception has no torch counterpart. Here calibration taps
each module's input with a forward pre-hook (the tensor the module
receives, before autocast casts it: the stem sees the float32 normalised
image, later convs bf16 BatchNorm outputs, as in the JAX package), and
`quantized_calls(q, model)` swaps the `forward` of the named `nn.Conv2d`,
`nn.ConvTranspose2d` and `nn.Linear` instances of `model` for the int8 one
and restores it on exit. Bundles are keyed by `named_modules()` names (the
reference's torch names: `head.final_layer` is the JAX package's
`head/final`), so a bundle belongs to one model instance and two models
cannot take each other's weights. Modules with other settings (dilation,
groups, padding other than zeros) stay in float and are listed in
`Quantized.skipped` when calibrated, as are modules whose input was all
zero.

The s8 x s8 -> s32 products are `torch._int_mm` (cuBLASLt's int8 GEMM on
the card, a reference loop on the CPU: one code path for both) over an
int8 im2col built from view ops, with the contraction and the output
channels zero-padded to multiples of 8 and the rows to at least 17, as the
card's GEMM demands; the padding adds exact zeros. A transposed conv runs
as stride x stride phase convs over its input (the 4x4 stride-2 deconv as
four 2x2 convs), never over a zero-inserted input, and the gathered rows
are taken a few images at a time. The JAX package computes these products
in XLA convolutions, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

QUANT_TYPES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
#: bytes of gathered int8 rows one product takes at most (whole images)
GATHER_BYTES = 256 << 20
#: `torch._int_mm` on the card: rows > 16, columns and contraction
#: multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _is_simple(mod: nn.Module) -> bool:
    """True when the module's configuration maps 1:1 onto the int8 call:
    any Linear, and convs with dilation 1, one group and explicit zero
    padding."""
    if isinstance(mod, nn.Linear):
        return True
    return (isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d))
            and mod.padding_mode == "zeros"
            and not isinstance(mod.padding, str)
            and all(d == 1 for d in mod.dilation) and mod.groups == 1)


def _out_axis(mod: nn.Module) -> int:
    """The weight's output-channel axis: 1 for a transposed conv's
    (in, out, kh, kw), else 0."""
    return 1 if isinstance(mod, nn.ConvTranspose2d) else 0


def _quant_modules(model: nn.Module) -> Dict[str, nn.Module]:
    return {name: m for name, m in model.named_modules()
            if isinstance(m, QUANT_TYPES)}


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


@torch.no_grad()
def calibrate(fn: Callable, *batches, model: nn.Module) -> Dict[str, float]:
    """max|input| of every simple conv, transposed conv and Linear of
    `model` that `fn(batch)` calls, over all `batches`, keyed by module
    name. `fn` may run other models too: only `model`'s modules are
    tapped (the JAX package's `root_type` filter)."""
    amax: Dict[str, float] = {}
    seen: Dict[str, torch.Tensor] = {}

    def tap(name):
        def hook(mod, args):
            m = args[0].detach().abs().amax().float()
            seen[name] = torch.maximum(seen[name], m) if name in seen else m
        return hook

    handles = [m.register_forward_pre_hook(tap(name))
               for name, m in _quant_modules(model).items() if _is_simple(m)]
    try:
        for b in batches:
            seen.clear()
            fn(b)
            for k, v in seen.items():
                amax[k] = max(amax.get(k, 0.0), float(v))
    finally:
        for h in handles:
            h.remove()
    return amax


# ---------------------------------------------------------------------------
# Weight quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Quantized:
    """Int8 weights and scales, keyed by module name ('backbone.conv1').

    kernels: int8 in the module's own weight layout; kscales: float32 per
    output channel; ascales: the per-tensor input scale; biases: float32
    (modules with a bias only). `root_type` is the model class the bundle
    was built for, and `params_digest` a fingerprint of the float weights
    the kernels came from (`verify_source_params`): a bundle carries its own
    kernels, so pairing it with other weights would serve stale ones."""

    kernels: Dict[str, torch.Tensor]
    kscales: Dict[str, torch.Tensor]
    ascales: Dict[str, float]
    biases: Dict[str, torch.Tensor]
    skipped: Tuple[str, ...] = ()
    root_type: Optional[type] = None
    params_digest: Optional[str] = None

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(self.kernels)


def digest_params(model: nn.Module, paths: Iterable[str]) -> str:
    """Order-independent fingerprint of the weights of the modules named
    `paths`: each name, weight shape and two float64 moments (sum,
    abs-sum). Any checkpoint swap moves the moments."""
    modules = dict(model.named_modules())
    h = hashlib.sha256()
    for p in sorted(paths):
        mod = modules.get(p)
        if mod is None or not isinstance(mod, QUANT_TYPES):
            h.update(("missing:" + p).encode())
            continue
        w = mod.weight.detach().to("cpu", torch.float64)
        h.update(p.encode())
        h.update(str(tuple(w.shape)).encode())
        h.update(np.float64(w.sum().item()).tobytes())
        h.update(np.float64(w.abs().sum().item()).tobytes())
    return h.hexdigest()[:16]


def verify_source_params(q: Quantized, model: nn.Module,
                         what: str = "model") -> None:
    """Raise unless `model`'s weights are the ones `q` was quantized from
    (no-op for a bundle without a digest)."""
    if q.params_digest is None:
        return
    live = digest_params(model, q.paths)
    if live != q.params_digest:
        raise ValueError(
            f"quantized bundle does not match the live {what} params "
            f"(bundle digest {q.params_digest}, live {live}): the bundle "
            f"was calibrated from a different checkpoint; rebuild it "
            f"(cli.evaluate --int8 without --int8-db, or quantize_model)")


@torch.no_grad()
def quantize_params(model: nn.Module, amax: Dict[str, float],
                    skip: Iterable[str] = ()) -> Quantized:
    """Per-output-channel int8 quantization of every calibrated module.

    `skip`: name prefixes to leave in float (("head.final_layer",) keeps
    the heatmap projection in float: its logits feed a softmax, and the
    fused head reads its weights directly). Names that are no quantizable
    module, skipped prefixes and modules whose input amax was 0 are listed
    in `skipped`."""
    skip = tuple(skip)
    modules = _quant_modules(model)
    kernels, kscales, ascales, biases = {}, {}, {}, {}
    skipped = []
    for path, a in sorted(amax.items()):
        mod = modules.get(path)
        if (mod is None or any(path.startswith(s) for s in skip)
                or a == 0.0):
            skipped.append(path)
            continue
        w = mod.weight.detach().float()
        axis = _out_axis(mod)
        red = tuple(d for d in range(w.ndim) if d != axis)
        s = (w.abs().amax(dim=red) / 127.0).clamp_min(1e-12)
        shape = [1] * w.ndim
        shape[axis] = -1
        kernels[path] = torch.round(w / s.view(shape)).clamp(
            -127, 127).to(torch.int8)
        kscales[path] = s
        ascales[path] = a / 127.0
        if mod.bias is not None:
            biases[path] = mod.bias.detach().float().clone()
    return Quantized(kernels, kscales, ascales, biases, tuple(skipped),
                     params_digest=digest_params(model, kernels))


# ---------------------------------------------------------------------------
# Quantized execution
# ---------------------------------------------------------------------------


def _quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.round(x.float() * (1.0 / scale)).clamp_(-127, 127).to(
        torch.int8)


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """The layer's compute dtype: the autocast dtype inside an autocast
    region (a float conv there hands back that dtype), else the input's
    (the JAX package's `mod.dtype or x.dtype`)."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def _pack(w: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 -> (N8, K8) contiguous, zero-padded to multiples of 8:
    the GEMM's second operand, transposed."""
    n, k = w.shape
    out = torch.zeros(_round_up(n, _ALIGN), _round_up(k, _ALIGN),
                      dtype=torch.int8, device=w.device)
    out[:n, :k] = w
    return out


def _int_mm(a: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """(Mp, K8) int8 @ packed (N8, K8).T -> (Mp, N8) int32, exact."""
    return torch._int_mm(a, w_packed.t())


def _gather_rows(cols: torch.Tensor, k8: int) -> Tuple[torch.Tensor, int]:
    """An int8 view (..., *window) -> its (M, K) rows copied into a
    zero-padded (Mp, K8) matrix (Mp >= 17); returns it and M."""
    lead = cols.shape[:3]
    m = lead[0] * lead[1] * lead[2]
    k = cols[0, 0, 0].numel()
    mp = max(m, _MIN_ROWS)
    a = torch.empty(mp, k8, dtype=torch.int8, device=cols.device)
    if k8 > k:
        a[:, k:].zero_()
    if mp > m:
        a[m:].zero_()
    a[:m, :k].view(cols.shape).copy_(cols)
    return a, m


class _Layer:
    """One module's int8 operands on its device: the packed weight (one
    per phase for a transposed conv), the float32 epilogue scale and the
    bias."""

    def __init__(self, mod: nn.Module, q: Quantized, name: str):
        dev = mod.weight.device
        self.mod = mod
        self.ascale = q.ascales[name]
        kern = q.kernels[name].to(dev)
        # f32(s_x) * s_w, in float32 as the JAX package forms it
        self.scale = q.kscales[name].to(dev) * self.ascale
        self.bias = (q.biases[name].to(dev) if name in q.biases else None)
        self.n = kern.shape[_out_axis(mod)]
        if isinstance(mod, nn.ConvTranspose2d):
            self.phases = {}
            for rh in range(mod.stride[0]):
                for rw in range(mod.stride[1]):
                    th = _phase_taps(rh, mod.stride[0], mod.padding[0],
                                     mod.kernel_size[0])
                    tw = _phase_taps(rw, mod.stride[1], mod.padding[1],
                                     mod.kernel_size[1])
                    if not th[0] or not tw[0]:
                        self.phases[rh, rw] = (th, tw, None)
                        continue
                    # (in, out, th, tw)
                    wp = kern[:, :, th[0]][:, :, :, tw[0]]
                    self.phases[rh, rw] = (th, tw, _pack(
                        wp.permute(1, 0, 2, 3).reshape(self.n, -1)))
        else:
            self.w = _pack(kern.reshape(self.n, -1))

    def epilogue(self, y: torch.Tensor, m: int,
                 dtype: torch.dtype) -> torch.Tensor:
        out = y[:m, :self.n].float() * self.scale
        if self.bias is not None:
            out = out + self.bias
        return out.to(dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _out_dtype(x)
        xq = _quantize_act(x, self.ascale)
        mod = self.mod
        if isinstance(mod, nn.Linear):
            lead = xq.shape[:-1]
            a, m = _gather_rows(xq.reshape(-1, 1, 1, xq.shape[-1]),
                                self.w.shape[1])
            y = self.epilogue(_int_mm(a, self.w), m, dtype)
            return y.reshape(*lead, self.n)
        # NCHW (channels_last in the models) -> NHWC, a view there
        xh = xq.permute(0, 2, 3, 1)
        if isinstance(mod, nn.ConvTranspose2d):
            out = self._transposed(xh, dtype)
        else:
            out = self._conv(xh, dtype)
        return out.permute(0, 3, 1, 2)

    def _chunks(self, batch: int, rows_per_image: int, k8: int):
        per = max(1, GATHER_BYTES // max(1, rows_per_image * k8))
        return [(b, min(b + per, batch)) for b in range(0, batch, per)]

    def _conv(self, xh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        mod = self.mod
        (kh, kw), (sh, sw), (ph, pw) = (mod.kernel_size, mod.stride,
                                        mod.padding)
        xp = F.pad(xh, (0, 0, pw, pw, ph, ph)) if ph or pw else xh
        # (B, Ho, Wo, C, kh, kw)
        cols = xp.unfold(1, kh, sh).unfold(2, kw, sw)
        B, Ho, Wo = cols.shape[:3]
        out = torch.empty(B, Ho, Wo, self.n, dtype=dtype, device=xh.device)
        for b0, b1 in self._chunks(B, Ho * Wo, self.w.shape[1]):
            a, m = _gather_rows(cols[b0:b1], self.w.shape[1])
            out[b0:b1] = self.epilogue(_int_mm(a, self.w), m, dtype).view(
                b1 - b0, Ho, Wo, self.n)
        return out

    def _transposed(self, xh: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
        mod = self.mod
        B, H, W, _ = xh.shape
        sh, sw = mod.stride
        Ho = ((H - 1) * sh - 2 * mod.padding[0] + mod.kernel_size[0]
              + mod.output_padding[0])
        Wo = ((W - 1) * sw - 2 * mod.padding[1] + mod.kernel_size[1]
              + mod.output_padding[1])
        out = torch.empty(B, Ho, Wo, self.n, dtype=dtype, device=xh.device)
        for (rh, rw), (th, tw, w) in self.phases.items():
            mh, mw = len(range(rh, Ho, sh)), len(range(rw, Wo, sw))
            if w is None:     # no tap reaches this phase: bias only
                fill = (torch.zeros(self.n, device=xh.device)
                        if self.bias is None else self.bias)
                out[:, rh::sh, rw::sw] = fill.to(dtype)
                continue
            xp, oh, ow = _phase_input(xh, th, tw, mh, mw)
            cols = xp[:, oh:oh + mh + len(th[0]) - 1,
                      ow:ow + mw + len(tw[0]) - 1].unfold(
                1, len(th[0]), 1).unfold(2, len(tw[0]), 1)
            part = torch.empty(B, mh, mw, self.n, dtype=dtype,
                               device=xh.device)
            for b0, b1 in self._chunks(B, mh * mw, w.shape[1]):
                a, m = _gather_rows(cols[b0:b1], w.shape[1])
                part[b0:b1] = self.epilogue(_int_mm(a, w), m, dtype).view(
                    b1 - b0, mh, mw, self.n)
            out[:, rh::sh, rw::sw] = part
        return out


def _phase_taps(r: int, s: int, p: int, k: int):
    """Output phase r of a transposed conv (stride s, padding p, kernel
    k) along one axis: output s*m + r sums input m + c - t times kernel tap
    k0 + s*t. Returns (the taps in window order, i.e. for inputs
    m + c - T + 1 .. m + c, and c)."""
    k0 = (r + p) % s
    taps = list(range(k0, k, s))
    c = (r + p - k0) // s
    return taps[::-1], c


def _phase_input(xh: torch.Tensor, th, tw, mh: int, mw: int):
    """`xh` zero-padded so that every phase window lies inside it; returns
    it and the window origin of output (0, 0)."""
    (taps_h, ch), (taps_w, cw) = th, tw
    H, W = xh.shape[1:3]
    lo_h = max(0, len(taps_h) - 1 - ch)
    lo_w = max(0, len(taps_w) - 1 - cw)
    hi_h = max(0, mh + ch - H)
    hi_w = max(0, mw + cw - W)
    xp = F.pad(xh, (0, 0, lo_w, hi_w, lo_h, hi_h)) if (
        lo_h or lo_w or hi_h or hi_w) else xh
    return xp, ch - len(taps_h) + 1 + lo_h, cw - len(taps_w) + 1 + lo_w


class QuantizedCalls:
    """`quantized_calls`' context manager, reusable: made once (the int8
    operands packed on the modules' device), entered for each call."""

    def __init__(self, q: Quantized, model: nn.Module):
        modules = _quant_modules(model)
        missing = [p for p in q.paths if p not in modules]
        if missing:
            raise ValueError(
                f"quantized bundle names {len(missing)} modules that "
                f"{type(model).__name__} does not have (e.g. "
                f"{missing[0]!r}): a bundle of another model, or one keyed "
                f"by the JAX package's paths (carry those across with "
                f"interop.quantized_from_jax)")
        for p in q.paths:
            if tuple(q.kernels[p].shape) != tuple(modules[p].weight.shape):
                raise ValueError(
                    f"quantized kernel {p!r} has shape "
                    f"{tuple(q.kernels[p].shape)}, the module's weight "
                    f"{tuple(modules[p].weight.shape)}")
        self.layers = {modules[p]: _Layer(modules[p], q, p) for p in q.paths}
        self._saved: Optional[dict] = None

    def __enter__(self) -> "QuantizedCalls":
        if self._saved is not None:
            raise RuntimeError("these int8 calls are already active")
        self._saved = {m: m.__dict__.get("forward") for m in self.layers}
        for m, layer in self.layers.items():
            m.forward = layer
        return self

    def __exit__(self, *exc) -> None:
        for m, fwd in self._saved.items():
            if fwd is None:
                m.__dict__.pop("forward", None)
            else:
                m.forward = fwd
        self._saved = None


def quantized_calls(q: Quantized, model: nn.Module) -> QuantizedCalls:
    """Context manager: inside it, every module of `model` named in `q`
    runs its int8 forward. Raises, before anything runs, if a name of `q`
    is no conv, transposed conv or Linear of `model` or its kernel's shape
    is not that module's weight's (a bundle of another model, or one keyed
    by flax paths). The returned object can be entered again."""
    return QuantizedCalls(q, model)


def quantized_apply(model: nn.Module, q: Quantized, *args, **kwargs):
    """`model(*args, **kwargs)` with its int8 convs and Linears."""
    with quantized_calls(q, model):
        return model(*args, **kwargs)


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def save_quantized(path: str, q: Quantized) -> None:
    """Write a bundle to one .npz: `k//name` int8 kernels, `s//name` and
    `b//name` float32 scales and biases, and `meta` (JSON: ascales, skipped,
    the root type's name, params_digest), the JAX package's layout."""
    arrs = {}
    for prefix, table in (("k//", q.kernels), ("s//", q.kscales),
                          ("b//", q.biases)):
        for p, v in table.items():
            arrs[prefix + p] = v.detach().cpu().numpy()
    meta = {"ascales": q.ascales, "skipped": list(q.skipped),
            "root_type": q.root_type.__name__ if q.root_type else None,
            "params_digest": q.params_digest}
    arrs["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrs)


def load_quantized(path: str, root_type: Optional[type] = None) -> Quantized:
    """Load a bundle written by `save_quantized` (tensors on the CPU). With
    `root_type`, the saved root type's name must be its name."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]))
        tables = {"k": {}, "s": {}, "b": {}}
        for key in z.files:
            if key != "meta":
                kind, p = key.split("//", 1)
                tables[kind][p] = torch.from_numpy(z[key])
    saved = meta["root_type"]
    if root_type is not None and saved not in (None, root_type.__name__):
        raise ValueError(
            f"quantized bundle {path} was built for root type {saved!r}, "
            f"not {root_type.__name__!r}")
    return Quantized(tables["k"], tables["s"], meta["ascales"], tables["b"],
                     tuple(meta["skipped"]), root_type,
                     params_digest=meta.get("params_digest"))


# ---------------------------------------------------------------------------
# One call
# ---------------------------------------------------------------------------


def quantize_model(model: nn.Module, calib_batches, skip: Iterable[str] = (),
                   forward: Optional[Callable] = None) -> Quantized:
    """Calibrate `model` on `calib_batches` (model inputs; `forward(batch)`
    runs them, `model` by default) and quantize it; the bundle's root type
    is `type(model)`."""
    amax = calibrate(forward or model, *calib_batches, model=model)
    return dataclasses.replace(quantize_params(model, amax, skip=skip),
                               root_type=type(model))
