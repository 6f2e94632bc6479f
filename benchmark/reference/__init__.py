"""The plain reference the benchmark holds the port to.

Plain PyTorch in float32, written from the reference repository's
description and from frozen copies of the port's plain paths. It imports
neither JAX, nor the JAX package, nor anything of the port, and takes none
of the port's weights or derived tables: the benchmark hands it the same
frames and weights it hands the port, and it works out the rest again.

`Precision` rounds the operands of every product: float32 leaves them, and
the lower types are the control that a sound comparison has to fail.
"""

from __future__ import annotations

import torch


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, the type's largest; the gradient passes
    straight through."""
    with torch.no_grad():
        scale = 448.0 / x.abs().amax().float().clamp_min(1e-30)
        q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to
    float8 e5m2 under a per-tensor scale (57344 its largest), as fp8
    training feeds gradients to the backward's products."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale = 57344.0 / g.abs().amax().float().clamp_min(1e-30)
        return ((g.float() * scale).to(torch.float8_e5m2).float()
                / scale).to(g.dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to TF32's 10-bit mantissa (to nearest, ties to even),
    as the tensor cores round float32 operands; the gradient passes
    straight through."""
    with torch.no_grad():
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        q = bits.view(torch.float32)
    return x + (q.to(x.dtype) - x).detach()


class Precision:
    """The type the reference computes its products in: "float32" (as
    written, TF32 off), "fp8" (each product's operands rounded to float8
    e4m3 and, in the backward, the gradient of its output to e5m2,
    accumulated in float32) or "tf32" (float32 products with TF32 allowed
    and each explicit product's operands rounded to TF32, the type below
    float32 with TF32 off). `q(x)` rounds an operand, `q.out(y)` a
    product's output's gradient."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _fp8(x)
        return _tf32(x) if self.name == "tf32" else x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return _Fp8Grad.apply(y) if self.name == "fp8" else y

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False
