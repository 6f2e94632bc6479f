"""The collectives of the sharded programs, with their gradients.

The JAX package gets these from XLA: `jit` over sharded operands inserts
the gradient psum over `data`, sync-BatchNorm's global statistics, and
`shard_map`'s psum of a replicated operand's cotangent over `model`. Here
they are written out over the process groups of a `parallel.Mesh`.

Every collective is an all-reduce (or, for the weights, a broadcast): gloo
has no all_gather on CUDA tensors, so a gather is an all-reduce of a zeroed
buffer that holds this rank's block, which one code path serves on gloo
and on NCCL alike (zeros add exactly). Each takes the group it reduces over
from the mesh, and every rank of that group must make the same calls in
the same order.
"""

from __future__ import annotations

import collections
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from hand_integral_pose_estimation_tpu_torch.parallel.mesh import Mesh


def _wire(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor of `dtype` is all-reduced in: bool as uint8, the
    16-bit floats in float32 (gloo's reductions do not take them all;
    the sums here are exact or gain precision), others as they are."""
    if dtype == torch.bool:
        return torch.uint8
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def _gather(x: torch.Tensor, group, index: int, size: int,
            dim: int) -> torch.Tensor:
    """The blocks of `size` ranks, each `x` on its rank, concatenated on
    `dim` in the group's order (this rank's block at `index`)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    out = x.new_zeros(shape, dtype=_wire(x.dtype))
    out.narrow(dim, index * n, n).copy_(x)
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _GatherModel(torch.autograd.Function):
    """Gather over `model`; the gradient is this rank's block of the whole
    one (every rank of the model row holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return _gather(x, mesh.model_group, mesh.model_index,
                       mesh.shape["model"], dim)

    @staticmethod
    def backward(ctx, grad):
        block = grad.narrow(ctx.dim, ctx.mesh.model_index * ctx.n, ctx.n)
        return block.contiguous(), None, None


class _CopyToModel(torch.autograd.Function):
    """Identity; the gradient is summed over `model` (the cotangent of an
    operand that each rank of a model row uses for its own block of
    outputs: `shard_map`'s psum)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(_wire(grad.dtype), copy=True)
        dist.all_reduce(total, group=ctx.mesh.model_group)
        return total.to(grad.dtype), None


def gather_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model row's blocks of `x` concatenated on `dim`."""
    return _GatherModel.apply(x, mesh, dim)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x`, whose gradient is summed over the model row."""
    return _CopyToModel.apply(x, mesh)


@torch.no_grad()
def gather_data(tensors: Sequence[Optional[torch.Tensor]],
                mesh: Mesh) -> list[Optional[torch.Tensor]]:
    """Each tensor's rows from every rank of the data column, in rank
    order (the sweeps' gather; None kept). One all-reduce per dtype: the
    tensors of a dtype travel in one zeroed buffer."""
    D, d = mesh.shape["data"], mesh.data_index
    by_dtype = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        if t is not None:
            by_dtype[t.dtype].append(i)
    out = list(tensors)
    for dtype, idx in by_dtype.items():
        wire = _wire(dtype)
        sizes = [tensors[i].numel() for i in idx]
        buf = tensors[idx[0]].new_zeros((D, sum(sizes)), dtype=wire)
        torch.cat([tensors[i].reshape(-1).to(wire) for i in idx],
                  out=buf[d])
        dist.all_reduce(buf, group=mesh.data_group)
        o = 0
        for i, n in zip(idx, sizes):
            t = tensors[i]
            out[i] = buf[:, o:o + n].reshape(
                D * t.shape[0], *t.shape[1:]).to(dtype)
            o += n
    return out


def over_data(fn, mesh: Optional[Mesh], *tensors):
    """`fn(*tensors)` with the batch split over the mesh's data axis: each
    rank runs `fn` on its rows of every argument (one batch of B rows on
    every rank) and the outputs, a tensor or a tuple or NamedTuple of
    them, are gathered over the data column, so every rank returns the
    whole result. Without a mesh, `fn(*tensors)`. B must divide by the
    data axis."""
    if mesh is None:
        return fn(*tensors)
    from hand_integral_pose_estimation_tpu_torch.parallel.mesh import (
        shard_host_batch,
    )
    B, n = tensors[0].shape[0], mesh.shape["data"]
    if B % n:
        raise ValueError(f"batch {B} must divide by the mesh 'data'-axis "
                         f"size {n}")
    out = fn(*shard_host_batch(mesh, tensors))
    if isinstance(out, torch.Tensor):
        return gather_data([out], mesh)[0]
    fields = gather_data(list(out), mesh)
    return type(out)(*fields) if hasattr(out, "_fields") else tuple(fields)


def all_reduce_gradients(params: Iterable[nn.Parameter], mesh: Mesh) -> None:
    """Average the parameters' gradients over the data column, in place:
    one flat all-reduce per dtype (the gradient psum that `jit` inserts
    over `data`)."""
    by_dtype = collections.defaultdict(list)
    for p in params:
        if p.grad is not None:
            by_dtype[p.grad.dtype].append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.data_group)
        flat.div_(mesh.shape["data"])
        o = 0
        for g in grads:
            g.copy_(flat[o:o + g.numel()].view(g.shape))
            o += g.numel()


class _SyncBatchNorm(torch.autograd.Function):
    """Batch normalisation over the data column's whole batch. The
    statistics in two passes, both all-reduced: the sum and the count,
    then the sum of squared deviations from the global mean (float32 does
    not cancel as it would with the sum of squares). The backward
    all-reduces the sums of dy and dy * x_hat; the weight's and bias's
    gradients are this rank's sums, which the gradient all-reduce then
    averages, as every other parameter's."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        dt = torch.promote_types(x.dtype, torch.float32)
        C = x.shape[1]
        dims = (0, 2, 3)
        xf = x.to(dt)
        stats = torch.cat([xf.sum(dims),
                           xf.new_full((1,), x.numel() // C)])
        dist.all_reduce(stats, group=group)
        n = stats[C]
        mean = stats[:C] / n
        xc = xf - mean.view(1, C, 1, 1)
        sq = (xc * xc).sum(dims)
        dist.all_reduce(sq, group=group)
        var = sq / n
        invstd = torch.rsqrt(var + eps)
        y = (xc * invstd.view(1, C, 1, 1) * weight.view(1, C, 1, 1).to(dt)
             + bias.view(1, C, 1, 1).to(dt))
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _mean, _var, _n):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dt = mean.dtype
        C = x.shape[1]
        dims = (0, 2, 3)
        xhat = (x.to(dt) - mean.view(1, C, 1, 1)) * invstd.view(1, C, 1, 1)
        dyf = dy.to(dt)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        sum_dy = total[:C].view(1, C, 1, 1)
        sum_dy_xhat = total[C:].view(1, C, 1, 1)
        dx = ((weight.to(dt) * invstd).view(1, C, 1, 1)
              * (dyf - sum_dy / n - xhat * sum_dy_xhat / n))
        return (dx.to(x.dtype), local[C:].to(weight.dtype),
                local[:C].to(weight.dtype), None, None)


class SyncBatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose training-mode statistics are those of the
    data column's whole batch (`_SyncBatchNorm`); in eval mode, or without
    a group, it is `nn.BatchNorm2d`. The running variance takes the
    unbiased global variance, as torch's BatchNorm2d does with its own
    batch. Same parameters, buffers and state_dict keys."""

    group: Optional[dist.ProcessGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.group is None:
            return super().forward(x)
        y, mean, var, n = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps, self.group)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_((var * n / (n - 1)).to(
                self.running_var.dtype), self.momentum)
        return y


def convert_sync_batchnorm(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap every `nn.BatchNorm2d` of `model` for a `SyncBatchNorm` over
    the mesh's data column that shares its parameters and buffers (names
    and state_dict keys kept), in place. Returns `model`."""
    for name, m in list(model.named_modules()):
        if type(m) is not nn.BatchNorm2d:
            continue
        s = SyncBatchNorm(m.num_features, m.eps, m.momentum, m.affine,
                          m.track_running_stats)
        s.weight, s.bias = m.weight, m.bias
        for b, t in m.named_buffers(recurse=False):
            setattr(s, b, t)
        s.group = mesh.data_group
        s.train(m.training)
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, s)
    return model
