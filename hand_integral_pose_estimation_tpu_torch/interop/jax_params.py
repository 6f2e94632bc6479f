"""JAX ResPoseNet variables -> this package's ResPoseNet `state_dict`.

The inverse of `convert_pose_snapshot` in
hand_integral_pose_estimation_tpu/interop/torch_weights.py. It reads the
JAX package's `{"params": ..., "batch_stats": ...}` tree as nested dicts
of arrays (numpy, or anything `np.asarray` accepts) and never imports jax.

Layout rules (no numerics):
  * conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw);
  * transposed conv kernel: flip both spatial axes, then (kh, kw, in, out)
    -> (in, out, kh, kw) (flax applies the kernel unflipped over the
    dilated input, torch flipped; see `_deconv` in torch_weights.py);
  * `_Norm_k/BatchNorm_0/{scale, bias}` with batch_stats `{mean, var}` ->
    `bnK.{weight, bias, running_mean, running_var}`, plus a zero
    `num_batches_tracked`;
  * in a block, `Conv_k`/`_Norm_k` for k < n_main are the main path and
    `Conv_{n_main}`/`_Norm_{n_main}` the downsample; n_main is 3 for a
    bottleneck (its first conv is 1x1) and 2 for a basic block.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _deconv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _bn(sd: OrderedDict, prefix: str, params: Mapping, stats: Mapping):
    p, s = params["BatchNorm_0"], stats["BatchNorm_0"]
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _block(sd: OrderedDict, prefix: str, params: Mapping, stats: Mapping):
    n_main = 3 if np.asarray(params["Conv_0"]["kernel"]).shape[0] == 1 else 2
    for k in range(n_main):
        sd[f"{prefix}.conv{k + 1}.weight"] = _conv(params[f"Conv_{k}"]["kernel"])
        _bn(sd, f"{prefix}.bn{k + 1}", params[f"_Norm_{k}"],
            stats[f"_Norm_{k}"])
    if f"Conv_{n_main}" in params:
        sd[f"{prefix}.downsample.0.weight"] = _conv(
            params[f"Conv_{n_main}"]["kernel"])
        _bn(sd, f"{prefix}.downsample.1", params[f"_Norm_{n_main}"],
            stats[f"_Norm_{n_main}"])


def pose_state_dict_from_jax(variables: Mapping[str, Any]
                             ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ResPoseNet variables -> `ResPoseNet.state_dict()` (float32 CPU
    tensors) with the reference's key names."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()

    bp, bs = params["backbone"], stats["backbone"]
    sd["backbone.conv1.weight"] = _conv(bp["conv1"]["kernel"])
    _bn(sd, "backbone.bn1", bp["_Norm_0"], bs["_Norm_0"])
    for stage in range(1, 5):
        i = 0
        while f"layer{stage}_{i}" in bp:
            name = f"layer{stage}_{i}"
            _block(sd, f"backbone.layer{stage}.{i}", bp[name], bs[name])
            i += 1

    hp, hs = params["head"], stats["head"]
    i = 0
    while f"deconv{i}" in hp:
        sd[f"head.deconv_layers.{3 * i}.weight"] = _deconv(
            hp[f"deconv{i}"]["kernel"])
        _bn(sd, f"head.deconv_layers.{3 * i + 1}", hp[f"_Norm_{i}"],
            hs[f"_Norm_{i}"])
        i += 1
    sd["head.final_layer.weight"] = _conv(hp["final"]["kernel"])
    sd["head.final_layer.bias"] = _t(hp["final"]["bias"])
    return sd
