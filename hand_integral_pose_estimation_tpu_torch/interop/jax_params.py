"""JAX variables -> this package's `state_dict`s: the pose net, the
Faster R-CNN detector and PANet; and the JAX package's int8 bundles
(`quantized_from_jax`) by the same maps.

The inverses of `convert_pose_snapshot` and `convert_faster_rcnn_state_dict`
in hand_integral_pose_estimation_tpu/interop/torch_weights.py and of
`convert_torch_state_dict` in hand_integral_pose_estimation_tpu/models/
panet.py. They read the
JAX package's `{"params": ..., "batch_stats": ...}` trees as nested dicts
of arrays (numpy, or anything `np.asarray` accepts) and never import jax.

Layout rules (no numerics):
  * conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw);
  * transposed conv kernel: flip both spatial axes, then (kh, kw, in, out)
    -> (in, out, kh, kw) (flax applies the kernel unflipped over the
    dilated input, torch flipped; see `_deconv` in torch_weights.py);
  * `_Norm_k/BatchNorm_0/{scale, bias}` with batch_stats `{mean, var}` ->
    `bnK.{weight, bias, running_mean, running_var}`, plus a zero
    `num_batches_tracked`; `_Norm_k/GroupNorm_0/{scale, bias}` ->
    `bnK.{weight, bias}`;
  * the detector's RPN class conv: the JAX model orders its 2A output
    channels as the flattened (A, 2), channel a*2 + k; the reference, and
    this package, as [bg x A, fg x A], channel k*A + a
    (torch_weights.py:183-191,244-247);
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
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _deconv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _bn(sd: OrderedDict, prefix: str, params: Mapping, stats: Mapping):
    if "GroupNorm_0" in params:
        p = params["GroupNorm_0"]
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        return
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
            stats.get(f"_Norm_{k}"))
    if f"Conv_{n_main}" in params:
        sd[f"{prefix}.downsample.0.weight"] = _conv(
            params[f"Conv_{n_main}"]["kernel"])
        _bn(sd, f"{prefix}.downsample.1", params[f"_Norm_{n_main}"],
            stats.get(f"_Norm_{n_main}"))


def _stages(sd: OrderedDict, prefix, params: Mapping, stats: Mapping,
            stages) -> None:
    """Blocks `layer{S}_{I}` of a JAX ResNet tree -> `prefix(S).I.*`."""
    for stage in stages:
        i = 0
        while f"layer{stage}_{i}" in params:
            name = f"layer{stage}_{i}"
            _block(sd, f"{prefix(stage)}.{i}", params[name],
                   stats.get(name, {}))
            i += 1


def pose_state_dict_from_jax(variables: Mapping[str, Any]
                             ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ResPoseNet variables -> `ResPoseNet.state_dict()` (float32 CPU
    tensors) with the reference's key names."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()

    bp, bs = params["backbone"], stats["backbone"]
    sd["backbone.conv1.weight"] = _conv(bp["conv1"]["kernel"])
    _bn(sd, "backbone.bn1", bp["_Norm_0"], bs["_Norm_0"])
    _stages(sd, lambda s: f"backbone.layer{s}", bp, bs, range(1, 5))

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


def panet_state_dict_from_jax(params: Mapping[str, Any]
                              ) -> "OrderedDict[str, torch.Tensor]":
    """JAX `PANet` params (`dict{i}`, `bias_enc{i}`, `bias_dec{i}`,
    `camera_w`, `code_w`) -> `PANet.state_dict()` (float32 CPU tensors):
    the mapping of the JAX package's `convert_torch_state_dict`
    (models/panet.py:184-212) run backwards."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    i = 0
    while f"dict{i}" in params:
        d = np.asarray(params[f"dict{i}"])
        pre = f"sparse_coding_layers.{i}"
        sd[f"{pre}.dictionary"] = _t(d if i == 0 else d[:, :, None, None])
        sd[f"{pre}.bias_encode_with_cam"] = _t(params[f"bias_enc{i}"])
        sd[f"{pre}.bias_decode"] = _t(params[f"bias_dec{i}"])
        i += 1
    sd["camera_estimator.linear_comb_layer.weight"] = _t(
        np.asarray(params["camera_w"])[None, :, None, None])
    sd["code_estimator.fc_layer.weight"] = _t(params["code_w"])
    return sd


def _rpn_cls_from_jax(x: np.ndarray, num_anchors: int) -> np.ndarray:
    """Last axis (A, 2)-flattened -> [bg x A, fg x A]: out[k*A + a] =
    x[a*2 + k]."""
    return np.asarray(x)[..., np.arange(2 * num_anchors)
                         .reshape(num_anchors, 2).T.reshape(-1)]


def detector_state_dict_from_jax(variables: Mapping[str, Any], det_cfg
                                 ) -> "OrderedDict[str, torch.Tensor]":
    """JAX FasterRCNN variables -> `FasterRCNN.state_dict()` (float32 CPU
    tensors) under the reference's key names (RCNN_base indices 0, 1 and
    4-6, RCNN_top.0, RCNN_rpn.*, RCNN_cls_score, RCNN_bbox_pred), with the
    RPN class channels permuted into the reference's order."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()

    bp, bs = params["base"], stats.get("base", {})
    sd["RCNN_base.0.weight"] = _conv(bp["conv1"]["kernel"])
    _bn(sd, "RCNN_base.1", bp["_Norm_0"], bs.get("_Norm_0"))
    _stages(sd, lambda s: f"RCNN_base.{3 + s}", bp, bs, range(1, 4))
    _stages(sd, lambda s: "RCNN_top.0", params["tail"], stats.get("tail", {}),
            (4,))

    A = len(det_cfg.anchor_scales) * len(det_cfg.anchor_ratios)
    rpn = "RCNN_rpn."
    sd[rpn + "RPN_Conv.weight"] = _conv(params["rpn_conv"]["kernel"])
    sd[rpn + "RPN_Conv.bias"] = _t(params["rpn_conv"]["bias"])
    sd[rpn + "RPN_cls_score.weight"] = _conv(
        _rpn_cls_from_jax(params["rpn_cls"]["kernel"], A))
    sd[rpn + "RPN_cls_score.bias"] = _t(
        _rpn_cls_from_jax(params["rpn_cls"]["bias"], A))
    sd[rpn + "RPN_bbox_pred.weight"] = _conv(params["rpn_bbox"]["kernel"])
    sd[rpn + "RPN_bbox_pred.bias"] = _t(params["rpn_bbox"]["bias"])
    for name, key in (("RCNN_cls_score", "cls_score"),
                      ("RCNN_bbox_pred", "bbox_pred")):
        sd[f"{name}.weight"] = _t(np.asarray(params[key]["kernel"]).T)
        sd[f"{name}.bias"] = _t(params[key]["bias"])
    return sd


def _block_name(model, prefix: str, index: str, conv: int) -> str:
    """Torch name of `Conv_{conv}` in block `prefix.index`: conv{k+1} on
    the main path, `downsample.0` past it (see `_block`)."""
    block = model.get_submodule(f"{prefix}.{index}")
    n_main = 3 if hasattr(block, "conv3") else 2
    return (f"{prefix}.{index}.conv{conv + 1}" if conv < n_main
            else f"{prefix}.{index}.downsample.0")


def _module_from_jax(path: str, model):
    """A JAX module path -> (torch module name, kernel layout), by the maps
    of `pose_state_dict_from_jax` and `detector_state_dict_from_jax`; the
    layout is "conv", "deconv", "dense" or "rpn_cls"."""
    pose = type(model).__name__ == "ResPoseNet"
    flat = ({"backbone/conv1": ("backbone.conv1", "conv"),
             "head/final": ("head.final_layer", "conv")} if pose else
            {"base/conv1": ("RCNN_base.0", "conv"),
             "rpn_conv": ("RCNN_rpn.RPN_Conv", "conv"),
             "rpn_cls": ("RCNN_rpn.RPN_cls_score", "rpn_cls"),
             "rpn_bbox": ("RCNN_rpn.RPN_bbox_pred", "conv"),
             "cls_score": ("RCNN_cls_score", "dense"),
             "bbox_pred": ("RCNN_bbox_pred", "dense")})
    if path in flat:
        return flat[path]
    parts = path.split("/")
    if pose and parts[0] == "head" and parts[1].startswith("deconv"):
        return f"head.deconv_layers.{3 * int(parts[1][6:])}", "deconv"
    trees = ("backbone",) if pose else ("base", "tail")
    if (len(parts) == 3 and parts[0] in trees
            and parts[1].startswith("layer") and parts[2].startswith("Conv_")):
        stage, index = (int(v) for v in parts[1][5:].split("_"))
        prefix = (f"backbone.layer{stage}" if pose else
                  "RCNN_top.0" if stage == 4 else f"RCNN_base.{3 + stage}")
        return _block_name(model, prefix, index, int(parts[2][5:])), "conv"
    raise ValueError(f"no {type(model).__name__} module maps from the JAX "
                     f"path {path!r}")


def quantized_from_jax(bundle, model):
    """A JAX package `Quantized` bundle (kernels, kscales, biases, ascales
    and skipped keyed by flax paths; arrays of any kind `np.asarray`
    reads) -> this package's `quantize.Quantized` for `model` (a
    `ResPoseNet` or a ResNet `FasterRCNN`): the same int8 values in the
    torch names and layouts, the RPN class conv's output channels permuted
    with its scales and biases, the digest recomputed from `model`'s
    weights and `type(model)` as the root type."""
    from hand_integral_pose_estimation_tpu_torch.quantize import (
        Quantized,
        digest_params,
    )

    A = getattr(model, "num_anchors", None)

    def out_channels(x, layout):
        return _rpn_cls_from_jax(x, A) if layout == "rpn_cls" else x

    def kernel(k, layout):
        k = np.asarray(k)
        if layout == "dense":
            return k.T
        if layout == "deconv":
            return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        return np.transpose(out_channels(k, layout), (3, 2, 0, 1))

    names = {p: _module_from_jax(p, model) for p in bundle.kernels}
    kernels, kscales, biases, ascales = {}, {}, {}, {}
    for p, (name, layout) in names.items():
        kernels[name] = torch.from_numpy(np.ascontiguousarray(
            kernel(bundle.kernels[p], layout)))
        kscales[name] = torch.from_numpy(np.array(
            out_channels(np.asarray(bundle.kscales[p]), layout)))
        ascales[name] = float(bundle.ascales[p])
        if p in bundle.biases:
            biases[name] = torch.from_numpy(np.array(
                out_channels(np.asarray(bundle.biases[p]), layout)))
    skipped = tuple(sorted(_module_from_jax(p, model)[0]
                           for p in bundle.skipped))
    return Quantized(kernels, kscales, ascales, biases, skipped,
                     type(model), digest_params(model, kernels))
