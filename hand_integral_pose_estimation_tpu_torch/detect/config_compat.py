"""Reference RCNN-config override shim: yaml files / KEY VALUE lists.

A copy of hand_integral_pose_estimation_tpu/detect/config_compat.py (numpy
and the standard library only) over this package's `config.py`, so the
port imports nothing of the JAX package.

Capability equivalent of the reference's detector config override machinery
(`lib/model_rcnn/utils/config_rcnn.py:372-400` `cfg_from_file` /
`cfg_from_list`, and `:339-370` `_merge_a_into_b`): operators carrying the
reference's `cfgs/res101.yml`-style files or `--set TEST.RPN_POST_NMS_TOP_N
64`-style command lines can apply them directly to the frozen
:class:`~hand_integral_pose_estimation_tpu_torch.config.DetectorConfig` tree.

Semantics preserved from the reference:
  * unknown keys raise ``KeyError`` (``_merge_a_into_b``: "a must specify
    keys that are in b");
  * value types must be coercible to the field's type, else ``ValueError``
    (the reference asserts exact type match after ``literal_eval``; here
    list->tuple and int->float widenings are accepted since the dataclass
    carries richer types than the edict);
  * keys that exist in the reference namespace but configure its *runtime
    environment* (CUDA device ids, snapshot prefixes, matlab paths, ...)
    are accepted and ignored, exactly as loading them into the reference's
    global ``__C`` has no effect on the hand pipeline.

Deliberate deviations, documented per key in :data:`RCNN_KEY_MAP`:
  * ``TRAIN.RPN_NMS_THRESH`` / ``TEST.RPN_NMS_THRESH`` share one field
    (the reference defaults them identically at 0.7);
  * ``TEST.SCALES`` is single-scale (the reference's hand pipeline only
    ever indexes ``[0]``: `common/hand_detector.py:151`).
"""

from __future__ import annotations

import dataclasses
import typing
from ast import literal_eval
from typing import Any, Dict, List, Mapping, Sequence, Tuple

from hand_integral_pose_estimation_tpu_torch.config import DetectorConfig

#: dotted reference key -> DetectorConfig field. Multi-valued reference keys
#: map through a small adapter (second tuple slot) that turns the reference
#: value into the field value.
RCNN_KEY_MAP: Dict[str, Tuple[str, Any]] = {
    "ANCHOR_SCALES": ("anchor_scales", None),
    "ANCHOR_RATIOS": ("anchor_ratios", None),
    # the reference keeps a per-level list with one entry (FEAT_STRIDE =
    # [16]); single-level here
    "FEAT_STRIDE": ("feat_stride", lambda v: _single(v, "FEAT_STRIDE")),
    "POOLING_SIZE": ("pooling_size", None),
    "PIXEL_MEANS": ("pixel_means", lambda v: _pixel_means(v)),
    "TEST.SCALES": ("test_scale", lambda v: _single(v, "TEST.SCALES")),
    "TEST.MAX_SIZE": ("test_max_size", None),
    "TEST.NMS": ("det_nms_thresh", None),
    "TEST.RPN_NMS_THRESH": ("rpn_nms_thresh", None),
    "TEST.RPN_PRE_NMS_TOP_N": ("rpn_pre_nms_top_n_test", None),
    "TEST.RPN_POST_NMS_TOP_N": ("rpn_post_nms_top_n_test", None),
    "TEST.RPN_MIN_SIZE": ("rpn_min_size", None),
    "TRAIN.RPN_NMS_THRESH": ("rpn_nms_thresh", None),
    "TRAIN.RPN_PRE_NMS_TOP_N": ("rpn_pre_nms_top_n_train", None),
    "TRAIN.RPN_POST_NMS_TOP_N": ("rpn_post_nms_top_n_train", None),
    "TRAIN.RPN_MIN_SIZE": ("rpn_min_size", None),
    "TRAIN.RPN_BATCHSIZE": ("rpn_batch_size", None),
    "TRAIN.RPN_FG_FRACTION": ("rpn_fg_fraction", None),
    "TRAIN.RPN_POSITIVE_OVERLAP": ("rpn_positive_overlap", None),
    "TRAIN.RPN_NEGATIVE_OVERLAP": ("rpn_negative_overlap", None),
    "TRAIN.BATCH_SIZE": ("roi_batch_size", None),
    "TRAIN.FG_FRACTION": ("roi_fg_fraction", None),
    "TRAIN.FG_THRESH": ("roi_fg_thresh", None),
    "TRAIN.BG_THRESH_HI": ("roi_bg_thresh_hi", None),
    "TRAIN.BG_THRESH_LO": ("roi_bg_thresh_lo", None),
    "TRAIN.BBOX_NORMALIZE_MEANS": ("bbox_normalize_means", None),
    "TRAIN.BBOX_NORMALIZE_STDS": ("bbox_normalize_stds", None),
}

#: valid reference keys with no pipeline-visible equivalent here: runtime
#: environment (device ids, output dirs, snapshot cadence), optimizer
#: hyper-parameters owned by the training CLIs, or machinery replaced by a
#: different design (ASPECT_GROUPING -> detect/data.py aspect_ratio_groups;
#: USE_FLIPPED -> build_detector_batch flip_rng). Accepted and ignored, as
#: the reference accepts them into its global __C.
IGNORED_KEYS = frozenset({
    "CUDA", "USE_GPU_NMS", "GPU_ID", "RNG_SEED", "EPS", "ROOT_DIR",
    "DATA_DIR", "MATLAB", "EXP_DIR", "DEDUP_BOXES", "MAX_NUM_GT_BOXES",
    "CROP_RESIZE_WITH_MAX_POOL", "MOBILENET.REGU_DEPTH",
    "MOBILENET.FIXED_LAYERS", "MOBILENET.WEIGHT_DECAY",
    "MOBILENET.DEPTH_MULTIPLIER", "RESNET.MAX_POOL", "RESNET.FIXED_BLOCKS",
    "TRAIN.LEARNING_RATE", "TRAIN.MOMENTUM", "TRAIN.WEIGHT_DECAY",
    "TRAIN.GAMMA", "TRAIN.STEPSIZE", "TRAIN.DISPLAY", "TRAIN.DOUBLE_BIAS",
    "TRAIN.TRUNCATED", "TRAIN.BIAS_DECAY", "TRAIN.USE_GT",
    "TRAIN.ASPECT_GROUPING", "TRAIN.SNAPSHOT_KEPT",
    "TRAIN.SUMMARY_INTERVAL", "TRAIN.SCALES", "TRAIN.MAX_SIZE",
    "TRAIN.TRIM_HEIGHT", "TRAIN.TRIM_WIDTH", "TRAIN.IMS_PER_BATCH",
    "TRAIN.USE_FLIPPED", "TRAIN.BBOX_REG", "TRAIN.BBOX_THRESH",
    "TRAIN.SNAPSHOT_ITERS", "TRAIN.SNAPSHOT_PREFIX",
    "TRAIN.BBOX_NORMALIZE_TARGETS", "TRAIN.BBOX_INSIDE_WEIGHTS",
    "TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED", "TRAIN.PROPOSAL_METHOD",
    "TRAIN.HAS_RPN", "TRAIN.RPN_CLOBBER_POSITIVES",
    "TRAIN.RPN_BBOX_INSIDE_WEIGHTS", "TRAIN.RPN_POSITIVE_WEIGHT",
    "TRAIN.USE_ALL_GT", "TRAIN.BN_TRAIN",
    "TEST.SVM", "TEST.BBOX_REG", "TEST.HAS_RPN", "TEST.PROPOSAL_METHOD",
    "TEST.MODE", "TEST.RPN_TOP_N",
})


def _single(v: Any, key: str) -> Any:
    """Reference per-scale tuples are single-entry in the hand pipeline."""
    if isinstance(v, (list, tuple)):
        if len(v) != 1:
            raise ValueError(
                f"{key}={v!r}: multi-scale pyramids are not supported "
                "(the reference hand pipeline only uses SCALES[0])")
        return v[0]
    return v


def _pixel_means(v: Any) -> Any:
    """The reference stores PIXEL_MEANS as a (1, 1, 3) nested array."""
    import numpy as np
    return tuple(float(x) for x in np.asarray(v).reshape(-1))


def _coerce(value: Any, field: dataclasses.Field, key: str) -> Any:
    """Coerce a parsed override value to the dataclass field's type, with the
    reference's type-mismatch strictness (`_merge_a_into_b:352-361`)."""
    ftype = field.type
    origin = typing.get_origin(ftype) if not isinstance(ftype, str) else None
    is_tuple = (origin is tuple) or (
        isinstance(ftype, str) and ftype.startswith("Tuple"))
    if is_tuple:
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"{key}: expected a sequence, got {value!r}")
        return tuple(value)
    current_type = type(getattr(DetectorConfig(), field.name))
    if isinstance(value, bool) or current_type is bool:
        if not isinstance(value, bool):
            raise ValueError(f"{key}: expected bool, got {value!r}")
        return value
    if current_type is float and isinstance(value, (int, float)):
        return float(value)
    if current_type is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"{key}: expected int, got {value!r}")
        return value
    if not isinstance(value, current_type):
        raise ValueError(
            f"{key}: type {type(value).__name__} does not match field type "
            f"{current_type.__name__}")
    return value


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        dotted = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix=f"{dotted}."))
        else:
            out[dotted] = v
    return out


def apply_rcnn_overrides(cfg: DetectorConfig,
                         overrides: Mapping[str, Any]) -> DetectorConfig:
    """Apply a flat {dotted reference key: value} mapping to `cfg`.

    Unknown keys raise KeyError (reference `_merge_a_into_b:348-350`);
    POOLING_MODE accepts only 'align' (this implementation's ROIAlign is the
    reference's shipped default, `config_rcnn.py:284`)."""
    fields = {f.name: f for f in dataclasses.fields(DetectorConfig)}
    updates: Dict[str, Any] = {}
    for key, value in overrides.items():
        if key == "POOLING_MODE":
            if value != "align":
                raise ValueError(
                    f"POOLING_MODE={value!r}: only 'align' is supported "
                    "(the reference's shipped default; 'crop' is its legacy "
                    "FFI path, subsumed by ops/warp.py)")
            continue
        if key in IGNORED_KEYS:
            continue
        if key not in RCNN_KEY_MAP:
            raise KeyError(f"{key} is not a valid config key")
        name, adapt = RCNN_KEY_MAP[key]
        if adapt is not None:
            value = adapt(value)
        updates[name] = _coerce(value, fields[name], key)
    return dataclasses.replace(cfg, **updates)


def cfg_from_file(cfg: DetectorConfig, path: str) -> DetectorConfig:
    """Load a reference-format yaml (e.g. its `cfgs/res101.yml`) and merge it
    over `cfg` (reference `cfg_from_file:372-378`)."""
    import yaml
    with open(path) as f:
        tree = yaml.safe_load(f) or {}
    if not isinstance(tree, Mapping):
        raise ValueError(f"{path}: expected a mapping at top level")
    return apply_rcnn_overrides(cfg, _flatten(tree))


def cfg_from_list(cfg: DetectorConfig,
                  kv: Sequence[str]) -> DetectorConfig:
    """Merge an alternating KEY VALUE list (the reference's `--set` flag,
    `cfg_from_list:381-400`); values parse via literal_eval with string
    fallback."""
    if len(kv) % 2 != 0:
        raise ValueError("--set expects an even KEY VALUE list")
    overrides: Dict[str, Any] = {}
    for k, v in zip(kv[0::2], kv[1::2]):
        try:
            overrides[k] = literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    return apply_rcnn_overrides(cfg, overrides)


def add_override_flags(parser) -> None:
    """Attach the reference-parity `--cfg-file` / `--set` flags."""
    parser.add_argument(
        "--cfg-file", default=None, metavar="YAML",
        help="reference-format RCNN yaml config overrides "
             "(lib/model_rcnn/utils/config_rcnn.py cfg_from_file)")
    parser.add_argument(
        "--set", dest="set_cfgs", nargs="*", default=None, metavar="KV",
        help="reference-format KEY VALUE config override pairs "
             "(config_rcnn.py cfg_from_list), e.g. "
             "--set TEST.RPN_POST_NMS_TOP_N 64 TEST.NMS 0.3")


def overrides_from_args(cfg: DetectorConfig, args) -> DetectorConfig:
    """Apply `add_override_flags` results: file first, then --set pairs
    (the reference's trainval_net.py applies them in that order)."""
    if getattr(args, "cfg_file", None):
        cfg = cfg_from_file(cfg, args.cfg_file)
    if getattr(args, "set_cfgs", None):
        cfg = cfg_from_list(cfg, args.set_cfgs)
    return cfg


__all__: List[str] = [
    "RCNN_KEY_MAP", "IGNORED_KEYS", "apply_rcnn_overrides",
    "cfg_from_file", "cfg_from_list", "add_override_flags",
    "overrides_from_args",
]
