"""Int8 post-training quantization for the serving path (see ptq.py)."""

from hand_integral_pose_estimation_tpu_torch.quantize.ptq import (  # noqa: F401
    Quantized,
    calibrate,
    digest_params,
    load_quantized,
    quantize_model,
    quantize_params,
    quantized_apply,
    quantized_calls,
    save_quantized,
    verify_source_params,
)

__all__ = [
    "Quantized",
    "calibrate",
    "digest_params",
    "load_quantized",
    "quantize_model",
    "quantize_params",
    "quantized_apply",
    "quantized_calls",
    "save_quantized",
    "verify_source_params",
]
