"""Serving export of a calibrated, deployed model (serving/export.py)."""

from fp8_quantization_tpu_torch.serving.export import (  # noqa: F401
    export_quantized_model, load_exported)
