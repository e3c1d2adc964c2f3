"""Utilities of the entry points."""

from fp8_quantization_tpu_torch.utils.timing import (  # noqa: F401
    span, spanned, time_cuda, totals)
