"""Fused activation functions permitted inside quantized layers.

Mirrors ``fp8_quantization_tpu/nn/activations.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "swish": F.silu,
    "hardswish": F.hardswish,
    "hardsigmoid": F.hardsigmoid,
}


def get_activation(name: Optional[str]) -> Optional[Callable]:
    if name is None:
        return None
    if name not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {name!r}; "
                         f"known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
