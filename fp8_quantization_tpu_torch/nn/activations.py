"""Fused activation functions permitted inside quantized layers.

Mirrors ``fp8_quantization_tpu/nn/activations.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

_SQRT_HALF = float(np.sqrt(0.5).astype(np.float32))

ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # exact gelu in JAX's form, 0.5 * x * erfc(-x * sqrt(1/2)) (jax.nn.gelu
    # with approximate=False), not torch's 1 + erf, which cancels for x < 0
    "gelu": lambda x: 0.5 * x * torch.special.erfc(-x * _SQRT_HALF),
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
