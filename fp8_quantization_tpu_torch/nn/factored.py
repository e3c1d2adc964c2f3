"""Factored activations: the engines' inter-layer interchange.

Mirrors ``fp8_quantization_tpu/nn/factored.py`` (``Factored``, ``split``,
``materialize``, ``fadd``, ``fmax_pool``, ``fmean``) with bf16 storage; the
IEEE-f8 storage of ``deploy_act_f8`` is not ported.

A fake-quantized tensor is exactly ``norm * factor``: ``norm`` lies on the
quantizer's normalized grid (an <= 8-bit significand for FP8, the integer
``xint - zp`` in [-255, 255] for an asymmetric uniform quantizer; both
exact in bfloat16) and ``factor`` is a per-tensor float32 scalar.  In fixed mode under the
bf16 and fused engines layers exchange ``Factored`` pairs, so the next
product runs on ``norm`` with no rounding and folds ``factor`` in after.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


class Factored(NamedTuple):
    """A fake-quantized NHWC tensor in normalized form: value == norm * factor."""

    norm: torch.Tensor      # bfloat16, values on the normalized grid
    factor: torch.Tensor    # float32 scalar


MaybeFactored = Union[torch.Tensor, Factored]


def split(x: MaybeFactored) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(operand, factor or None): the layer-entry unpacking."""
    if isinstance(x, Factored):
        return x.norm, x.factor
    return x, None


def materialize(x: MaybeFactored) -> torch.Tensor:
    """Full-scale float32 value."""
    if isinstance(x, Factored):
        return x.norm.to(torch.float32) * x.factor
    return x


def fadd(a: MaybeFactored, b: MaybeFactored) -> torch.Tensor:
    """Residual add in float32."""
    return materialize(a) + materialize(b)


def max_pool_nhwc(x: torch.Tensor, window: int, stride: int,
                  padding: int) -> torch.Tensor:
    """Max pool over the H, W axes of an NHWC tensor (padding is -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def fmax_pool(x: MaybeFactored, window: int, stride: int,
              padding: int) -> MaybeFactored:
    """Max pool that stays factored: factor > 0, so max commutes with it."""
    if isinstance(x, Factored):
        return Factored(max_pool_nhwc(x.norm, window, stride, padding), x.factor)
    return max_pool_nhwc(x, window, stride, padding)


def fmean(x: MaybeFactored, axis: Sequence[int]) -> torch.Tensor:
    """Mean pool to a full-scale float32 value."""
    return torch.mean(materialize(x), dim=tuple(axis))
