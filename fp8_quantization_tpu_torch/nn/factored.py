"""Factored activations: the engines' inter-layer interchange.

Mirrors ``fp8_quantization_tpu/nn/factored.py`` (``Factored``,
``PrequantS8``, ``storage_dtype``, ``split``, ``materialize``, ``fadd``,
``fmax_pool``, ``fmean``).

A fake-quantized tensor is exactly ``norm * factor``: ``norm`` lies on the
quantizer's normalized grid (an <= 8-bit significand for FP8, the integer
``xint - zp`` in [-255, 255] for an asymmetric uniform quantizer; both
exact in bfloat16) and ``factor`` is a per-tensor float32 scalar.  In fixed mode under the
bf16 and fused engines layers exchange ``Factored`` pairs, so the next
product runs on ``norm`` with no rounding and folds ``factor`` in after.

``norm`` is stored in bfloat16, or under ``deploy_act_f8`` as the 1-byte
array of the IEEE cast (ops/fp8.ieee_store): ``torch.float8_e5m2``,
``torch.float8_e4m3fn``, or E3M4 codes in ``torch.bits8``, whose dtype
is the format mark and takes no arithmetic (``torch.uint8`` inside an
exported program, ops/fp8.py).  Every reader goes through
``upcast`` (``split``, ``materialize`` and the helpers here), an exact
conversion to bfloat16; the kernels read bfloat16, as JAX's Pallas
kernels take the f8 input upcast.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from fp8_quantization_tpu_torch.ops.fp8 import ieee_decode
from fp8_quantization_tpu_torch.ops.int8 import act_int_params


class Factored(NamedTuple):
    """A fake-quantized NHWC tensor in normalized form: value == norm * factor."""

    norm: torch.Tensor      # bfloat16 or 1-byte (see the module docstring)
    factor: torch.Tensor    # float32 scalar


class PrequantS8(NamedTuple):
    """An activation already on its consumer's asymmetric input grid, as
    the recentred int8 operand of the int8 datapath (ops/int8.prequant_s8):
    its producer (a LayerNorm, an int8 matmul's epilogue, the attention
    output) runs the consumer's quant prologue, so the consumer reads one
    byte a value.  value == (xs8 + 128 - round(zero)) * delta (``zero``
    clipped to the grid, ``delta`` at least 1e-8, as the prologue takes
    them)."""

    xs8: torch.Tensor       # int8, clip(round(x/delta) + zp, 0, 2^b - 1) - 128
    delta: torch.Tensor     # float32 scalar: the consumer's input step
    zero: torch.Tensor      # float32 scalar: its zero point
    bits: int               # its bit width


MaybeFactored = Union[torch.Tensor, Factored, PrequantS8]


def storage_dtype(norm: torch.Tensor) -> torch.Tensor:
    """The storage of a quantizer's normalized output: a 1-byte array as it
    is, anything else in bfloat16 (JAX ``storage_dtype``)."""
    if norm.element_size() == 1:
        return norm
    return norm.to(torch.bfloat16)


def upcast(norm: torch.Tensor) -> torch.Tensor:
    """A stored norm as exact bfloat16 (1-byte arrays decoded), others as
    they are."""
    if norm.element_size() == 1:
        return ieee_decode(norm)
    return norm


def split(x: MaybeFactored) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(operand, factor or None): the layer-entry unpacking; a
    ``PrequantS8`` is materialized (its consumers that take the s8 operand
    read ``xs8`` before they split)."""
    if isinstance(x, Factored):
        return upcast(x.norm), x.factor
    return materialize(x), None


def materialize(x: MaybeFactored) -> torch.Tensor:
    """Full-scale float32 value of a Factored tensor or of a PrequantS8
    (``(xs8 + 128 - zp) * delta``); a plain tensor as it is."""
    if isinstance(x, Factored):
        return upcast(x.norm).to(torch.float32) * x.factor
    if isinstance(x, PrequantS8):
        delta, zp = act_int_params(x.delta, x.zero, x.bits)
        return (x.xs8.to(torch.float32) + (128.0 - zp)) * delta
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
    """Max pool that stays factored: factor > 0, so max commutes with it;
    a 1-byte norm is upcast first, as in JAX."""
    if isinstance(x, Factored):
        return Factored(max_pool_nhwc(upcast(x.norm), window, stride, padding),
                        x.factor)
    return max_pool_nhwc(x, window, stride, padding)


def fmean(x: MaybeFactored, axis: Sequence[int]) -> torch.Tensor:
    """Mean pool to a full-scale float32 value."""
    return torch.mean(materialize(x), dim=tuple(axis))
