"""Uniform (INT) affine quantizers.

Mirrors ``fp8_quantization_tpu/ops/uniform.py`` (lines 22-134):
``_scale_from_delta``, the integer bounds, ``quantize_uniform_asymmetric`` /
``quantize_uniform_symmetric`` (round half to even, straight-through
gradient), ``tensorize_min_max`` and the two ``set_quant_range`` functions.
``delta`` / ``zero_float`` must already broadcast against ``x``.

Clipping is ``torch.minimum(torch.maximum(x, lo), hi)`` on tensors, as
``jnp.clip`` is: both split the gradient in half on a tie with a bound, so
the gradient w.r.t. x is bit-exact too.  The LSQ gradient scaling
(``grad_scaling=True``; JAX ``lsq_grad_scale``) comes with QAT and
raises.
"""

from __future__ import annotations

import torch

from fp8_quantization_tpu_torch.ops.rounding import round_ste

_EPS = 1e-8


def _qat_only() -> NotImplementedError:
    return NotImplementedError("LSQ gradient scaling comes with QAT and is "
                               "not ported yet")


def _scale_from_delta(delta: torch.Tensor, scale_domain: str,
                      eps: float = _EPS) -> torch.Tensor:
    if scale_domain == "linear":
        return torch.clamp(delta, min=eps)
    if scale_domain == "log":
        return torch.exp(delta)
    raise ValueError(f"scale_domain must be 'linear' or 'log', got {scale_domain}")


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def asymmetric_int_bounds(n_bits: int):
    """The integer grid [0, 2^n - 1]."""
    return 0.0, 2.0 ** n_bits - 1.0


def symmetric_int_bounds(n_bits: int, signed):
    """[-2^(n-1), 2^(n-1) - 1] if ``signed`` (a 0/1 tensor) else [0, 2^n - 1],
    as float32 tensors."""
    signed_f = torch.as_tensor(signed).to(torch.float32)
    int_min = torch.where(signed_f > 0, -(2.0 ** (n_bits - 1)), 0.0)
    int_max = 2.0 ** (float(n_bits) - signed_f) - 1.0
    return int_min, int_max


def quantize_uniform_asymmetric(x, delta, zero_float, n_bits: int, *,
                                scale_domain: str = "linear", eps: float = _EPS,
                                grad_scaling: bool = False, discretizer=round_ste):
    """``scale * (clip(round(x/scale) + zp) - zp)``."""
    if grad_scaling:
        raise _qat_only()
    int_min, int_max = asymmetric_int_bounds(n_bits)
    scale = _scale_from_delta(delta, scale_domain, eps)
    zero_point = _clip(discretizer(zero_float), int_min, int_max)
    x_int = discretizer(x / scale) + zero_point
    x_int = _clip(x_int, int_min, int_max)
    return scale * (x_int - zero_point)


def quantize_uniform_symmetric(x, delta, signed, n_bits: int, *,
                               scale_domain: str = "linear", eps: float = _EPS,
                               grad_scaling: bool = False, discretizer=round_ste):
    """``scale * clip(round(x/scale))`` (zero point 0)."""
    if grad_scaling:
        raise _qat_only()
    int_min, int_max = symmetric_int_bounds(n_bits, signed)
    scale = _scale_from_delta(delta, scale_domain, eps)
    x_int = _clip(discretizer(x / scale), int_min, int_max)
    return scale * x_int


def tensorize_min_max(x_min, x_max, eps: float = _EPS):
    """The range widened to include zero and at least ``eps`` wide."""
    x_min = torch.clamp(torch.as_tensor(x_min, dtype=torch.float32), max=0.0)
    x_max = torch.clamp(torch.as_tensor(x_max, dtype=torch.float32), min=eps)
    return x_min, x_max


def asymmetric_set_quant_range(x_min, x_max, n_bits: int, *,
                               scale_domain: str = "linear", eps: float = _EPS):
    """``(delta, zero_float)`` from a range."""
    x_min, x_max = tensorize_min_max(x_min, x_max, eps)
    _, int_max = asymmetric_int_bounds(n_bits)
    delta = (x_max - x_min) / int_max
    zero_float = -x_min / delta
    if scale_domain == "log":
        delta = torch.log(delta)
    return delta, zero_float


def symmetric_set_quant_range(x_min, x_max, n_bits: int, *,
                              scale_domain: str = "linear", eps: float = _EPS):
    """``(delta, signed)`` from a range; ``signed`` is an int32 0/1 for the
    whole tensor (``min(x_min) < 0``)."""
    x_min, x_max = tensorize_min_max(x_min, x_max, eps)
    signed = (torch.min(x_min) < 0).to(torch.int32)
    _, int_max = symmetric_int_bounds(n_bits, signed)
    x_absmax = torch.maximum(torch.abs(x_min), x_max)
    delta = x_absmax / int_max
    if scale_domain == "log":
        delta = torch.log(delta)
    return delta, signed
