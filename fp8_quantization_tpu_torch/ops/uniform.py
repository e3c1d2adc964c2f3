"""Uniform (INT) affine quantizers.

Mirrors ``fp8_quantization_tpu/ops/uniform.py`` (lines 22-134):
``_scale_from_delta``, the integer bounds, ``quantize_uniform_asymmetric`` /
``quantize_uniform_symmetric`` (round half to even, straight-through
gradient), ``tensorize_min_max`` and the two ``set_quant_range`` functions.
``delta`` / ``zero_float`` must already broadcast against ``x``.

``int_asym_consts`` / ``int_sym_consts`` / ``int_quantize_prepared`` freeze
a fixed quantizer into the ``(6, C)`` constant tensor that the CUDA kernels
read (see ``csrc/fq_epilogue.cuh``), as ``ops/fp8.fp8_consts`` does for FP8:
the arithmetic of the Pallas tiles ``_int_asym_quantize_tile`` and
``_int_sym_quantize_tile`` (JAX ``ops/pallas/qmatmul.py:107-142``).

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


# Row order of the (6, C) constants of an integer quantizer that the kernels
# read; keep in step with csrc/fq_epilogue.cuh.  Row 5 is the normalized
# grid's factor, as in ops/fp8.FP8_CONST_ROWS.
INT_CONST_ROWS = ("delta", "zero_point", "int_min", "int_max", "unused",
                  "factor")


def _int_rows(delta, zp, lo, hi, factor) -> torch.Tensor:
    delta = delta.reshape(-1)
    rows = [delta, zp, lo, hi, torch.zeros_like(delta), factor]
    return torch.stack([torch.as_tensor(r, dtype=torch.float32,
                                        device=delta.device).expand_as(delta)
                        for r in rows]).contiguous()


def int_asym_consts(scale: torch.Tensor, zero_float: torch.Tensor,
                    n_bits: int) -> torch.Tensor:
    """(6, 1) constants (rows as in ``INT_CONST_ROWS``) of a fixed
    per-tensor asymmetric quantizer from its scale (``_scale_from_delta`` of its delta) and ``zero_float``: the step
    floored at 1e-8 and the zero point clip(round(zero_float), 0, 2^n - 1),
    as ``_int_asym_quantize_tile`` computes them; the factor of its
    normalized output is the scale itself (JAX ``_act_factor``)."""
    scale = torch.as_tensor(scale, dtype=torch.float32).reshape(1)
    lo, hi = asymmetric_int_bounds(n_bits)
    zp = _clip(torch.round(torch.as_tensor(zero_float, dtype=torch.float32,
                                           device=scale.device).reshape(1)),
               lo, hi)
    return _int_rows(torch.clamp(scale, min=_EPS), zp, lo, hi, scale)


def int_sym_consts(scale: torch.Tensor, signed, n_bits: int) -> torch.Tensor:
    """(6, C) constants of a fixed (per-channel) symmetric quantizer from its
    scale and its 0/1 ``signed``: the step floored at 1e-8, zero point 0,
    the signed or unsigned grid; the factor is the floored step (the Pallas
    epilogue's ``max(delta, 1e-8)``)."""
    scale = torch.as_tensor(scale, dtype=torch.float32).reshape(-1)
    lo, hi = symmetric_int_bounds(n_bits, signed)
    delta = torch.clamp(scale, min=_EPS)
    return _int_rows(delta, 0.0, lo.to(delta.device), hi.to(delta.device),
                     delta)


def int_quantize_prepared(x: torch.Tensor, c: torch.Tensor, *,
                          channel_axis: int = -1,
                          normalized: bool = False) -> torch.Tensor:
    """Fixed uniform fake-quant of float32 ``x`` from ``int_asym_consts`` /
    ``int_sym_consts`` output ``c`` (per channel along ``channel_axis`` when
    ``c`` has C > 1 columns): ``xint = clip(round(x / delta) + zp, lo, hi)``,
    then ``xint - zp`` (normalized) or ``(xint - zp) * delta``.  The plain
    version of the kernels' ``int_quantize`` device function."""
    if c.shape[1] > 1:
        shape = [1] * x.ndim
        shape[channel_axis] = c.shape[1]
        delta, zp, lo, hi = (r.reshape(shape) for r in c[:4])
    else:
        delta, zp, lo, hi = c[:4, 0]
    xi = torch.minimum(torch.maximum(torch.round(x / delta) + zp, lo), hi)
    q = xi - zp
    return q if normalized else q * delta
