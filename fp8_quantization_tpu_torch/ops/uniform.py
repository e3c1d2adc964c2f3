"""Uniform (INT) affine quantizers.

Mirrors ``fp8_quantization_tpu/ops/uniform.py``: ``_scale_from_delta``,
the integer bounds, ``lsq_grad_scale``, ``quantize_uniform_asymmetric`` /
``quantize_uniform_symmetric`` (round half to even with the discretizer's
gradient estimator, straight-through by default; with ``grad_scaling`` the
LSQ scale on the step's and zero point's gradients), ``tensorize_min_max``,
the two ``set_quant_range`` functions and the host-side
``symmetric_grid``.  ``delta`` / ``zero_float`` must already broadcast
against ``x``.

``int_asym_consts`` / ``int_sym_consts`` / ``int_quantize_prepared`` freeze
a fixed quantizer into the ``(6, C)`` constant tensor that the CUDA kernels
read (see ``csrc/fq_epilogue.cuh``), as ``ops/fp8.fp8_consts`` does for FP8:
the arithmetic of the Pallas tiles ``_int_asym_quantize_tile`` and
``_int_sym_quantize_tile`` (JAX ``ops/pallas/qmatmul.py:107-142``).

Clipping is ``torch.minimum(torch.maximum(x, lo), hi)`` on tensors, as
``jnp.clip`` is: both split the gradient in half on a tie with a bound, so
the gradient w.r.t. x is bit-exact too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fp8_quantization_tpu_torch.ops.rounding import round_ste, scale_gradient

_EPS = 1e-8


class _Div(torch.autograd.Function):
    """``x / y`` whose backward is JAX's quotient rule (``ct / y`` and
    ``-((ct * (1 / (y * y))) * x)``): torch's own rounds the second
    otherwise, and the step's gradient must be bit-exact."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return x / y

    @staticmethod
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (ct / y).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            gy = (-((ct * (1.0 / (y * y))) * x)).sum_to_size(y.shape)
        return gx, gy


def _div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _Div.apply(x, y)


def _scale_from_delta(delta: torch.Tensor, scale_domain: str,
                      eps: float = _EPS) -> torch.Tensor:
    if scale_domain == "linear":
        # maximum, not clamp: JAX's clip halves the gradient on a tie
        return torch.maximum(delta, torch.tensor(eps, dtype=delta.dtype,
                                                 device=delta.device))
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


@functools.lru_cache(maxsize=1)
def _libm_powf():
    import ctypes
    import ctypes.util
    powf = ctypes.CDLL(ctypes.util.find_library("m")).powf
    powf.restype, powf.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return powf


def _powf(x: float, y: float) -> float:
    """float32 ``x ** y`` by libm's ``powf``, which XLA's CPU ``power``
    calls (torch's float32 pow takes other roundings)."""
    return float(_libm_powf()(x, y))


def lsq_grad_scale(x: torch.Tensor, int_max, per_channel: bool,
                   channel_axis: int = -1) -> float:
    """The LSQ gradient scale ``(int_max * numel)^-1/2``; per channel the
    count leaves out the channel axis (``channel_axis`` 0 for the port's
    OIHW / (out, in) weights where JAX's HWIO ones take -1).  A Python
    ``int_max`` gives a Python float, as in JAX; a tensor one (the
    symmetric grid's) the float32 value JAX computes."""
    num_elements = float(np.prod(x.shape))
    if per_channel and x.ndim:
        num_elements /= x.shape[channel_axis]
    if not isinstance(int_max, torch.Tensor):
        return (int_max * num_elements) ** -0.5
    prod = np.float32(float(int_max)) * np.float32(num_elements)
    return _powf(float(prod), -0.5)


def quantize_uniform_asymmetric(x, delta, zero_float, n_bits: int, *,
                                scale_domain: str = "linear", eps: float = _EPS,
                                grad_scaling: bool = False,
                                per_channel: bool = False,
                                channel_axis: int = -1, discretizer=round_ste):
    """``scale * (clip(round(x/scale) + zp) - zp)``."""
    int_min, int_max = asymmetric_int_bounds(n_bits)
    scale = _scale_from_delta(delta, scale_domain, eps)
    zero_point = _clip(discretizer(zero_float), int_min, int_max)
    if grad_scaling:
        gs = lsq_grad_scale(x, int_max, per_channel, channel_axis)
        scale = scale_gradient(scale, gs)
        zero_point = scale_gradient(zero_point, gs)
    x_int = discretizer(_div(x, scale)) + zero_point
    x_int = _clip(x_int, int_min, int_max)
    return scale * (x_int - zero_point)


def quantize_uniform_symmetric(x, delta, signed, n_bits: int, *,
                               scale_domain: str = "linear", eps: float = _EPS,
                               grad_scaling: bool = False,
                               per_channel: bool = False,
                               channel_axis: int = -1, discretizer=round_ste):
    """``scale * clip(round(x/scale))`` (zero point 0)."""
    int_min, int_max = symmetric_int_bounds(n_bits, signed)
    scale = _scale_from_delta(delta, scale_domain, eps)
    if grad_scaling:
        scale = scale_gradient(scale, lsq_grad_scale(x, int_max, per_channel,
                                                     channel_axis))
    x_int = _clip(discretizer(_div(x, scale)), int_min, int_max)
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


def symmetric_grid(delta: float, signed: bool, n_bits: int,
                   scale_domain: str = "linear") -> np.ndarray:
    """The symmetric integer lattice times its step, host side (the
    analytical study's grid)."""
    signed = bool(signed)
    int_min = -(2.0 ** (n_bits - 1)) if signed else 0.0
    int_max = 2.0 ** (n_bits - int(signed)) - 1.0
    scale = np.exp(delta) if scale_domain == "log" else max(float(delta), _EPS)
    return scale * np.arange(int_min, int_max + 1)


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
