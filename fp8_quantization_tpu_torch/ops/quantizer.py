"""Functional quantizer: static spec + state dict + pure transforms.

Mirrors ``fp8_quantization_tpu/ops/quantizer.py``: ``QMethod``,
``QuantizerSpec``, ``init_state``, ``apply``, ``apply_factored``,
``fixed_consts``, ``apply_prepared``, ``set_quant_range``,
``trainable_param_names`` (the state QAT learns) and the host-side
``quantizer_grid`` for ``fp_quantizer`` and the uniform methods
(``ops/uniform.py``).  Rounding takes a discretizer (``ops/rounding``):
the straight-through round by default, or the QAT estimator that the
spec's ``grad_estimator`` names (chosen by nn/quantizers.py).  ``fixed_consts`` freezes a fixed FP8 quantizer's
scalar algebra into the ``(6, C)`` layout of ``ops/fp8.fp8_consts``, which
the kernels also read; a spec that opts into the deployment cast path
(``cast_fastpath``, JAX lines 211-248) gets the six rows of
``ops/fp8.fp8_cast_consts`` below them where it is eligible, and
``apply_prepared`` then quantizes by the cast.  Uniform state is ``delta`` with
``signed`` (symmetric) or ``zero_float`` (asymmetric); ``apply_factored``
gives the bare integers ``x_int`` (symmetric) or ``x_int - zp``
(asymmetric), exact in bfloat16, and the step as the factor.

Per-channel state is 1-D ``(C,)`` and broadcast along ``channel_axis``.
Torch weights are OIHW / (out, in), so weight quantizers use
``channel_axis=0`` where the JAX package (HWIO) uses -1.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import numpy as np
import torch

from fp8_quantization_tpu_torch.ops import fp8 as fp8_ops
from fp8_quantization_tpu_torch.ops import uniform as uniform_ops
from fp8_quantization_tpu_torch.ops.rounding import round_ste


class QMethod(str, enum.Enum):
    symmetric_uniform = "symmetric_uniform"
    asymmetric_uniform = "asymmetric_uniform"
    fp_quantizer = "fp_quantizer"


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Static quantizer configuration (the JAX spec)."""

    method: QMethod = QMethod.fp_quantizer
    n_bits: int = 8
    per_channel: bool = False
    scale_domain: str = "linear"         # uniform methods: "linear" | "log"
    grad_scaling: bool = False           # uniform methods: LSQ gradient scale
    eps: float = 1e-8
    mantissa_bits: int = 4
    maxval: float | None = None          # None -> format default maxval
    set_maxval: bool = False
    learn_maxval: bool = False           # QAT: maxval trainable
    learn_mantissa_bits: bool = False    # QAT: mantissa_bits trainable
    mse_include_mantissa_bits: bool = True   # the MSE search's mantissa sweep
    allow_unsigned: bool = False
    # deployment, fixed mode, prepared: quantize by one saturating cast to
    # the IEEE 1-byte format (ops/fp8.fp8_quantize_cast), bit-exact against
    # the exact pipeline; n_bits 8, signed, M in {2, 3, 4}, else exact
    cast_fastpath: bool = False
    # activations (with cast_fastpath): factored outputs stored as the
    # 1-byte array itself; below smallest_normal the IEEE subnormal grid
    store_f8: bool = False
    # activations (with cast_fastpath): the cast is the whole quantizer,
    # store_f8's values in bfloat16 storage
    cast_ieee_subnorm: bool = False
    # QAT gradient estimator of the rounding (ops/rounding.GradientEstimator):
    # "ste" | "stoch_round" | "ewgs" | "stacked_sigmoid"
    grad_estimator: str = "ste"
    ewgs_scaling: float = 0.2
    ss_alpha: float = 1.0

    def replace(self, **kw) -> "QuantizerSpec":
        return dataclasses.replace(self, **kw)

    @property
    def is_fp8(self) -> bool:
        return self.method == QMethod.fp_quantizer


QuantState = Dict[str, torch.Tensor]


def init_state(spec: QuantizerSpec, num_channels: int | None = None,
               device=None) -> QuantState:
    """Initial state; ``num_channels`` is required iff ``spec.per_channel``."""
    if num_channels is None and spec.per_channel:
        raise ValueError("per_channel quantizer needs num_channels at init")
    shape = (num_channels,) if spec.per_channel else ()
    if not spec.is_fp8:
        state = {"delta": torch.ones(shape, dtype=torch.float32, device=device)}
        if spec.method == QMethod.symmetric_uniform:
            state["signed"] = torch.tensor(1, dtype=torch.int32, device=device)
        else:
            state["zero_float"] = torch.zeros(shape, dtype=torch.float32,
                                              device=device)
        state["initialized"] = torch.tensor(False, device=device)
        return state
    maxval0 = spec.maxval if spec.maxval is not None else (
        fp8_ops.default_fp8_maxval(spec.mantissa_bits, spec.n_bits))
    return {
        "maxval": torch.full(shape, maxval0, dtype=torch.float32, device=device),
        "mantissa_bits": torch.tensor(float(spec.mantissa_bits), device=device),
        "sign_bits": torch.tensor(1, dtype=torch.int32, device=device),
        "initialized": torch.tensor(spec.maxval is not None or not spec.set_maxval,
                                    device=device),
    }


def broadcast(param: torch.Tensor, x_ndim: int, channel_axis: int) -> torch.Tensor:
    """Reshape a 1-D per-channel param to broadcast against rank ``x_ndim``."""
    if param.ndim == 0 or x_ndim <= 1:
        return param
    shape = [1] * x_ndim
    shape[channel_axis % x_ndim] = param.shape[0]
    return param.reshape(shape)


def apply(spec: QuantizerSpec, state: QuantState, x: torch.Tensor, *,
          channel_axis: int = -1, discretizer=round_ste) -> torch.Tensor:
    """Fake-quantize ``x`` (quantize -> dequantize)."""
    if not spec.is_fp8:
        delta = broadcast(state["delta"], x.ndim, channel_axis)
        kw = dict(scale_domain=spec.scale_domain, eps=spec.eps,
                  grad_scaling=spec.grad_scaling,
                  per_channel=spec.per_channel, channel_axis=channel_axis,
                  discretizer=discretizer)
        if spec.method == QMethod.symmetric_uniform:
            return uniform_ops.quantize_uniform_symmetric(
                x, delta, state["signed"], spec.n_bits, **kw)
        return uniform_ops.quantize_uniform_asymmetric(
            x, delta, broadcast(state["zero_float"], x.ndim, channel_axis),
            spec.n_bits, **kw)
    return fp8_ops.quantize_to_fp8(
        x, broadcast(state["maxval"], x.ndim, channel_axis),
        state["mantissa_bits"], n_bits=spec.n_bits,
        sign_bits=state["sign_bits"], discretizer=discretizer)


def apply_factored(spec: QuantizerSpec, state: QuantState, x: torch.Tensor, *,
                   channel_axis: int = -1, discretizer=round_ste):
    """``(x_norm, factor)`` with ``fake_quant(x) == x_norm * factor`` and
    ``x_norm`` exact in bfloat16: the engines' decomposition."""
    if not spec.is_fp8:
        delta = broadcast(state["delta"], x.ndim, channel_axis)
        scale = uniform_ops._scale_from_delta(delta, spec.scale_domain, spec.eps)
        if spec.method == QMethod.symmetric_uniform:
            int_min, int_max = uniform_ops.symmetric_int_bounds(
                spec.n_bits, state["signed"])
            return uniform_ops._clip(discretizer(uniform_ops._div(x, scale)),
                                     int_min, int_max), scale
        int_min, int_max = uniform_ops.asymmetric_int_bounds(spec.n_bits)
        zero_float = broadcast(state["zero_float"], x.ndim, channel_axis)
        zp = uniform_ops._clip(torch.round(zero_float), int_min, int_max)
        x_int = uniform_ops._clip(
            discretizer(uniform_ops._div(x, scale)) + zp, int_min, int_max)
        return x_int - zp, scale
    maxval = broadcast(state["maxval"], x.ndim, channel_axis)
    sign_bits_f = state["sign_bits"].to(torch.float32)
    M = fp8_ops._clip_mbits(state["mantissa_bits"], spec.n_bits, sign_bits_f,
                            round_ste)
    x_norm = fp8_ops.quantize_to_fp8(
        x, maxval, state["mantissa_bits"], n_bits=spec.n_bits,
        sign_bits=state["sign_bits"], normalized=True, discretizer=discretizer)
    return x_norm, maxval / (2.0 - 2.0 ** -M)


def fixed_consts(spec: QuantizerSpec, state: QuantState):
    """The scalar algebra of a fixed FP8 quantizer, computed once: a ``(6,
    C)`` float32 tensor (rows ``ops/fp8.FP8_CONST_ROWS``, ``C`` = 1 per
    tensor), with the six ``ops/fp8.CAST_CONST_ROWS`` below (``(12, C)``)
    when the spec opts into the cast path and the state is eligible; None
    for the uniform methods (JAX prepares FP8 only)."""
    if not spec.is_fp8:
        return None
    consts = fp8_ops.fp8_consts(state["maxval"], state["mantissa_bits"],
                                spec.n_bits, state["sign_bits"])
    if spec.cast_fastpath:
        cast = fp8_ops.fp8_cast_consts(state["maxval"], state["mantissa_bits"],
                                       spec.n_bits, state["sign_bits"])
        if cast is not None:
            consts = torch.cat([consts, cast.expand(-1, consts.shape[1])])
    return consts


def uses_cast(spec: QuantizerSpec, consts: torch.Tensor) -> bool:
    """Whether ``apply_prepared`` quantizes by the cast: the spec opts in
    and ``consts`` carry the cast rows."""
    return spec.cast_fastpath and consts.shape[0] == 12


def apply_prepared(spec: QuantizerSpec, consts: torch.Tensor, x: torch.Tensor,
                   *, channel_axis: int = -1, factored: bool = False,
                   cast_mbits=None):
    """Fixed-mode FP8 fake-quant from ``fixed_consts`` output: the values of
    ``apply`` (or, with ``factored``, ``apply_factored``) on the same
    state, with no scalar algebra per call.  The factor of a per-tensor
    quantizer is a scalar, of a per-channel one ``(C,)`` broadcast along
    ``channel_axis``.  Where ``uses_cast``, the cast path
    (``ops/fp8.fp8_quantize_cast``; ``cast_mbits`` spares its host read of
    the format): the same values, but a factored output's norm and factor
    are the exact ones scaled by a power of two, ``store_f8`` stores the
    norm in one byte and ``cast_ieee_subnorm`` rounds to the IEEE grid
    below its smallest normal."""
    assert spec.is_fp8, "the prepared path is FP8 only"
    if uses_cast(spec, consts):
        c = consts[6:]
        kw = dict(channel_axis=channel_axis, ieee_subnorm=spec.cast_ieee_subnorm,
                  mbits=cast_mbits)
        if not factored:
            return fp8_ops.fp8_quantize_cast(x, c, **kw)
        return (fp8_ops.fp8_quantize_cast(x, c, normalized=True,
                                          store_f8=spec.store_f8, **kw),
                _row(c, 0, x.ndim, channel_axis))
    if not factored:
        return fp8_ops.fp8_quantize_prepared(x, consts, channel_axis=channel_axis)
    x_norm = fp8_ops.fp8_quantize_prepared(x, consts, channel_axis=channel_axis,
                                           normalized=True)
    return x_norm, _row(consts, 5, x.ndim, channel_axis)


def _row(consts, i, x_ndim, channel_axis):
    """Row ``i`` of prepared constants: a scalar per tensor, else ``(C,)``
    broadcast along ``channel_axis``."""
    return consts[i, 0] if consts.shape[1] == 1 else broadcast(
        consts[i], x_ndim, channel_axis)


def set_quant_range(spec: QuantizerSpec, state: QuantState, x_min,
                    x_max) -> QuantState:
    """New state with the range set from (x_min, x_max)."""
    new = dict(state)
    if not spec.is_fp8:
        kw = dict(scale_domain=spec.scale_domain, eps=spec.eps)
        if spec.method == QMethod.symmetric_uniform:
            delta, new["signed"] = uniform_ops.symmetric_set_quant_range(
                x_min, x_max, spec.n_bits, **kw)
        else:
            delta, zero_float = uniform_ops.asymmetric_set_quant_range(
                x_min, x_max, spec.n_bits, **kw)
            new["zero_float"] = torch.broadcast_to(
                zero_float, state["zero_float"].shape).clone()
        new["delta"] = torch.broadcast_to(delta, state["delta"].shape).clone()
        new["initialized"] = torch.ones((), dtype=torch.bool, device=delta.device)
        return new
    maxval, sign_bits = fp8_ops.fp8_set_quant_range(
        x_min, x_max, allow_unsigned=spec.allow_unsigned)
    if spec.set_maxval:
        new["maxval"] = torch.broadcast_to(maxval.to(torch.float32),
                                           state["maxval"].shape).clone()
    # signedness updates even when set_maxval is False
    new["sign_bits"] = sign_bits.reshape(())
    new["initialized"] = torch.ones((), dtype=torch.bool, device=maxval.device)
    return new


def trainable_param_names(spec: QuantizerSpec) -> tuple[str, ...]:
    """The state entries that QAT's learn mode trains: ``maxval`` and
    ``mantissa_bits`` as the spec's learn flags say (FP8), ``delta`` and,
    asymmetric, ``zero_float`` (uniform)."""
    if spec.is_fp8:
        return tuple(name for name, learn in (
            ("maxval", spec.learn_maxval),
            ("mantissa_bits", spec.learn_mantissa_bits)) if learn)
    if spec.method == QMethod.symmetric_uniform:
        return ("delta",)
    return ("delta", "zero_float")


def quantizer_grid(spec: QuantizerSpec, state: QuantState) -> np.ndarray:
    """Every value of a per-tensor quantizer's current grid, host side (the
    analytical study's grid and the tests' oracle)."""
    def scalar(v):
        return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)

    if spec.is_fp8:
        sign_bits = int(scalar(state["sign_bits"]))
        mbits = int(np.clip(int(np.round(scalar(state["mantissa_bits"]))), 1,
                            spec.n_bits - sign_bits))
        ebits = spec.n_bits - sign_bits - mbits
        maxval = float(scalar(state["maxval"]).reshape(-1)[0])
        return fp8_ops.generate_all_float_values_scaled(
            spec.n_bits, ebits, 2 ** (ebits - 1), maxval)
    delta = float(scalar(state["delta"]).reshape(-1)[0])
    if spec.method == QMethod.symmetric_uniform:
        return uniform_ops.symmetric_grid(delta, bool(scalar(state["signed"])),
                                          spec.n_bits, spec.scale_domain)
    zf = float(scalar(state["zero_float"]).reshape(-1)[0])
    int_min, int_max = 0.0, 2.0 ** spec.n_bits - 1.0
    zp = np.clip(np.round(zf), int_min, int_max)
    scale = np.exp(delta) if spec.scale_domain == "log" else max(delta, spec.eps)
    return scale * (np.arange(int_min, int_max + 1) - zp)
