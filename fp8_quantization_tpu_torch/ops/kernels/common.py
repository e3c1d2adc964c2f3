"""Helpers shared by the kernel wrappers (no JAX counterpart)."""

from __future__ import annotations

import contextlib

import torch

from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts, fp8_quantize_prepared
from fp8_quantization_tpu_torch.ops.quantizer import QMethod, QuantizerSpec
from fp8_quantization_tpu_torch.ops.uniform import (
    _scale_from_delta, int_asym_consts, int_quantize_prepared)

ACTIVATION_CODES = {None: 0, "relu": 1, "relu6": 2}   # csrc/fq_epilogue.cuh
SMEM_LIMIT = 232448      # shared memory a block can have on the H100
SMS = 132                # its streaming multiprocessors
# quantizer codes of the kernels (csrc/fq_epilogue.cuh, enum QuantMethod)
QUANT_CODES = {"none": 0, "fp8": 1, "int_asym": 2, "int_sym": 3}


def check_methods(act_method: str, activation, weight_method: str = "none"):
    """The methods of the Pallas bodies: weights "fp8" | "int_sym" | "none"
    (baked), activations "fp8" | "int_asym" | "none"."""
    if weight_method not in ("fp8", "int_sym", "none"):
        raise ValueError(f"weight_method must be 'fp8', 'int_sym' or 'none', "
                         f"not {weight_method!r}")
    if act_method not in ("fp8", "int_asym", "none"):
        raise ValueError(f"act_method must be 'fp8', 'int_asym' or 'none', "
                         f"not {act_method!r}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"fused kernels take activation None, 'relu' or "
                         f"'relu6', not {activation!r}")


def pack_act_consts(spec: QuantizerSpec, state: dict):
    """(method, (6, 1) constants) of a fixed per-tensor activation quantizer
    for the kernels, the counterpart of JAX ``_pack_act_scalars``
    (nn/layers.py:46-62): "fp8" with maxval floored at 1e-30 as the Pallas
    wrappers do, or "int_asym" with the scale from ``_scale_from_delta``
    and the zero point."""
    if spec.is_fp8:
        return "fp8", fp8_consts(torch.clamp(state["maxval"], min=1e-30),
                                 state["mantissa_bits"], spec.n_bits,
                                 state["sign_bits"])
    if spec.method == QMethod.asymmetric_uniform:
        scale = _scale_from_delta(state["delta"].reshape(()),
                                  spec.scale_domain, spec.eps)
        return "int_asym", int_asym_consts(scale, state["zero_float"],
                                           spec.n_bits)
    raise ValueError(f"the kernels quantize activations with fp8 or "
                     f"asymmetric_uniform, not {spec.method.value}")


def quantize_prepared(x: torch.Tensor, method: str, consts, *,
                      channel_axis: int = -1,
                      normalized: bool = False) -> torch.Tensor:
    """The plain version of the kernels' ``quantize``: ``x`` fake-quantized
    by the (6, C) ``consts`` of ``method`` ("none": ``x`` itself)."""
    if method == "fp8":
        return fp8_quantize_prepared(x, consts, channel_axis=channel_axis,
                                     normalized=normalized)
    if method in ("int_asym", "int_sym"):
        return int_quantize_prepared(x, consts, channel_axis=channel_axis,
                                     normalized=normalized)
    return x


@contextlib.contextmanager
def no_tf32():
    """Full-precision float32 products for the plain versions on the card
    (cuDNN convolutions default to TF32); restores the flags after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the operands lie on the card (launch the kernel), False
    when they lie on the CPU (take the plain version); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel operands must all lie on one CUDA device or "
                     f"all on the CPU, got {sorted(str(t.device) for t in tensors)}")


def require(t: torch.Tensor, name: str, dtypes, shape=None,
            vector_loads: bool = False) -> None:
    """Raise unless ``t`` is contiguous, of one of ``dtypes`` and ``shape``;
    with ``vector_loads`` (a kernel reads it 16 bytes at a time) its data
    must also start on a 16-byte boundary."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if vector_loads and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def consts_or_dummy(c, like: torch.Tensor) -> torch.Tensor:
    """A (6, C) quantizer constant tensor, or a zero (6, 1) one when
    unused."""
    if c is None:
        return torch.zeros((6, 1), dtype=torch.float32, device=like.device)
    return c


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
