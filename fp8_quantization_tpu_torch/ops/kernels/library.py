"""The eight hand-written kernels as torch ops (``fp8tpu::<name>``).

The counterpart of "the Pallas kernel is part of the traced program" in
the JAX package: where ``jax.export`` serializes a Pallas kernel inside
the StableHLO artifact, ``torch.export`` records a call of one of these
ops, and a program loaded with ``torch.export.load`` runs it once this
module is imported (serving/export.py).  The names are the ``WRAPPERS``
keys of ``ops/kernels/__init__.py``.

Each op has

* a CUDA implementation: the kernel's launch (``<kernel>_cuda`` in its
  module: the operand checks, the bf16 copy conversions, the launch and
  ``build.check``), which raises when the build or the launch fails and
  counts the launch on its wrapper (``fn.launches``), so a forward run from
  an exported program counts as a live one does;
* a CPU implementation: the kernel's plain version, looked up on its
  module at each call.  The device of the operands picks it; it never
  stands in for a failed launch;
* a fake (``register_fake``): the output's shape and dtype from the
  inputs' shapes, symbolic batch sizes included.

The wrappers' config dataclasses are flattened into ints, bools, floats
and strs (``qblock``'s four stage methods joined by commas); optional
tensors are ``Tensor?``.  The ops take no gradient: they run only in fixed
mode.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.library import custom_op

from fp8_quantization_tpu_torch.ops.kernels import (
    attention, qblock, qconv, qconv_int8, qdwconv, qmatmul, qmatmul_int8,
    qstem)

NAMESPACE = "fp8tpu"


def _op(name: str, cpu, cuda):
    """Register ``fp8tpu::<name>`` from the Python signature of ``cpu``,
    with ``cuda`` as its CUDA implementation."""
    op = custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=(),
                   device_types="cpu")
    op.register_kernel("cuda")(cuda)
    return op


def _out_dtype(emit_norm: bool) -> torch.dtype:
    return torch.bfloat16 if emit_norm else torch.float32


# ---- qmatmul ------------------------------------------------------------------

def _qmatmul_cfg(weight_method, act_method, quantize_input, activation,
                 emit_norm):
    return qmatmul.FusedQuantMatmulConfig(
        weight_method=weight_method, act_method=act_method,
        quantize_input=quantize_input, activation=activation,
        emit_norm=emit_norm)


def _qmatmul_cpu(x: torch.Tensor, w: torch.Tensor,
                 w_consts: Optional[torch.Tensor],
                 a_consts: Optional[torch.Tensor], scale: torch.Tensor,
                 shift: torch.Tensor, weight_method: str, act_method: str,
                 quantize_input: bool, activation: Optional[str],
                 emit_norm: bool) -> torch.Tensor:
    return qmatmul.qmatmul_plain(
        x, w, w_consts, a_consts, scale, shift,
        _qmatmul_cfg(weight_method, act_method, quantize_input, activation,
                     emit_norm)).contiguous()


def _qmatmul_cuda(x, w, w_consts, a_consts, scale, shift, weight_method,
                  act_method, quantize_input, activation, emit_norm):
    return qmatmul.qmatmul_cuda(
        x, w, w_consts, a_consts, scale, shift,
        _qmatmul_cfg(weight_method, act_method, quantize_input, activation,
                     emit_norm))


qmatmul_op = _op("qmatmul", _qmatmul_cpu, _qmatmul_cuda)


@qmatmul_op.register_fake
def _(x, w, w_consts, a_consts, scale, shift, weight_method, act_method,
      quantize_input, activation, emit_norm):
    return x.new_empty((x.shape[0], w.shape[0]), dtype=_out_dtype(emit_norm))


# ---- qconv3x3 -----------------------------------------------------------------

def _qconv_cfg(residual, act_method, activation, emit_norm, stride):
    return qconv.FusedConvConfig(act_method=act_method, activation=activation,
                                 residual=residual is not None,
                                 emit_norm=emit_norm, stride=stride)


def _qconv_cpu(x: torch.Tensor, w: torch.Tensor,
               a_consts: Optional[torch.Tensor], scale: torch.Tensor,
               shift: torch.Tensor, residual: Optional[torch.Tensor],
               act_method: str, activation: Optional[str], emit_norm: bool,
               stride: int) -> torch.Tensor:
    return qconv.qconv3x3_plain(
        x, w, a_consts, scale, shift, residual,
        _qconv_cfg(residual, act_method, activation, emit_norm, stride))


def _qconv_cuda(x, w, a_consts, scale, shift, residual, act_method,
                activation, emit_norm, stride):
    return qconv.qconv3x3_cuda(
        x, w, a_consts, scale, shift, residual,
        _qconv_cfg(residual, act_method, activation, emit_norm, stride))


qconv3x3_op = _op("qconv3x3", _qconv_cpu, _qconv_cuda)


@qconv3x3_op.register_fake
def _(x, w, a_consts, scale, shift, residual, act_method, activation,
      emit_norm, stride):
    ho, wo = qconv.out_hw(x.shape[1], x.shape[2], stride)
    return x.new_empty((x.shape[0], ho, wo, w.shape[0]),
                       dtype=_out_dtype(emit_norm))


# ---- qstem --------------------------------------------------------------------

def _qstem_cpu(x: torch.Tensor, w: torch.Tensor,
               a_consts: Optional[torch.Tensor], scale: torch.Tensor,
               shift: torch.Tensor, act_method: str,
               emit_norm: bool) -> torch.Tensor:
    return qstem.qstem_plain(x, w, a_consts, scale, shift,
                             qstem.FusedStemConfig(act_method, emit_norm))


def _qstem_cuda(x, w, a_consts, scale, shift, act_method, emit_norm):
    return qstem.qstem_cuda(x, w, a_consts, scale, shift,
                            qstem.FusedStemConfig(act_method, emit_norm))


qstem_op = _op("qstem", _qstem_cpu, _qstem_cuda)


@qstem_op.register_fake
def _(x, w, a_consts, scale, shift, act_method, emit_norm):
    p = qstem.stem_out_size(x.shape[1])
    return x.new_empty((x.shape[0], p, p, w.shape[1]),
                       dtype=_out_dtype(emit_norm))


# ---- qmatmul_int8 -------------------------------------------------------------
# ``x`` is float32 or, for the s8 input branch, int8 (the schema's Tensor
# takes either; the implementations read its dtype, the fake needs none)

def _qmatmul_int8_cpu(x: torch.Tensor, w: torch.Tensor,
                      w_delta: torch.Tensor, w_scalars: torch.Tensor,
                      a_scalars: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, activation: Optional[str],
                      n_bits: int, act_n_bits: int) -> torch.Tensor:
    return qmatmul_int8.qmatmul_int8_plain(
        x, w, w_delta, w_scalars, a_scalars, scale, shift,
        qmatmul_int8.Int8MatmulConfig(activation, n_bits,
                                      act_n_bits)).contiguous()


def _qmatmul_int8_cuda(x, w, w_delta, w_scalars, a_scalars, scale, shift,
                       activation, n_bits, act_n_bits):
    return qmatmul_int8.qmatmul_int8_cuda(
        x, w, w_delta, w_scalars, a_scalars, scale, shift,
        qmatmul_int8.Int8MatmulConfig(activation, n_bits, act_n_bits))


qmatmul_int8_op = _op("qmatmul_int8", _qmatmul_int8_cpu, _qmatmul_int8_cuda)


@qmatmul_int8_op.register_fake
def _(x, w, w_delta, w_scalars, a_scalars, scale, shift, activation, n_bits,
      act_n_bits):
    return x.new_empty((x.shape[0], w.shape[0]), dtype=torch.float32)


# ---- qconv3x3_int8 ------------------------------------------------------------

def _qconv_int8_cfg(activation, n_bits, act_n_bits, stride):
    return qconv_int8.Int8ConvConfig(stride=stride, activation=activation,
                                     n_bits=n_bits, act_n_bits=act_n_bits)


def _qconv_int8_cpu(x: torch.Tensor, w: torch.Tensor, w_delta: torch.Tensor,
                    w_scalars: torch.Tensor, a_scalars: torch.Tensor,
                    scale: torch.Tensor, shift: torch.Tensor,
                    activation: Optional[str], n_bits: int, act_n_bits: int,
                    stride: int) -> torch.Tensor:
    return qconv_int8.qconv3x3_int8_plain(
        x, w, w_delta, w_scalars, a_scalars, scale, shift,
        _qconv_int8_cfg(activation, n_bits, act_n_bits, stride))


def _qconv_int8_cuda(x, w, w_delta, w_scalars, a_scalars, scale, shift,
                     activation, n_bits, act_n_bits, stride):
    return qconv_int8.qconv3x3_int8_cuda(
        x, w, w_delta, w_scalars, a_scalars, scale, shift,
        _qconv_int8_cfg(activation, n_bits, act_n_bits, stride))


qconv3x3_int8_op = _op("qconv3x3_int8", _qconv_int8_cpu, _qconv_int8_cuda)


@qconv3x3_int8_op.register_fake
def _(x, w, w_delta, w_scalars, a_scalars, scale, shift, activation, n_bits,
      act_n_bits, stride):
    ho, wo = qconv.out_hw(x.shape[1], x.shape[2], stride)
    return x.new_empty((x.shape[0], ho, wo, w.shape[0]), dtype=torch.float32)


# ---- qdwconv3x3 ---------------------------------------------------------------

def _qdwconv_cfg(act_method, activation, emit_norm, stride):
    return qdwconv.DwConvConfig(act_method=act_method, activation=activation,
                                emit_norm=emit_norm, stride=stride)


def _qdwconv_cpu(x: torch.Tensor, w: torch.Tensor,
                 a_consts: Optional[torch.Tensor], scale: torch.Tensor,
                 shift: torch.Tensor, act_method: str,
                 activation: Optional[str], emit_norm: bool,
                 stride: int) -> torch.Tensor:
    return qdwconv.qdwconv3x3_plain(
        x, w, a_consts, scale, shift,
        _qdwconv_cfg(act_method, activation, emit_norm, stride))


def _qdwconv_cuda(x, w, a_consts, scale, shift, act_method, activation,
                  emit_norm, stride):
    return qdwconv.qdwconv3x3_cuda(
        x, w, a_consts, scale, shift,
        _qdwconv_cfg(act_method, activation, emit_norm, stride))


qdwconv3x3_op = _op("qdwconv3x3", _qdwconv_cpu, _qdwconv_cuda)


@qdwconv3x3_op.register_fake
def _(x, w, a_consts, scale, shift, act_method, activation, emit_norm,
      stride):
    ho, wo = qdwconv.out_hw(x.shape[1], x.shape[2], stride)
    return x.new_empty((x.shape[0], ho, wo, x.shape[3]),
                       dtype=_out_dtype(emit_norm))


# ---- qblock -------------------------------------------------------------------

def _qblock_cfg(expand, stride, use_res, emit_norm, methods):
    return qblock.FusedBlockConfig(expand=expand, stride=stride,
                                   use_res=use_res, emit_norm=emit_norm,
                                   methods=tuple(methods.split(",")))


def _qblock_cpu(x: torch.Tensor, w1: Optional[torch.Tensor],
                wd: torch.Tensor, w2: torch.Tensor, a_consts: torch.Tensor,
                scale1: Optional[torch.Tensor],
                shift1: Optional[torch.Tensor], scale_d: torch.Tensor,
                shift_d: torch.Tensor, scale2: torch.Tensor,
                shift2: torch.Tensor, x_factor: torch.Tensor, expand: bool,
                stride: int, use_res: bool, emit_norm: bool,
                methods: str) -> torch.Tensor:
    return qblock.qblock_plain(
        x, w1, wd, w2, a_consts, scale1, shift1, scale_d, shift_d, scale2,
        shift2, x_factor, _qblock_cfg(expand, stride, use_res, emit_norm,
                                      methods))


def _qblock_cuda(x, w1, wd, w2, a_consts, scale1, shift1, scale_d, shift_d,
                 scale2, shift2, x_factor, expand, stride, use_res, emit_norm,
                 methods):
    return qblock.qblock_cuda(
        x, w1, wd, w2, a_consts, scale1, shift1, scale_d, shift_d, scale2,
        shift2, x_factor, _qblock_cfg(expand, stride, use_res, emit_norm,
                                      methods))


qblock_op = _op("qblock", _qblock_cpu, _qblock_cuda)


@qblock_op.register_fake
def _(x, w1, wd, w2, a_consts, scale1, shift1, scale_d, shift_d, scale2,
      shift2, x_factor, expand, stride, use_res, emit_norm, methods):
    cfg = _qblock_cfg(expand, stride, use_res, emit_norm, methods)
    ho, wo = qdwconv.out_hw(x.shape[1], x.shape[2], stride)
    return x.new_empty((x.shape[0], ho, wo, w2.shape[-1]),
                       dtype=_out_dtype(cfg.out_bf16))


# ---- flash_mha ----------------------------------------------------------------

def _flash_mha_cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float) -> torch.Tensor:
    """(B, S, H, D) float32, the layout the CUDA kernel writes."""
    return attention.flash_mha_plain(q, k, v, sm_scale=sm_scale).permute(
        0, 2, 1, 3).contiguous()


def _flash_mha_cuda(q, k, v, sm_scale):
    return attention.flash_mha_cuda(q, k, v, sm_scale=sm_scale)


flash_mha_op = _op("flash_mha", _flash_mha_cpu, _flash_mha_cuda)


@flash_mha_op.register_fake
def _(q, k, v, sm_scale):
    b, h, s, d = q.shape
    return q.new_empty((b, s, h, d), dtype=torch.float32)


OPS = {"qstem": qstem_op, "qconv3x3": qconv3x3_op, "qmatmul": qmatmul_op,
       "qconv3x3_int8": qconv3x3_int8_op, "qmatmul_int8": qmatmul_int8_op,
       "qdwconv3x3": qdwconv3x3_op, "qblock": qblock_op,
       "flash_mha": flash_mha_op}
