"""The s8 x s8 -> s32 convolution and matmul as torch functions.

Mirrors ``fp8_quantization_tpu/ops/int8.py`` (``prequant_s8``,
``int8_conv`` with ``groups`` (JAX ``feature_group_count``: 1 or pure
depthwise), ``int8_matmul`` with ``x_prequant`` and ``emit_s8``, lines
41-227, with ``out_bf16`` and ``signed_static``), and
``int8_shifted_grid`` of ``ops/pallas/qmatmul.py`` (lines 123-134).  The
JAX package runs these through XLA on its 'parity' and 'bf16' engines; here
they are the CPU reference and, under 'fused', the route of the stems, the
depthwise convs and the matmuls that emit s8 (the ViT's gelu mlp1).

``prequant_s8`` is the producer side of the s8 interchange
(nn/factored.PrequantS8): the consumer's quant prologue, run where the
value is made, so the consumer reads its recentred int8 operand.

Recentred identity (the activation grid is xint in [0, 2^a - 1], the weight
grid wint, signed or unsigned)::

    sum (xint - zp) * wint  ==  dot(xs, wsg)            xs  = xint - 128
                              + S_w * rowsum(xs)        wsg = wint - S_w
                              + (128 - zp) * colsum(wsg)
                              + K * (128 - zp) * S_w     S_w = 128 * (1 - signed)

with SAME padding holding xs = zp - 128, the real zero.  The integer sums
are exact: in float32 with TF32 off where every partial sum stays below
2^24 (K * 2^14 < 2^24) and, for a convolution, the stride is above 1 (then
cuDNN has no Winograd or FFT algorithm for it, which would not be exact);
in float64 elsewhere.  The float32 epilogue then follows the JAX order
(there lines 149-158 and 206-220), so the results equal JAX's.

``out_bf16`` (config ``conv_out_bf16``) returns the result as a bfloat16
tensor, as JAX does; its consumers promote it to float32 where JAX's
would (nn/quantizers.py).  ``signed_static`` (config
``int8_assume_signed``, checked by nn/bake.bake_int8_weights) drops the
``S_w`` terms, zero for a signed grid.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def act_int_params(a_delta: torch.Tensor, a_zero: torch.Tensor, a_bits: int):
    """(delta, zp) of the asymmetric activation grid."""
    delta = torch.clamp(a_delta, min=1e-8)
    zp = torch.clamp(torch.round(a_zero), 0.0, 2.0 ** a_bits - 1.0)
    return delta, zp


def quantize_act(x: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor,
                 a_bits: int) -> torch.Tensor:
    """xs = clip(round(x/delta) + zp, 0, 2^a - 1) - 128, float32 integers."""
    xint = torch.clamp(torch.round(x.to(torch.float32) / delta) + zp,
                       0.0, 2.0 ** a_bits - 1.0)
    return xint - 128.0


def prequant_s8(x: torch.Tensor, a_delta: torch.Tensor, a_zero: torch.Tensor,
                a_bits: int) -> torch.Tensor:
    """x on the recentred s8 grid of an asymmetric input quantizer (JAX
    ``prequant_s8``): the prologue of ``int8_matmul`` / ``int8_conv``,
    elementwise the same, as an int8 tensor."""
    delta, zp = act_int_params(a_delta, a_zero, a_bits)
    return quantize_act(x, delta, zp, a_bits).to(torch.int8)


def int8_shifted_grid(w: torch.Tensor, delta: torch.Tensor,
                      signed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Weights on the recentred integer grid, float32: wsg = wint - S_w.
    ``delta`` broadcasts against ``w``; ``signed`` is a 0/1 float scalar.
    The int8 kernels' in-kernel quant, their plain versions and the bake
    (nn/bake.bake_int8_weights) all take this grid."""
    delta = torch.clamp(delta, min=1e-8)
    s_w = 128.0 * (1.0 - signed)
    int_min = torch.where(signed > 0, -(2.0 ** (n_bits - 1)), 0.0)
    int_max = 2.0 ** (n_bits - signed) - 1.0
    q = torch.minimum(torch.maximum(torch.round(w / delta), int_min), int_max)
    return q - s_w


def _exact_dtype(k: int, strided: bool = True) -> torch.dtype:
    return torch.float32 if k * 2 ** 14 < 2 ** 24 and strided else torch.float64


def _epilogue(y, delta_x, w_delta, scale, shift, act_fn, out_bf16):
    y = y * (delta_x * torch.clamp(w_delta, min=1e-8))
    if scale is not None:
        y = y * scale
    if shift is not None:
        y = y + shift
    if act_fn is not None:
        y = act_fn(y)
    return y.to(torch.bfloat16) if out_bf16 else y


def int8_conv(x: torch.Tensor, wsg: torch.Tensor, w_delta: torch.Tensor,
              signed: torch.Tensor, a_delta: torch.Tensor, a_zero: torch.Tensor,
              a_bits: int, stride: int = 1, padding: int = 1,
              scale: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              act_fn: Optional[Callable] = None, out_bf16: bool = False,
              signed_static: bool = False, groups: int = 1) -> torch.Tensor:
    """Convolution equal to the fake-quant chain.

    x: (N, H, W, Cin) float32.  wsg: (Cout, Cin/groups, kh, kw) int8 on the
    recentred grid; ``groups`` 1 or Cin == Cout (depthwise: the row sum and
    the K term are taken per group, K = kh*kw).  w_delta: (Cout,) weight step; signed: 0/1 float scalar;
    a_delta / a_zero: the asymmetric activation quantizer's step and zero;
    scale / shift: the folded BN or bias, ``y*scale + shift``; act_fn last.
    Returns float32 (N, Ho, Wo, Cout), bfloat16 under ``out_bf16``."""
    cout, cin_g, kh, kw = wsg.shape
    cin = x.shape[-1]
    if groups != 1 and not groups == cin == cout:
        raise ValueError(f"int8_conv takes groups 1 or Cin == Cout (depthwise), "
                         f"not {groups} for {cin} -> {cout}")
    delta_x, zp = act_int_params(a_delta, a_zero, a_bits)
    xs = quantize_act(x, delta_x, zp, a_bits).permute(0, 3, 1, 2)
    pad0 = zp - 128.0
    # pad with the real zero: shift it to 0, pad with zeros, shift back
    xs = F.pad(xs - pad0, (padding,) * 4) + pad0
    k_taps = kh * kw * cin_g
    dt = _exact_dtype(k_taps, strided=stride > 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        acc = F.conv2d(xs.to(dt), wsg.to(dt), stride=stride, groups=groups)
    acc = acc.to(torch.float32).permute(0, 2, 3, 1)
    colsum = wsg.to(torch.int32).sum(dim=(1, 2, 3)).to(torch.float32)
    if signed_static:
        y = acc + (128.0 - zp) * colsum
    else:
        # the window sum of xs over each group's input channels: all of
        # them (groups 1), or the channel itself (depthwise)
        xg = xs if groups != 1 else xs.sum(dim=1, keepdim=True)
        ones = torch.ones((xg.shape[1], 1, kh, kw), dtype=dt, device=x.device)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            rows = F.conv2d(xg.to(dt), ones, stride=stride, groups=xg.shape[1])
        rows = rows.to(torch.float32).permute(0, 2, 3, 1)
        s_w = 128.0 * (1.0 - signed)
        y = (acc + s_w * rows + (128.0 - zp) * colsum
             + float(k_taps) * (128.0 - zp) * s_w)
    return _epilogue(y, delta_x, w_delta, scale, shift, act_fn,
                     out_bf16).contiguous()


def int8_matmul(x2d: torch.Tensor, wsg: torch.Tensor, w_delta: torch.Tensor,
                signed: torch.Tensor, a_delta: torch.Tensor,
                a_zero: torch.Tensor, a_bits: int,
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None,
                act_fn: Optional[Callable] = None, out_bf16: bool = False,
                signed_static: bool = False, x_prequant: bool = False,
                emit_s8: Optional[Tuple] = None) -> torch.Tensor:
    """(M, K) x (K, N) on the recentred grid; ``wsg`` is (N, K) int8 (torch's
    Linear layout).  Arguments otherwise as ``int8_conv``; returns float32
    (M, N), bfloat16 under ``out_bf16``.

    ``x_prequant``: ``x2d`` is already the recentred int8 operand (from
    ``prequant_s8``); ``a_delta`` / ``a_zero`` still drive the epilogue.
    ``emit_s8``: (delta, zero, bits) of the next consumer's input
    quantizer: the result, after ``act_fn``, is returned on that grid as
    int8 (``prequant_s8``), which overrides ``out_bf16``."""
    k = x2d.shape[-1]
    delta_x, zp = act_int_params(a_delta, a_zero, a_bits)
    if x_prequant:
        if x2d.dtype != torch.int8:
            raise ValueError(f"x_prequant needs an int8 x, not {x2d.dtype}")
        xs = x2d.to(torch.float32)
    else:
        xs = quantize_act(x2d, delta_x, zp, a_bits)
    dt = _exact_dtype(k)
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    with no_tf32():
        acc = xs.to(dt) @ wsg.to(dt).t()
    colsum = wsg.to(torch.int32).sum(dim=1).to(torch.float32)
    y = acc.to(torch.float32) + (128.0 - zp) * colsum
    if not signed_static:
        s_w = 128.0 * (1.0 - signed)
        rowsum = s_w * xs.to(torch.int32).sum(dim=-1).to(torch.float32)
        y = y + rowsum[:, None] + k * (128.0 - zp) * s_w
    if emit_s8 is not None:
        y = _epilogue(y, delta_x, w_delta, scale, shift, act_fn, False)
        return prequant_s8(y, *emit_s8)
    return _epilogue(y, delta_x, w_delta, scale, shift, act_fn, out_bf16)
