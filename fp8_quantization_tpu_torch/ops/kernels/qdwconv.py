"""Fused depthwise 3x3 SAME conv: ``y = out_quant(act(dwconv3x3(x, w)*scale
+ shift))``.

Mirrors ``fused_quant_dwconv3x3`` of ``fp8_quantization_tpu/ops/pallas/
qconv.py`` (Pallas body ``_qdwconv3x3_kernel``, line 183; ``pallas_call`` at
line 251).  The kernel is ``csrc/qdwconv.cu``: one thread per output pixel
and vector of 8 channels, the nine taps summed in float32 in (dy, dx)
row-major order, SAME padding as a bounds mask (an out-of-image tap reads
0) and stride 2 as index arithmetic (no phase split).  It is bound by bytes
(about 18 operations for every 4 bytes it moves, see the note in the
source).

Semantics carried over: ``act_method`` (FP8 or int_asym), ``activation``
and ``emit_norm``.
The input is a factored bf16 norm (or a bf16 value); the weights are the
baked normalized taps as a ``(3, 3, C)`` float32 tensor (bf16-exact
values, ``weight_taps``).  Every tap product of a bf16 input and a
bf16-exact weight is exact in float32, so the plain version, which sums the
same products in the same order, gives the kernel's bits.  The TPU knobs
(``imgs_per_block``, the phase split, the VMEM limit) do not carry over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from fp8_quantization_tpu_torch.nn.activations import get_activation
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    ACTIVATION_CODES, QUANT_CODES, check_methods, consts_or_dummy, on_card,
    quantize_prepared, require, stream_ptr)

REPLACES = "fp8_quantization_tpu/ops/pallas/qconv.py:183"


@dataclasses.dataclass(frozen=True)
class DwConvConfig:
    act_method: str = "none"            # output quantizer: "fp8" |
                                        # "int_asym" | "none"
    activation: Optional[str] = None    # None | "relu" | "relu6"
    emit_norm: bool = False             # store the normalized bf16 value
    stride: int = 1                     # 1 or 2

    def __post_init__(self):
        check_methods(self.act_method, self.activation)
        if self.stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {self.stride}")
        if self.emit_norm and self.act_method == "none":
            raise ValueError("emit_norm needs an output quantizer")


def weight_taps(w_oihw: torch.Tensor) -> torch.Tensor:
    """(C, 1, 3, 3) depthwise weights -> the kernel's (3, 3, C) float32
    taps."""
    c = w_oihw.shape[0]
    return (w_oihw.reshape(c, 3, 3).permute(1, 2, 0)
            .to(torch.float32).contiguous())


def out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def dw_taps_sum(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """sum over (dy, dx) in row-major order of ``x[s*i+dy-1, s*j+dx-1] *
    w[dy, dx]`` for float32 NHWC ``x`` (zero outside the image) and (3, 3, C)
    ``w``; the products are added one by one, as the kernels add them."""
    n, h, wd, _ = x.shape
    ho, wo = out_hw(h, wd, stride)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (wo - 1) + 1:stride, :]
            term = tap * w[dy, dx]
            acc = term if acc is None else acc + term
    return acc


def qdwconv3x3_plain(x: torch.Tensor, w: torch.Tensor, a_consts,
                     scale: torch.Tensor, shift: torch.Tensor,
                     cfg: DwConvConfig) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (CPU tests, card reference):
    bit-exact against the kernel."""
    y = dw_taps_sum(x.to(torch.bfloat16).to(torch.float32),
                    w.to(torch.float32), cfg.stride)
    y = y * scale + shift
    act = get_activation(cfg.activation)
    if act is not None:
        y = act(y)
    y = quantize_prepared(y, cfg.act_method, a_consts, normalized=cfg.emit_norm)
    return y.to(torch.bfloat16 if cfg.emit_norm else torch.float32).contiguous()


def fused_quant_dwconv3x3(x: torch.Tensor, w: torch.Tensor,
                          a_consts: Optional[torch.Tensor],
                          scale: torch.Tensor, shift: torch.Tensor, *,
                          cfg: DwConvConfig) -> torch.Tensor:
    """y (N, Ho, Wo, C) for x (N, H, W, C) bf16 and the ``weight_taps`` w
    (3, 3, C) float32; ``a_consts`` (6, 1) for the output quant,
    ``scale``/``shift`` (C,) float32.  CPU tensors take
    ``qdwconv3x3_plain``; CUDA tensors launch the kernel."""
    n, h, wd, c = x.shape
    if w.shape != (3, 3, c):
        raise ValueError(f"w must be (3, 3, C) = (3, 3, {c}), got "
                         f"{tuple(w.shape)}")
    extra = [t for t in (a_consts,) if t is not None]
    if not on_card(x, w, scale, shift, *extra):
        return qdwconv3x3_plain(x, w, a_consts, scale, shift, cfg)
    aq = cfg.act_method != "none"
    if aq and a_consts is None:
        raise ValueError(f"act_method={cfg.act_method!r} needs a_consts")
    a_consts = consts_or_dummy(a_consts if aq else None, x)
    require(x, "x", (torch.bfloat16,), vector_loads=True)
    require(w, "w", (torch.float32,), (3, 3, c))
    require(a_consts, "a_consts", (torch.float32,), (6, 1))
    require(scale, "scale", (torch.float32,), (c,))
    require(shift, "shift", (torch.float32,), (c,))
    ho, wo = out_hw(h, wd, cfg.stride)
    out = torch.empty((n, ho, wo, c), device=x.device,
                      dtype=torch.bfloat16 if cfg.emit_norm else torch.float32)
    err = build.entry("qdwconv")(
        x.data_ptr(), w.data_ptr(), a_consts.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), n, h, wd, c, cfg.stride,
        QUANT_CODES[cfg.act_method],
        ACTIVATION_CODES[cfg.activation], int(cfg.emit_norm), stream_ptr(x))
    build.check(err, "qdwconv3x3")
    fused_quant_dwconv3x3.launches += 1
    return out


fused_quant_dwconv3x3.launches = 0
