"""Fused quant-matmul: ``y = epilogue(q(x) @ q(w)^T)``.

Mirrors ``fused_quant_matmul`` of ``fp8_quantization_tpu/ops/pallas/
qmatmul.py`` (Pallas body ``_qmatmul_kernel``, line 145; ``pallas_call`` at
line 389).  The kernel is ``csrc/qmatmul.cu``.

Semantics carried over: ``weight_method`` ("fp8" or "int_sym": w is raw
float32 and is quantized per output channel in the kernel, int_sym on the
calibrated signed or unsigned grid; "none": w is already on the normalized
grid), ``act_method`` ("fp8" | "int_asym" | "none"), ``quantize_input``
(the act quantizer quantizes x while it is staged; else it quantizes the
output), ``activation`` and ``emit_norm``.  Operands enter the product as
bf16 on the normalized grid with fp32 sums; the epilogue multiplies the
in-kernel weight factor and the input's factor back in, then ``y*scale +
shift``, relu/relu6 and the optional output quant.  The TPU tiling knobs
(block sizes, VMEM limit) do not carry over; ``mxu_dtype="float32"`` (a
parity debugging mode) is not ported, and the int8 body is
``ops/kernels/qmatmul_int8``.

Differences from the JAX signature: ``w`` is ``(N, K)`` (torch's Linear
layout, which the kernel reads as wgmma's K-major B operand) and the
quantizers arrive as ``(6, C)`` constants from ``ops/fp8.fp8_consts`` or
``ops/uniform.int_asym_consts`` / ``int_sym_consts``.

On the card the kernel is bound by the products at the ViT's shapes and
by bytes and launch latency at ResNet-18's and MobileNetV2's (see the note
in csrc/qmatmul.cu).  Its block tile is 128 rows by ``tile_n(N)`` columns.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    ACTIVATION_CODES, QUANT_CODES, check_methods, consts_or_dummy, on_card,
    quantize_prepared, require, stream_ptr)
from fp8_quantization_tpu_torch.nn.activations import get_activation
from fp8_quantization_tpu_torch.utils.timing import span

REPLACES = "fp8_quantization_tpu/ops/pallas/qmatmul.py:145"
TILE_M = 128                       # csrc/gemm_sm90.cuh: BM
TILE_NS = (64, 32, 16)             # the wgmma widths the kernel is built for
# a column tile costs its width plus this many columns' worth of re-reading
# the A rows (every column tile reads all of x's tile rows again)
TILE_READ_COST = 32


@functools.lru_cache(maxsize=None)
def tile_n(n: int) -> int:
    """The kernel's column tile for N output channels: the width in
    ``TILE_NS`` with the least ``ceil(N / BN) * (BN + TILE_READ_COST)``,
    the wider on a tie, so that a small N keeps a full tile (16 -> 16,
    24 -> 32, 144 -> 64) and a large one reads x few times.  No tile is
    wider than 64: the epilogue's per-output quantization costs more than
    the products (csrc/qmatmul.cu), and a narrow tile keeps each block's
    share of it short, so more blocks overlap it with their products."""
    return min(TILE_NS, key=lambda bn: (-(-n // bn) * (bn + TILE_READ_COST), -bn))


@dataclasses.dataclass(frozen=True)
class FusedQuantMatmulConfig:
    weight_method: str = "fp8"          # "fp8" | "int_sym" | "none"
    act_method: str = "none"            # "fp8" | "int_asym" | "none":
                                        # x-in or y-out quant
    quantize_input: bool = False        # True: quantize x; False: quantize y
    activation: Optional[str] = None    # None | "relu" | "relu6"
    emit_norm: bool = False             # store the normalized bf16 value

    def __post_init__(self):
        check_methods(self.act_method, self.activation, self.weight_method)
        if self.emit_norm and (self.act_method == "none" or self.quantize_input):
            raise ValueError("emit_norm needs an output quantizer")


def qmatmul_plain(x: torch.Tensor, w: torch.Tensor, w_consts, a_consts,
                  scale: torch.Tensor, shift: torch.Tensor,
                  cfg: FusedQuantMatmulConfig) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (CPU tests, card reference).
    On the card call it under ``common.no_tf32()``."""
    x_method = cfg.act_method if cfg.quantize_input else "none"
    xf = quantize_prepared(x.to(torch.float32), x_method, a_consts,
                           normalized=True)
    wf = quantize_prepared(w.to(torch.float32), cfg.weight_method, w_consts,
                           channel_axis=0, normalized=True)
    y = (xf.to(torch.bfloat16).to(torch.float32)
         @ wf.to(torch.bfloat16).to(torch.float32).t())
    if cfg.weight_method != "none":
        y = y * w_consts[5]
    if x_method != "none":
        y = y * a_consts[5, 0]
    y = y * scale + shift
    act = get_activation(cfg.activation)
    if act is not None:
        y = act(y)
    if not cfg.quantize_input:
        y = quantize_prepared(y, cfg.act_method, a_consts,
                              normalized=cfg.emit_norm)
    return y.to(torch.bfloat16 if cfg.emit_norm else torch.float32)


def _copyable(t: torch.Tensor) -> bool:
    """Whether the kernel can copy bf16 rows of ``t`` by 16-byte cp.async."""
    return t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0


def fused_quant_matmul(x: torch.Tensor, w: torch.Tensor,
                       w_consts: Optional[torch.Tensor],
                       a_consts: Optional[torch.Tensor],
                       scale: torch.Tensor, shift: torch.Tensor, *,
                       cfg: FusedQuantMatmulConfig) -> torch.Tensor:
    """y (M, N) = epilogue(q(x) @ q(w)^T).

    Args:
      x: (M, K) float32 or bf16.
      w: (N, K) float32 (weight_method "fp8" / "int_sym") or bf16
        normalized grid ("none").
      w_consts: (6, N) per-channel weight quantizer constants.
      a_consts: (6, 1) activation quantizer constants (act_method "fp8" /
        "int_asym"), for x under ``cfg.quantize_input``, else for y.
      scale, shift: (N,) float32 epilogue ``y*scale + shift``.
    Returns float32, or bf16 normalized values with ``cfg.emit_norm``.
    Calls the op ``fp8tpu::qmatmul`` (ops/kernels/library.py): CPU tensors
    take ``qmatmul_plain``; CUDA tensors launch the kernel
    (``qmatmul_cuda``).
    """
    M, K = x.shape
    N = w.shape[0]
    if w.shape != (N, K):
        raise ValueError(f"w must be (N, K) = (*, {K}), got {tuple(w.shape)}")
    with span("kernel.qmatmul"):
        return torch.ops.fp8tpu.qmatmul(
            x, w, w_consts, a_consts, scale, shift, cfg.weight_method,
            cfg.act_method, cfg.quantize_input, cfg.activation, cfg.emit_norm)


def qmatmul_cuda(x: torch.Tensor, w: torch.Tensor, w_consts, a_consts,
                 scale: torch.Tensor, shift: torch.Tensor,
                 cfg: FusedQuantMatmulConfig) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (op ``fp8tpu::qmatmul``,
    ops/kernels/library.py); raises where it cannot launch."""
    M, K = x.shape
    N = w.shape[0]
    extra = [t for t in (w_consts, a_consts) if t is not None]
    on_card(x, w, scale, shift, *extra)
    wq = cfg.weight_method != "none"
    aq = cfg.act_method != "none"
    if wq and w_consts is None or aq and a_consts is None:
        raise ValueError("quantizing methods need their quantizer constants")
    w_consts = consts_or_dummy(w_consts if wq else None, x)
    a_consts = consts_or_dummy(a_consts if aq else None, x)
    fp = (torch.float32, torch.bfloat16)
    require(x, "x", fp)
    require(w, "w", (torch.float32,) if wq else (torch.bfloat16,))
    require(w_consts, "w_consts", (torch.float32,), (6, N) if wq else (6, 1))
    require(a_consts, "a_consts", (torch.float32,), (6, 1))
    require(scale, "scale", (torch.float32,), (N,))
    require(shift, "shift", (torch.float32,), (N,))
    # the kernel copies bf16 operands as they are (16-byte rows of 8) and
    # quantizes only float32 ones: anything else is converted here first
    if x.dtype == torch.bfloat16 and (cfg.quantize_input or not _copyable(x)):
        x = x.float()
    if w.dtype == torch.bfloat16 and not _copyable(w):
        w = w.float()
    out = torch.empty((M, N), device=x.device,
                      dtype=torch.bfloat16 if cfg.emit_norm else torch.float32)
    err = build.entry("qmatmul")(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        int(w.dtype == torch.bfloat16), w_consts.data_ptr(),
        a_consts.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), M, N, K, QUANT_CODES[cfg.weight_method],
        QUANT_CODES[cfg.act_method], int(cfg.quantize_input),
        ACTIVATION_CODES[cfg.activation], int(cfg.emit_norm), tile_n(N),
        stream_ptr(x))
    build.check(err, "qmatmul")
    fused_quant_matmul.launches += 1
    return out


fused_quant_matmul.launches = 0
