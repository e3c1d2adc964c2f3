"""Fused 3x3 SAME conv: ``y = out_quant(act(conv3x3(x, w)*scale + shift
[+ residual]))``.

Mirrors ``fused_quant_conv3x3`` of ``fp8_quantization_tpu/ops/pallas/
qconv.py`` (Pallas bodies ``_qconv3x3_kernel`` and ``_conv_epilogue``,
lines 130 and 111; ``pallas_call`` at line 472).  The kernel is
``csrc/qconv.cu``: an implicit GEMM over NHWC, M = N*Ho*Wo, K = 9*Cin,
N = Cout, on the wgmma mainloop of ``csrc/gemm_sm90.cuh`` with an
implicit-im2col producer (SAME padding as a zero fill, stride 2 as index
arithmetic).

Semantics carried over: ``act_method``, ``activation``, ``residual``,
``emit_norm`` and ``stride``; the output quant is FP8 or int_asym.  The
input is a factored bf16 norm; the weights are baked normalized values
laid out once, at bake time, as a ``(Cout, 9*Cin)`` bf16 matrix, K-major
as wgmma reads it (``weight_matrix``).  The TPU knobs
(``imgs_per_block``, ``im2col``, the phase split, the VMEM limit) do not
carry over; the int8 body is ``ops/kernels/qconv_int8``.

On the card operations bound it (see the note in csrc/qconv.cu).  Each
block computes 128 output pixels by ``conv_tile(M, Cout).bn`` channels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from fp8_quantization_tpu_torch.nn.activations import get_activation
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    ACTIVATION_CODES, QUANT_CODES, SMS, check_methods, consts_or_dummy,
    on_card, quantize_prepared, require, stream_ptr)
from fp8_quantization_tpu_torch.utils.timing import span

REPLACES = "fp8_quantization_tpu/ops/pallas/qconv.py:130"
TILE_M = 128                        # csrc/gemm_sm90.cuh: BM
TILE_NS = (128, 64, 32, 16)         # the wgmma widths the kernel is built for


@dataclasses.dataclass(frozen=True)
class ConvTile:
    """A block's share of the output: 128 output pixels (GEMM rows) times
    ``bn`` output channels, K = 9*Cin in chunks of 64."""
    bn: int

    def blocks(self, m: int, cout: int) -> int:
        return -(-m // TILE_M) * -(-cout // self.bn)

    def smem_bytes(self, cin: int) -> int:
        """The kernel's dynamic shared memory (csrc/qconv.cu, ConvPlan):
        up to 3 stages of a 128-row A and a bn-row B chunk of 64 bf16 (as
        many as K's chunks), or the float32 output tile staged for the
        stores if larger, plus 1024 to align the base."""
        stages = min(-(-9 * cin // 64), 3)
        ring = stages * (TILE_M + self.bn) * 128
        return max(ring, TILE_M * (4 * self.bn + 32)) + 1024


@functools.lru_cache(maxsize=None)
def conv_tile(m: int, cout: int) -> ConvTile:
    """The kernel's tile for M output pixels and Cout channels: 128 wide
    where that grid has at most two blocks per SM (two fit, at 128
    registers a thread), else the widest no wider than 64 and than Cout
    needs (its power of two, at least 16; three blocks fit an SM).  Where
    blocks are few (ResNet-18's maps from 28x28 / 2 down at batch 64) the
    wide tile gathers each input row for twice the channels, and the L2
    traffic of the gathers, not the occupancy, bounds the kernel (the
    launch-width variants of ops/kernels/variants.py, PERF.md section 6)."""
    need = max(16, 1 << (cout - 1).bit_length())
    if need >= 128 and ConvTile(128).blocks(m, cout) <= 2 * SMS:
        return ConvTile(128)
    return ConvTile(min(64, need))


@dataclasses.dataclass(frozen=True)
class FusedConvConfig:
    act_method: str = "none"            # output quantizer: "fp8" |
                                        # "int_asym" | "none"
    activation: Optional[str] = None    # None | "relu" | "relu6"
    residual: bool = False              # add a residual after scale/shift
    emit_norm: bool = False             # store the normalized bf16 value
    stride: int = 1                     # 1 or 2

    def __post_init__(self):
        check_methods(self.act_method, self.activation)
        if self.stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {self.stride}")
        if self.emit_norm and self.act_method == "none":
            raise ValueError("emit_norm needs an output quantizer")


def weight_matrix(w_oihw: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) weights -> the kernel's (Cout, 9*Cin) bf16 matrix,
    column (dy*3 + dx)*Cin + ci: the K-major B operand of wgmma."""
    return (w_oihw.permute(0, 2, 3, 1).reshape(w_oihw.shape[0], -1)
            .to(torch.bfloat16).contiguous())


def out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def qconv3x3_plain(x: torch.Tensor, w: torch.Tensor, a_consts,
                   scale: torch.Tensor, shift: torch.Tensor,
                   residual: Optional[torch.Tensor],
                   cfg: FusedConvConfig) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (CPU tests, card reference).
    On the card call it under ``common.no_tf32()``."""
    cin, cout = x.shape[-1], w.shape[0]
    wk = w.to(torch.float32).reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    xb = x.to(torch.bfloat16).to(torch.float32).permute(0, 3, 1, 2)
    y = F.conv2d(xb, wk, stride=cfg.stride, padding=1).permute(0, 2, 3, 1)
    y = y * scale + shift
    if residual is not None:
        y = y + residual.to(torch.float32)
    act = get_activation(cfg.activation)
    if act is not None:
        y = act(y)
    y = quantize_prepared(y, cfg.act_method, a_consts, normalized=cfg.emit_norm)
    return y.to(torch.bfloat16 if cfg.emit_norm else torch.float32).contiguous()


def fused_quant_conv3x3(x: torch.Tensor, w: torch.Tensor,
                        a_consts: Optional[torch.Tensor],
                        scale: torch.Tensor, shift: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, *,
                        cfg: FusedConvConfig) -> torch.Tensor:
    """y (N, Ho, Wo, Cout) for x (N, H, W, Cin) bf16 norms and the
    ``weight_matrix`` w (Cout, 9*Cin) bf16; ``a_consts`` (6, 1) for the
    output quant, ``scale``/``shift`` (Cout,) float32, ``residual``
    (N, Ho, Wo, Cout) added after scale/shift (cast to bf16 under emit_norm,
    float32 otherwise, as the JAX wrapper does).  Calls the op
    ``fp8tpu::qconv3x3`` (ops/kernels/library.py): CPU tensors take
    ``qconv3x3_plain``; CUDA tensors launch the kernel (``qconv3x3_cuda``)."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, 9 * cin):
        raise ValueError(f"w must be (Cout, 9*Cin) = (*, {9 * cin}), "
                         f"got {tuple(w.shape)}")
    if cfg.residual != (residual is not None):
        raise ValueError("cfg.residual must match the residual argument")
    ho, wo = out_hw(h, wd, cfg.stride)
    if residual is not None:
        if tuple(residual.shape) != (n, ho, wo, cout):
            raise ValueError(f"residual shape {tuple(residual.shape)} != "
                             f"{(n, ho, wo, cout)}")
        residual = residual.to(torch.bfloat16 if cfg.emit_norm
                               else torch.float32).contiguous()
    with span("kernel.qconv3x3"):
        return torch.ops.fp8tpu.qconv3x3(
            x, w, a_consts, scale, shift, residual, cfg.act_method,
            cfg.activation, cfg.emit_norm, cfg.stride)


def qconv3x3_cuda(x: torch.Tensor, w: torch.Tensor, a_consts,
                  scale: torch.Tensor, shift: torch.Tensor,
                  residual: Optional[torch.Tensor],
                  cfg: FusedConvConfig) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (op ``fp8tpu::qconv3x3``,
    ops/kernels/library.py); raises where it cannot launch."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    ho, wo = out_hw(h, wd, cfg.stride)
    extra = [t for t in (a_consts, residual) if t is not None]
    on_card(x, w, scale, shift, *extra)
    aq = cfg.act_method != "none"
    if aq and a_consts is None:
        raise ValueError(f"act_method={cfg.act_method!r} needs a_consts")
    if cin % 8 or cout % 8:
        raise ValueError(f"the conv kernel needs Cin and Cout divisible by 8, "
                         f"got {cin}, {cout}")
    a_consts = consts_or_dummy(a_consts if aq else None, x)
    require(x, "x", (torch.bfloat16,), vector_loads=True)
    require(w, "w", (torch.bfloat16,), vector_loads=True)
    require(a_consts, "a_consts", (torch.float32,), (6, 1))
    require(scale, "scale", (torch.float32,), (cout,))
    require(shift, "shift", (torch.float32,), (cout,))
    out = torch.empty((n, ho, wo, cout), device=x.device,
                      dtype=torch.bfloat16 if cfg.emit_norm else torch.float32)
    err = build.entry("qconv")(
        x.data_ptr(), w.data_ptr(), a_consts.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), residual.data_ptr() if residual is not None else None,
        int(residual is not None and residual.dtype == torch.bfloat16),
        out.data_ptr(), n, h, wd, cin, cout, cfg.stride,
        QUANT_CODES[cfg.act_method],
        ACTIVATION_CODES[cfg.activation], int(cfg.emit_norm),
        conv_tile(n * ho * wo, cout).bn, stream_ptr(x))
    build.check(err, "qconv3x3")
    fused_quant_conv3x3.launches += 1
    return out


fused_quant_conv3x3.launches = 0
