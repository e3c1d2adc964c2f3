"""Int8 3x3 SAME conv: ``y = epilogue(conv3x3(xs, wsg) + corrections)``.

Mirrors the int8 path of ``fused_quant_conv3x3`` in ``fp8_quantization_tpu/
ops/pallas/qconv.py`` (``mxu_dtype="int8"``: Pallas body
``_qconv3x3_int8_kernel``, line 278; ``pallas_call`` at line 442).  The
kernel is ``csrc/qconv_int8.cu`` with ``csrc/int8_epilogue.cuh``: an
implicit s8 GEMM over NHWC, M = N*Ho*Wo, K = 9*Cin, N = Cout.

The identity is the quant-matmul's (ops/kernels/qmatmul_int8.py) over the
3x3 window.  SAME padding holds xs = zp - 128, the real zero, so the
rowsum is the window sum of the per-pixel channel sums, padding included,
and K = 9*Cin.  Semantics carried over: stride 1 and 2, in-kernel weight
quant or ``w_prequant``, signed and unsigned weight grids, relu/relu6.
``w`` is the (Cout, 9*Cin) matrix of ``weight_matrix``, column
(dy*3 + dx)*Cin + ci.  The TPU knobs (``imgs_per_block``, the phase split,
the VMEM limit) do not carry over.

On the card the kernel is bound by bytes at every ResNet-18 shape but the
last (see the note in csrc/qconv_int8.cu).  Each of its CTAs owns a tile of
output pixels of one image and of output channels (``conv_tile``) and
quantizes the input patch under it once per 32-channel chunk.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from fp8_quantization_tpu_torch.ops.int8 import act_int_params, quantize_act
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    ACTIVATION_CODES, SMEM_LIMIT, on_card, require, stream_ptr)
from fp8_quantization_tpu_torch.ops.kernels.qconv import out_hw
from fp8_quantization_tpu_torch.ops.kernels.qmatmul_int8 import (
    check_int8_config, check_scalars, epilogue, exact_total, weight_grid)
from fp8_quantization_tpu_torch.utils.timing import span

REPLACES = "fp8_quantization_tpu/ops/pallas/qconv.py:278"
TILE_MS = (128, 64)      # GEMM rows (output pixels) a CTA; csrc/qconv_int8.cu


@dataclasses.dataclass(frozen=True)
class ConvTile:
    """A CTA's share of the output: ``th x tw`` pixels of one image (``bm``
    GEMM rows, ``th * tw <= bm``) times ``bn`` output channels."""
    bm: int
    th: int
    tw: int
    bn: int

    def halo(self, stride: int) -> tuple[int, int]:
        """(rows, columns) of the input patch the tile reads."""
        return (self.th - 1) * stride + 3, (self.tw - 1) * stride + 3

    def smem_bytes(self, stride: int) -> int:
        """The kernel's dynamic shared memory (csrc/qconv_int8.cu, Plan):
        the float32 patch of one 32-channel chunk, two s8 patches, two
        weight chunks, the pixel, row and column sums."""
        ph, pw = self.halo(stride)
        p = ph * pw
        patch = (32 * p + 127) // 128 * 128
        return (128 * p + 2 * patch + 2 * 288 * self.bn
                + (4 * p + 15) // 16 * 16 + 4 * self.bm + 4 * self.bn)


@functools.lru_cache(maxsize=None)
def conv_tile(ho: int, wo: int, stride: int, cout: int) -> ConvTile:
    """The kernel's tile for an (ho, wo) output map: the (bm, th, tw) with
    the least ``tiles * (bm + patch pixels)`` (products computed plus input
    pixels staged, per image), the larger bm and the wider tile on a tie,
    within the shared memory of a block; bn = 64 for up to 64 output
    channels, else 128."""
    best = None
    for bm in TILE_MS:
        for tw in range(1, min(wo, bm) + 1):
            th = min(ho, bm // tw)
            tile = ConvTile(bm, th, tw, 64 if cout <= 64 else 128)
            if tile.smem_bytes(stride) > SMEM_LIMIT:
                continue
            ph, pw = tile.halo(stride)
            cost = -(-ho // th) * -(-wo // tw) * (bm + ph * pw)
            key = (cost, -bm, -tw)
            if best is None or key < best[0]:
                best = (key, tile)
    return best[1]


@dataclasses.dataclass(frozen=True)
class Int8ConvConfig:
    stride: int = 1                     # 1 or 2
    activation: Optional[str] = None    # None | "relu" | "relu6"
    n_bits: int = 8                     # weight grid bits
    act_n_bits: int = 8                 # input grid bits

    def __post_init__(self):
        check_int8_config(self.activation, self.n_bits, self.act_n_bits)
        if self.stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {self.stride}")


def weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) weights -> the int8 kernels' (Cout, kh*kw*Cin)
    matrix, column (dy*kw + dx)*Cin + ci, same dtype."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()


def qconv3x3_int8_plain(x: torch.Tensor, w: torch.Tensor,
                        w_delta: torch.Tensor, w_scalars: torch.Tensor,
                        a_scalars: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor,
                        cfg: Int8ConvConfig) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, integer sums exact in
    float64 (rounded after the convolution, whatever algorithm cuDNN
    picks), for the CPU tests and the card reference."""
    cin, cout = x.shape[-1], w.shape[0]
    dx, zp = act_int_params(a_scalars[0], a_scalars[1], cfg.act_n_bits)
    xs = quantize_act(x, dx, zp, cfg.act_n_bits).permute(0, 3, 1, 2)
    pad0 = zp - 128.0
    xs = (F.pad(xs - pad0, (1, 1, 1, 1)) + pad0).to(torch.float64)
    wsg = weight_grid(w, w_delta, w_scalars, cfg.n_bits)
    w4 = wsg.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    ones = torch.ones((1, 1, 3, 3), dtype=torch.float64, device=x.device)
    acc = torch.round(F.conv2d(xs, w4, stride=cfg.stride))
    rows = torch.round(F.conv2d(xs.sum(dim=1, keepdim=True), ones,
                                stride=cfg.stride))
    s_w = 128.0 * (1.0 - w_scalars[1])
    total = exact_total(acc.permute(0, 2, 3, 1), rows.permute(0, 2, 3, 1),
                        wsg.sum(dim=1), 9 * cin, zp, s_w)
    return epilogue(total, dx, w_delta, scale, shift,
                    cfg.activation).contiguous()


def fused_quant_conv3x3_int8(x: torch.Tensor, w: torch.Tensor,
                             w_delta: torch.Tensor, w_scalars: torch.Tensor,
                             a_scalars: torch.Tensor, scale: torch.Tensor,
                             shift: torch.Tensor, *,
                             cfg: Int8ConvConfig) -> torch.Tensor:
    """y (N, Ho, Wo, Cout) float32 for x (N, H, W, Cin) float32 and the
    ``weight_matrix`` w (Cout, 9*Cin), int8 grid or float32; the scalars as
    ``fused_quant_matmul_int8``'s.  Calls the op ``fp8tpu::qconv3x3_int8``
    (ops/kernels/library.py): CPU tensors take ``qconv3x3_int8_plain``;
    CUDA tensors launch the kernel (``qconv3x3_int8_cuda``)."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, 9 * cin):
        raise ValueError(f"w must be (Cout, 9*Cin) = (*, {9 * cin}), "
                         f"got {tuple(w.shape)}")
    with span("kernel.qconv3x3_int8"):
        return torch.ops.fp8tpu.qconv3x3_int8(
            x, w, w_delta, w_scalars, a_scalars, scale, shift, cfg.activation,
            cfg.n_bits, cfg.act_n_bits, cfg.stride)


def qconv3x3_int8_cuda(x: torch.Tensor, w: torch.Tensor,
                       w_delta: torch.Tensor, w_scalars: torch.Tensor,
                       a_scalars: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor,
                       cfg: Int8ConvConfig) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (op ``fp8tpu::qconv3x3_int8``,
    ops/kernels/library.py); raises where it cannot launch."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    args = (w_delta, w_scalars, a_scalars, scale, shift)
    on_card(x, w, *args)
    if cin % 16:
        raise ValueError(f"the int8 conv kernel needs Cin divisible by 16, "
                         f"got {cin}")
    require(x, "x", (torch.float32,), vector_loads=True)
    require(w, "w", (torch.int8, torch.float32), vector_loads=True)
    check_scalars(cout, *args)
    ho, wo = out_hw(h, wd, cfg.stride)
    tile = conv_tile(ho, wo, cfg.stride, cout)
    out = torch.empty((n, ho, wo, cout), device=x.device, dtype=torch.float32)
    err = build.entry("qconv_int8")(
        x.data_ptr(), w.data_ptr(), int(w.dtype == torch.int8),
        w_delta.data_ptr(), w_scalars.data_ptr(), a_scalars.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n, h, wd, cin,
        cout, cfg.stride, cfg.act_n_bits, cfg.n_bits,
        ACTIVATION_CODES[cfg.activation], tile.bm, tile.th, tile.tw, tile.bn,
        stream_ptr(x))
    build.check(err, "qconv3x3_int8")
    fused_quant_conv3x3_int8.launches += 1
    return out


fused_quant_conv3x3_int8.launches = 0
