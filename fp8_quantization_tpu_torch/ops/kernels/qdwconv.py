"""Fused depthwise 3x3 SAME conv: ``y = out_quant(act(dwconv3x3(x, w)*scale
+ shift))``.

Mirrors ``fused_quant_dwconv3x3`` of ``fp8_quantization_tpu/ops/pallas/
qconv.py`` (Pallas body ``_qdwconv3x3_kernel``, line 183; ``pallas_call`` at
line 251).  The kernel is ``csrc/qdwconv.cu``: a block stages the input
halo of a ``th x tw`` output tile and ``8 * cg`` channels (``dw_tile``)
into shared memory, SAME padding as a zero fill and stride 2 as index
arithmetic (no phase split); each thread walks a strip of 7 outputs of 2
channels with a sliding window, the nine taps summed in float32 in
(dy, dx) row-major order.  It is bound by bytes and, about as much, by
the epilogue's instruction issue (see the note in the source).

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
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from fp8_quantization_tpu_torch.nn.activations import get_activation
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    ACTIVATION_CODES, QUANT_CODES, check_methods, consts_or_dummy, on_card,
    quantize_prepared, require, stream_ptr)

REPLACES = "fp8_quantization_tpu/ops/pallas/qconv.py:183"
SEG = 7             # outputs a thread computes along a row (csrc: kSeg)
VEC = 2             # channels a thread computes (csrc: kVec)
MAX_THREADS = 512   # csrc: kMaxThreads
SIMPLE_THREADS = 256


@dataclasses.dataclass(frozen=True)
class DwTile:
    """A block's share of the output: ``th x tw`` pixels of one image and
    ``8 * cg`` channels; ``cg = 0`` is the route for C % 8 != 0, one thread
    per output value in blocks of 256."""
    th: int
    tw: int
    cg: int

    def threads(self) -> int:
        """One thread per tile row and VEC channels; it walks the row's
        tw / SEG strips."""
        return self.cg * (8 // VEC) * self.th

    def halo(self, stride: int) -> tuple[int, int]:
        """Input rows and columns a tile reads."""
        return stride * (self.th - 1) + 3, stride * (self.tw - 1) + 3

    def row_pitch(self, stride: int) -> int:
        """16-byte pieces a staged halo row takes (csrc: rp): padded so
        that the rows a quarter-warp reads land on other banks where the
        group is narrower than 8 pieces."""
        hc = self.halo(stride)[1]
        for pad in range(8 if 0 < self.cg < 8 else 0):
            if (stride * (hc * self.cg + pad) - self.cg) % 8 == 0:
                return hc * self.cg + pad
        return hc * self.cg

    def smem_bytes(self, stride: int) -> int:
        return self.halo(stride)[0] * self.row_pitch(stride) * 16


@functools.lru_cache(maxsize=None)
def dw_tile(h: int, w: int, c: int, stride: int) -> DwTile:
    """The kernel's tile for an (h, w, c) input: whole 7-wide strips, up to
    4 a row at stride 1 and 2 at stride 2 (a thread walks them, so its
    weights and constants serve 28 or 14 outputs), 4 to 8 rows (the whole
    map up to 8, else a divisor in 4..8 where there is one), and the widest
    group of up to 8 (stride 1) or 4 (stride 2) 8-channel vectors that
    divides C / 8 and is a power of two, so that a stride-2 halo stays near
    32 KB."""
    if c % 8:
        return DwTile(1, 1, 0)
    ho, wo = out_hw(h, w, stride)
    tw = SEG * min(-(-wo // SEG), 4 if stride == 1 else 2)
    th = ho if ho <= 8 else next((d for d in range(8, 3, -1) if ho % d == 0), 8)
    cg = 8 if stride == 1 else 4
    while (c // 8) % cg:
        cg //= 2
    return DwTile(th, tw, cg)


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
    ``scale``/``shift`` (C,) float32.  Calls the op ``fp8tpu::qdwconv3x3``
    (ops/kernels/library.py): CPU tensors take ``qdwconv3x3_plain``; CUDA
    tensors launch the kernel (``qdwconv3x3_cuda``)."""
    n, h, wd, c = x.shape
    if w.shape != (3, 3, c):
        raise ValueError(f"w must be (3, 3, C) = (3, 3, {c}), got "
                         f"{tuple(w.shape)}")
    return torch.ops.fp8tpu.qdwconv3x3(
        x, w, a_consts, scale, shift, cfg.act_method, cfg.activation,
        cfg.emit_norm, cfg.stride)


def qdwconv3x3_cuda(x: torch.Tensor, w: torch.Tensor, a_consts,
                    scale: torch.Tensor, shift: torch.Tensor,
                    cfg: DwConvConfig) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (op ``fp8tpu::qdwconv3x3``,
    ops/kernels/library.py); raises where it cannot launch."""
    n, h, wd, c = x.shape
    extra = [t for t in (a_consts,) if t is not None]
    on_card(x, w, scale, shift, *extra)
    aq = cfg.act_method != "none"
    if aq and a_consts is None:
        raise ValueError(f"act_method={cfg.act_method!r} needs a_consts")
    a_consts = consts_or_dummy(a_consts if aq else None, x)
    tile = dw_tile(h, wd, c, cfg.stride)
    vec = tile.cg > 0                   # the tiled route reads 16 bytes at once
    require(x, "x", (torch.bfloat16,), vector_loads=True)
    require(w, "w", (torch.float32,), (3, 3, c), vector_loads=vec)
    require(a_consts, "a_consts", (torch.float32,), (6, 1))
    require(scale, "scale", (torch.float32,), (c,), vector_loads=vec)
    require(shift, "shift", (torch.float32,), (c,), vector_loads=vec)
    ho, wo = out_hw(h, wd, cfg.stride)
    out = torch.empty((n, ho, wo, c), device=x.device,
                      dtype=torch.bfloat16 if cfg.emit_norm else torch.float32)
    err = build.entry("qdwconv")(
        x.data_ptr(), w.data_ptr(), a_consts.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), n, h, wd, c, cfg.stride,
        QUANT_CODES[cfg.act_method],
        ACTIVATION_CODES[cfg.activation], int(cfg.emit_norm), tile.th, tile.tw,
        tile.cg, stream_ptr(x))
    build.check(err, "qdwconv3x3")
    fused_quant_dwconv3x3.launches += 1
    return out


fused_quant_dwconv3x3.launches = 0
