"""Fused ResNet stem: ``maxpool3x3s2(out_quant(relu(conv7x7s2(x, w)*scale +
shift)))``.

Mirrors ``fused_quant_stem`` of ``fp8_quantization_tpu/ops/pallas/qstem.py``
(Pallas body ``_qstem_kernel``, line 88; ``pallas_call`` at line 242).  The
kernel is ``csrc/qstem.cu``: persistent blocks walk tiles of pooled
outputs (``stem_tile``) and recompute the conv rows and columns each
tile's pooling windows read (a halo), instead of the Pallas band loop with
its carried row.  The input is cast to bf16 inside the kernel as it loads
and cin = 3 is read directly (the ``k_pad`` lane padding and the
plane-building prologue are TPU artefacts).  The products read their A
fragments straight from the staged patch: the weights are laid out with K
dy-major, each dy's ``7 * cin`` taps padded to an even run
(``weight_matrix``), so a pair of taps is one aligned word of the patch at
a pixel's base plus ``k_offsets``.  The pool runs before the quant: FP8
and integer quantization are monotone, so this is exactly the model's
quant-then-pool order.

Semantics carried over: ``act_method`` (FP8 or int_asym) and
``emit_norm``; the activation is relu (zero pool padding is exact after
relu).  ``imgs_per_block``, ``k_pad``, ``band_rows`` and the VMEM limit do
not carry over.

On the card its bytes and its tensor-core products both take about 0.02
ms at batch 64; the staging, products, pool and epilogue of a tile run
in turn and take the time (see the note in csrc/qstem.cu).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fp8_quantization_tpu_torch.nn.factored import max_pool_nhwc
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    QUANT_CODES, check_methods, consts_or_dummy, on_card, quantize_prepared,
    require, stream_ptr)
from fp8_quantization_tpu_torch.utils.timing import span

REPLACES = "fp8_quantization_tpu/ops/pallas/qstem.py:88"
COUT = 64          # the kernel is written for the ResNet stem's width
CSP = COUT + 4     # the conv tile's row pitch in floats (csrc: CSP)


def run_len(cin: int) -> int:
    """The taps (dx, ci) of one dy, ``7 * cin``, padded to an even count."""
    return -(-7 * cin // 2) * 2


def k_pad(cin: int) -> int:
    """Rows of the weight matrix: 7 runs, padded to a multiple of 16."""
    return -(-7 * run_len(cin) // 16) * 16


def k_offsets(cin: int, pitch: int) -> list[int]:
    """Element offset in the staged patch of weight row k, from the patch
    element of a conv pixel's first tap (csrc: the koff table):
    ``dy * pitch + (k - dy * run_len)``, and 0 for the padded rows past
    ``7 * run_len`` (their weights are zero)."""
    runp = run_len(cin)
    return [(k // runp) * pitch + k % runp if k < 7 * runp else 0
            for k in range(k_pad(cin))]


@dataclasses.dataclass(frozen=True)
class StemTile:
    """``tp x tq`` pooled outputs of one image; the kernel computes the
    ``(2tp + 1) x (2tq + 1)`` conv pixels under them from a ``(4tp + 7) x
    (4tq + 7)`` input patch."""
    tp: int
    tq: int

    def conv(self) -> tuple[int, int]:
        return 2 * self.tp + 1, 2 * self.tq + 1

    def patch(self) -> tuple[int, int]:
        cr, cc = self.conv()
        return 2 * cr + 5, 2 * cc + 5

    def pitch(self, cin: int) -> int:
        """bf16 elements a staged patch row takes: even, and one past the
        row (the odd tap of the last pair of a run reads it)."""
        return (self.patch()[1] * cin + 2) // 2 * 2

    def tiles(self, s: int) -> int:
        p = stem_out_size(s)
        return -(-p // self.tp) * -(-p // self.tq)

    def smem_bytes(self, cin: int) -> int:
        """The kernel's dynamic shared memory: the weights as (64, Kp + 8)
        bf16 rows, scale and shift, the koff table, the patch and the fp32
        conv tile (csrc: the off_* offsets)."""
        def a16(b):
            return -(-b // 16) * 16
        cr, cc = self.conv()
        koff = a16(64 * (k_pad(cin) + 8) * 2) + 2 * COUT * 4
        patch = a16(koff + k_pad(cin) // 16 * 4 * 8)
        cs = a16(patch + self.patch()[0] * self.pitch(cin) * 2)
        return cs + cr * cc * CSP * 4


def stem_tile(s: int) -> StemTile:
    """8 x 8 pooled outputs (a 17 x 17 conv tile, 1.13x the conv work of
    the pooled pixels; two blocks fit an SM), the whole map below 8."""
    p = stem_out_size(s)
    return StemTile(min(8, p), min(8, p))


@dataclasses.dataclass(frozen=True)
class FusedStemConfig:
    act_method: str = "fp8"        # output quantizer: "fp8" | "int_asym"
                                   # | "none"
    emit_norm: bool = False        # store the normalized bf16 value

    def __post_init__(self):
        check_methods(self.act_method, "relu")
        if self.emit_norm and self.act_method == "none":
            raise ValueError("emit_norm needs an output quantizer")


def weight_matrix(w_oihw: torch.Tensor) -> torch.Tensor:
    """(Cout, cin, 7, 7) weights -> the kernel's (Kp, Cout) bf16 matrix, row
    dy * run_len + dx * cin + ci, zero rows where a run is padded and past
    ``7 * run_len`` to Kp = ``k_pad(cin)``."""
    cout, cin = w_oihw.shape[:2]
    runs = w_oihw.permute(2, 3, 1, 0).reshape(7, 7 * cin, cout)
    runs = F.pad(runs, (0, 0, 0, run_len(cin) - 7 * cin))
    wm = runs.reshape(7 * run_len(cin), cout)
    return F.pad(wm, (0, 0, 0, k_pad(cin) - wm.shape[0])).to(
        torch.bfloat16).contiguous()


def weight_oihw(w: torch.Tensor, cin: int) -> torch.Tensor:
    """The inverse of ``weight_matrix``: (Cout, cin, 7, 7) float32."""
    runs = w[:7 * run_len(cin)].to(torch.float32).reshape(7, run_len(cin), -1)
    return runs[:, :7 * cin].reshape(7, 7, cin, -1).permute(3, 2, 0, 1)


def stem_out_size(s: int) -> int:
    conv = (s - 1) // 2 + 1
    return (conv - 1) // 2 + 1


def qstem_plain(x: torch.Tensor, w: torch.Tensor, a_consts,
                scale: torch.Tensor, shift: torch.Tensor,
                cfg: FusedStemConfig) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (CPU tests, card reference).
    On the card call it under ``common.no_tf32()``."""
    wk = weight_oihw(w, x.shape[-1])
    xb = x.to(torch.bfloat16).to(torch.float32).permute(0, 3, 1, 2)
    y = F.conv2d(xb, wk, stride=2, padding=3).permute(0, 2, 3, 1)
    y = torch.relu(y * scale + shift)
    y = max_pool_nhwc(y, 3, 2, 1)
    y = quantize_prepared(y, cfg.act_method, a_consts, normalized=cfg.emit_norm)
    return y.to(torch.bfloat16 if cfg.emit_norm else torch.float32).contiguous()


def fused_quant_stem(x: torch.Tensor, w: torch.Tensor, a_consts,
                     scale: torch.Tensor, shift: torch.Tensor, *,
                     cfg: FusedStemConfig) -> torch.Tensor:
    """(N, P, P, Cout) pooled activations for x (N, S, S, cin) float32 or
    bf16 raw images and the ``weight_matrix`` w (Kp, Cout) bf16 (weight
    factor and BN folded into ``scale``/``shift`` by the caller).  Calls
    the op ``fp8tpu::qstem`` (ops/kernels/library.py): CPU tensors take
    ``qstem_plain``; CUDA tensors launch the kernel (``qstem_cuda``)."""
    n, s, s2, cin = x.shape
    if s != s2:
        raise ValueError(f"square images only, got {tuple(x.shape)}")
    kp = k_pad(cin)
    if tuple(w.shape) != (kp, w.shape[1]):
        raise ValueError(f"w must be ({kp}, Cout), got {tuple(w.shape)}")
    with span("kernel.qstem"):
        return torch.ops.fp8tpu.qstem(x, w, a_consts, scale, shift,
                                      cfg.act_method, cfg.emit_norm)


def qstem_cuda(x: torch.Tensor, w: torch.Tensor, a_consts,
               scale: torch.Tensor, shift: torch.Tensor,
               cfg: FusedStemConfig) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (op ``fp8tpu::qstem``,
    ops/kernels/library.py); raises where it cannot launch."""
    n, s, _, cin = x.shape
    kp = k_pad(cin)
    extra = [a_consts] if a_consts is not None else []
    on_card(x, w, scale, shift, *extra)
    if w.shape[1] != COUT or cin > 4:
        raise ValueError(f"the stem kernel takes Cout = {COUT} and cin <= 4, "
                         f"got {w.shape[1]}, {cin}")
    aq = cfg.act_method != "none"
    if aq and a_consts is None:
        raise ValueError(f"act_method={cfg.act_method!r} needs a_consts")
    a_consts = consts_or_dummy(a_consts if aq else None, x)
    require(x, "x", (torch.float32, torch.bfloat16), vector_loads=True)
    require(w, "w", (torch.bfloat16,), vector_loads=True)
    require(a_consts, "a_consts", (torch.float32,), (6, 1))
    require(scale, "scale", (torch.float32,), (COUT,))
    require(shift, "shift", (torch.float32,), (COUT,))
    p = stem_out_size(s)
    tile = stem_tile(s)
    out = torch.empty((n, p, p, COUT), device=x.device,
                      dtype=torch.bfloat16 if cfg.emit_norm else torch.float32)
    err = build.entry("qstem")(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), kp,
        a_consts.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), n, s, cin, QUANT_CODES[cfg.act_method],
        int(cfg.emit_norm), tile.tp, tile.tq, stream_ptr(x))
    build.check(err, "qstem")
    fused_quant_stem.launches += 1
    return out


fused_quant_stem.launches = 0
