"""Fused ResNet stem: ``maxpool3x3s2(out_quant(relu(conv7x7s2(x, w)*scale +
shift)))``.

Mirrors ``fused_quant_stem`` of ``fp8_quantization_tpu/ops/pallas/qstem.py``
(Pallas body ``_qstem_kernel``, line 88; ``pallas_call`` at line 242).  The
kernel is ``csrc/qstem.cu``: each block owns a tile of pooled outputs and
recomputes the conv rows and columns its pooling windows read (a halo),
instead of the Pallas band loop with its carried row.  The input is cast
to bf16 inside the kernel as it loads and cin = 3 is read directly (the
``k_pad`` lane padding and the plane-building prologue are TPU artefacts).
The pool runs before the quant: FP8 and integer quantization are
monotone, so this is exactly the model's quant-then-pool order.

Semantics carried over: ``act_method`` (FP8 or int_asym) and
``emit_norm``; the activation is relu (zero pool padding is exact after
relu).  ``imgs_per_block``, ``k_pad``, ``band_rows`` and the VMEM limit do
not carry over.

On the card it is bound by operations (see the note in csrc/qstem.cu).
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

REPLACES = "fp8_quantization_tpu/ops/pallas/qstem.py:88"
COUT = 64          # the kernel is written for the ResNet stem's width


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
    (dy*7 + dx)*cin + ci, zero-padded to Kp = a multiple of 16 rows."""
    cout, cin = w_oihw.shape[:2]
    k = 49 * cin
    kp = -(-k // 16) * 16
    wm = w_oihw.permute(2, 3, 1, 0).reshape(k, cout)
    return F.pad(wm, (0, 0, 0, kp - k)).to(torch.bfloat16).contiguous()


def stem_out_size(s: int) -> int:
    conv = (s - 1) // 2 + 1
    return (conv - 1) // 2 + 1


def qstem_plain(x: torch.Tensor, w: torch.Tensor, a_consts,
                scale: torch.Tensor, shift: torch.Tensor,
                cfg: FusedStemConfig) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (CPU tests, card reference).
    On the card call it under ``common.no_tf32()``."""
    cin, cout = x.shape[-1], w.shape[1]
    wk = (w[:49 * cin].to(torch.float32).reshape(7, 7, cin, cout)
          .permute(3, 2, 0, 1))
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
    factor and BN folded into ``scale``/``shift`` by the caller).  CPU
    tensors take ``qstem_plain``; CUDA tensors launch the kernel."""
    n, s, s2, cin = x.shape
    if s != s2:
        raise ValueError(f"square images only, got {tuple(x.shape)}")
    kp = -(-49 * cin // 16) * 16
    if tuple(w.shape) != (kp, w.shape[1]):
        raise ValueError(f"w must be ({kp}, Cout), got {tuple(w.shape)}")
    extra = [a_consts] if a_consts is not None else []
    if not on_card(x, w, scale, shift, *extra):
        return qstem_plain(x, w, a_consts, scale, shift, cfg)
    if w.shape[1] != COUT or cin > 4:
        raise ValueError(f"the stem kernel takes Cout = {COUT} and cin <= 4, "
                         f"got {w.shape[1]}, {cin}")
    aq = cfg.act_method != "none"
    if aq and a_consts is None:
        raise ValueError(f"act_method={cfg.act_method!r} needs a_consts")
    a_consts = consts_or_dummy(a_consts if aq else None, x)
    require(x, "x", (torch.float32, torch.bfloat16))
    require(w, "w", (torch.bfloat16,), vector_loads=True)
    require(a_consts, "a_consts", (torch.float32,), (6, 1))
    require(scale, "scale", (torch.float32,), (COUT,))
    require(shift, "shift", (torch.float32,), (COUT,))
    p = stem_out_size(s)
    out = torch.empty((n, p, p, COUT), device=x.device,
                      dtype=torch.bfloat16 if cfg.emit_norm else torch.float32)
    err = build.entry("qstem")(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), kp,
        a_consts.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), n, s, cin, QUANT_CODES[cfg.act_method],
        int(cfg.emit_norm), stream_ptr(x))
    build.check(err, "qstem")
    fused_quant_stem.launches += 1
    return out


fused_quant_stem.launches = 0
