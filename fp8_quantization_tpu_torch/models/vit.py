"""Quantized Vision Transformer (ViT-S/16) on NHWC input.

Mirrors ``fp8_quantization_tpu/models/vit.py``: patch embed (a quantized
16x16/16 conv with bias) -> cls token and position embedding -> ``depth``
pre-norm encoder blocks [QuantLayerNorm -> attention (quantized qkv and
proj, unquantized softmax) -> residual add -> block quantizer ->
QuantLayerNorm -> quantized MLP (gelu) -> residual add -> block quantizer]
-> final QuantLayerNorm -> the cls row -> quantized head.  Module names are
the JAX scope names (``patch_embed``, ``cls_token``, ``pos_embed``,
``block{i}.{ln1,attn.qkv,attn.proj,res1_act,ln2,mlp1,mlp2,res2_act}``,
``ln_final``, ``head``), so that its variables carry over by path
(models/convert.load_jax_variables).

In fixed mode under ``bf16`` and ``fused`` the LayerNorms, the gelu MLP
layer and the block quantizers emit ``Factored`` tensors, as in JAX (there
lines 159-205, 284-291).  Under ``fused`` in fixed mode the attention runs
``ops/kernels/attention.flash_mha`` on views of the qkv output where
``autotune.attn_wins`` says so (JAX lines 108-116) and qkv, proj, mlp2 and
the head run ``qmatmul`` where ``autotune.pallas_wins`` says so;
everywhere else the attention is the float32 chain (JAX lines 117-125).  The patch embed and mlp1 (gelu) take the composed path on every
engine, as in JAX.  In a prepared model (nn/bake.prepare_inference) the
quantizers apply their stored constants (``qprep``) in fixed mode.  Under
``deploy_act_f8`` the token path carries 1-byte norms, which every reader
(the LayerNorms, the residual adds, the cls slice, the linears) takes
through ``factored.split`` / ``materialize``, exactly upcast.

On the int8 datapath (``int8_mxu`` + ``quantize_input``) in fixed mode
with quantized or int8-baked weights (``_i8_fast``, computed once at the
root, JAX there lines 31-54, 264-266) the token stream is 2-D,
(B*S_pad, D), and every int8 matmul edge exchanges its operand as a
``PrequantS8`` made by its producer (JAX there lines 130-137, 177-192,
295-301): ln1 -> qkv, the attention output -> proj, ln2 -> mlp1, mlp1
(the epilogue of its int8 matmul: under ``fused`` the Hopper s8 kernel's
with gelu, ops/kernels/qmatmul_int8.sm90_takes, else ops/int8's) -> mlp2,
the cls rows -> head; each producer reads
its consumer's grid with ``QuantLinear.int8_input_grid``.  S is padded to
a multiple of 16 on ``parity`` and ``bf16`` and not on ``fused`` (JAX
there lines 267-278), whose attention then never needs the mask; a
padded stream masks its pad keys out of the softmax with an additive
-1e9 (JAX there lines 108, 119-124), and the pad rows are dropped at the
cls slice.  Calibration modes keep the 3-D stream and emit no s8.

Not ported: the presets other than ``all`` and ``FP_logits``, which raise
where JAX ignores them (ROADMAP.md, section C).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fp8_quantization_tpu_torch.device import resolve_device
from fp8_quantization_tpu_torch.nn.config import LayerQuantConfig
from fp8_quantization_tpu_torch.nn.factored import (
    Factored, PrequantS8, fadd, materialize, split)
from fp8_quantization_tpu_torch.nn.layers import (
    QuantConv, QuantizedActivation, QuantLayerNorm, QuantLinear,
    gated_route, int8_interchange_ok)
from fp8_quantization_tpu_torch.ops.int8 import prequant_s8
from fp8_quantization_tpu_torch.ops.kernels import attention, autotune
from fp8_quantization_tpu_torch.utils.timing import span, spanned

# the int8 stream's token count is padded to a multiple of this off 'fused'
# (the bf16 tile height in JAX, there lines 250-262)
SEQ_ALIGN = 16


def _i8_fast(cfg: LayerQuantConfig, mode: str, quant_a: bool, quant_w: bool,
             baked: bool, train_bn: bool) -> bool:
    """Whether the s8 interchange runs (JAX ``_i8_fast``): fixed mode, not
    training BN, quantized inputs, quantized or int8-baked weights, under a
    config of the int8 datapath."""
    return (mode == "fixed" and not train_bn and quant_a
            and (baked or (quant_w and cfg.quant_w))
            and int8_interchange_ok(cfg))


def _s8(y: torch.Tensor, consumer: QuantLinear) -> PrequantS8:
    """``y`` on ``consumer``'s input grid, made by its producer."""
    grid = consumer.int8_input_grid()
    return PrequantS8(prequant_s8(y, *grid), *grid)


def composed_attention(q, k, v, n_real: int = 0) -> torch.Tensor:
    """The float32 chain of JAX (there lines 117-125): ``softmax(q k^T /
    sqrt(hd)) v`` with the softmax as ``jax.nn.softmax`` computes it, in
    the operands' dtype (bfloat16 from an int8 qkv under
    ``conv_out_bf16``, as in JAX); with ``0 < n_real < S`` the keys past
    ``n_real`` (pads) get -1e9 added."""
    hd = torch.tensor(float(q.shape[-1]), dtype=torch.float32, device=q.device)
    a = (q @ k.transpose(-1, -2)) / torch.sqrt(hd)
    n = a.shape[-1]
    if 0 < n_real < n:
        a = a + torch.where(torch.arange(n, device=a.device) < n_real,
                            0.0, -1e9).to(a.dtype)
    e = torch.exp(a - a.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)) @ v


class QuantSelfAttention(nn.Module):
    """Multi-head self-attention with quantized qkv and output projections."""

    def __init__(self, dim: int, num_heads: int, config: LayerQuantConfig):
        super().__init__()
        self.dim, self.num_heads, self.config = dim, num_heads, config
        self.qkv = QuantLinear(dim, 3 * dim, use_bias=True, config=config)
        self.proj = QuantLinear(dim, dim, use_bias=True, config=config)

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, seq_len: int = 0, n_real: int = 0,
                i8: bool = False):
        """``seq_len`` 0: ``x`` is (B, S, D); else the 2-D int8 stream of
        (B*seq_len, D) rows, whose rows past ``n_real`` in each image are
        pads when ``0 < n_real < seq_len``.  ``i8``: the s8 interchange
        (the attention output goes to proj as a ``PrequantS8``)."""
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a)
        qkv = self.qkv(x, **kw)
        n = seq_len or qkv.shape[1]
        b = qkv.shape[0] // n if seq_len else qkv.shape[0]
        h = self.num_heads
        hd = self.dim // h
        # (B, H, S, hd) views of the (B, S, 3, H, hd) qkv output
        q, k, v = (qkv.reshape(b, n, 3, h, hd)[:, :, i].transpose(1, 2)
                   for i in range(3))
        masked = 0 < n_real < n
        if mode == "fixed" and self.config.engine == "fused" and not masked:
            y = gated_route(
                self, partial(autotune.attn_wins, b, h, n, hd, like=q),
                lambda: attention.flash_mha(q, k, v,
                                            sm_scale=1.0 / float(hd) ** 0.5),
                lambda: composed_attention(q, k, v))
        else:
            y = composed_attention(q, k, v, n_real)
        y = y.transpose(1, 2).reshape(*((b * n,) if seq_len else (b, n)),
                                      self.dim)
        return self.proj(_s8(y, self.proj) if i8 else y, **kw)


class QuantEncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 config: LayerQuantConfig):
        super().__init__()
        self.config = config
        self.ln1 = QuantLayerNorm(dim, config)
        self.attn = QuantSelfAttention(dim, num_heads, config)
        self.res1_act = QuantizedActivation(config)
        self.ln2 = QuantLayerNorm(dim, config)
        self.mlp1 = QuantLinear(dim, dim * mlp_ratio, use_bias=True,
                                activation="gelu", config=config)
        self.mlp2 = QuantLinear(dim * mlp_ratio, dim, use_bias=True,
                                config=config)
        self.res2_act = QuantizedActivation(config)

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, seq_len: int = 0, n_real: int = 0,
                i8: bool = False):
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a)
        out = ("factored" if mode == "fixed"
               and self.config.engine in ("bf16", "fused") else "value")
        ln1kw, ln2kw, mlp1kw = dict(out=out), dict(out=out), dict(out=out)
        if i8:
            # each int8 matmul's operand made by its producer on the
            # consumer's grid (the residual edges stay Factored: the
            # LayerNorms need real values)
            ln1kw = dict(emit_s8=self.attn.qkv.int8_input_grid())
            ln2kw = dict(emit_s8=self.mlp1.int8_input_grid())
            mlp1kw = dict(emit_s8=self.mlp2.int8_input_grid())
        y = self.attn(self.ln1(x, **kw, **ln1kw), **kw, seq_len=seq_len,
                      n_real=n_real, i8=i8)
        with span("residual"):
            x = fadd(x, y)
        x = self.res1_act(x, mode=mode, quant_a=quant_a, out=out)
        y = self.mlp2(self.mlp1(self.ln2(x, **kw, **ln2kw), **kw, **mlp1kw),
                      **kw)
        with span("residual"):
            x = fadd(x, y)
        return self.res2_act(x, mode=mode, quant_a=quant_a, out=out)


class QuantizedViT(nn.Module):
    """ViT classifier with quantized projections and norms throughout, for
    ``image_size`` x ``image_size`` inputs (the position embedding's
    length)."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: int = 4, image_size: int = 224,
                 config: LayerQuantConfig = LayerQuantConfig(),
                 head_config: Optional[LayerQuantConfig] = None):
        super().__init__()
        self.config, self.depth = config, depth
        self.patch_embed = QuantConv(3, dim, patch_size, stride=patch_size,
                                     padding=0, use_bias=True, config=config)
        n_tokens = (image_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.randn(1, n_tokens, dim) * 0.02)
        for i in range(depth):
            self.add_module(f"block{i}", QuantEncoderBlock(
                dim, num_heads, mlp_ratio, config))
        self.ln_final = QuantLayerNorm(dim, config)
        self.head = QuantLinear(dim, num_classes, use_bias=True,
                                config=head_config or config)

    def input_shape(self, image_shape) -> tuple:
        """The shape of the input this model takes: the NHWC images'."""
        return tuple(image_shape)

    @spanned("forward")
    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False):
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a)
        x = self.patch_embed(x, **kw, train_bn=train_bn)
        b, gh, gw, d = x.shape
        if gh * gw + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"{gh * gw + 1} tokens, but the position embedding has "
                f"{self.pos_embed.shape[1]}: build the model for this image "
                "size")
        x = torch.cat([self.cls_token.expand(b, 1, d),
                       x.reshape(b, gh * gw, d)], dim=1) + self.pos_embed
        n = gh * gw + 1
        # int8-baked weights count as quantized (every int8 layer is baked
        # when the patch embed is)
        baked = self.patch_embed.w_int8 is not None
        i8 = _i8_fast(self.config, mode, quant_a, quant_w, baked, train_bn)
        # 'fused' keeps the unpadded stream, so flash_mha needs no mask
        n_pad = -n % SEQ_ALIGN if i8 and self.config.engine != "fused" else 0
        seq = n + n_pad
        bkw = dict(kw, i8=i8)
        if i8:
            x = F.pad(x, (0, 0, 0, n_pad)).reshape(b * seq, d)
            bkw.update(seq_len=seq, n_real=n if n_pad else 0)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, **bkw)
        out = ("factored" if mode == "fixed"
               and self.config.engine in ("bf16", "fused") else "value")
        # the cls rows (the slice commutes with the per-tensor factor)
        norm, factor = split(self.ln_final(x, **kw, out=out))
        norm = (norm.reshape(b, seq, -1) if i8 else norm)[:, 0]
        x = norm if factor is None else Factored(norm, factor)
        if _i8_fast(self.head.config, mode, quant_a, quant_w, baked, train_bn):
            x = _s8(materialize(x), self.head)
        return self.head(x, **kw)


def vit_small_quantized(base: LayerQuantConfig,
                        quant_setup: Optional[str] = None,
                        num_classes: int = 1000, device="cuda",
                        **kw) -> QuantizedViT:
    """ViT-S/16 (dim 384, depth 12, 6 heads, MLP ratio 4) at 224x224.
    ``quant_setup='FP_logits'`` keeps the head's logits float32 (JAX
    ``vit_small_quantized``); presets other than ``all`` raise."""
    setup = quant_setup or "all"
    if setup not in ("all", "FP_logits"):
        raise ValueError(f"Quantization setup '{setup}' not supported for "
                         "the ViT (all, FP_logits)")
    head = base.fp32_acts() if setup == "FP_logits" else None
    cfg = dict(patch_size=16, dim=384, depth=12, num_heads=6, mlp_ratio=4)
    cfg.update(kw)
    return QuantizedViT(num_classes=num_classes, config=base,
                        head_config=head, **cfg).to(resolve_device(device))
