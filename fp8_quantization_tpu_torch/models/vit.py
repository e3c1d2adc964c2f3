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

Not ported: the int8 stream layout (``seq_len``/``n_real``, the key mask,
``PrequantS8``, ``_i8_fast``; building the ViT under the int8 datapath
raises) and the presets other than ``all`` and ``FP_logits``, which raise
where JAX ignores them (ROADMAP.md, section C).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn

from fp8_quantization_tpu_torch.device import resolve_device
from fp8_quantization_tpu_torch.nn.config import LayerQuantConfig
from fp8_quantization_tpu_torch.nn.factored import Factored, fadd, split
from fp8_quantization_tpu_torch.nn.layers import (
    QuantConv, QuantizedActivation, QuantLayerNorm, QuantLinear,
    gated_route, int8_datapath)
from fp8_quantization_tpu_torch.ops.kernels import attention, autotune


def composed_attention(q, k, v) -> torch.Tensor:
    """The float32 chain of JAX (there lines 117-125): ``softmax(q k^T /
    sqrt(hd)) v`` with the softmax as ``jax.nn.softmax`` computes it."""
    hd = torch.tensor(float(q.shape[-1]), dtype=torch.float32, device=q.device)
    a = (q @ k.transpose(-1, -2)) / torch.sqrt(hd)
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
                quant_a: bool = True):
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a)
        qkv = self.qkv(x, **kw)
        b, n, _ = qkv.shape
        h = self.num_heads
        hd = self.dim // h
        # (B, H, S, hd) views of the (B, S, 3, H, hd) qkv output
        q, k, v = (qkv.reshape(b, n, 3, h, hd)[:, :, i].transpose(1, 2)
                   for i in range(3))
        if mode == "fixed" and self.config.engine == "fused":
            y = gated_route(
                self, partial(autotune.attn_wins, b, h, n, hd, like=q),
                lambda: attention.flash_mha(q, k, v,
                                            sm_scale=1.0 / float(hd) ** 0.5),
                lambda: composed_attention(q, k, v))
        else:
            y = composed_attention(q, k, v)
        return self.proj(y.transpose(1, 2).reshape(b, n, self.dim), **kw)


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
                quant_a: bool = True):
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a)
        out = ("factored" if mode == "fixed"
               and self.config.engine in ("bf16", "fused") else "value")
        y = self.attn(self.ln1(x, **kw, out=out), **kw)
        x = self.res1_act(fadd(x, y), mode=mode, quant_a=quant_a, out=out)
        y = self.mlp2(self.mlp1(self.ln2(x, **kw, out=out), **kw, out=out),
                      **kw)
        return self.res2_act(fadd(x, y), mode=mode, quant_a=quant_a, out=out)


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
        for cfg in (config, head_config):
            if cfg is not None and int8_datapath(cfg):
                raise NotImplementedError(
                    "the ViT on the int8 datapath (the padded token layout, "
                    "the key mask, PrequantS8) is not ported yet (ROADMAP.md, "
                    "section A, item \"ViT INT8\")")
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
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, **kw)
        out = ("factored" if mode == "fixed"
               and self.config.engine in ("bf16", "fused") else "value")
        # the cls rows (the slice commutes with the per-tensor factor)
        norm, factor = split(self.ln_final(x, **kw, out=out))
        x = norm[:, 0] if factor is None else Factored(norm[:, 0], factor)
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
