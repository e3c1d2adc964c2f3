"""Quantized ResNet-18/50 on NHWC input.

Mirrors ``fp8_quantization_tpu/models/resnet.py``: torchvision's topology
with every conv+bn(+relu) a BN-fused quantized conv; each residual block
ends add -> relu -> block activation quantizer; the global average pool is
quantized by the tied quantizer of the last block without a range update
(there lines 248-253); the fc is a quantized linear.  Module names follow
the JAX package (``stem``, ``layer{s}_{b}.conv{i}``,
``layer{s}_{b}_downsample``, ``layer{s}_{b}_act``, ``fc``) so that its
variables carry over by path (models/convert.load_jax_variables).

Under ``engine='fused'`` in fixed mode the stem (conv7x7/2 + BN + relu +
maxpool + quant, FP8 or int_asym) runs the qstem kernel once it is baked
and where ``autotune.stem_group`` says so (there lines 132-173), else the
layer path and the pool; under ``quantize_input`` it takes the layer path,
as in JAX (``_conv_fused_state`` returns None).  Under the int8 datapath (nn/layers.int8_datapath) the stem takes
the layer route (``ops/int8.int8_conv``) and ``fmax_pool`` instead, as the
JAX model does when ``_conv_fused_state`` returns None (there lines
146-157, and nn/layers.py:795-799); the block tails and the tied avgpool
quantizer then exchange ``Factored`` integers ``xint - zp``.  In a
prepared model (nn/bake.prepare_inference) the stem kernel takes the
stem's stored fold and output-quant constants.

``stem_s2d`` (there lines 98-105): ``True`` runs the stem as the exact
space-to-depth 4x4/1 conv (ops/s2d.py, nn/layers.QuantConv), ``'input'``
takes images that arrive s2d'd, (N, H/2, W/2, 4C), with the checkpoint
and quantizer state of the default stem.  Either way the stem rides the
general conv path and its maxpool, as in JAX (there line 147): the qstem
kernel is not launched.

The ``quant_setup`` presets are JAX's (there lines 268-299), ``LSQ_paper``
included: input quantization everywhere, an 8-bit stem with fp32
activations, fp32 block-output quantizers, an 8w/8a fc and an untied
avgpool.  Under ``fused`` its 1x1 convs and fc run qmatmul with the input
quantized in the kernel, its stem and 3x3 convs the bf16 path (nn/layers).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from fp8_quantization_tpu_torch.device import resolve_device
from fp8_quantization_tpu_torch.nn.config import LayerQuantConfig
from fp8_quantization_tpu_torch.nn.factored import (
    Factored, fadd, fmax_pool, fmean, materialize, storage_dtype)
from fp8_quantization_tpu_torch.nn.layers import (
    QuantConv, QuantizedActivation, QuantLinear, gated_route,
    layer_weight_spec)
from fp8_quantization_tpu_torch.ops.kernels import autotune, qstem
from fp8_quantization_tpu_torch.utils.timing import span, spanned


class BasicBlockFeatures(nn.Module):
    """conv3x3-bn-relu -> conv3x3-bn (quantized), no residual/act."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int,
                 config: LayerQuantConfig):
        super().__init__()
        self.conv1 = QuantConv(in_features, features, 3, stride, 1, bn=True,
                               activation="relu", config=config)
        self.conv2 = QuantConv(features, features, 3, 1, 1, bn=True,
                               config=config)

    def forward(self, x, **kw):
        return self.conv2(self.conv1(x, **kw), **kw)


class BottleneckFeatures(nn.Module):
    """conv1x1-bn-relu -> conv3x3-bn-relu -> conv1x1-bn (expansion 4)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int,
                 config: LayerQuantConfig):
        super().__init__()
        self.conv1 = QuantConv(in_features, features, 1, 1, 0, bn=True,
                               activation="relu", config=config)
        self.conv2 = QuantConv(features, features, 3, stride, 1, bn=True,
                               activation="relu", config=config)
        self.conv3 = QuantConv(features, features * 4, 1, 1, 0, bn=True,
                               config=config)

    def forward(self, x, **kw):
        return self.conv3(self.conv2(self.conv1(x, **kw), **kw), **kw)


class QuantizedResNet(nn.Module):
    """ResNet-18/50 with per-layer quantization configs."""

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool,
                 num_classes: int = 1000,
                 config: LayerQuantConfig = LayerQuantConfig(),
                 stem_config: Optional[LayerQuantConfig] = None,
                 fc_config: Optional[LayerQuantConfig] = None,
                 last_block_config: Optional[LayerQuantConfig] = None,
                 block_act_config: Optional[LayerQuantConfig] = None,
                 tie_avgpool: bool = True, stem_s2d: Union[bool, str] = False):
        super().__init__()
        self.config = config
        self.stage_sizes = tuple(stage_sizes)
        self.tie_avgpool = tie_avgpool
        self.stem_s2d = stem_s2d
        self.stem = QuantConv(3, 64, 7, 2, 3, bn=True, activation="relu",
                              config=stem_config or config, s2d=stem_s2d)
        block_cls = BottleneckFeatures if bottleneck else BasicBlockFeatures
        widths = (64, 128, 256, 512)
        num_blocks = sum(self.stage_sizes)
        self.block_names = []
        in_feats, idx = 64, 0
        for stage, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                last = idx == num_blocks - 1
                bcfg = (last_block_config or config) if last else config
                ba_cfg = (last_block_config or block_act_config or config
                          if last else block_act_config or config)
                stride = 2 if (stage > 0 and b == 0) else 1
                width = widths[stage]
                out_feats = width * block_cls.expansion
                name = f"layer{stage + 1}_{b}"
                if stride != 1 or in_feats != out_feats:
                    self.add_module(f"{name}_downsample", QuantConv(
                        in_feats, out_feats, 1, stride, 0, bn=True,
                        config=config))
                self.add_module(name, block_cls(in_feats, width, stride, bcfg))
                self.add_module(f"{name}_act", QuantizedActivation(ba_cfg))
                self.block_names.append(name)
                in_feats, idx = out_feats, idx + 1
        self.fc = QuantLinear(in_feats, num_classes, use_bias=True,
                              config=fc_config or config)

    def input_shape(self, image_shape) -> tuple:
        """The shape of the input this model takes for NHWC images of
        ``image_shape``: under ``stem_s2d='input'`` they come
        space-to-depth'd, (N, H/2, W/2, 4C) (ops/s2d.py)."""
        n, h, w, c = image_shape
        if self.stem_s2d == "input":
            return (n, h // 2, w // 2, 4 * c)
        return tuple(image_shape)

    def weight_spec_fn(self):
        """Module path -> the weight QuantizerSpec of the layer there, as
        the preset configures it (fc4's 4-bit fc and 8-bit stem, ...; JAX
        ``weight_spec_fn``), for training/oscillation.py."""
        return layer_weight_spec(self)

    def _fused_stem(self, x, mode, quant_w, quant_a, train_bn, out):
        """The qstem kernel route as a call, or None where the layer + pool
        path is the only one."""
        if (mode != "fixed" or train_bn or self.config.engine != "fused"
                or isinstance(x, Factored) or self.stem_s2d or x.ndim != 4
                or x.shape[1] != x.shape[2] or x.shape[-1] > 4):
            return None
        st = self.stem.fused_state(quant_w, quant_a)
        if st is None:
            return None

        def launch():
            emit = (out == "factored" and st["a_method"] != "none"
                    and st["factored_ok"])
            kcfg = qstem.FusedStemConfig(act_method=st["a_method"],
                                         emit_norm=emit)
            y = qstem.fused_quant_stem(
                x.contiguous(), self.stem.stem_operand(), st["a_consts"],
                st["scale"].contiguous(), st["shift"].contiguous(), cfg=kcfg)
            # the kernel emits bfloat16, so this store changes nothing: it
            # mirrors JAX's storage_dtype at the same place
            return Factored(storage_dtype(y), st["factor"]) if emit else y
        return launch

    @spanned("forward")
    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False):
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a, train_bn=train_bn)
        out = "value"
        if mode == "fixed" and self.config.engine in ("bf16", "fused"):
            out = kw["out"] = "factored"

        def layer_path():
            return fmax_pool(self.stem(x, **kw), 3, 2, 1)

        # the stem layer, on either route: the kernel, or its conv and pool
        with span("layer"):
            launch = self._fused_stem(x, mode, quant_w, quant_a, train_bn,
                                      out)
            if launch is None:
                x = layer_path()
            else:
                n, s, _, cin = x.shape
                x = gated_route(self, lambda **routes: autotune.stem_group(
                    n, s, cin, self.stem.features, 1, like=x, **routes)[0] > 0,
                    launch, layer_path)

        last_q = None
        for name in self.block_names:
            downsample = getattr(self, f"{name}_downsample", None)
            residual = x if downsample is None else downsample(x, **kw)
            y = getattr(self, name)(x, **kw)
            with span("residual"):
                y = torch.relu(fadd(y, residual))
            last_q = getattr(self, f"{name}_act")
            x = last_q(y, mode=mode, quant_a=quant_a, out=out)

        x = fmean(x, axis=(1, 2))
        if self.tie_avgpool and last_q is not None:
            x = last_q(x, mode=mode, quant_a=quant_a, update_range=False, out=out)
        x = self.fc(x, **{**kw, "out": "value"})
        return materialize(x)


def resnet_configs(base: LayerQuantConfig, quant_setup: Optional[str]) -> dict:
    """quant_setup presets -> per-layer config overrides."""
    setup = quant_setup or "all"
    cfgs = dict(config=base, stem_config=None, fc_config=None,
                last_block_config=None, block_act_config=None, tie_avgpool=True)
    if setup == "all":
        return cfgs
    if setup == "FP_logits":
        cfgs["fc_config"] = base.fp32_acts()
        return cfgs
    if setup == "fc4":
        cfgs["stem_config"] = base.with_weight_bits(8)
        cfgs["fc_config"] = base.with_weight_bits(4)
        return cfgs
    if setup == "LSQ":
        cfgs["stem_config"] = base.with_weight_bits(8)
        cfgs["last_block_config"] = base.with_act_bits(8)
        cfgs["fc_config"] = base.with_weight_bits(8).fp32_acts()
        return cfgs
    if setup == "LSQ_paper":
        # input quantization everywhere; the stem 8-bit weights and fp32
        # activations; the block-output quantizers fp32 (the convs' input
        # quantizers stay); the fc 8w/8a; the avgpool untied
        qin = base.replace(quantize_input=True)
        cfgs["config"] = qin
        cfgs["stem_config"] = qin.with_weight_bits(8).fp32_acts()
        cfgs["block_act_config"] = qin.fp32_acts()
        cfgs["fc_config"] = qin.with_weight_bits(8).with_act_bits(8)
        cfgs["tie_avgpool"] = False
        return cfgs
    raise ValueError(f"Quantization setup '{setup}' not supported for Resnet")


def resnet18_quantized(base: LayerQuantConfig, quant_setup: Optional[str] = None,
                       num_classes: int = 1000, device="cuda",
                       stem_s2d: Union[bool, str] = False) -> QuantizedResNet:
    return QuantizedResNet((2, 2, 2, 2), False, num_classes, stem_s2d=stem_s2d,
                           **resnet_configs(base, quant_setup)).to(
                               resolve_device(device))


def resnet50_quantized(base: LayerQuantConfig, quant_setup: Optional[str] = None,
                       num_classes: int = 1000, device="cuda",
                       stem_s2d: Union[bool, str] = False) -> QuantizedResNet:
    return QuantizedResNet((3, 4, 6, 3), True, num_classes, stem_s2d=stem_s2d,
                           **resnet_configs(base, quant_setup)).to(
                               resolve_device(device))


QUANT_ARCHITECTURES = {"resnet18_quantized": resnet18_quantized,
                       "resnet50_quantized": resnet50_quantized}
