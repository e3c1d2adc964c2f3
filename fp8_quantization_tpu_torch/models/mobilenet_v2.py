"""Quantized MobileNetV2 (the tonylins variant) on NHWC input.

Mirrors ``fp8_quantization_tpu/models/mobilenet_v2.py``: every conv+bn
(+relu6) is a BN-fused quantized conv; a residual block ends add -> block
activation quantizer; the head's output quantizer is hoisted to the model
(``head_act``) and tied to the average pool without a range update (there
lines 262-278); the classifier is a quantized linear.  Module names are the
JAX scope names (``stem``, ``block{i}_{b}.{expand,dw,project,block_act}``,
``head``, ``head_act``, ``classifier``), so that its variables carry over
by path (models/convert.load_jax_variables).  The classifier's dropout
(``dropout_rate``, JAX there lines 206-210, 280-290; 0 by default, so
inference is as before) acts in training forwards (``train_bn``) only and
draws its mask from the model's ``dropout_generator``, never from the
global random state; a ``Factored`` input keeps its factor (dropout
scales by 1/keep, which commutes with it).  ``weight_spec_fn`` resolves a
layer's module path to its weight spec under the preset (JAX there lines
212-234), for training/oscillation.py.  ``width_mult`` scales every
channel count by ``int(c * width_mult)``, with no divisor rounding, and the
head's 1280 only above 1 (JAX there lines 195, 243-252, 348-351).  The
presets are JAX's: ``all``, ``FP_logits``, ``fc4``, ``fc4_dw8``,
``dw_bf16_acts``, ``LSQ`` and ``LSQ_paper`` (input quant everywhere,
float32 block activations, an 8-bit stem and classifier and the avgpool
untied from the head's quantizer, ``tie_avgpool=False``).

On the int8 datapath (``int8_mxu`` + ``quantize_input``) every layer runs
its int8 route (nn/layers.py): the stem (3x3/2, Cin 3) and the depthwise
convs ``ops/int8.int8_conv`` (grouped), the 1x1s and the classifier
``qmatmul_int8`` under ``fused``; qblock and qdwconv3x3 are not taken under
``quantize_input`` or ``int8_mxu``, as in JAX (nn/layers.py:795-797, 987).

Under ``engine='fused'`` in fixed mode a block whose stages are all baked
runs ``ops/kernels/qblock`` as one kernel where ``autotune.ir_group`` says
so (there lines 86-190), each stage with its own output quant (FP8,
int_asym or none): each stage's scale comes from the layer's own ``_fold``
with the upstream factor folded in (the block input's factor to expand, or
to dw in a t=1 block; the expand output's factor to dw; dw's to project).
Otherwise, and under folded BN (``fused_state`` returns None there, JAX
nn/layers.py:795-799), the block runs layer by layer, each layer behind
its own gate: the 1x1 convs on ``qmatmul``, the depthwise convs on
``qdwconv``; so does a block whose widths qblock does not take
(``qblock.channels_ok``: multiples of 8, which width_mult 1.4 breaks).  The stem (Cin = 3) stays
on the composed path, as in JAX.  A prepared block
(nn/bake.prepare_inference) keeps its stages' constants as one ``(6, 4)``
buffer.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn

from fp8_quantization_tpu_torch.device import resolve_device
from fp8_quantization_tpu_torch.nn.config import LayerQuantConfig
from fp8_quantization_tpu_torch.nn.factored import (
    Factored, fadd, fmean, materialize, split, storage_dtype)
from fp8_quantization_tpu_torch.nn.layers import (
    QuantConv, QuantizedActivation, QuantLinear, gated_route,
    layer_weight_spec)
from fp8_quantization_tpu_torch.nn.quantizers import preparing
from fp8_quantization_tpu_torch.ops.kernels import autotune, qblock
from fp8_quantization_tpu_torch.parallel import collectives

# (expand ratio t, channels c, repeats n, stride s), the reference's table
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class QuantInvertedResidual(nn.Module):
    """[expand 1x1 + relu6] -> dw 3x3 + relu6 -> project 1x1, with a
    residual and the block quantizer when stride is 1 and the width stays."""

    def __init__(self, in_features: int, features: int, stride: int,
                 expand_ratio: int, config: LayerQuantConfig,
                 dw_config: Optional[LayerQuantConfig] = None,
                 expand_config: Optional[LayerQuantConfig] = None,
                 block_act_config: Optional[LayerQuantConfig] = None):
        super().__init__()
        hidden = round(in_features * expand_ratio)
        self.config, self.stride = config, stride
        self.use_res = stride == 1 and in_features == features
        self.expand = None
        if expand_ratio != 1:
            self.expand = QuantConv(in_features, hidden, 1, 1, 0, bn=True,
                                    activation="relu6",
                                    config=expand_config or config)
        self.dw = QuantConv(hidden, hidden, 3, stride, 1, bn=True,
                            activation="relu6", config=dw_config or config,
                            groups=hidden)
        self.project = QuantConv(hidden, features, 1, 1, 0, bn=True,
                                 config=config)
        if self.use_res:
            self.block_act = QuantizedActivation(block_act_config or config)
        # the qblock route's (6, 4) stage constants, stored by the prepare
        # pass (nn/bake.prepare_inference) with the stages' methods
        self.register_buffer("prep_consts", None)
        self._prep_methods = None

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False,
                out: str = "value"):
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a,
                  train_bn=train_bn, out=out)

        def layers():
            y = x
            if self.expand is not None:
                y = self.expand(y, **kw)
            y = self.project(self.dw(y, **kw), **kw)
            if self.use_res:
                y = self.block_act(fadd(x, y), mode=mode, quant_a=quant_a,
                                   out=out)
            return y

        if mode == "fixed" and not train_bn and self.config.engine == "fused":
            launch = self._fused_forward(x, quant_w, quant_a, out)
            if launch is not None:
                xv = split(x)[0]
                n, h, _, cin = xv.shape
                return gated_route(self, partial(
                    autotune.ir_group, n, h, cin, self.dw.features,
                    self.project.features, 1, stride=self.stride,
                    expand=self.expand is not None, use_res=self.use_res,
                    like=xv), launch, layers)
        return layers()

    def _fused_forward(self, x, quant_w, quant_a, out):
        """The qblock kernel route as a call, or None where the per-layer
        path is the only one."""
        xv, xf = split(x)
        if xv.ndim != 4 or xv.shape[-1] < 8 or not qblock.channels_ok(
                xv.shape[-1], self.dw.features, self.project.features):
            return None
        _, h, w, _ = xv.shape
        if self.stride == 2 and (h % 2 or w % 2):
            return None
        st1 = None
        if self.expand is not None:
            st1 = self.expand.fused_state(quant_w, quant_a, xf)
            if st1 is None:
                return None
        std = self.dw.fused_state(quant_w, quant_a,
                                  xf if st1 is None else st1["factor"])
        if std is None:
            return None
        stp = self.project.fused_state(quant_w, quant_a, std["factor"])
        if stp is None:
            return None
        stb = self.block_act.fused_state(quant_a) if self.use_res else None
        return lambda: self._launch(xv, xf, (st1, std, stp, stb), out)

    def _launch(self, xv, xf, stages, out):
        """qblock on the input norms ``xv`` (factor ``xf``) with the stages'
        fused states."""
        st1, std, stp, stb = stages
        final = stb if self.use_res else stp
        emit = (out == "factored" and final["a_method"] != "none"
                and final["factored_ok"])
        methods = tuple("none" if st is None else st["a_method"]
                        for st in stages)
        if (self.prep_consts is not None and self._prep_methods == methods
                and not preparing(self)):
            consts = self.prep_consts
        else:
            dummy = torch.zeros((6, 1), device=xv.device)
            consts = torch.cat([dummy if st is None or st["a_consts"] is None
                                else st["a_consts"] for st in stages], dim=1)
            if preparing(self):
                self.prep_consts, self._prep_methods = consts, methods
        cfg = qblock.FusedBlockConfig(
            expand=st1 is not None, stride=self.stride, use_res=self.use_res,
            emit_norm=emit, methods=methods)
        y = qblock.fused_inverted_residual(
            xv.to(torch.bfloat16).contiguous(),
            None if st1 is None else st1["w"], std["w"], stp["w"],
            consts.contiguous(),
            None if st1 is None else st1["scale"].contiguous(),
            None if st1 is None else st1["shift"].contiguous(),
            std["scale"].contiguous(), std["shift"].contiguous(),
            stp["scale"].contiguous(), stp["shift"].contiguous(),
            x_factor=xf if self.use_res else None, cfg=cfg)
        # the kernel emits bfloat16, so this store changes nothing: it
        # mirrors JAX's storage_dtype at the same place
        return Factored(storage_dtype(y), final["factor"]) if emit else y


class QuantizedMobileNetV2(nn.Module):
    """MobileNetV2 with per-layer quantization configs."""

    def __init__(self, num_classes: int = 1000,
                 settings=INVERTED_RESIDUAL_SETTING,
                 config: LayerQuantConfig = LayerQuantConfig(),
                 width_mult: float = 1.0, tie_avgpool: bool = True,
                 stem_config: Optional[LayerQuantConfig] = None,
                 head_config: Optional[LayerQuantConfig] = None,
                 fc_config: Optional[LayerQuantConfig] = None,
                 dw_config: Optional[LayerQuantConfig] = None,
                 expand_config: Optional[LayerQuantConfig] = None,
                 block_act_config: Optional[LayerQuantConfig] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.config = config
        self.dropout_rate = dropout_rate
        self.dropout_generator: Optional[torch.Generator] = None
        self.settings = tuple(tuple(s) for s in settings)
        self.width_mult, self.tie_avgpool = width_mult, tie_avgpool
        input_channel = int(32 * width_mult)
        last_channel = int(1280 * width_mult) if width_mult > 1.0 else 1280
        self.stem = QuantConv(3, input_channel, 3, 2, 1, bn=True,
                              activation="relu6", config=stem_config or config)
        self.block_names = []
        cin = input_channel
        for i, (t, c, n, s) in enumerate(self.settings):
            c = int(c * width_mult)
            for b in range(n):
                name = f"block{i}_{b}"
                self.add_module(name, QuantInvertedResidual(
                    cin, c, s if b == 0 else 1, t, config, dw_config,
                    expand_config, block_act_config))
                self.block_names.append(name)
                cin = c
        self.head_config = head_config or config
        self.head = QuantConv(cin, last_channel, 1, 1, 0, bn=True,
                              activation="relu6",
                              config=(self.head_config.fp32_acts()
                                      if not self.head_config.quantize_input
                                      else self.head_config))
        self.head_act = QuantizedActivation(self.head_config)
        self.classifier = QuantLinear(last_channel, num_classes, use_bias=True,
                                      config=fc_config or config)

    def input_shape(self, image_shape) -> tuple:
        """The shape of the input this model takes: the NHWC images'."""
        return tuple(image_shape)

    def weight_spec_fn(self):
        """Module path -> the weight QuantizerSpec of the layer there, as
        the preset configures it (fc4_dw8's 8-bit depthwise convs and 4-bit
        classifier, ...)."""
        return layer_weight_spec(self)

    def _dropout(self, x):
        """Inverted dropout with keep probability 1 - rate (flax
        ``nn.Dropout``), the mask from ``dropout_generator`` (under data
        parallelism this rank's rows of the global batch's mask)."""
        if self.dropout_generator is None:
            raise ValueError("dropout in a training forward needs the "
                             "model's dropout_generator")
        norm, factor = split(x)
        keep_prob = 1.0 - self.dropout_rate
        keep = collectives.rand_rows(norm.shape, self.dropout_generator,
                                     device=norm.device) < keep_prob
        y = torch.where(keep, norm / keep_prob, torch.zeros_like(norm))
        return y if factor is None else Factored(y, factor)

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False):
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a, train_bn=train_bn)
        out = "value"
        if mode == "fixed" and self.config.engine in ("bf16", "fused"):
            out = kw["out"] = "factored"
        x = self.stem(x, **kw)
        for name in self.block_names:
            x = getattr(self, name)(x, **kw)
        x = self.head(x, **kw)
        quant_head = not self.head_config.quantize_input
        if quant_head:
            x = self.head_act(x, mode=mode, quant_a=quant_a, out=out)
        x = fmean(x, axis=(1, 2))
        if quant_head and self.tie_avgpool:
            x = self.head_act(x, mode=mode, quant_a=quant_a,
                              update_range=False, out=out)
        if self.dropout_rate > 0.0 and train_bn:
            x = self._dropout(x)
        x = self.classifier(x, **{**kw, "out": "value"})
        return materialize(x)


def mobilenet_v2_configs(base: LayerQuantConfig,
                         quant_setup: Optional[str]) -> dict:
    """quant_setup presets -> per-layer config overrides (JAX
    ``mobilenet_v2_configs``)."""
    setup = quant_setup or "all"
    cfgs = dict(config=base, stem_config=None, head_config=None,
                fc_config=None, dw_config=None, expand_config=None,
                block_act_config=None, tie_avgpool=True)
    if setup == "all":
        return cfgs
    if setup == "FP_logits":
        cfgs["fc_config"] = base.fp32_acts()
        return cfgs
    if setup in ("fc4", "fc4_dw8"):
        cfgs["stem_config"] = base.with_weight_bits(8)
        cfgs["fc_config"] = base.with_weight_bits(4)
        if setup == "fc4_dw8":
            cfgs["dw_config"] = base.with_weight_bits(8)
        return cfgs
    if setup == "dw_bf16_acts":
        # weights quantized everywhere, activations everywhere but the
        # expand -> dw chain
        cfgs["expand_config"] = base.fp32_acts()
        cfgs["dw_config"] = base.fp32_acts()
        return cfgs
    if setup == "LSQ":
        cfgs["stem_config"] = base.with_weight_bits(8)
        cfgs["head_config"] = base.with_act_bits(8)
        cfgs["fc_config"] = base.with_weight_bits(8).fp32_acts()
        return cfgs
    if setup == "LSQ_paper":
        qin = base.replace(quantize_input=True)
        cfgs["config"] = qin
        cfgs["stem_config"] = qin.with_weight_bits(8).fp32_acts()
        cfgs["head_config"] = qin
        cfgs["block_act_config"] = qin.fp32_acts()
        cfgs["fc_config"] = qin.with_weight_bits(8).with_act_bits(8)
        cfgs["tie_avgpool"] = False
        return cfgs
    raise ValueError(f"Quantization setup '{setup}' not supported for "
                     "MobilenetV2")


def mobilenetv2_quantized(base: LayerQuantConfig,
                          quant_setup: Optional[str] = None,
                          num_classes: int = 1000,
                          settings=INVERTED_RESIDUAL_SETTING,
                          device="cuda", dropout_rate: float = 0.0,
                          width_mult: float = 1.0) -> QuantizedMobileNetV2:
    return QuantizedMobileNetV2(num_classes, settings,
                                **mobilenet_v2_configs(base, quant_setup),
                                width_mult=width_mult,
                                dropout_rate=dropout_rate).to(
                                    resolve_device(device))
