"""The port's counterpart of tests/_tiny.py's TinyModel: conv-bn-relu ->
conv-bn-relu -> global mean -> linear, all quantized, with the JAX model's
module names, so that models/convert.load_jax_variables carries a JAX
TinyModel's variables into it."""

import torch
from torch import nn

from fp8_quantization_tpu_torch.nn.config import LayerQuantConfig
from fp8_quantization_tpu_torch.nn.factored import fmean, materialize
from fp8_quantization_tpu_torch.nn.layers import QuantConv, QuantLinear


class TinyModel(nn.Module):
    """conv-bn-relu -> conv-bn-relu -> gap -> linear, all quantized."""

    def __init__(self, config: LayerQuantConfig, num_classes: int = 4,
                 width: int = 8, in_channels: int = 3):
        super().__init__()
        self.config = config
        self.conv1 = QuantConv(in_channels, width, 3, 2, 1, bn=True,
                               activation="relu", config=config)
        self.conv2 = QuantConv(width, width * 2, 3, 2, 1, bn=True,
                               activation="relu", config=config)
        self.fc = QuantLinear(width * 2, num_classes, use_bias=True,
                              config=config)

    def input_shape(self, image_shape) -> tuple:
        return tuple(image_shape)

    def forward(self, x, mode: str = "fixed", quant_w: bool = True,
                quant_a: bool = True, train_bn: bool = False):
        kw = dict(mode=mode, quant_w=quant_w, quant_a=quant_a,
                  train_bn=train_bn)
        # the zoo models' factored interchange on the fast engines
        if mode == "fixed" and self.config.engine in ("bf16", "fused"):
            kw["out"] = "factored"
        x = self.conv2(self.conv1(x, **kw), **kw)
        x = fmean(x, axis=(1, 2))
        x = self.fc(x, **{**kw, "out": "value"})
        return materialize(x)


def tiny_model(config: LayerQuantConfig, **kw) -> TinyModel:
    torch.manual_seed(0)
    return TinyModel(config, **kw)
