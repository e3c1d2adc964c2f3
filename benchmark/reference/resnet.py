"""Plain reference of the quantized bottleneck ResNet (torchvision's v1.5
of He et al., arXiv:1512.03385: the stride on each block's 3x3 conv), FP8
post-training quantization, float32.

Takes a state dict in torchvision's key layout (``conv1``, ``bn1``,
``layer{s}.{b}.conv{i}`` / ``bn{i}``, ``layer{s}.{b}.downsample.{0,1}``,
``fc``) and infers the stages and blocks from its keys.  Every conv and the
fc take their weight on its per-channel FP8 grid; every conv is followed by
its BN on the running statistics, its relu where torchvision has one, and
its output quant; a block adds its branch to the (downsampled) residual,
takes the relu and its block quant; the global average pool is quantized by
the last block's quantizer without a range update; the fc's output (the
logits) is quantized too.  The stem's max pool follows its output quant
(the quant is monotone, so the two commute).  Tensors are NCHW here.

``calibrate`` sets the ranges from a calibration batch, ``__call__`` is
the fixed forward; ``quant.Quant`` says how each product's operands are
held (the configuration's bf16 datapath, or the control's e4m3).  This
module imports nothing of the program.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from benchmark.reference.quant import Quant, float32_products

BN_EPS = 1e-5


class ResNet:
    def __init__(self, sd: dict, mbits: int = 4, datapath: str = "bf16",
                 wide: bool = False):
        self.sd = {k: v.to(torch.float32) for k, v in sd.items()
                   if not k.endswith("num_batches_tracked")}
        self.q = Quant(mbits, datapath, wide)
        blocks = sorted({tuple(int(v) for v in m.groups())
                         for m in (re.match(r"layer(\d+)\.(\d+)\.", k)
                                   for k in self.sd) if m})
        self.blocks = [f"layer{s}.{b}" for s, b in blocks]

    def _bn(self, y, prefix):
        sd = self.sd
        inv = torch.rsqrt(sd[f"{prefix}.running_var"] + BN_EPS) * sd[f"{prefix}.weight"]
        shift = sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * inv
        return y * inv[:, None, None] + shift[:, None, None]

    def _conv(self, x, conv, bn, stride, padding, relu, on_grid=True):
        q = self.q
        w = q.operand(q.weight(conv, self.sd[f"{conv}.weight"]), True, 0)
        y = q.conv2d(q.operand(x, on_grid), w, stride=stride, padding=padding)
        y = self._bn(y, bn)
        if relu:
            y = torch.relu(y)
        return q.act(conv, y)

    def _block(self, x, name, stride):
        y = x
        for i, s, p in ((1, 1, 0), (2, stride, 1), (3, 1, 0)):
            y = self._conv(y, f"{name}.conv{i}", f"{name}.bn{i}", s, p, relu=i < 3)
        residual = x
        if f"{name}.downsample.0.weight" in self.sd:
            residual = self._conv(x, f"{name}.downsample.0",
                                  f"{name}.downsample.1", stride, 0, relu=False)
        return self.q.act(f"{name}.act", torch.relu(y + residual))

    def _forward(self, images):
        """``images`` NHWC float32 -> logits (N, classes)."""
        q = self.q
        x = images.permute(0, 3, 1, 2)
        x = self._conv(x, "conv1", "bn1", 2, 3, relu=True, on_grid=False)
        x = F.max_pool2d(x, 3, 2, 1)
        stage_seen = set()
        for name in self.blocks:
            stage = name.split(".")[0]
            stride = 2 if stage != "layer1" and stage not in stage_seen else 1
            stage_seen.add(stage)
            x = self._block(x, name, stride)
        x = q.act(f"{self.blocks[-1]}.act", x.mean(dim=(2, 3)), update=False)
        w = q.operand(q.weight("fc", self.sd["fc.weight"]), True, 0)
        return q.act("fc", q.matmul(q.operand(x, True), w.t()) + self.sd["fc.bias"])

    @torch.no_grad()
    def calibrate(self, images):
        self.q.calibrating = True
        try:
            with float32_products():
                self._forward(images)
        finally:
            self.q.calibrating = False

    @torch.no_grad()
    def __call__(self, images):
        with float32_products():
            return self._forward(images)


def build(model: dict, sd: dict, mbits: int, datapath: str = "bf16",
          wide: bool = False) -> ResNet:
    """The reference of a configuration's ``model`` (its stages come from
    the state dict's keys)."""
    return ResNet(sd, mbits, datapath, wide)
