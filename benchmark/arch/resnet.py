"""The bottleneck ResNet as torchvision defines it (v1.5: He et al.,
arXiv:1512.03385, with each block's stride on its 3x3 conv), in
torchvision's key layout: the random weights a configuration is measured
with, and the operations of a forward.

``draw`` is a copy of the distribution that the port's
``models/convert.random_resnet_state_dict`` draws, made on the device in a
few calls: bottleneck convs N(0, 2 / fan_in) less their output channel's
mean (each filter sums to zero), the last BN of each bottleneck with gamma
U(0.1, 0.3), so that each block is a correction of the residual stream and
the logits depend on the image; every other BN gamma and running variance U(0.5, 1.5), beta and running mean
N(0, 0.1^2); the fc N(0, 0.02^2) with bias 0.

The configuration's ``model`` gives ``stages`` (blocks per stage),
``widths`` (each stage's; a block's output is 4 times its width),
``classes`` and ``image_size``.
"""

from __future__ import annotations

import math

import torch

# the port's random draw this module stands in for (models/convert.py)
PORT_DRAW = "random_resnet_state_dict"


def conv_shapes(model: dict):
    """[(key prefix, (Cout, Cin, k, k), stride, input height, bn prefix,
    gamma range)] of every conv, in torchvision's order, and the fc's input
    width."""
    size = model["image_size"]
    convs = [("conv1", (64, 3, 7, 7), 2, size, "bn1", (0.5, 1.5))]
    h = ((size - 1) // 2) // 2 + 1          # after the stem and its max pool
    cin = 64
    for stage, n_blocks in enumerate(model["stages"]):
        width = model["widths"][stage]
        for b in range(n_blocks):
            t = f"layer{stage + 1}.{b}"
            stride = 2 if (stage > 0 and b == 0) else 1
            h_out = (h - 1) // stride + 1
            shapes = [((width, cin, 1, 1), 1, h), ((width, width, 3, 3), stride, h),
                      ((width * 4, width, 1, 1), 1, h_out)]
            for i, (shape, s, h_in) in enumerate(shapes, 1):
                convs.append((f"{t}.conv{i}", shape, s, h_in, f"{t}.bn{i}",
                              (0.1, 0.3) if i == 3 else (0.5, 1.5)))
            if stride != 1 or cin != width * 4:
                convs.append((f"{t}.downsample.0", (width * 4, cin, 1, 1), stride,
                              h, f"{t}.downsample.1", (0.5, 1.5)))
            cin, h = width * 4, h_out
    return convs, cin


def draw(model: dict, generator: torch.Generator, device) -> dict:
    """The state dict, float32 on ``device``, from ``generator``."""
    convs, feats = conv_shapes(model)
    classes = model["classes"]
    sizes = [math.prod(shape) for _, shape, _, _, _, _ in convs]
    flat = torch.randn(sum(sizes) + classes * feats, generator=generator,
                       device=device)
    channels = sum(shape[0] for _, shape, _, _, _, _ in convs)
    bn = torch.rand(2, channels, generator=generator, device=device)
    bn_normal = torch.randn(2, channels, generator=generator, device=device)
    sd, at, ch = {}, 0, 0
    for (key, shape, _, _, bn_key, (lo, hi)), size in zip(convs, sizes):
        w = flat[at:at + size].reshape(shape) * math.sqrt(2.0 / math.prod(shape[1:]))
        at += size
        sd[f"{key}.weight"] = w - w.reshape(shape[0], -1).mean(dim=1).reshape(-1, 1, 1, 1)
        c = shape[0]
        sd[f"{bn_key}.weight"] = lo + (hi - lo) * bn[0, ch:ch + c]
        sd[f"{bn_key}.bias"] = 0.1 * bn_normal[0, ch:ch + c]
        sd[f"{bn_key}.running_mean"] = 0.1 * bn_normal[1, ch:ch + c]
        sd[f"{bn_key}.running_var"] = 0.5 + bn[1, ch:ch + c]
        ch += c
    sd["fc.weight"] = 0.02 * flat[at:].reshape(classes, feats)
    sd["fc.bias"] = torch.zeros(classes, device=device)
    return sd


def forward_flops(model: dict) -> float:
    """Operations of one image's forward: 2 per multiply-add of every conv
    and of the fc; elementwise work (BN, relu, quantizers, pools, the
    residual adds) not counted."""
    convs, feats = conv_shapes(model)
    total = 2.0 * feats * model["classes"]
    for _, (cout, cin, k, _), stride, h_in, _, _ in convs:
        h_out = (h_in + 2 * (k // 2) - k) // stride + 1
        total += 2.0 * h_out * h_out * cout * cin * k * k
    return total
