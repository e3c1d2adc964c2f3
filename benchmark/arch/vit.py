"""ViT (Dosovitskiy et al., arXiv:2010.11929) in timm's key layout: the
random weights a configuration is measured with, and the operations of a
forward.

``draw`` is a copy of the distribution that the port's
``models/convert.random_vit_state_dict`` draws, made on the device in a
few calls: every linear and the patch conv N(0, 1 / fan_in) with biases
N(0, 0.02^2), the LayerNorm gammas U(0.5, 1.5) and betas N(0, 0.02^2),
``cls_token`` and ``pos_embed`` N(0, 0.02^2), the head N(0, 0.02^2) with
bias 0.  Fan-in scaling keeps the signal's scale through the blocks, so
that the logits depend on the image.

The configuration's ``model`` gives ``dim``, ``depth``, ``heads``,
``mlp_ratio``, ``patch``, ``image_size`` and ``classes``.
"""

from __future__ import annotations

import math

import torch

# the port's random draw this module stands in for (models/convert.py)
PORT_DRAW = "random_vit_state_dict"


def _layout(model: dict):
    """([(key, shape, std of the weight)] of the fan-in-scaled weights,
    [(key, shape)] of the N(0, 0.02^2) tensors, [LayerNorm prefixes])."""
    dim, patch = model["dim"], model["patch"]
    hidden = dim * model["mlp_ratio"]
    tokens = (model["image_size"] // patch) ** 2 + 1
    fan = 3 * patch * patch
    scaled = [("patch_embed.proj.weight", (dim, 3, patch, patch), fan)]
    small = [("cls_token", (1, 1, dim)), ("pos_embed", (1, tokens, dim)),
             ("patch_embed.proj.bias", (dim,))]
    norms = []
    for i in range(model["depth"]):
        t = f"blocks.{i}"
        norms += [f"{t}.norm1", f"{t}.norm2"]
        for name, n_out, n_in in (("attn.qkv", 3 * dim, dim), ("attn.proj", dim, dim),
                                  ("mlp.fc1", hidden, dim), ("mlp.fc2", dim, hidden)):
            scaled.append((f"{t}.{name}.weight", (n_out, n_in), n_in))
            small.append((f"{t}.{name}.bias", (n_out,)))
    norms.append("norm")
    small += [(f"{p}.bias", (dim,)) for p in norms]
    small.append(("head.weight", (model["classes"], dim)))
    return scaled, small, norms


def draw(model: dict, generator: torch.Generator, device) -> dict:
    """The state dict, float32 on ``device``, from ``generator``."""
    scaled, small, norms = _layout(model)
    sizes = [math.prod(s) for _, s, _ in scaled] + [math.prod(s) for _, s in small]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    gammas = torch.rand(len(norms), model["dim"], generator=generator,
                        device=device)
    sd, at = {}, 0
    for key, shape, fan_in in scaled:
        size = math.prod(shape)
        sd[key] = flat[at:at + size].reshape(shape) * math.sqrt(1.0 / fan_in)
        at += size
    for key, shape in small:
        size = math.prod(shape)
        sd[key] = flat[at:at + size].reshape(shape) * 0.02
        at += size
    for i, prefix in enumerate(norms):
        sd[f"{prefix}.weight"] = 0.5 + gammas[i]
    sd["head.bias"] = torch.zeros(model["classes"], device=device)
    return sd


def forward_flops(model: dict) -> float:
    """Operations of one image's forward: 2 per multiply-add of the patch
    embedding, of qkv, proj and the two MLP layers, of attention's two
    products and of the head; elementwise work (LayerNorm, softmax, gelu,
    quantizers, the residual adds) not counted."""
    dim, patch = model["dim"], model["patch"]
    hidden = dim * model["mlp_ratio"]
    patches = (model["image_size"] // patch) ** 2
    n = patches + 1
    block = n * dim * (3 * dim + dim + 2 * hidden) + 2 * n * n * dim
    return 2.0 * (patches * 3 * patch * patch * dim + model["depth"] * block
                  + dim * model["classes"])
