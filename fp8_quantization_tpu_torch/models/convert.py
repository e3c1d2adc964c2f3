"""Checkpoint loading and weight carry-over for the port's models.

Counterpart of ``fp8_quantization_tpu/models/convert.py`` (whose
torchvision and tonylins key maps it follows, there lines 20-111) and of
the random checkpoints of ``tools/dress_rehearsal.py`` (lines 39-105):

* ``load_torchvision_resnet``: a torchvision ResNet state dict (numpy or
  torch values, e.g. from ``load_torch_state_dict``) into a
  ``QuantizedResNet``;
* ``load_tonylins_mobilenet_v2``: a tonylins MobileNetV2 state dict into a
  ``QuantizedMobileNetV2``;
* ``load_timm_vit``: a timm ``vit_small_patch16_224``-layout state dict
  into a ``QuantizedViT`` (JAX ``convert_vit``, there lines 114-153);
* ``random_resnet_state_dict`` / ``random_mobilenet_v2_state_dict`` /
  ``random_vit_state_dict``: random state dicts in those layouts, made with
  numpy from a seed;
* ``load_jax_variables``: the JAX package's variables (nested dicts of
  numpy arrays: ``params`` with HWIO kernels, ``batch_stats``, the
  ``quant`` collection, ``baked`` and ``baked_int8``) into the port's
  modules, so that a model calibrated or baked in JAX computes the same
  thing here.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from fp8_quantization_tpu_torch.nn.layers import (
    QuantizedActivation, QuantizedLayerBase, QuantLayerNorm)
from fp8_quantization_tpu_torch.ops.fp8 import CAST_CONST_ROWS, FP8_CONST_ROWS

Arrays = Dict[str, np.ndarray]


def load_torch_state_dict(path: str) -> Arrays:
    """A .pth/.tar checkpoint as numpy arrays (``module.`` prefixes cut)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v.numpy() for k, v in sd.items()
            if hasattr(v, "numpy")}


def _bn_keys(rng: np.random.RandomState, sd: Arrays, prefix: str, c: int,
             gamma=(0.5, 1.5)):
    sd[f"{prefix}.weight"] = rng.uniform(*gamma, c).astype(np.float32)
    sd[f"{prefix}.bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
    sd[f"{prefix}.running_mean"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(1000, np.int64)


def random_resnet_state_dict(seed: int, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                             bottleneck: bool = False,
                             num_classes: int = 1000) -> Arrays:
    """Random weights in torchvision's ResNet key layout, float32 numpy.

    Basic blocks (ResNet-18) take the scales of tools/dress_rehearsal.py:
    conv N(0, 0.05^2), BN gamma and running var U(0.5, 1.5), beta and
    running mean N(0, 0.1^2), fc N(0, 0.02^2), fc bias 0.

    Bottleneck blocks (ResNet-50) take the same BN draws, fc and draw
    order, but every conv (the stem and the downsamples included) is
    N(0, 2 / fan_in) with fan_in = Cin * k * k ("He" scaling), less the
    mean of its output channel's fan-in (each filter sums to zero), and
    the last BN of each block has gamma U(0.1, 0.3).  With the
    dress-rehearsal scales the 16 blocks' branches add the per-channel
    means of their relu'd inputs to the residual stream as constants, and
    the input-dependent share of the logits (chip_smoke.input_share) falls
    to 0.03-0.04 at batch 64, every image with the same top-1; He scaling
    keeps the signal's scale from layer to layer, the zero-sum filters
    keep a relu'd input's mean out of the branches, and the small last
    gamma keeps each branch a correction of the residual stream, as in a
    trained ResNet.  The share is then about 0.4 (measured in float32 and
    FP8 on the CPU, seeds 0-2)."""
    rng = np.random.RandomState(seed)
    normal = lambda shape, s: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731

    def conv(shape):
        if not bottleneck:
            return normal(shape, 0.05)
        w = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        w -= w.reshape(shape[0], -1).mean(axis=1).reshape(-1, 1, 1, 1)
        return w.astype(np.float32)

    sd: Arrays = {"conv1.weight": conv((64, 3, 7, 7))}
    _bn_keys(rng, sd, "bn1", 64)
    exp = 4 if bottleneck else 1
    in_feats = 64
    for stage, n_blocks in enumerate(stage_sizes):
        width = 64 * 2 ** stage
        for b in range(n_blocks):
            t = f"layer{stage + 1}.{b}"
            stride = 2 if (stage > 0 and b == 0) else 1
            if bottleneck:
                shapes = [(width, in_feats, 1, 1), (width, width, 3, 3),
                          (width * 4, width, 1, 1)]
            else:
                shapes = [(width, in_feats, 3, 3), (width, width, 3, 3)]
            for i, shape in enumerate(shapes, 1):
                sd[f"{t}.conv{i}.weight"] = conv(shape)
                _bn_keys(rng, sd, f"{t}.bn{i}", shape[0],
                         (0.1, 0.3) if bottleneck and i == 3 else (0.5, 1.5))
            if stride != 1 or in_feats != width * exp:
                sd[f"{t}.downsample.0.weight"] = conv((width * exp, in_feats, 1, 1))
                _bn_keys(rng, sd, f"{t}.downsample.1", width * exp)
            in_feats = width * exp
    sd["fc.weight"] = normal((num_classes, in_feats), 0.02)
    sd["fc.bias"] = np.zeros(num_classes, np.float32)
    return sd


def random_mobilenet_v2_state_dict(seed: int, settings=None,
                                   num_classes: int = 1000,
                                   width_mult: float = 1.0) -> Arrays:
    """Random weights in the tonylins MobileNetV2 key layout (at width 1.0
    a 32-channel stem and a 1280-channel head; ``width_mult`` scales the
    channels as the model does), float32 numpy, drawn in the
    order of tools/dress_rehearsal.py:73-105 with its BN (as
    ``random_resnet_state_dict``) and classifier (N(0, 0.02^2), bias 0)
    scales.

    Conv weights are N(0, 2 / fan_in) with fan_in = Cin/groups * k * k
    ("He" scaling), not the dress rehearsal's N(0, 0.05^2): through 17
    blocks at that scale the signal falls below the BN shifts, the part of
    the logits that depends on the input becomes negligible against their
    spread (every image gets the same top-1), and a check of one engine
    against another compares constants.  Fan-in scaling keeps the signal's
    scale from block to block (chip_smoke.py prints the input-dependent
    share it gives)."""
    from fp8_quantization_tpu_torch.models.mobilenet_v2 import (
        INVERTED_RESIDUAL_SETTING)
    rng = np.random.RandomState(seed)

    def conv(sd, key, shape):
        fan_in = shape[1] * shape[2] * shape[3]
        sd[key] = (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
                   ).astype(np.float32)

    sd: Arrays = {}
    stem = int(32 * width_mult)
    last = int(1280 * width_mult) if width_mult > 1.0 else 1280
    conv(sd, "features.0.0.weight", (stem, 3, 3, 3))
    _bn_keys(rng, sd, "features.0.1", stem)
    cin, feat = stem, 1
    for t, c, n, _ in settings or INVERTED_RESIDUAL_SETTING:
        c = int(c * width_mult)
        for _ in range(n):
            pre, hidden = f"features.{feat}.conv", cin * t
            layers = ([((hidden, 1, 3, 3), 0), ((c, hidden, 1, 1), 3)]
                      if t == 1 else
                      [((hidden, cin, 1, 1), 0), ((hidden, 1, 3, 3), 3),
                       ((c, hidden, 1, 1), 6)])
            for shape, j in layers:
                conv(sd, f"{pre}.{j}.weight", shape)
                _bn_keys(rng, sd, f"{pre}.{j + 1}", shape[0])
            cin, feat = c, feat + 1
    conv(sd, f"features.{feat}.0.weight", (last, cin, 1, 1))
    _bn_keys(rng, sd, f"features.{feat}.1", last)
    sd["classifier.1.weight"] = (rng.standard_normal((num_classes, last))
                                 * 0.02).astype(np.float32)
    sd["classifier.1.bias"] = np.zeros(num_classes, np.float32)
    return sd


def random_vit_state_dict(seed: int, depth: int = 12, dim: int = 384,
                          mlp_ratio: int = 4, patch_size: int = 16,
                          image_size: int = 224,
                          num_classes: int = 1000) -> Arrays:
    """Random weights in timm's ViT key layout, float32 numpy: every linear
    and the patch conv N(0, 1 / fan_in), their biases N(0, 0.02^2), the
    LayerNorm gammas U(0.5, 1.5) and betas N(0, 0.02^2), ``cls_token`` and
    ``pos_embed`` N(0, 0.02^2); the head N(0, 0.02^2) with bias 0.

    Fan-in scaling rather than timm's N(0, 0.02^2) init, as for the
    MobileNetV2 weights: the cls row starts as the same vector for every
    image and takes the input only through attention, and branches that
    keep the scale of their input carry more of it (chip_smoke.py prints
    the input-dependent share of the logits' spread and requires more than
    0.01)."""
    rng = np.random.RandomState(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def linear(sd, prefix, n_out, n_in):
        sd[f"{prefix}.weight"] = normal((n_out, n_in), np.sqrt(1.0 / n_in))
        sd[f"{prefix}.bias"] = normal(n_out, 0.02)

    def norm(sd, prefix):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, dim).astype(np.float32)
        sd[f"{prefix}.bias"] = normal(dim, 0.02)

    n_tokens = (image_size // patch_size) ** 2 + 1
    fan_in = 3 * patch_size * patch_size
    sd: Arrays = {
        "cls_token": normal((1, 1, dim), 0.02),
        "pos_embed": normal((1, n_tokens, dim), 0.02),
        "patch_embed.proj.weight": normal((dim, 3, patch_size, patch_size),
                                          np.sqrt(1.0 / fan_in)),
        "patch_embed.proj.bias": normal(dim, 0.02)}
    hidden = dim * mlp_ratio
    for i in range(depth):
        t = f"blocks.{i}"
        norm(sd, f"{t}.norm1")
        linear(sd, f"{t}.attn.qkv", 3 * dim, dim)
        linear(sd, f"{t}.attn.proj", dim, dim)
        norm(sd, f"{t}.norm2")
        linear(sd, f"{t}.mlp.fc1", hidden, dim)
        linear(sd, f"{t}.mlp.fc2", dim, hidden)
    norm(sd, "norm")
    sd["head.weight"] = normal((num_classes, dim), 0.02)
    sd["head.bias"] = np.zeros(num_classes, np.float32)
    return sd


def _bn_targets(mod_path: str, bn_prefix: str) -> dict:
    return {f"{bn_prefix}.weight": f"{mod_path}.bn_weight",
            f"{bn_prefix}.bias": f"{mod_path}.bn_bias",
            f"{bn_prefix}.running_mean": f"{mod_path}.running_mean",
            f"{bn_prefix}.running_var": f"{mod_path}.running_var"}


def torchvision_key_map(model) -> dict:
    """torchvision key -> the port's state-dict key for a QuantizedResNet."""
    keys = {"conv1.weight": "stem.weight", **_bn_targets("stem", "bn1"),
            "fc.weight": "fc.weight", "fc.bias": "fc.bias"}
    for name in model.block_names:
        stage, b = name[len("layer"):].split("_")
        t = f"layer{stage}.{b}"
        block = getattr(model, name)
        for i in range(1, len(list(block.children())) + 1):
            keys[f"{t}.conv{i}.weight"] = f"{name}.conv{i}.weight"
            keys.update(_bn_targets(f"{name}.conv{i}", f"{t}.bn{i}"))
        if hasattr(model, f"{name}_downsample"):
            keys[f"{t}.downsample.0.weight"] = f"{name}_downsample.weight"
            keys.update(_bn_targets(f"{name}_downsample", f"{t}.downsample.1"))
    return keys


def tonylins_key_map(model) -> dict:
    """tonylins key -> the port's state-dict key for a QuantizedMobileNetV2
    (JAX ``convert_mobilenet_v2``): features.0 is the stem,
    features.1..17 the blocks (``conv.{0,3}`` for t=1, ``conv.{0,3,6}``
    otherwise, each followed by its BN), then the head and classifier.1."""
    keys = {"features.0.0.weight": "stem.weight",
            **_bn_targets("stem", "features.0.1"),
            "classifier.1.weight": "classifier.weight",
            "classifier.1.bias": "classifier.bias"}
    feat = 1
    for name in model.block_names:
        block = getattr(model, name)
        layout = (("dw", 0), ("project", 3)) if block.expand is None else (
            ("expand", 0), ("dw", 3), ("project", 6))
        for mod, j in layout:
            pre = f"features.{feat}.conv.{j}"
            keys[f"{pre}.weight"] = f"{name}.{mod}.weight"
            keys.update(_bn_targets(f"{name}.{mod}",
                                    f"features.{feat}.conv.{j + 1}"))
        feat += 1
    keys[f"features.{feat}.0.weight"] = "head.weight"
    keys.update(_bn_targets("head", f"features.{feat}.1"))
    return keys


def timm_vit_key_map(model) -> dict:
    """timm key -> the port's state-dict key for a QuantizedViT (JAX
    ``convert_vit``): ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
    mlp.fc2}`` -> ``block{i}.{ln1,attn.qkv,attn.proj,ln2,mlp1,mlp2}``, the
    final ``norm`` -> ``ln_final``; LayerNorm gamma is each ``weight``."""
    keys = {"cls_token": "cls_token", "pos_embed": "pos_embed",
            "patch_embed.proj.weight": "patch_embed.weight",
            "patch_embed.proj.bias": "patch_embed.bias"}
    names = [("norm1", "ln1"), ("attn.qkv", "attn.qkv"),
             ("attn.proj", "attn.proj"), ("norm2", "ln2"),
             ("mlp.fc1", "mlp1"), ("mlp.fc2", "mlp2")]
    layers = [(f"blocks.{i}.{src}", f"block{i}.{dst}")
              for i in range(model.depth) for src, dst in names]
    for src, dst in layers + [("norm", "ln_final"), ("head", "head")]:
        for p in ("weight", "bias"):
            keys[f"{src}.{p}"] = f"{dst}.{p}"
    return keys


@torch.no_grad()
def _load_by_map(model, sd, key_map: dict) -> None:
    own = model.state_dict()
    for src, dst in key_map.items():
        if src not in sd:
            raise KeyError(f"missing {src!r} in the state dict")
        value = torch.as_tensor(np.asarray(sd[src]), dtype=torch.float32)
        if tuple(value.shape) != tuple(own[dst].shape):
            raise ValueError(f"shape mismatch at {src}: {tuple(value.shape)} vs "
                             f"{tuple(own[dst].shape)}")
        own[dst].copy_(value)


def load_torchvision_resnet(model, sd) -> None:
    """Copy a torchvision ResNet state dict into ``model`` (in place, shape
    checked; every parameter of the map must be present)."""
    _load_by_map(model, sd, torchvision_key_map(model))


def load_tonylins_mobilenet_v2(model, sd) -> None:
    """Copy a tonylins MobileNetV2 state dict into ``model`` (in place,
    shape checked; every parameter of the map must be present)."""
    _load_by_map(model, sd, tonylins_key_map(model))


def load_timm_vit(model, sd) -> None:
    """Copy a timm ViT state dict into ``model`` (in place, shape checked;
    every parameter of the map must be present).  timm's LayerNorms use eps
    1e-6; the port keeps JAX's 1e-5 (ROADMAP.md, section C)."""
    _load_by_map(model, sd, timm_vit_key_map(model))


def _node(tree, path: Sequence[str]):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _copy(dst: torch.Tensor, value) -> None:
    v = torch.as_tensor(np.array(value)).to(dst.dtype)
    if tuple(v.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: {tuple(v.shape)} vs {tuple(dst.shape)}")
    dst.copy_(v)


# JAX's cast_probe dtype (a zero-dim array of the IEEE format) -> M
_CAST_PROBE_MBITS = {"float8_e5m2": 2, "float8_e4m3": 3, "float8_e3m4": 4}


def _load_quantizer(quantizer, tree, prep=None) -> None:
    """The quantizer's ``q`` and ``est`` state, and its ``qprep`` constants
    (the dict of ops/fp8.FP8_CONST_ROWS, each broadcast to the maxval's
    shape) as the (6, C) ``qprep`` buffer, None where JAX has none.  A
    dict with the cast path's constants (``cast_probe``, whose dtype names
    the format, and ``cast_scale`` ... ``cast_magic``) gives the (12, C)
    buffer of ops/quantizer.fixed_consts."""
    if tree is None:
        return
    quantizer.load_state({k: np.array(v) for k, v in tree.get("q", {}).items()},
                         {k: np.array(v) for k, v in tree.get("est", {}).items()})
    c = (prep or {}).get("c")
    if c is None:
        quantizer.qprep = quantizer.cast_m = None
        return
    c = dict(c)
    names = FP8_CONST_ROWS
    quantizer.cast_m = None
    if "cast_probe" in c:
        quantizer.cast_m = _CAST_PROBE_MBITS[np.asarray(c["cast_probe"]).dtype.name]
        c["cast_mbits"] = float(quantizer.cast_m)
        names += CAST_CONST_ROWS
    shape = quantizer.maxval.reshape(-1).shape
    quantizer.qprep = torch.stack([
        torch.broadcast_to(torch.as_tensor(np.array(c[k]), dtype=torch.float32)
                           .reshape(-1), shape)
        for k in names]).to(quantizer.maxval.device).contiguous()


def _load_int8_bake(mod, tree) -> None:
    if tree is None or "w_int8" not in tree:
        mod.w_int8 = mod.w_delta = mod.w_signed = None
        return
    w = np.asarray(tree["w_int8"])
    # HWIO -> (Cout, kh*kw*Cin) with columns (dy, dx, ci); (K, N) -> (N, K)
    w = (w.transpose(3, 0, 1, 2).reshape(w.shape[3], -1) if w.ndim == 4
         else w.T)
    dev = mod.weight.device
    mod.w_int8 = torch.tensor(np.ascontiguousarray(w), dtype=torch.int8,
                              device=dev)
    mod.w_delta = torch.tensor(np.asarray(tree["w_delta"]), dtype=torch.float32,
                               device=dev).reshape(-1)
    mod.w_signed = torch.tensor(np.asarray(tree["w_signed"]),
                                dtype=torch.float32, device=dev).reshape(())


def _load_quantizers(mod, quant, qprep, path) -> None:
    for name in ("weight_q", "act_q"):
        _load_quantizer(getattr(mod, name), _node(quant, path + [name]),
                        _node(qprep, path + [name]))


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Load the JAX package's variables into the port's modules in place.

    Module paths are the JAX scope paths (``layer1_0.conv1`` <->
    ``("layer1_0", "conv1")``, ``block1_0.dw`` <-> ``("block1_0", "dw")``,
    ``head_act`` <-> ``("head_act",)``).  Conv kernels go HWIO -> OIHW (a
    grouped (3, 3, C/g, C) kernel to (C, C/g, 3, 3) by the same transpose,
    a 1-D (W, I, O) kernel to (O, I, W), a transposed conv's (*k, I, O) to
    (O, I, *k)), dense kernels (in, out) -> (out, in); ``gamma``/``beta`` -> ``bn_weight``/
    ``bn_bias``; ``batch_stats`` mean/var -> running_mean/var; ``quant``
    ``q``/``est`` -> quantizer and estimator buffers (FP8 ``maxval``... or
    uniform ``delta``, ``zero_float``, ``signed``; the estimators' carries,
    the MSE search's ``search_grid`` / ``mses`` and the line search's
    ``thresholds`` / ``losses`` / ``one_sided`` among them); ``qprep``
    ``c`` -> the quantizer's ``qprep`` constants; ``baked/w_factor`` ->
    ``w_factor``; ``baked_int8`` -> ``w_int8`` (HWIO, a depthwise
    (3, 3, 1, C) one too, or (K, N) -> the int8 kernels' (C, K) layout: the
    ResNets', MobileNetV2's and the ViT's), ``w_delta``, ``w_signed``.  A ``QuantLayerNorm``
    takes ``scale``/``bias`` and its two quantizers; parameters of the model
    itself (the ViT's ``cls_token``, ``pos_embed``) come from the root of
    ``params``.
    """
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    quant = variables.get("quant", {})
    baked = variables.get("baked", {})
    baked_int8 = variables.get("baked_int8", {})
    qprep = variables.get("qprep", {})
    if not isinstance(model, (QuantizedLayerBase, QuantLayerNorm)):
        for name, param in model.named_parameters(recurse=False):
            _copy(param, params[name])
    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        if isinstance(mod, QuantizedLayerBase):
            p = _node(params, path)
            if p is None:
                raise KeyError(f"no params for {name!r}")
            # (*k, in/groups, out) -> (out, in/groups, *k): convs (grouped,
            # 1-D and transposed too) and dense (in, out) -> (out, in)
            k = np.moveaxis(np.asarray(p["kernel"]), (-1, -2), (0, 1))
            _copy(mod.weight, k)
            if mod.bn:
                _copy(mod.bn_weight, p["gamma"])
                _copy(mod.bn_bias, p["beta"])
                s = _node(stats, path)
                _copy(mod.running_mean, s["mean"])
                _copy(mod.running_var, s["var"])
            if mod.use_bias:
                _copy(mod.bias, p["bias"])
            _load_quantizers(mod, quant, qprep, path)
            wf = _node(baked, path + ["w_factor"])
            mod.w_factor = (None if wf is None else torch.tensor(
                np.asarray(wf), dtype=torch.float32,
                device=mod.weight.device).reshape(-1))
            _load_int8_bake(mod, _node(baked_int8, path))
        elif isinstance(mod, QuantLayerNorm):
            p = _node(params, path)
            if p is None:
                raise KeyError(f"no params for {name!r}")
            _copy(mod.weight, p["scale"])
            _copy(mod.bias, p["bias"])
            _load_quantizers(mod, quant, qprep, path)
        elif isinstance(mod, QuantizedActivation):
            _load_quantizer(mod.act_q, _node(quant, path + ["act_q"]),
                            _node(qprep, path + ["act_q"]))
