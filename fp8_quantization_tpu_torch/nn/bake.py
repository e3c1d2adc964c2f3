"""Bake fake-quantized weights into the layers for inference.

Mirrors ``bake_weights`` of ``fp8_quantization_tpu/nn/bake.py``: after
calibration, every quantized layer's weight is replaced by its fixed-mode
quantized value and the model is evaluated with ``quant_w=False``.

* ``parity`` engine: the weight becomes the full-scale fake-quant value.
* ``bf16`` / ``fused`` engines: the weight becomes the normalized-grid value
  (bf16-exact) and its per-channel factor goes to the layer's ``w_factor``
  buffer, which the layer folds in after the product.

The JAX package bakes by running one forward and collecting what layers
sow; under ``engine='pallas'`` its kernel routes never sow, so the fc and
the 1x1 downsample convs are left unbaked and then run on unquantized
weights (see ROADMAP.md, section C).  This port bakes each quantized layer
directly from its weight quantizer, with no forward, so every layer with
``config.quant_w`` is baked whatever the engine.

A ``QuantLayerNorm``'s gamma is baked to its full-scale fake-quant value on
every engine, with no ``w_factor``: JAX quantizes it with ``_quant_w`` and
sows that value (there lines 100-103, ``nn/layers.py:134-140``).

Under folded BN (``bn_mode='folded'``) the bake stores the quantized
*folded* weight and then neutralizes BN as the JAX ``bake_weights`` does
(there lines 104-114): gamma = 1, beta = the folded shift, mean = 0,
var = 1 - eps.  In float32 ``(1 - 1e-5) + 1e-5 == 1``, so the fold after
the bake multiplies by exactly 1 and the shift is beta: the identity.

``bake_int8_weights`` mirrors the JAX function of that name (there lines
135-175) for the int8 datapath: every layer with an int8 route (dense and
depthwise convs, linears: the ResNets', MobileNetV2's and the ViT's), the
layers JAX's bake forward sows from; under ``int8_assume_signed`` (the model's
config) it checks the claim against the baked signedness and raises with
JAX's message for any unsigned grid.  Under an ``int8_mxu`` config the JAX
``bake_weights`` bakes nothing (its int8 route sows only ``baked_int8``),
so evaluating afterwards with ``quant_w=False`` runs unquantized weights
(ROADMAP.md, section C); the int8 bake is the one to use there, and the
model is evaluated with ``quant_w=True`` as before.

``prepare_inference`` mirrors the JAX function of that name (there lines
199-225): after calibration (and after the bake) one fixed-mode forward on
an example input, with the ``quant_w`` / ``quant_a`` the deployment will
use, stores every layer's fixed-mode scalar algebra (nn/layers.py,
nn/quantizers.py) so that later forwards read it instead of recomputing
it, with bit-identical results.  Its example input is one image, at shapes
no evaluation uses, so it asks no kernel gate (ops/kernels/autotune.py)
unless the gate's mode settles the route: at each gated site it runs both
the kernel and the composed route (nn/layers.gated_route), so that
whichever a later forward's verdict picks finds its constants, and it
records no verdict (JAX keeps its gates out of the host transform with
``_pallas_gates_off``, there lines 34-53); the cast path's constants
(``deploy_cast_quant`` and the activation flags) are computed there, on
the host values, as JAX computes them eagerly.  ``prepare_for_deployment`` is the bake,
the prepare pass (``quant_w=False``) and nothing else;
``prepare_for_deployment_host`` runs it on the host CPU and puts the model
back on its device.  Calibrating afterwards leaves the prepared constants
stale: run the prepare pass again.

``bake_for_inference`` is the bake of the CLI's ``--bake-weights`` (the
int8 grid on the int8 datapath, else ``bake_weights``), shared with the
serving export; ``is_baked`` and ``is_prepared`` tell whether a model has
been through either pass (utils/checkpoint.py refuses to save such a
model: JAX saves the calibrated variables before it bakes).
"""

from __future__ import annotations

import torch
from torch import nn

from fp8_quantization_tpu_torch.nn.layers import (
    QuantizedLayerBase, QuantLayerNorm, int8_datapath)

EXAMPLE_SHAPE = (1, 64, 64, 3)     # deep enough for every model's strides


@torch.no_grad()
def bake_weights(model: nn.Module) -> nn.Module:
    """Bake every quantized layer of ``model`` in place; returns the model.
    Evaluate afterwards with ``quant_w=False``."""
    for layer in model.modules():
        if isinstance(layer, QuantLayerNorm) and layer.config.quant_w:
            layer.weight.copy_(layer.weight_q(layer.weight, mode="fixed"))
            layer.baked = True
        if not isinstance(layer, QuantizedLayerBase) or not layer.config.quant_w:
            continue
        layer.baked = True
        kernel = layer._kernel()
        if layer.config.engine == "parity":
            layer.weight.copy_(layer.weight_q(kernel, mode="fixed"))
        else:
            wn, wf = layer.weight_q(kernel, mode="fixed", out="factored")
            layer.weight.copy_(wn)
            layer.w_factor = wf.reshape(-1).to(torch.float32).clone()
        if layer._folded():
            _neutralize_bn(layer)
    return model


def _neutralize_bn(layer: QuantizedLayerBase) -> None:
    """gamma = 1, beta = the folded shift, mean = 0, var = 1 - eps: the
    fold of the baked (already folded) weight becomes the identity."""
    shift = layer._bn_inv_shift()[1]
    layer.bn_weight.fill_(1.0)
    layer.bn_bias.copy_(shift)
    layer.running_mean.zero_()
    layer.running_var.fill_(1.0 - layer.bn_eps)


@torch.no_grad()
def bake_int8_weights(model: nn.Module) -> nn.Module:
    """Store every int8-datapath layer's weights on the recentred int8 grid
    (``w_int8`` in the int8 kernels' (C, K) layout, ``w_delta``,
    ``w_signed``), straight from its weight quantizer; returns the model.
    The layers then take these whatever ``quant_w`` is; evaluate with
    ``quant_w=True``."""
    baked = []
    for name, layer in model.named_modules():
        if (isinstance(layer, QuantizedLayerBase) and layer.config.quant_w
                and layer.int8_capable and int8_datapath(layer.config)):
            layer.w_int8, layer.w_delta, layer.w_signed = layer.int8_weights()
            baked.append((name, layer))
    cfg = getattr(model, "config", None)
    if cfg is not None and getattr(cfg, "int8_assume_signed", False):
        bad = [name.replace(".", "/") for name, layer in baked
               if float(layer.w_signed) != 1.0]
        if bad:
            raise ValueError(
                "int8_assume_signed=True but unsigned weight grids were "
                f"baked for: {bad} — drop the flag or the offending "
                "layers' unsigned ranges")
    return model


def bake_for_inference(model: nn.Module) -> bool:
    """Bake a calibrated model for inference: ``bake_int8_weights`` on the
    int8 datapath (evaluate with ``quant_w=True``), else ``bake_weights``
    (``quant_w=False``); returns the ``quant_w`` to evaluate with."""
    if int8_datapath(model.config):
        bake_int8_weights(model)
        return True
    bake_weights(model)
    return False


def is_baked(model: nn.Module) -> bool:
    """Whether a bake has changed any layer of ``model``."""
    return any(getattr(m, "baked", False)
               or getattr(m, "w_factor", None) is not None
               or getattr(m, "w_int8", None) is not None
               for m in model.modules())


def is_prepared(model: nn.Module) -> bool:
    """Whether ``model`` holds constants of a prepare pass (``qprep``,
    ``kprep``, ``prep_*``)."""
    return any(n.rsplit(".", 1)[-1] in ("qprep", "kprep")
               or n.rsplit(".", 1)[-1].startswith("prep_")
               for n, _ in model.named_buffers())


@torch.no_grad()
def prepare_inference(model: nn.Module, example_input: torch.Tensor, *,
                      quant_w: bool = True, quant_a: bool = True) -> nn.Module:
    """Freeze the fixed-mode scalar algebra of ``model`` in place (one
    fixed-mode forward on ``example_input``, whose values do not matter);
    evaluate afterwards with the same ``quant_w`` / ``quant_a``.  Returns
    the model.  Calibrating afterwards leaves the constants stale: run this
    again."""
    modules = list(model.modules())
    for m in modules:
        m._preparing = True
    try:
        model(example_input, mode="fixed", quant_w=quant_w, quant_a=quant_a)
    finally:
        for m in modules:
            m._preparing = False
    return model


def prepare_for_deployment(model: nn.Module, example_input: torch.Tensor, *,
                           quant_a: bool = True) -> nn.Module:
    """``bake_weights`` then ``prepare_inference(quant_w=False)``: evaluate
    the model with ``quant_w=False`` afterwards."""
    bake_weights(model)
    return prepare_inference(model, example_input, quant_w=False,
                             quant_a=quant_a)


def prepare_for_deployment_host(model: nn.Module, example_shape=EXAMPLE_SHAPE,
                                *, quant_a: bool = True) -> nn.Module:
    """``prepare_for_deployment`` run on the host CPU (the kernels' plain
    versions) on a zero example of images of ``example_shape`` (in the
    geometry the model takes, ``model.input_shape``), the model then moved back
    to the device it was on.  The constants are then the CPU's: where its
    log2 / exp2 round otherwise than the card's, they differ from what the
    card computes unprepared; ``prepare_for_deployment`` on the card keeps
    the card's."""
    device = next(model.parameters()).device
    model.cpu()
    prepare_for_deployment(model, torch.zeros(model.input_shape(example_shape)),
                           quant_a=quant_a)
    return model.to(device)
