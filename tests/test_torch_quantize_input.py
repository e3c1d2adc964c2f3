"""``--quantize-input`` with a ``Factored`` input: every engine of the port
follows the reference (``parity``), against the JAX package (CPU).

A layer that quantizes its input (``quantize_input``) and receives a
``Factored`` pair (norm, factor) from the layer before materializes it and
quantizes the value with its own input quantizer, as JAX's ``parity``
engine (and its int8 datapath) does.  JAX's ``bf16`` engine instead takes
the pair as it is and skips the layer's input quantizer (JAX
nn/layers.py:1001-1004, 1235-1238); one test pins that difference so that
it stays visible.

* One layer (1x1 conv at stride 2, linear), calibrated by JAX on a range
  that clips the incoming grid: port ``bf16`` and ``fused`` on the
  ``Factored`` input against JAX ``parity`` on its value, rtol = atol =
  1e-5 (tests/test_pallas_qmatmul.py's tolerance: the products are summed
  in another order).
* A tiny ResNet-18 (64x64 inputs, so the tied avgpool averages a 2x2 map
  and the fc's input range differs from the last block's): every quantized
  layer of the ``bf16`` and ``fused`` forwards, given its own input,
  against the same layer on ``parity`` given the value, within 1e-5 of
  the layer's largest output (a K = 4608 sum in another order; chip_smoke's
  bound for outputs with no quantizer after the product).  The logits themselves are chaotic under input quantization
  (an ulp upstream flips E3M4 bins downstream, PERF.md section 6), so the
  comparison is per layer, each on its own recorded input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.nn import factored as jfactored
from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet_configs)
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.factored import Factored, materialize
from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts, fp8_quantize_prepared

torch.set_num_threads(1)

FP8_QI = dict(per_channel_weights=True, fp8_mantissa_bits=4, fp8_set_maxval=True,
              weight_range_method="current_minmax", act_range_method="allminmax",
              quantize_input=True)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _factored_input(shape, seed=4):
    """(norm, factor, value) of an E3M4 grid with maxval 2.5 over a normal
    sample: norm bf16-exact, value = norm * factor in float32."""
    x = torch.from_numpy(np.random.RandomState(seed).standard_normal(shape)
                         .astype(np.float32)) * 1.5
    c = fp8_consts(torch.tensor([2.5]), 4)
    norm = fp8_quantize_prepared(x, c, normalized=True)
    factor = c[5, 0]
    return norm, factor, norm * factor


LAYERS = {
    # name: (shape of the input, JAX layer, port layer)
    "conv1x1_s2": ((2, 8, 8, 16),
                   lambda cfg: jlayers.QuantConv(features=24, kernel_size=(1, 1),
                                                 strides=(2, 2), bn=True,
                                                 activation="relu", config=cfg),
                   lambda cfg: layers.QuantConv(16, 24, 1, 2, 0, bn=True,
                                                activation="relu", config=cfg)),
    "linear": ((4, 32), lambda cfg: jlayers.QuantLinear(features=12, config=cfg),
               lambda cfg: layers.QuantLinear(32, 12, config=cfg)),
}


def _layer_pair(case):
    """(JAX parity layer and its calibrated variables, port layer builder,
    norm, factor, value): the layer calibrated on 0.6 of the value, a range
    that clips the incoming grid, so re-quantizing moves the input."""
    shape, jmake, tmake = LAYERS[case]
    norm, factor, value = _factored_input(shape)
    jmod = jmake(j_make_config(engine="parity", **FP8_QI))
    calib = jnp.asarray(value.numpy() * 0.6)
    jv = jmod.init(jax.random.PRNGKey(1), calib)
    rng = np.random.RandomState(8)
    if "batch_stats" in jv:
        jv = {**jv, "batch_stats": jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            jv["batch_stats"])}
    _, upd = jmod.apply(jv, calib, mode="calibrate", mutable=["quant"])
    jv = {**jv, **upd}

    def port(engine):
        tmod = tmake(make_layer_config(engine=engine, **FP8_QI))
        convert.load_jax_variables(tmod, _np_tree(jv))
        return tmod
    return jmod, jv, port, norm, factor, value


@pytest.mark.parametrize("engine", ["bf16", "fused"])
@pytest.mark.parametrize("case", list(LAYERS))
def test_factored_input_follows_jax_parity(case, engine):
    """Port bf16 / fused on the Factored input equal JAX parity on its
    value: the input is materialized and re-quantized."""
    jmod, jv, port, norm, factor, value = _layer_pair(case)
    ref = np.asarray(jmod.apply(jv, jnp.asarray(value.numpy()), mode="fixed"))
    tmod = port(engine)
    with torch.no_grad():
        out = tmod(Factored(norm.to(torch.bfloat16), factor), mode="fixed")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("case", list(LAYERS))
def test_jax_bf16_skips_the_input_quantizer_of_a_factored_input(case):
    """JAX's bf16 engine on the same Factored input takes the norm as it
    is: its output equals JAX parity with the layer's input quantizer off
    and misses JAX parity with it on by far more than the summation-order
    tolerance, where the port's bf16 meets it."""
    jmod, jv, port, norm, factor, value = _layer_pair(case)
    jvalue = jnp.asarray(value.numpy())
    ref = np.asarray(jmod.apply(jv, jvalue, mode="fixed"))
    ref_unquantized_input = np.asarray(jmod.apply(jv, jvalue, mode="fixed",
                                                  quant_a=False))
    jbf16 = jmod.clone(config=j_make_config(engine="bf16", **FP8_QI))
    jin = jfactored.Factored(jnp.asarray(norm.numpy()).astype(jnp.bfloat16),
                             jnp.asarray(float(factor), jnp.float32))
    jout = np.asarray(jbf16.apply(jv, jin, mode="fixed"))
    np.testing.assert_allclose(jout, ref_unquantized_input, **TOL)
    assert np.abs(jout - ref).max() > 100 * (1e-5 + 1e-5 * np.abs(ref).max())
    with torch.no_grad():
        out = port("bf16")(Factored(norm.to(torch.bfloat16), factor), mode="fixed")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


STAGES, CLASSES, SEED = (1, 1, 1, 1), 10, 6


@pytest.fixture(scope="module")
def resnet_qi():
    """The tiny ResNet-18 under FP8 quantize_input on 'parity', calibrated
    on 64x64 inputs, and the same state under 'bf16' and 'fused'."""
    sd = convert.random_resnet_state_dict(SEED, STAGES, num_classes=CLASSES)
    x = torch.from_numpy(np.random.RandomState(SEED)
                         .standard_normal((2, 64, 64, 3)).astype(np.float32))
    models = {}
    for engine in ("parity", "bf16", "fused"):
        models[engine] = QuantizedResNet(STAGES, False, CLASSES, **resnet_configs(
            make_layer_config(engine=engine, **FP8_QI), None))
    convert.load_torchvision_resnet(models["parity"], sd)
    calibrate(models["parity"], [x.numpy()], device="cpu")
    for engine in ("bf16", "fused"):
        models[engine].load_state_dict(models["parity"].state_dict())
    return models, x


def _record_layers(model, x):
    """[(name, input, output)] of every QuantConv / QuantLinear call of one
    fixed-mode forward, in call order."""
    calls, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, layers.QuantizedLayerBase):
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, name=name: calls.append((name, args[0], out))))
    try:
        with torch.no_grad():
            model(x, mode="fixed")
    finally:
        for h in hooks:
            h.remove()
    return calls


@pytest.mark.parametrize("engine", ["bf16", "fused"])
def test_tiny_resnet_quantize_input_layers_follow_parity(resnet_qi, engine):
    """Every quantized layer of the tiny ResNet-18's bf16 / fused forward,
    on the input that forward gave it, equals the parity layer on that
    input's value; the fc and the downsamples receive Factored inputs."""
    models, x = resnet_qi
    calls = _record_layers(models[engine], x)
    parity = dict(models["parity"].named_modules())
    factored_in = [name for name, inp, _ in calls if isinstance(inp, Factored)]
    assert "fc" in factored_in and len(factored_in) >= 4, factored_in
    for name, inp, out in calls:
        with torch.no_grad():
            ref = parity[name](materialize(inp), mode="fixed")
        err = float((materialize(out) - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)
