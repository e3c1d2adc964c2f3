"""The bottleneck ResNet (ResNet-50's blocks) under the main path's FP8
config against the JAX package (CPU), and the ResNet random draws.

The model is tests/_resnet_pair.py's: stage_sizes=(1, 1, 1, 1) with
bottleneck blocks on 32x32 inputs, batch 2, from one
random_resnet_state_dict(seed, bottleneck=True); JAX's ``pallas`` engine in
interpret mode.  Tolerances are tests/test_torch_resnet.py's:

* calibrated ranges: min/max of activations summed in another order,
  relative 1e-4;
* quantized outputs (a layer's or the fc's output grid): within one grid
  step of JAX's (2^-M of the magnitude plus the subnormal step), >= 98%
  exact, top-1 identical for the logits;
* every prepared forward bit-equal to the unprepared one.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.nn import factored as jfactored
from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import bake_weights, prepare_inference
from fp8_quantization_tpu_torch.nn.factored import Factored, materialize
from fp8_quantization_tpu_torch.ops import kernels
from tests._resnet_pair import (
    CLASSES, JAX_ENGINE, MAIN, N_LAYERS, fc_maxval, inputs, jax_calibrated,
    jax_logits, jax_model, np_tree, one_grid_step, port_model, t)
from tests.test_torch_int_grids import _spy_plain

torch.set_num_threads(1)


# ---- FP8, the main path's config ---------------------------------------------

@pytest.fixture(scope="module")
def fp8_run():
    """JAX 'pallas' calibrated and baked, its logits; the port 'fused'
    model calibrated by itself and baked, its logits."""
    sd, x = inputs()
    jmodel = jax_model(dict(engine="pallas", **MAIN))
    jvars = jax_calibrated(jmodel, sd, x)
    with _pallas_gates_off():
        jbaked = j_bake(jmodel, jvars, jnp.asarray(x))
    model = port_model(dict(engine="fused", **MAIN))
    convert.load_torchvision_resnet(model, sd)
    calibrate(model, [x], device="cpu")
    calibrated = {k: v.clone() for k, v in model.state_dict().items()}
    bake_weights(model)
    with torch.no_grad():
        logits = model(t(x), mode="fixed", quant_w=False).numpy()
    return dict(sd=sd, x=x, jvars=np_tree(jvars), jbaked=np_tree(jbaked),
                jlogits=jax_logits(jmodel, jbaked, x, False), model=model,
                calibrated=calibrated, logits=logits)


def test_bottleneck_calibrated_state_matches_jax(fp8_run):
    jq, cal, n = fp8_run["jvars"]["quant"], fp8_run["calibrated"], 0
    for key, value in cal.items():
        if not key.endswith(".maxval"):
            continue
        node = jq
        for part in key.split(".")[:-1]:
            node = node[part]
        np.testing.assert_allclose(value.numpy(), node["q"]["maxval"], rtol=1e-4)
        n += 1
    # a weight and an output quantizer per layer, a block-output quantizer
    # per block
    assert n == 2 * N_LAYERS + 4


def test_bottleneck_fused_logits_match_jax_pallas(fp8_run):
    logits = fp8_run["logits"]
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    one_grid_step(logits, fp8_run["jlogits"], fc_maxval(fp8_run["jvars"]))


def test_bottleneck_bake_covers_every_layer(fp8_run):
    baked = [n for n, m in fp8_run["model"].named_modules()
             if isinstance(m, layers.QuantizedLayerBase) and m.w_factor is not None]
    assert len(baked) == N_LAYERS
    assert {"layer1_0_downsample", "layer1_0.conv3", "fc"} <= set(baked)


def test_bottleneck_fused_routes(fp8_run, monkeypatch):
    """A baked fused forward reaches 1 qstem, one qconv3x3 a block and
    qmatmul for every 1x1 conv, downsample and the fc (ResNet-50: 1, 16,
    37), and launches nothing on the CPU."""
    calls = {}
    _spy_plain(monkeypatch, calls)
    before = kernels.launch_counts()
    with torch.no_grad():
        fp8_run["model"](t(fp8_run["x"]), mode="fixed", quant_w=False)
    assert calls == {"qstem_plain": 1, "qconv3x3_plain": 4,
                     "qmatmul_plain": 2 * 4 + 4 + 1}
    assert kernels.launch_counts() == before


def _record_layers(model, x, quant_w):
    """[(path, module, input, kwargs, output)] of every quantized layer and
    block-output quantizer call of one fixed-mode forward, in call order."""
    calls, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, (layers.QuantizedLayerBase, layers.QuantizedActivation)):
            hooks.append(mod.register_forward_hook(
                lambda m, args, kw, out, name=name: calls.append(
                    (name, m, args[0], kw, out)), with_kwargs=True))
    try:
        with torch.no_grad():
            logits = model(t(x), mode="fixed", quant_w=quant_w)
    finally:
        for h in hooks:
            h.remove()
    return calls, logits


def _jax_layer(mod, jcfg):
    """The JAX layer of a port QuantConv / QuantLinear / QuantizedActivation."""
    if isinstance(mod, layers.QuantConv):
        k, s, p = mod.kernel_size, mod.stride, mod.padding
        return jlayers.QuantConv(features=mod.features, kernel_size=(k, k),
                                 strides=(s, s), padding=((p, p), (p, p)),
                                 bn=mod.bn, activation=mod.activation, config=jcfg)
    if isinstance(mod, layers.QuantLinear):
        return jlayers.QuantLinear(features=mod.features, use_bias=mod.use_bias,
                                   config=jcfg)
    return jlayers.QuantizedActivation(config=jcfg)


def _jax_value(t):
    """A port tensor or Factored pair as the JAX layer takes it."""
    if isinstance(t, Factored):
        return jfactored.Factored(jnp.asarray(t.norm.float().numpy()).astype(jnp.bfloat16),
                                  jnp.asarray(t.factor.numpy(), jnp.float32))
    return jnp.asarray(t.numpy())


def _layer_vars(jvars, path):
    out = {}
    for coll, tree in jvars.items():
        node = tree
        for part in path.split("."):
            node = node.get(part) if isinstance(node, dict) else None
            if node is None:
                break
        if node is not None:
            out[coll] = node
    return out


# grid steps of the fc's output quantizer that whole 'parity' / 'bf16'
# logits may differ from JAX's by (test_bottleneck_layers_match_jax)
WHOLE_STEPS = 2


@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
def test_bottleneck_layers_match_jax(fp8_run, engine):
    """JAX's calibrated state in the port on each engine, unbaked (weights
    quantized per forward; under 'fused' in the kernel) and baked: every
    quantized layer and block-output quantizer of the port's forward, on
    the input that forward gave it, against the JAX layer of the same
    engine on that input, within one grid step of its output quantizer,
    >= 98% exact (tests/test_torch_resnet.py's layer tolerance).  On
    'parity' and 'bf16' the whole logits too, against JAX's forward of the
    same engine and state (which holds the block composition, the residual
    add and relu, to JAX's): top-1 identical and within WHOLE_STEPS steps
    of the fc's output grid, with no exact share required: at this size one
    value that sums to a bin boundary in another order flips a bin that
    carries to the logits (measured 0.65 steps on 'parity', 1.38 on
    'bf16'; JAX's own 'bf16' forward differs by 1.4 steps jitted from
    eagerly).  The fused forward's logits are held in
    test_bottleneck_fused_logits_match_jax_pallas.  Then the baked bf16 and
    fused forwards prepared, bit-equal to the unprepared ones."""
    x, jvars = fp8_run["x"], fp8_run["jvars"]
    jcfg = j_make_config(engine=JAX_ENGINE[engine], **MAIN)
    jmodel = jax_model(dict(engine=JAX_ENGINE[engine], **MAIN))
    model = port_model(dict(engine=engine, **MAIN))
    convert.load_jax_variables(model, jvars)
    for quant_w in (True, False):
        if not quant_w:
            with _pallas_gates_off():
                jvars = np_tree(j_bake(jmodel, jvars, jnp.asarray(x)))
            bake_weights(model)
        calls, logits = _record_layers(model, x, quant_w)
        if engine != "fused":
            got, ref = logits.numpy(), jax_logits(jmodel, jvars, x, quant_w)
            step = (np.maximum(np.abs(got), np.abs(ref)) * 2.0 ** -4
                    + fc_maxval(jvars) * 2.0 ** -10)
            assert np.all(np.abs(got - ref) <= WHOLE_STEPS * step), (
                np.abs(got - ref).max())
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        if engine == "fused" and not quant_w:
            # the baked stem runs qstem inside the model (stem + maxpool):
            # its output is the first block's input
            calls.insert(0, ("stem", model.stem, t(x), calls[0][3], calls[0][2]))
            pooled = {"stem"}
        else:
            pooled = set()
        # every layer, every block-output quantizer and the tied avgpool's
        assert len(calls) == N_LAYERS + 4 + 1
        for name, mod, inp, kw, out in calls:
            jmod, v = _jax_layer(mod, jcfg), _layer_vars(jvars, name)
            kw = {k: a for k, a in kw.items() if k != "train_bn"}
            ref = jmod.apply(v, _jax_value(inp), **kw)
            if name in pooled:
                ref = jfactored.fmax_pool(ref, (3, 3), strides=(2, 2),
                                          padding=((1, 1), (1, 1)))
            ref = np.asarray(jfactored.materialize(ref), np.float32)
            got = materialize(out).numpy()
            maxval = float(v["quant"]["act_q"]["q"]["maxval"])
            step = np.maximum(np.abs(got), np.abs(ref)) * 2.0 ** -4 + maxval * 2.0 ** -10
            assert np.all(np.abs(got - ref) <= step), (name, np.abs(got - ref).max())
            assert (got == ref).mean() >= 0.98, (name, (got == ref).mean())
    if engine != "parity":
        prepare_inference(model, torch.zeros(1, 32, 32, 3), quant_w=False)
        with torch.no_grad():
            assert torch.equal(model(t(x), mode="fixed", quant_w=False), logits)


def test_bottleneck_bake_matches_jax(fp8_run):
    """From JAX's calibrated state each package's bake stores the same
    normalized weights and factors in every layer (the fc and the four
    downsamples included)."""
    model = port_model(dict(engine="fused", **MAIN))
    convert.load_jax_variables(model, fp8_run["jvars"])
    bake_weights(model)
    jb, n = fp8_run["jbaked"], 0
    for name, mod in model.named_modules():
        if not isinstance(mod, layers.QuantizedLayerBase):
            continue
        node = _layer_vars(jb, name)
        k = node["params"]["kernel"]
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        np.testing.assert_array_equal(mod.weight.detach().numpy(), k)
        np.testing.assert_array_equal(mod.w_factor.numpy(), node["baked"]["w_factor"])
        n += 1
    assert n == N_LAYERS


# ---- the random draws ------------------------------------------------------------

def _digest(sd):
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(np.ascontiguousarray(sd[k]).tobytes())
    return h.hexdigest()


def test_resnet18_random_draws_are_unchanged():
    """The basic-block draws (ResNet-18, every test and chip_smoke number
    built on them) are bit-for-bit those of before the bottleneck draw got
    its own scales."""
    assert _digest(convert.random_resnet_state_dict(0)) == (
        "b864e783dcf0ef2d0d5e5be1ccc0531c0641e0eb9e773118d81381523e0a0c79")
    assert _digest(convert.random_resnet_state_dict(3, (1, 1, 1, 1), False, 10)) == (
        "68b06a3d809947d86d3a41bf1a33aca2658538faeccfeb1a68ac7bcc0f6f3143")


def test_bottleneck_draw_scales():
    """The bottleneck draw's documented scales: He-scaled zero-sum convs,
    the last BN of each block with gamma in [0.1, 0.3]."""
    sd = convert.random_resnet_state_dict(0, (3, 4, 6, 3), True)
    assert len(sd) == 320 and sd["fc.weight"].shape == (1000, 2048)
    for key in ("conv1.weight", "layer1.0.conv2.weight", "layer4.2.conv3.weight",
                "layer3.0.downsample.0.weight"):
        w = sd[key].reshape(sd[key].shape[0], -1).astype(np.float64)
        assert np.abs(w.sum(axis=1)).max() < 1e-4 * np.abs(w).sum(axis=1).min()
        np.testing.assert_allclose(w.std(), np.sqrt(2.0 / w.shape[1]), rtol=0.1)
    for key in (k for k in sd if k.endswith("bn3.weight")):
        assert 0.1 <= sd[key].min() and sd[key].max() <= 0.3, key
    assert sd["layer1.0.bn2.weight"].min() >= 0.5
