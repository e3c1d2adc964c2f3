"""The MobileNetV2 slice of the port against the JAX package (CPU).

* A tiny MobileNetV2 (settings ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1))
  at 32x32, batch 2, 10 classes) from one random tonylins state dict, in
  both bn modes: port 'fused' (plain versions) against JAX
  engine='pallas', port 'bf16' against JAX 'bf16'.  The JAX reference is
  baked inside nn/bake._pallas_gates_off() (ROADMAP.md section C).  Logits
  within one FP8 grid step on >= 98% of elements, top-1 identical; a spy on
  the wrappers shows which route ran.  The blocks with 12 channels run
  layer by layer (qblock.channels_ok), so a second tiny model whose block
  widths are multiples of 8 (TINY8) holds qblock on every block type.
* The routes of a block, the presets, the CLI on CPU in both bn modes, and
  the loaders.

The kernels and the folded-BN layers: tests/test_torch_mobilenet_layers.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fp8_quantization_tpu.models.mobilenet_v2 as jmnv2
from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models.convert import (
    convert_mobilenet_v2, merge_variables)
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.nn.bake import bake_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.factored import Factored
from fp8_quantization_tpu_torch.ops.kernels import qblock, qdwconv, qmatmul

torch.set_num_threads(1)

MBITS = 4
MAIN = dict(per_channel_weights=True, fp8_mantissa_bits=MBITS,
            fp8_set_maxval=True, weight_range_method="current_minmax",
            act_range_method="allminmax")
TINY = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1))
CLASSES, SEED = 10, 4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _one_grid_step(out, ref, maxval, min_exact=0.98, min_near=1.0):
    """At least ``min_near`` of the elements within one FP8 grid step of the
    larger magnitude, and at least ``min_exact`` of them equal."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    step = (np.maximum(np.abs(out), np.abs(ref)) * 2.0 ** -MBITS
            + maxval * 2.0 ** -10)
    near = (np.abs(out - ref) <= step).mean()
    assert near >= min_near, (near, np.abs(out - ref).max())
    exact = (out == ref).mean()
    assert exact >= min_exact, exact


# ---- (d) the tiny MobileNetV2 --------------------------------------------------

def _jax_model(engine, bn_mode, settings=TINY):
    return jmnv2.mobilenetv2_quantized(
        j_make_config(engine=engine, bn_mode=bn_mode, **MAIN),
        num_classes=CLASSES, settings=settings)


def _port_model(engine, bn_mode, sd=None, settings=TINY):
    model = tmnv2.mobilenetv2_quantized(
        make_layer_config(engine=engine, bn_mode=bn_mode, **MAIN),
        num_classes=CLASSES, settings=settings, device="cpu")
    if sd is not None:
        convert.load_tonylins_mobilenet_v2(model, sd)
    return model


def _spy(monkeypatch, calls):
    for mod, name in ((qblock, "fused_inverted_residual"),
                      (qdwconv, "fused_quant_dwconv3x3"),
                      (qmatmul, "fused_quant_matmul")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)


@pytest.fixture(scope="module")
def tiny_sd():
    return convert.random_mobilenet_v2_state_dict(SEED, TINY, CLASSES)


@pytest.fixture(scope="module")
def tiny_x():
    return np.random.RandomState(SEED).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)


def _jax_run(engine, bn_mode, sd, x, settings=TINY):
    """(JAX-calibrated variables, JAX-baked variables, baked logits)."""
    jmodel = _jax_model(engine, bn_mode, settings)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmnv2, "INVERTED_RESIDUAL_SETTING", settings)
        params, stats = convert_mobilenet_v2(sd)
    jvars = j_calibrate(jmodel, merge_variables(jvars, params, stats),
                        [jnp.asarray(x)])
    with _pallas_gates_off():
        jbaked = j_bake(jmodel, jvars, jnp.asarray(x))
    logits = jax.jit(lambda v, xx: jmodel.apply(v, xx, mode="fixed",
                                                quant_w=False))(
        jbaked, jnp.asarray(x))
    return _np_tree(jvars), _np_tree(jbaked), np.asarray(logits)


def _logit_maxval(jvars):
    return float(jvars["quant"]["classifier"]["act_q"]["q"]["maxval"])


# per bn mode and engine: the launches of one tiny forward; under
# fp32_after only block0_0 (32 -> 32 -> 8) runs qblock, whose rows are 16
# bytes (qblock.channels_ok): the blocks with 12 channels run layer by
# layer, 3 depthwise and 6 1x1 launches, the head and classifier 2 more
ROUTES = {("fp32_after", "fused"): {"fused_inverted_residual": 1,
                                    "fused_quant_dwconv3x3": 3,
                                    "fused_quant_matmul": 8},
          ("folded", "fused"): {"fused_quant_dwconv3x3": 4,
                                "fused_quant_matmul": 9},
          ("fp32_after", "bf16"): {}, ("folded", "bf16"): {}}


@pytest.mark.parametrize("engine", ["fused", "bf16"])
@pytest.mark.parametrize("bn_mode", ["fp32_after", "folded"])
def test_tiny_mobilenet_matches_jax(bn_mode, engine, tiny_sd, tiny_x,
                                    monkeypatch):
    """Each package calibrates on its own.  Their BN inverses differ in the
    last bit (XLA's CPU rsqrt is not correctly rounded), so after 17 layers
    the classifier's output range differs in its last bits and moves every
    logit's grid point a little: the bound is one grid step on >= 98% of
    the logits, not equality."""
    _hold_tiny_against_jax(bn_mode, engine, TINY, tiny_sd, tiny_x,
                           ROUTES[(bn_mode, engine)], monkeypatch)


# a tiny MobileNetV2 whose block widths are all multiples of 8, so that
# every block under fp32_after takes qblock: 32 -> 32 -> 8 (t = 1, no
# expand), 8 -> 48 -> 16 (stride 2), 16 -> 96 -> 16 twice (residual)
TINY8 = ((1, 8, 1, 1), (6, 16, 2, 2), (6, 16, 1, 1))


def test_tiny_mobilenet_widths_of_8_match_jax(tiny_x, monkeypatch):
    """The qblock route of every block type (no expand, stride 2,
    residual) held against JAX engine='pallas' at the model level, by the
    bound of test_tiny_mobilenet_matches_jax: four qblock launches and
    the head and classifier on qmatmul."""
    _hold_tiny_against_jax(
        "fp32_after", "fused", TINY8,
        convert.random_mobilenet_v2_state_dict(SEED, TINY8, CLASSES), tiny_x,
        {"fused_inverted_residual": 4, "fused_quant_matmul": 2}, monkeypatch)


def _hold_tiny_against_jax(bn_mode, engine, settings, sd, x, routes,
                           monkeypatch):
    jvars, _, jlogits = _jax_run("pallas" if engine == "fused" else engine,
                                 bn_mode, sd, x, settings)
    model = _port_model(engine, bn_mode, sd, settings)
    calibrate(model, [x], device="cpu")
    np.testing.assert_allclose(model.classifier.act_q.state()["maxval"].numpy(),
                               _logit_maxval(jvars), rtol=1e-4)
    bake_weights(model)
    calls = {}
    _spy(monkeypatch, calls)
    with torch.no_grad():
        logits = model(_t(x), mode="fixed", quant_w=False).numpy()
    assert calls == routes
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    _one_grid_step(logits, jlogits, _logit_maxval(jvars), min_exact=0.0,
                   min_near=0.98)
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


@pytest.mark.parametrize("bn_mode", ["fp32_after", "folded"])
def test_jax_variables_carry_over(bn_mode, tiny_sd, tiny_x):
    """load_jax_variables: the JAX-calibrated, JAX-baked MobileNetV2 in a
    fresh port model gives JAX's logits."""
    jvars, jbaked, jlogits = _jax_run("bf16", bn_mode, tiny_sd, tiny_x)
    model = _port_model("fused", bn_mode)
    convert.load_jax_variables(model, jbaked)
    np.testing.assert_array_equal(
        model.block1_0.dw.weight.detach().numpy(),
        jbaked["params"]["block1_0"]["dw"]["kernel"].transpose(3, 2, 0, 1))
    with torch.no_grad():
        logits = model(_t(tiny_x), mode="fixed", quant_w=False).numpy()
    _one_grid_step(logits, jlogits, _logit_maxval(jvars))
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


# ---- (e) routes ----------------------------------------------------------------

def test_unbaked_block_takes_the_layer_path(tiny_x, monkeypatch):
    """Without a bake no stage has a fused state: the block runs per layer
    (the 1x1 convs on qmatmul with in-kernel weight quant, the depthwise
    convs composed)."""
    block = tmnv2.QuantInvertedResidual(
        16, 16, 1, 4, make_layer_config(engine="fused", **MAIN))
    x = _t(np.random.RandomState(1).normal(0, 1, (2, 8, 8, 16)))
    calibrate(block, [x], device="cpu")
    calls = {}
    _spy(monkeypatch, calls)
    with torch.no_grad():
        y = block(x, mode="fixed", out="factored")
    assert calls == {"fused_quant_matmul": 2}
    assert isinstance(y, Factored) and torch.isfinite(y.norm.float()).all()


def test_fused_block_equals_layer_path_bit_for_bit_on_cpu(tiny_sd, tiny_x):
    """On the CPU the qblock plain version and the per-layer route compute
    the same stages in the same order: the baked 'fused' model equals the
    'bf16' one on every logit."""
    fused, bf16 = _port_model("fused", "fp32_after", tiny_sd), \
        _port_model("bf16", "fp32_after", tiny_sd)
    calibrate(fused, [tiny_x], device="cpu")
    bf16.load_state_dict(fused.state_dict())
    bake_weights(fused)
    bake_weights(bf16)
    with torch.no_grad():
        a = fused(_t(tiny_x), mode="fixed", quant_w=False)
        b = bf16(_t(tiny_x), mode="fixed", quant_w=False)
    assert torch.equal(a, b)


def test_presets():
    base = make_layer_config(engine="fused", **MAIN)
    cfgs = tmnv2.mobilenet_v2_configs(base, "dw_bf16_acts")
    assert not cfgs["expand_config"].quant_a and not cfgs["dw_config"].quant_a
    assert tmnv2.mobilenet_v2_configs(base, "fc4_dw8")[
        "dw_config"].weight_quant.n_bits == 8
    # LSQ_paper (JAX mobilenet_v2.py:334-341; held against JAX in
    # tests/test_torch_layer_options.py)
    lsq = tmnv2.mobilenet_v2_configs(base, "LSQ_paper")
    assert lsq["config"].quantize_input and not lsq["tie_avgpool"]
    assert not lsq["stem_config"].quant_a and not lsq["block_act_config"].quant_a
    assert lsq["stem_config"].weight_quant.n_bits == 8
    assert lsq["fc_config"].act_quant.n_bits == 8
    with pytest.raises(ValueError):
        tmnv2.mobilenet_v2_configs(base, "nope")
    model = tmnv2.mobilenetv2_quantized(base, "dw_bf16_acts", device="cpu")
    names = {n for n, _ in model.named_modules()}
    assert {"stem", "block0_0.dw", "block0_0.project", "block1_1.block_act",
            "block6_0.expand", "head", "head_act", "classifier"} <= names
    assert "block0_0.expand" not in names and len(model.block_names) == 17


# ---- (f) the CLI and the loaders -------------------------------------------------

@pytest.mark.parametrize("bn_mode", ["fp32_after", "folded"])
def test_cli_mobilenet_validate_quantized_cpu(bn_mode, capsys):
    image_net.main(["validate-quantized", "--device", "cpu",
                    "--architecture", "mobilenet_v2_quantized",
                    "--engine", "fused", "--bn-mode", bn_mode,
                    "--per-channel", "--fp8-set-maxval",
                    "--num-est-batches", "1", "--max-eval-batches", "1",
                    "--batch-size", "2"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2 and np.isfinite(metrics["loss"])


def test_tonylins_loader_round_trip(tiny_sd):
    model = _port_model("parity", "fp32_after", tiny_sd)
    own = model.state_dict()
    key_map = convert.tonylins_key_map(model)
    assert set(key_map) == {k for k in tiny_sd if "num_batches" not in k}
    for src, dst in key_map.items():
        np.testing.assert_array_equal(own[dst].numpy(), tiny_sd[src])
    bad = dict(tiny_sd)
    bad.pop("features.2.conv.3.weight")
    with pytest.raises(KeyError):
        convert.load_tonylins_mobilenet_v2(model, bad)


def test_random_state_dict_uses_fan_in_scaling():
    sd = convert.random_mobilenet_v2_state_dict(0)
    for key, fan_in in (("features.0.0.weight", 27),
                        ("features.1.conv.0.weight", 9),
                        ("features.2.conv.0.weight", 16),
                        ("features.18.0.weight", 320)):
        std = float(sd[key].std())
        assert abs(std / np.sqrt(2.0 / fan_in) - 1) < 0.2, (key, std)
    assert sd["classifier.1.weight"].shape == (1000, 1280)
    assert len([k for k in sd if k.endswith("conv.3.weight")]) == 17
