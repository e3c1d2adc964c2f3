"""MobileNetV2 on the int8 datapath against the JAX package (CPU).

* The grouped ``ops/int8.int8_conv`` (a depthwise 3x3, strides 1 and 2,
  signed and unsigned weight grids) against JAX's ``int8_conv`` with
  ``feature_group_count = C``: rtol = atol = 2e-5, tests/test_torch_int8.py's
  bound between the packages (the integer sums are exact on both sides);
  the depthwise layer on the int8 datapath against the parity fake-quant
  chain at the same bound, as JAX's test_quantconv_xla_int8_matches_parity
  holds its own, and against JAX's layer.
* The tiny MobileNetV2 of tests/test_torch_mobilenet.py (settings ((1, 8,
  1, 1), (6, 12, 2, 2), (6, 16, 1, 1)) at 32x32, batch 2, 10 classes) from
  one random tonylins state dict, with the int8 config (per-channel
  symmetric weights, asymmetric inputs, ``quantize_input``, ``int8_mxu``,
  current_minmax / allminmax), in both bn modes: JAX calibrates once on
  'bf16', and both packages evaluate that state (and JAX's int8 bake of
  it) on each engine, port 'fused' against JAX 'pallas' (on the CPU under
  its default gate mode every int8 layer of it takes the XLA s8 route):
  logits within 2e-5, top-1 identical.  The port's own int8 bake equals
  JAX's grids, and a baked forward with quant_w=False equals the unbaked
  one.
* The routes on 'fused' (the stem and the depthwise convs through
  ops/int8, the 1x1s and the classifier through qmatmul_int8, no qblock,
  qdwconv3x3 or FP8 qmatmul) and the CLI on the CPU.
"""

import functools
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
from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.bake import _pallas_gates_off
from fp8_quantization_tpu.nn.bake import bake_int8_weights as j_bake_int8
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.ops import int8 as jint8
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu.ops.pallas.qmatmul import int8_shifted_grid as j_grid
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import bake_int8_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.ops import int8 as tint8
from fp8_quantization_tpu_torch.ops.kernels import (
    qblock, qdwconv, qmatmul, qmatmul_int8)

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
TINY = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1))
CLASSES, SEED = 10, 4
INT8 = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
            per_channel_weights=True, quantize_input=True, int8_mxu=True,
            weight_range_method="current_minmax", act_range_method="allminmax")
ENGINES = {"parity": "parity", "bf16": "bf16", "fused": "pallas"}
BN_MODES = ("fp32_after", "folded")


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


# ---- the grouped int8_conv ----------------------------------------------------

def _dw_operands(rng, c, signed):
    w = (rng.standard_normal((3, 3, 1, c)) * 0.3).astype(np.float32)
    if not signed:
        w = np.abs(w)
    spec = jq.QuantizerSpec(method=jq.QMethod.symmetric_uniform,
                            per_channel=True)
    flat = w.reshape(-1, c)
    lo = -np.abs(flat).max(axis=0) if signed else flat.min(axis=0)
    st = jq.set_quant_range(spec, jq.init_state(spec, c), jnp.asarray(lo),
                            jnp.asarray(flat.max(axis=0)))
    delta, sgn = np.asarray(st["delta"]), np.float32(st["signed"])
    wsg = np.asarray(j_grid(jnp.asarray(w), jnp.asarray(delta),
                            jnp.float32(sgn), 8)).astype(np.int8)
    return wsg, delta, sgn


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_int8_conv_matches_jax(stride, signed):
    c = 24
    rng = np.random.RandomState(stride + 2 * signed)
    x = rng.standard_normal((2, 9, 9, c)).astype(np.float32)
    wsg, delta, sgn = _dw_operands(rng, c, signed)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ad = np.float32((x.max() - x.min()) / 255)
    az = np.float32(-x.min() / ad)
    ref = jint8.int8_conv(jnp.asarray(x), jnp.asarray(wsg), jnp.asarray(delta),
                          jnp.float32(sgn), ad, az, 8, strides=(stride, stride),
                          feature_group_count=c, scale=jnp.asarray(scale),
                          shift=jnp.asarray(shift),
                          act_fn=lambda y: jnp.clip(y, 0.0, 6.0))
    out = tint8.int8_conv(_t(x), _t(wsg.transpose(3, 2, 0, 1)), _t(delta),
                          torch.tensor(sgn), torch.tensor(ad), torch.tensor(az),
                          8, stride=stride, padding=1, scale=_t(scale),
                          shift=_t(shift), act_fn=lambda y: y.clamp(0.0, 6.0),
                          groups=c)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="depthwise"):
        tint8.int8_conv(_t(x), _t(wsg.transpose(3, 2, 0, 1)[:12]), _t(delta[:12]),
                        torch.tensor(sgn), torch.tensor(ad), torch.tensor(az), 8,
                        groups=12)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("engine", ["bf16", "fused"])
def test_depthwise_layer_int8_matches_parity_and_jax(engine, stride):
    """A depthwise 3x3 + BN + relu6 on the int8 datapath equals the parity
    fake-quant chain (int8_mxu off) and JAX's int8 layer from one
    calibrated state."""
    c = 32
    rng = np.random.RandomState(11 + stride)
    x = rng.normal(0, 1, (2, 14, 14, c)).astype(np.float32)
    jcfg = j_make_config(engine="bf16", **INT8)
    jmod = jlayers.QuantConv(features=c, kernel_size=(3, 3),
                             strides=(stride, stride), padding=((1, 1), (1, 1)),
                             feature_group_count=c, bn=True,
                             activation="relu6", config=jcfg)
    jv = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    jv = {**jv, "batch_stats": jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        jv["batch_stats"])}
    _, upd = jmod.apply(jv, jnp.asarray(x), mode="calibrate", mutable=["quant"])
    jv = _np_tree({**jv, **upd})
    ref = np.asarray(jmod.apply(jv, jnp.asarray(x), mode="fixed"))

    def port(cfg):
        mod = layers.QuantConv(c, c, 3, stride, 1, bn=True, activation="relu6",
                               groups=c, config=cfg)
        convert.load_jax_variables(mod, jv)
        with torch.no_grad():
            return mod(_t(x), mode="fixed")

    int8 = port(make_layer_config(engine=engine, **INT8))
    parity = port(make_layer_config(engine="parity", **dict(INT8, int8_mxu=False)))
    np.testing.assert_allclose(int8.numpy(), parity.numpy(), **TOL)
    np.testing.assert_allclose(int8.numpy(), ref, **TOL)


# ---- the tiny MobileNetV2 ----------------------------------------------------

def _sd():
    return convert.random_mobilenet_v2_state_dict(SEED, TINY, CLASSES)


def _x():
    return np.random.RandomState(SEED).normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)


def _jax_model(engine, bn_mode):
    return jmnv2.mobilenetv2_quantized(
        j_make_config(engine=engine, bn_mode=bn_mode, **INT8),
        num_classes=CLASSES, settings=TINY)


def _port_model(engine, bn_mode):
    return tmnv2.mobilenetv2_quantized(
        make_layer_config(engine=engine, bn_mode=bn_mode, **INT8),
        num_classes=CLASSES, settings=TINY, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_state(bn_mode):
    """(JAX-calibrated variables, their int8 bake), calibrated on 'bf16'."""
    jmodel = _jax_model("bf16", bn_mode)
    x = jnp.asarray(_x())
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmnv2, "INVERTED_RESIDUAL_SETTING", TINY)
        params, stats = convert_mobilenet_v2(_sd())
    jvars = j_calibrate(jmodel, merge_variables(jvars, params, stats), [x])
    with _pallas_gates_off():
        jbaked = j_bake_int8(jmodel, jvars, x)
    return _np_tree(jvars), _np_tree(jbaked)


@functools.lru_cache(maxsize=None)
def _jax_logits(engine, bn_mode, baked):
    jmodel = _jax_model(ENGINES[engine], bn_mode)
    return np.asarray(jax.jit(lambda v, xx: jmodel.apply(
        v, xx, mode="fixed", quant_w=not baked))(
            _jax_state(bn_mode)[baked], jnp.asarray(_x())), np.float32)


def _carried(engine, bn_mode, baked):
    model = _port_model(engine, bn_mode)
    convert.load_jax_variables(model, _jax_state(bn_mode)[baked])
    return model


def _forward(model, quant_w):
    with torch.no_grad():
        return model(_t(_x()), mode="fixed", quant_w=quant_w).numpy()


CASES = [(e, m, b) for e in ENGINES for m in BN_MODES for b in (False, True)]


@pytest.mark.parametrize("engine, bn_mode, baked", CASES)
def test_tiny_mobilenet_int8_matches_jax(engine, bn_mode, baked):
    model = _carried(engine, bn_mode, baked)
    assert (model.block1_0.dw.w_int8 is not None) == baked
    logits = _forward(model, quant_w=not baked)
    ref = _jax_logits(engine, bn_mode, baked)
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, ref, **TOL)
    np.testing.assert_array_equal(logits.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("bn_mode", BN_MODES)
def test_port_int8_bake_matches_jax_and_changes_nothing(bn_mode):
    """The port's int8 bake of JAX's calibrated state gives JAX's grids in
    all 15 quantized layers (the depthwise ones as (C, 9)), and the baked
    model's quant_w=False forward equals the unbaked quant_w=True one."""
    model = _carried("fused", bn_mode, False)
    unbaked = _forward(model, quant_w=True)
    bake_int8_weights(model)
    jb, n = _jax_state(bn_mode)[1]["baked_int8"], 0
    for name, mod in model.named_modules():
        if getattr(mod, "w_int8", None) is None:
            continue
        node = jb
        for part in name.split("."):
            node = node[part]
        w = node["w_int8"]
        w = w.transpose(3, 0, 1, 2).reshape(w.shape[3], -1) if w.ndim == 4 else w.T
        np.testing.assert_array_equal(mod.w_int8.numpy(), w)
        np.testing.assert_array_equal(mod.w_delta.numpy(), node["w_delta"])
        assert float(mod.w_signed) == float(node["w_signed"])
        n += 1
    assert n == 1 + 4 + 3 + 4 + 2 and model.block0_0.dw.w_int8.shape == (32, 9)
    np.testing.assert_array_equal(_forward(model, quant_w=False), unbaked)


def test_routes_on_fused(monkeypatch):
    calls = {"qmatmul_int8": 0, "int8_conv": 0, "fp8": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(qmatmul_int8, "qmatmul_int8_plain",
                        spy("qmatmul_int8", qmatmul_int8.qmatmul_int8_plain))
    monkeypatch.setattr(tint8, "int8_conv", spy("int8_conv", tint8.int8_conv))
    for mod, name in ((qblock, "fused_inverted_residual"),
                      (qdwconv, "fused_quant_dwconv3x3"),
                      (qmatmul, "fused_quant_matmul")):
        monkeypatch.setattr(mod, name, spy("fp8", getattr(mod, name)))
    model = _carried("fused", "fp32_after", True)
    _forward(model, quant_w=False)
    # 4 projects + 3 expands + head + classifier; the stem + 4 depthwise
    assert calls == {"qmatmul_int8": 9, "int8_conv": 5, "fp8": 0}


def test_cli_mobilenet_int8_validate_quantized_cpu(capsys):
    image_net.main(["validate-quantized", "--device", "cpu",
                    "--architecture", "mobilenet_v2_quantized",
                    "--engine", "fused", "--qmethod", "symmetric_uniform",
                    "--qmethod-act", "asymmetric_uniform", "--per-channel",
                    "--quantize-input", "--int8-mxu",
                    "--num-est-batches", "1", "--max-eval-batches", "1",
                    "--batch-size", "2"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2 and np.isfinite(metrics["loss"])
