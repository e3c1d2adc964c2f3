"""The layer and model options the port used to refuse, against the JAX
package (CPU): ``QuantConv1d``, ``QuantConvTranspose``, grouped convs
(groups 2 and 4), MobileNetV2's ``width_mult`` (0.5 and 1.4) and its
``LSQ_paper`` preset, all FP8 (E3M4 per-channel weights,
current_minmax / allminmax).

* Layers, on 'parity' and 'bf16': each package calibrates on its own, and
  the weight quantizer states are bit-exact, the input and output ranges
  within one float32 ulp (the products are summed in another order); the
  port's forward on JAX's calibrated state within one FP8 grid step of
  JAX's output (tests/test_torch_resnet.py's layer bound), 98% of it
  equal.  tests/test_conv_variants.py's shapes, and odd sizes: a 1-D conv
  with 'SAME' padding at stride 3 on 37 samples, transposed convs whose
  JAX padding crops torch's full output ('SAME' with k = 3, s = 2 on 7x9,
  'VALID' with k = (3, 5), s = (2, 1), explicit pairs).
* The tiny MobileNetV2 of tests/test_torch_mobilenet.py at width 0.5 and
  1.4, and under LSQ_paper: JAX's calibrated and baked state carried over,
  on 'parity' and 'bf16', top-1 identical; the logits within one grid step
  of the classifier's quantizer, 98% equal, and under LSQ_paper (whose
  logits are not quantized) at rtol = atol = 2e-5.
* 'fused' against 'bf16' in the port: the 1-D, transposed and grouped
  convs take the composed path there, bit-equal; LSQ_paper's 1x1s and
  classifier take qmatmul with its input quant (its plain version here),
  at rtol = atol = 2e-5.
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
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import bake_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.ops.kernels import qblock, qmatmul

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


def _one_grid_step(out, ref, maxval, min_exact=0.98):
    """Every element within one FP8 grid step of the larger magnitude (plus
    the subnormal step), at least ``min_exact`` of them equal."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    step = (np.maximum(np.abs(out), np.abs(ref)) * 2.0 ** -MBITS
            + maxval * 2.0 ** -10)
    assert np.all(np.abs(out - ref) <= step), np.abs(out - ref).max()
    assert (out == ref).mean() >= min_exact, (out == ref).mean()


# ---- the layers ---------------------------------------------------------------

# name: (JAX module kwargs, port class and kwargs, input shape)
LAYERS = {
    "conv1d_k5_s2": (
        ("QuantConv1d", dict(features=12, kernel_size=5, strides=2,
                             padding=((2, 2),), bn=True, activation="relu")),
        ("QuantConv1d", dict(features=12, kernel_size=5, stride=2,
                             padding=(2, 2), bn=True, activation="relu")),
        (4, 40, 6)),
    "conv1d_same_s3_odd_groups2": (
        ("QuantConv1d", dict(features=8, kernel_size=4, strides=3,
                             padding="SAME", feature_group_count=2)),
        ("QuantConv1d", dict(features=8, kernel_size=4, stride=3,
                             padding="SAME", groups=2)),
        (3, 37, 6)),
    "conv1d_valid": (
        ("QuantConv1d", dict(features=5, kernel_size=3, padding="VALID")),
        ("QuantConv1d", dict(features=5, kernel_size=3, padding="VALID")),
        (2, 11, 4)),
    "convT_k4_s2_same": (
        ("QuantConvTranspose", dict(features=8, kernel_size=(4, 4),
                                    strides=(2, 2))),
        ("QuantConvTranspose", dict(features=8, kernel_size=(4, 4),
                                    stride=(2, 2))),
        (2, 8, 8, 4)),
    "convT_k3_s2_same_odd": (
        ("QuantConvTranspose", dict(features=6, kernel_size=(3, 3),
                                    strides=(2, 2), activation="relu")),
        ("QuantConvTranspose", dict(features=6, kernel_size=(3, 3),
                                    stride=(2, 2), activation="relu")),
        (2, 7, 9, 4)),
    "convT_k3x5_valid": (
        ("QuantConvTranspose", dict(features=6, kernel_size=(3, 5),
                                    strides=(2, 1), padding="VALID")),
        ("QuantConvTranspose", dict(features=6, kernel_size=(3, 5),
                                    stride=(2, 1), padding="VALID")),
        (2, 5, 6, 4)),
    "convT_explicit_pads": (
        ("QuantConvTranspose", dict(features=6, kernel_size=(3, 3),
                                    strides=(2, 2),
                                    padding=((1, 2), (0, 1)))),
        ("QuantConvTranspose", dict(features=6, kernel_size=(3, 3),
                                    stride=(2, 2),
                                    padding=((1, 2), (0, 1)))),
        (2, 5, 5, 4)),
    "conv1d_transposed": (
        ("QuantConvTranspose", dict(features=6, kernel_size=(4,),
                                    strides=(3,))),
        ("QuantConvTranspose", dict(features=6, kernel_size=(4,),
                                    stride=(3,))),
        (2, 9, 4)),
    "grouped2_s1": (
        ("QuantConv", dict(features=24, kernel_size=(3, 3),
                           padding=((1, 1), (1, 1)), feature_group_count=2,
                           bn=True, activation="relu")),
        ("QuantConv", dict(features=24, kernel_size=3, padding=1, groups=2,
                           bn=True, activation="relu")),
        (2, 8, 8, 16)),
    "grouped4_s2": (
        ("QuantConv", dict(features=16, kernel_size=(3, 3), strides=(2, 2),
                           padding=((1, 1), (1, 1)), feature_group_count=4,
                           bn=True)),
        ("QuantConv", dict(features=16, kernel_size=3, stride=2, padding=1,
                           groups=4, bn=True)),
        (2, 8, 8, 16)),
}


def _port_layer(case, engine):
    (_, _), (cls, kw), shape = LAYERS[case]
    kw = dict(kw)
    features = kw.pop("features")
    cfg = make_layer_config(engine=engine, **MAIN)
    if cls == "QuantConv":
        kw = dict(kernel_size=kw.pop("kernel_size"), stride=kw.pop("stride", 1),
                  padding=kw.pop("padding"), **kw)
    return getattr(layers, cls)(shape[-1], features, config=cfg, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(case, engine):
    """(JAX-calibrated variables, JAX's fixed-mode output)."""
    (cls, kw), _, shape = LAYERS[case]
    x = np.random.RandomState(len(case)).normal(0, 1, shape).astype(np.float32)
    jmod = getattr(jlayers, cls)(config=j_make_config(engine=engine, **MAIN),
                                 **kw)
    jv = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    if "batch_stats" in jv:
        rng = np.random.RandomState(8)
        jv = {**jv, "batch_stats": jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            jv["batch_stats"])}
    _, upd = jmod.apply(jv, jnp.asarray(x), mode="calibrate", mutable=["quant"])
    jv = {**jv, **upd}
    ref = jmod.apply(jv, jnp.asarray(x), mode="fixed")
    return x, _np_tree(jv), np.asarray(ref)


@pytest.mark.parametrize("engine", ["parity", "bf16"])
@pytest.mark.parametrize("case", list(LAYERS))
def test_layer_matches_jax(case, engine):
    x, jv, ref = _jax_run(case, engine)
    carried = _port_layer(case, engine)
    convert.load_jax_variables(carried, jv)
    with torch.no_grad():
        out = carried(_t(x), mode="fixed")
    assert out.shape == ref.shape
    _one_grid_step(out.numpy(), ref, float(jv["quant"]["act_q"]["q"]["maxval"]))
    # calibrating on its own, from JAX's weights
    own = _port_layer(case, engine)
    convert.load_jax_variables(own, {k: v for k, v in jv.items()
                                     if k != "quant"})
    calibrate(own, [x], device="cpu")
    for name, q in (("weight_q", own.weight_q), ("act_q", own.act_q)):
        for key, value in q.state().items():
            theirs = np.asarray(jv["quant"][name]["q"][key]).reshape(-1)
            if name == "weight_q":
                np.testing.assert_array_equal(value.numpy().reshape(-1), theirs)
            else:
                np.testing.assert_array_max_ulp(
                    value.numpy().reshape(-1).astype(np.float32),
                    theirs.astype(np.float32), maxulp=1)


@pytest.mark.parametrize("case", list(LAYERS))
def test_layer_fused_equals_bf16(case):
    """No kernel takes these layers: 'fused' runs bf16's composed path."""
    x, jv, _ = _jax_run(case, "bf16")
    outs = []
    for engine in ("bf16", "fused"):
        mod = _port_layer(case, engine)
        convert.load_jax_variables(mod, jv)
        with torch.no_grad():
            outs.append(mod(_t(x), mode="fixed"))
        bake_weights(mod)
        with torch.no_grad():
            assert torch.equal(mod(_t(x), mode="fixed", quant_w=False), outs[-1])
    assert torch.equal(outs[0], outs[1])


def test_conv_transpose_pads_follow_jax():
    """JAX's padding rule of lax.conv_transpose, dimension by dimension."""
    from jax._src.lax.convolution import _conv_transpose_padding
    for k in range(1, 6):
        for s in range(1, 4):
            for pad in ("SAME", "VALID"):
                assert (layers.conv_transpose_pads(k, s, pad)
                        == _conv_transpose_padding(k, s, pad))


# ---- MobileNetV2: width_mult and LSQ_paper -----------------------------------

MODELS = {"width0.5": (0.5, None), "width1.4": (1.4, None),
          "lsq_paper": (1.0, "LSQ_paper")}


def _x():
    return np.random.RandomState(SEED).normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)


def _sd(width):
    return convert.random_mobilenet_v2_state_dict(SEED, TINY, CLASSES, width)


def _port_model(case, engine):
    width, setup = MODELS[case]
    return tmnv2.mobilenetv2_quantized(
        make_layer_config(engine=engine, **MAIN), setup, num_classes=CLASSES,
        settings=TINY, device="cpu", width_mult=width)


@functools.lru_cache(maxsize=None)
def _jax_model_run(case, engine):
    """(JAX-baked variables, baked logits, the classifier's output maxval
    or None)."""
    width, setup = MODELS[case]
    jmodel = jmnv2.mobilenetv2_quantized(
        j_make_config(engine=engine, **MAIN), setup, num_classes=CLASSES,
        width_mult=width, settings=TINY)
    x = jnp.asarray(_x())
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmnv2, "INVERTED_RESIDUAL_SETTING", TINY)
        params, stats = convert_mobilenet_v2(_sd(width))
    jvars = j_calibrate(jmodel, merge_variables(jvars, params, stats), [x])
    with _pallas_gates_off():
        jbaked = _np_tree(jax.jit(lambda v, xx: j_bake(jmodel, v, xx))(jvars, x))
    logits = np.asarray(jax.jit(lambda v, xx: jmodel.apply(
        v, xx, mode="fixed", quant_w=False))(jbaked, x))
    q = jbaked["quant"]["classifier"]["act_q"]["q"]
    return jbaked, logits, float(q.get("maxval", 0.0))


@pytest.mark.parametrize("engine", ["parity", "bf16"])
@pytest.mark.parametrize("case", list(MODELS))
def test_mobilenet_options_match_jax(case, engine):
    jbaked, jlogits, maxval = _jax_model_run(case, engine)
    model = _port_model(case, engine)
    convert.load_jax_variables(model, jbaked)
    width = MODELS[case][0]
    assert model.stem.features == int(32 * width)
    assert model.classifier.weight.shape[1] == (
        int(1280 * width) if width > 1 else 1280)
    with torch.no_grad():
        logits = model(_t(_x()), mode="fixed", quant_w=False).numpy()
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    _hold_logits(case, logits, jlogits, maxval)
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def _hold_logits(case, out, ref, maxval):
    """LSQ_paper's classifier quantizes its input, not its logits: they are
    unquantized float32 sums, held at the port's bound between packages
    for such outputs (rtol = atol = 2e-5, as tests/test_torch_int8_vit.py
    holds its logits).  The other models' logits lie on the classifier's
    FP8 grid: one grid step, 98% equal."""
    if case == "lsq_paper":
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    else:
        _one_grid_step(out, ref, maxval)


@pytest.mark.parametrize("case", list(MODELS))
def test_mobilenet_options_fused_equal_bf16(case, monkeypatch):
    """From one calibrated state: 'fused' (the kernels' plain versions)
    against 'bf16'.  Under LSQ_paper every 1x1 conv and the classifier
    take qmatmul with the input quantized in the kernel (7 + head +
    classifier), the depthwise convs and the stem the composed path.  A
    block runs qblock only where its widths are multiples of 8
    (``qblock.channels_ok``): one block at width 1.4 (16 -> 96 -> 16),
    none at 0.5."""
    jbaked, _, maxval = _jax_model_run(case, "bf16")
    calls, blocks = [], []
    fn, fn_block = qmatmul.fused_quant_matmul, qblock.fused_inverted_residual

    def spy(*a, cfg, **k):
        calls.append(cfg.quantize_input)
        return fn(*a, cfg=cfg, **k)
    monkeypatch.setattr(qmatmul, "fused_quant_matmul", spy)
    monkeypatch.setattr(qblock, "fused_inverted_residual",
                        lambda *a, **k: blocks.append(1) or fn_block(*a, **k))
    outs = {}
    for engine in ("bf16", "fused"):
        model = _port_model(case, engine)
        convert.load_jax_variables(model, jbaked)
        with torch.no_grad():
            outs[engine] = model(_t(_x()), mode="fixed", quant_w=False).numpy()
    assert len(blocks) == {"width0.5": 0, "width1.4": 1, "lsq_paper": 0}[case]
    if case == "lsq_paper":
        assert calls == [True] * 9
        _hold_logits(case, outs["fused"], outs["bf16"], maxval)
    else:
        np.testing.assert_array_equal(outs["fused"], outs["bf16"])
    np.testing.assert_array_equal(outs["fused"].argmax(-1),
                                  outs["bf16"].argmax(-1))


def test_width_mult_state_dict_and_loader():
    sd = _sd(1.4)
    assert sd["features.0.0.weight"].shape == (44, 3, 3, 3)
    assert sd["classifier.1.weight"].shape == (CLASSES, 1792)
    model = _port_model("width1.4", "parity")
    convert.load_tonylins_mobilenet_v2(model, sd)
    np.testing.assert_array_equal(model.block2_0.project.weight.detach().numpy(),
                                  sd["features.4.conv.6.weight"])


def test_cli_mobilenet_lsq_paper_validate_quantized_cpu(capsys):
    image_net.main(["validate-quantized", "--device", "cpu",
                    "--architecture", "mobilenet_v2_quantized",
                    "--engine", "fused", "--quant-setup", "LSQ_paper",
                    "--per-channel", "--fp8-set-maxval",
                    "--num-est-batches", "1", "--max-eval-batches", "1",
                    "--batch-size", "2"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2 and np.isfinite(metrics["loss"])
