"""The port's routes under the kernel gate (ops/kernels/autotune.py)
against the JAX package (CPU).

Tiny models from random weights: ResNet-18's topology at stage sizes
(1, 1, 1, 1) on 32x32 images (FP8, and INT8 on the int8 datapath),
MobileNetV2 at settings ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1)) on
32x32 in both bn modes, and a ViT (patch 4, dim 32, depth 2, 2 heads, MLP
ratio 2) on 16x16 images; batch 2, 10 classes.

* Under ``never`` the port's ``fused`` engine is its ``bf16`` engine bit
  for bit and launches no kernel, and it matches JAX ``engine='pallas'``
  under ``never`` (JAX's ``autotune.MODE`` monkeypatched): the port carries
  JAX's calibrated variables over and bakes them (JAX evaluates them with
  the weights quantized on the fly, the same values), and the logits are held
  to the model tests' tolerances (one grid step of the head's E3M4 output
  quantizer on every logit and >= 98% exact with top-1 identical for
  ResNet-18 and MobileNetV2, as tests/test_torch_resnet.py and
  test_torch_mobilenet.py; >= 98% within one step and top-1 identical for
  the ViT, as test_torch_vit.py (a); rtol = atol = 2e-5 on the int8
  datapath, as test_torch_int8.py).
* On the int8 datapath the 1x1 convs and the fc follow their own gate,
  ``int8_matmul_wins``: ops/int8 under ``never`` or a composed verdict,
  the int8 matmul kernel under ``always`` or a kernel verdict (JAX takes
  ops/int8 unraced outside ``always``, nn/layers.py:857, 1187).
* With the gates answering as on the card and a fake race that alternates
  its verdicts, the prepared forward is bit-equal to the unprepared one,
  whichever route each site's verdict picks, and the prepare pass races
  and records nothing.
* With the gates answering as on the card and real races (timed on the
  host here), each key races once, and a later forward launches the
  kernels its verdicts pick and races nothing.
"""

import copy
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fp8_quantization_tpu.models.mobilenet_v2 as jmnv2
import fp8_quantization_tpu.ops.pallas.autotune as jat
from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models.convert import (
    convert_mobilenet_v2, convert_resnet, convert_vit, merge_variables)
from fp8_quantization_tpu.models.resnet import QuantizedResNet as JResNet
from fp8_quantization_tpu.models.vit import QuantizedViT as JViT
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.models import vit as tvit
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet_configs)
from fp8_quantization_tpu_torch.nn.bake import (
    bake_int8_weights, bake_weights, prepare_inference)
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.ops import int8 as int8_ops
from fp8_quantization_tpu_torch.ops.kernels import (
    attention, autotune, qblock, qconv, qconv_int8, qdwconv, qmatmul,
    qmatmul_int8, qstem)

torch.set_num_threads(1)

CLASSES, SEED = 10, 7
MAIN = dict(per_channel_weights=True, fp8_mantissa_bits=4, fp8_set_maxval=True,
            weight_range_method="current_minmax", act_range_method="allminmax")
INT8 = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
            per_channel_weights=True, quantize_input=True, int8_mxu=True,
            weight_range_method="current_minmax", act_range_method="allminmax")
STAGES = (1, 1, 1, 1)
MNV2 = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1))
VIT = dict(patch_size=4, dim=32, depth=2, num_heads=2, mlp_ratio=2)
INT8_TOL = dict(rtol=2e-5, atol=2e-5)
# name -> (architecture, config, bn mode, image size, head layer)
MODELS = {"resnet18": ("resnet", MAIN, "fp32_after", 32, "fc"),
          "resnet18_int8": ("resnet", INT8, "fp32_after", 32, "fc"),
          "mnv2_fp32_after": ("mnv2", MAIN, "fp32_after", 32, "classifier"),
          "mnv2_folded": ("mnv2", MAIN, "folded", 32, "classifier"),
          "vit": ("vit", MAIN, "fp32_after", 16, "head")}
# the plain versions, which a kernel wrapper runs on CPU tensors
PLAIN = ((qmatmul, "qmatmul_plain"), (qconv, "qconv3x3_plain"),
         (qstem, "qstem_plain"), (qdwconv, "qdwconv3x3_plain"),
         (qblock, "qblock_plain"), (qconv_int8, "qconv3x3_int8_plain"),
         (qmatmul_int8, "qmatmul_int8_plain"), (attention, "flash_mha_plain"))


def _x(name):
    size = MODELS[name][3]
    return np.random.RandomState(SEED).normal(0, 1, (2, size, size, 3)).astype(
        np.float32)


def _int8(name):
    return MODELS[name][1] is INT8


def _jax_model(name):
    arch, cfg, bn_mode, _, _ = MODELS[name]
    config = j_make_config(engine="pallas", bn_mode=bn_mode, **cfg)
    if arch == "resnet":
        return JResNet(stage_sizes=STAGES, bottleneck=False,
                       num_classes=CLASSES, config=config)
    if arch == "mnv2":
        return jmnv2.mobilenetv2_quantized(config, num_classes=CLASSES,
                                           settings=MNV2)
    return JViT(num_classes=CLASSES, config=config, **VIT)


def _port_model(name, engine):
    arch, cfg, bn_mode, size, _ = MODELS[name]
    config = make_layer_config(engine=engine, bn_mode=bn_mode, **cfg)
    if arch == "resnet":
        return QuantizedResNet(STAGES, False, CLASSES,
                               **resnet_configs(config, None))
    if arch == "mnv2":
        return tmnv2.mobilenetv2_quantized(config, num_classes=CLASSES,
                                           settings=MNV2, device="cpu")
    return tvit.QuantizedViT(num_classes=CLASSES, image_size=size,
                             config=config, **VIT)


def _state_dict(name):
    arch = MODELS[name][0]
    if arch == "resnet":
        return convert.random_resnet_state_dict(SEED, STAGES,
                                                num_classes=CLASSES)
    if arch == "mnv2":
        return convert.random_mobilenet_v2_state_dict(SEED, MNV2, CLASSES)
    return convert.random_vit_state_dict(
        SEED, depth=VIT["depth"], dim=VIT["dim"], mlp_ratio=VIT["mlp_ratio"],
        patch_size=VIT["patch_size"], image_size=MODELS[name][3],
        num_classes=CLASSES)


def _jax_params(name, sd):
    arch = MODELS[name][0]
    if arch == "resnet":
        return convert_resnet(sd, STAGES, bottleneck=False)
    if arch == "mnv2":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmnv2, "INVERTED_RESIDUAL_SETTING", MNV2)
            return convert_mobilenet_v2(sd)
    return convert_vit(sd, depth=VIT["depth"])


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(JAX-calibrated variables, the logits of JAX engine='pallas' under
    MODE='never' with the weights quantized on the fly) of one model.  The
    bake changes no value, and JAX's eager bake would take most of this
    file's time."""
    x = jnp.asarray(_x(name))
    jmodel = _jax_model(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jat, "MODE", "never")
        jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
        jvars = j_calibrate(jmodel, merge_variables(
            jvars, *_jax_params(name, _state_dict(name))), [x])
        logits = jax.jit(lambda v, xx: jmodel.apply(
            v, xx, mode="fixed", quant_w=True))(jvars, x)
    return _np_tree(jvars), np.asarray(logits)


def _baked_port(name, engine, jvars):
    """The port's model on ``engine`` with JAX's calibrated variables,
    baked; (model, quant_w to evaluate with)."""
    model = _port_model(name, engine)
    convert.load_jax_variables(model, jvars)
    if _int8(name):
        return bake_int8_weights(model), True
    return bake_weights(model), False


def _count_plain(monkeypatch):
    calls = {}
    for mod, fname in PLAIN:
        fn = getattr(mod, fname)

        def spy(*a, _fn=fn, _name=fname, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, fname, spy)
    return calls


def _head_maxval(jvars, name):
    return float(jvars["quant"][MODELS[name][4]]["act_q"]["q"]["maxval"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_under_never_is_bf16_and_matches_jax_pallas(name, monkeypatch):
    jvars, jlogits = _jax_run(name)
    monkeypatch.setattr(autotune, "MODE", "never")
    x = torch.from_numpy(_x(name))
    out = {}
    calls = _count_plain(monkeypatch)
    for engine in ("fused", "bf16"):
        model, quant_w = _baked_port(name, engine, jvars)
        with torch.no_grad():
            out[engine] = model(x, mode="fixed", quant_w=quant_w)
    assert calls == {}, calls
    assert torch.equal(out["fused"], out["bf16"])
    logits = out["fused"].numpy()
    assert np.isfinite(logits).all() and logits.shape == (2, CLASSES)
    if _int8(name):
        np.testing.assert_allclose(logits, jlogits, **INT8_TOL)
        return
    step = (np.maximum(np.abs(logits), np.abs(jlogits)) * 2.0 ** -4
            + _head_maxval(jvars, name) * 2.0 ** -10)
    near = np.abs(logits - jlogits) <= step
    if MODELS[name][0] == "vit":
        assert near.mean() >= 0.98, near.mean()
    else:
        assert near.all(), np.abs(logits - jlogits).max()
        assert (logits == jlogits).mean() >= 0.98
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def _card_gates(tmp_path, monkeypatch):
    """The gates answer as on the card, in mode auto, from a fresh cache."""
    monkeypatch.setattr(autotune, "MODE", "auto")
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "live.json"))
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_TIMES", {})
    monkeypatch.setattr(autotune, "_DISK_LOADED", False)
    monkeypatch.setattr(autotune, "on_card", lambda *t: True)


@pytest.mark.parametrize("mode", ["never", "always", "auto:kernel",
                                  "auto:composed"])
def test_int8_1x1_and_fc_follow_their_gate(mode, tmp_path, monkeypatch):
    """ResNet-18's three 1x1 downsamples and the fc: ops/int8.int8_matmul
    under never and under a cached composed verdict of int8_matmul_wins,
    qmatmul_int8 (its plain version here) under always and under a kernel
    verdict; the 3x3 convs take qconv_int8 but under never."""
    jvars, _ = _jax_run("resnet18_int8")
    model, quant_w = _baked_port("resnet18_int8", "fused", jvars)
    kernel = mode in ("always", "auto:kernel")
    if mode.startswith("auto"):
        _card_gates(tmp_path, monkeypatch)
        # a verdict for every gated key: the 1x1s and the fc per mode, the
        # 3x3 convs the kernel
        monkeypatch.setattr(
            autotune, "_race", lambda what, key, *a: key[0] != "im" or kernel)
    else:
        monkeypatch.setattr(autotune, "MODE", mode)
    calls = _count_plain(monkeypatch)
    composed = []
    matmul = int8_ops.int8_matmul
    monkeypatch.setattr(int8_ops, "int8_matmul",
                        lambda *a, **k: composed.append(1) or matmul(*a, **k))
    with torch.no_grad():
        model(torch.from_numpy(_x("resnet18_int8")), mode="fixed",
              quant_w=quant_w)
    want = {} if mode == "never" else {"qconv3x3_int8_plain": 8}
    if kernel:
        want["qmatmul_int8_plain"] = 4
    assert calls == want
    assert len(composed) == (0 if kernel else 4)
    if mode.startswith("auto"):
        ims = {k: v for k, v in autotune.decisions().items() if k[0] == "im"}
        assert len(ims) == 4 and set(ims.values()) == {int(kernel)}


@pytest.fixture
def mixed_gates(tmp_path, monkeypatch):
    """The gates answer as on the card, from a fresh cache, with a fake
    race whose verdicts alternate kernel, composed, kernel, ...; returns
    the list of races run."""
    _card_gates(tmp_path, monkeypatch)
    verdicts = itertools.cycle((True, False))
    races = []

    def fake_race(what, key, kernel, composed, device):
        races.append(key)
        return next(verdicts)
    monkeypatch.setattr(autotune, "_race", fake_race)
    return races


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prepared_forward_bit_equal_under_mixed_verdicts(name, mixed_gates,
                                                         monkeypatch):
    """Whatever route each site's verdict picks, the prepared forward is
    bit-equal to the unprepared one; the prepare pass (one zero image)
    races and records nothing, and runs both routes of every gated site,
    so the routes of both verdicts run later on prepared constants."""
    model = _port_model(name, "fused")
    convert.load_jax_variables(model, _jax_run(name)[0])
    quant_w = _int8(name)
    (bake_int8_weights if quant_w else bake_weights)(model)
    prepared = copy.deepcopy(model)
    x = torch.from_numpy(_x(name))
    prepare_inference(prepared, torch.zeros((1,) + tuple(x.shape[1:])),
                      quant_w=quant_w)
    assert mixed_gates == [] and autotune.decisions() == {}
    calls = _count_plain(monkeypatch)
    with torch.no_grad():
        want = model(x, mode="fixed", quant_w=quant_w)
        n_races = len(mixed_gates)
        got = prepared(x, mode="fixed", quant_w=quant_w)
    assert len(mixed_gates) == n_races >= 2
    assert set(autotune.decisions().values()) == {0, 1}
    assert calls and all(n % 2 == 0 for n in calls.values())
    assert torch.equal(got, want)


# each gate and the plain version its "kernel" answer runs
GATE_PLAIN = {"pallas_wins": "qmatmul_plain",
              "int8_matmul_wins": "qmatmul_int8_plain",
              "conv3_group": "qconv3x3_plain",
              "conv3_int8_group": "qconv3x3_int8_plain",
              "dw_group": "qdwconv3x3_plain", "stem_group": "qstem_plain",
              "attn_wins": "flash_mha_plain", "ir_group": "qblock_plain"}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_real_races_then_the_verdicts_route(name, tmp_path, monkeypatch):
    """Real races of each site's two routes (host-timed here, so the
    verdicts are whatever they are): each key races once, in the first
    forward; the second forward races nothing, runs the plain version of
    each kernel its gates answer "kernel" for and nothing else, and its
    logits equal the first's."""
    model, quant_w = _baked_port(name, "fused", _jax_run(name)[0])
    _card_gates(tmp_path, monkeypatch)
    x = torch.from_numpy(_x(name))
    with torch.no_grad():
        first = model(x, mode="fixed", quant_w=quant_w)
    raced = autotune.races()
    assert raced and set(raced) == set(autotune.decisions())
    answers = {}
    for gate, plain in GATE_PLAIN.items():
        fn = getattr(autotune, gate)

        def tally(*a, _fn=fn, _plain=plain, **k):
            answer = _fn(*a, **k)
            kernel = answer[0] if isinstance(answer, tuple) else answer
            answers[_plain] = answers.get(_plain, 0) + int(bool(kernel))
            return answer
        monkeypatch.setattr(autotune, gate, tally)
    calls = _count_plain(monkeypatch)
    with torch.no_grad():
        second = model(x, mode="fixed", quant_w=quant_w)
    assert autotune.races() == raced
    assert calls == {k: n for k, n in answers.items() if n}
    assert torch.equal(first, second)
