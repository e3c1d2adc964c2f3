"""The deployment prepare pass (nn/bake.prepare_inference,
prepare_for_deployment) against the unprepared port and the JAX package
(CPU).

* ``fixed_consts`` / ``apply_prepared`` against JAX's at every mantissa
  width, per tensor and per channel: the quantized values and five of the
  six constant rows bit for bit; ``bias_frac_pow2`` (``exp2`` of the
  bias's fraction, which only picks the bin) within 8 ulps, as XLA's
  ``exp2`` and torch's round apart.
* The prepared forward against the unprepared one on the same model, bit
  for bit: tiny ResNet-18 (FP8, INT8 output quant, INT8 input quant),
  MobileNetV2 (both bn modes) and ViT, on 'parity', 'bf16' and 'fused'
  (the kernels' plain versions), with a forward that shows the prepared
  constants in use.
* JAX's ``prepare_for_deployment`` output carried into the port
  (``load_jax_variables`` with the ``qprep`` collection): JAX's constants
  equal the port's own (``fixed_consts`` on the carried state) as above,
  the port's logits with JAX's constants equal its logits after its own
  prepare pass, and they lie within the model tests' tolerance of JAX's
  prepared logits (one step of the last layer's FP8 or INT8 output grid on
  >= 98%, top-1 identical), which the packages' summation orders set:
  ResNet-18 FP8 and INT8 output quant on the three engines, MobileNetV2
  in both bn modes and the ViT on 'fused'.  (INT8 input quant is not
  compared: JAX's bake leaves its int8 weights unbaked, ROADMAP.md
  section C.)
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fp8_quantization_tpu.models.mobilenet_v2 as jmnv2
from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models.convert import (
    convert_mobilenet_v2, convert_resnet, convert_vit, merge_variables)
from fp8_quantization_tpu.models.resnet import QuantizedResNet as JResNet
from fp8_quantization_tpu.models.vit import QuantizedViT as JViT
from fp8_quantization_tpu.nn.bake import (
    _pallas_gates_off, prepare_for_deployment as j_prepare)
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.models import vit as tvit
from fp8_quantization_tpu_torch.models.resnet import QuantizedResNet, resnet_configs
from fp8_quantization_tpu_torch.nn import bake
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.layers import QuantizedLayerBase
from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
from fp8_quantization_tpu_torch.ops import quantizer as tq
from fp8_quantization_tpu_torch.ops.fp8 import FP8_CONST_ROWS

torch.set_num_threads(1)

CLASSES, SEED = 10, 5
FP8 = dict(per_channel_weights=True, fp8_mantissa_bits=4, fp8_set_maxval=True,
           weight_range_method="current_minmax", act_range_method="allminmax")
INT8_OQ = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
               per_channel_weights=True, weight_range_method="current_minmax",
               act_range_method="allminmax")
INT8_IQ = dict(INT8_OQ, quantize_input=True, int8_mxu=True)
RESNET = (1, 1, 1, 1)
MNV2 = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1))
VIT = dict(patch_size=4, dim=32, depth=2, num_heads=2, mlp_ratio=2)
JAX_ENGINE = {"parity": "parity", "bf16": "bf16", "fused": "pallas"}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _check_consts(rows, jconsts, shape, label=""):
    """(6, C) rows against JAX's fixed_consts dict: bit-equal, but
    bias_frac_pow2 within 8 ulps (XLA's exp2 rounds otherwise)."""
    for row, name in zip(rows, FP8_CONST_ROWS):
        ref = np.broadcast_to(np.asarray(jconsts[name]), shape).reshape(-1)
        diff = np.abs(_bits(row).astype(np.int64) - _bits(ref))
        assert diff.max() <= (8 if name == "bias_frac_pow2" else 0), (label, name)


def _x(size=32):
    return np.random.RandomState(SEED).normal(0, 1, (2, size, size, 3)).astype(
        np.float32)


# ---- fixed_consts / apply_prepared ---------------------------------------------

@pytest.mark.parametrize("mbits", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
def test_fixed_consts_and_apply_prepared_match_jax(mbits, per_channel):
    rs = np.random.RandomState(mbits)
    c = 5 if per_channel else None
    shape = (c,) if per_channel else ()
    maxval = rs.uniform(0.05, 40.0, shape).astype(np.float32)
    x = (rs.standard_t(3, (7, 5)) * 4).astype(np.float32)
    x[0, :3] = [0.0, 1e-30, -1e30]
    state = {"maxval": torch.tensor(maxval),
             "mantissa_bits": torch.tensor(float(mbits)),
             "sign_bits": torch.tensor(1, dtype=torch.int32)}
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    spec = tq.QuantizerSpec(per_channel=per_channel, mantissa_bits=mbits)
    jspec = jq.QuantizerSpec(per_channel=per_channel, mantissa_bits=mbits)
    consts = tq.fixed_consts(spec, state)
    jconsts = jq.fixed_consts(jspec, jstate)
    assert consts.shape == (6, c or 1)
    _check_consts(consts.numpy(), jconsts, maxval.shape)
    xt = torch.from_numpy(x)
    for factored in (False, True):
        ours = tq.apply_prepared(spec, consts, xt, factored=factored)
        ref = jq.apply_prepared(jspec, jconsts, jnp.asarray(x), factored=factored)
        plain = (tq.apply_factored if factored else tq.apply)(spec, state, xt)
        if factored:
            np.testing.assert_array_equal(_bits(ours[1]), _bits(ref[1]))
            np.testing.assert_array_equal(_bits(ours[1]), _bits(plain[1]))
            ours, ref, plain = ours[0], ref[0], plain[0]
        np.testing.assert_array_equal(_bits(ours), _bits(ref))
        np.testing.assert_array_equal(_bits(ours), _bits(plain))


def test_uniform_quantizers_have_no_fixed_consts():
    spec = tq.QuantizerSpec(method=tq.QMethod.asymmetric_uniform)
    assert tq.fixed_consts(spec, tq.init_state(spec)) is None


# ---- the port's models ----------------------------------------------------------

def _resnet(cfg, engine):
    model = QuantizedResNet(RESNET, False, CLASSES, **resnet_configs(
        make_layer_config(engine=engine, **cfg), None))
    convert.load_torchvision_resnet(
        model, convert.random_resnet_state_dict(SEED, RESNET, num_classes=CLASSES))
    return model


def _mnv2(engine, bn_mode):
    model = tmnv2.mobilenetv2_quantized(
        make_layer_config(engine=engine, bn_mode=bn_mode, **FP8),
        num_classes=CLASSES, settings=MNV2, device="cpu")
    convert.load_tonylins_mobilenet_v2(
        model, convert.random_mobilenet_v2_state_dict(SEED, MNV2, CLASSES))
    return model


def _vit(engine, size=16):
    model = tvit.QuantizedViT(num_classes=CLASSES, image_size=size,
                              config=make_layer_config(engine=engine, **FP8),
                              **VIT)
    convert.load_timm_vit(model, convert.random_vit_state_dict(
        SEED, depth=VIT["depth"], dim=VIT["dim"], mlp_ratio=VIT["mlp_ratio"],
        patch_size=VIT["patch_size"], image_size=size, num_classes=CLASSES))
    return model


MODELS = {
    "resnet-fp8": (lambda e: _resnet(FP8, e), 32, False),
    "resnet-int8-output-quant": (lambda e: _resnet(INT8_OQ, e), 32, False),
    "resnet-int8-input-quant": (lambda e: _resnet(INT8_IQ, e), 32, True),
    "mnv2-fp32_after": (lambda e: _mnv2(e, "fp32_after"), 32, False),
    "mnv2-folded": (lambda e: _mnv2(e, "folded"), 32, False),
    "vit": (_vit, 16, False),
}


def _forward(model, x, quant_w):
    with torch.no_grad():
        return model(torch.from_numpy(x), mode="fixed", quant_w=quant_w)


def _prepared(model):
    """Names of the buffers a prepare pass stored (qprep, kprep, prep_*)."""
    return [n for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1] in ("qprep", "kprep", "prep_fold",
                                         "prep_w_consts", "prep_int8_w_delta",
                                         "prep_int8_scalars", "prep_consts")]


@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
@pytest.mark.parametrize("name", list(MODELS))
def test_prepared_forward_is_bit_identical(name, engine):
    """Calibrate, bake (the int8 bake on the int8 datapath), then the
    prepared copy's logits equal the unprepared model's bit for bit, and
    the prepare pass stored constants that the forward reads."""
    build, size, int8 = MODELS[name]
    x = _x(size)
    model = build(engine)
    calibrate(model, [x], device="cpu")
    if int8:
        bake.bake_int8_weights(model)
    else:
        bake.bake_weights(model)
    quant_w = int8
    before = _forward(model, x, quant_w)
    prepared = bake.prepare_inference(copy.deepcopy(model),
                                      torch.zeros((1, size, size, 3)),
                                      quant_w=quant_w)
    after = _forward(prepared, x, quant_w)
    assert torch.isfinite(after).all()
    assert torch.equal(before, after)
    stored = _prepared(prepared)
    assert stored and not _prepared(model)
    assert set(stored) <= set(prepared.state_dict())
    if name.startswith("resnet-int8"):
        assert any(n.endswith("prep_fold") for n in stored)
    else:
        assert any(n.endswith("qprep") for n in stored)


def test_prepared_constants_are_read_not_recomputed(monkeypatch):
    """After the prepare pass a fused forward computes no FP8 constants
    (ops/fp8.fp8_consts) and no fold (QuantizedLayerBase._fold_values)."""
    from fp8_quantization_tpu_torch.ops import fp8 as tfp8
    x = _x()
    model = _resnet(FP8, "fused")
    calibrate(model, [x], device="cpu")
    bake.prepare_for_deployment(model, torch.zeros((1, 32, 32, 3)))
    calls = []
    for mod, name in ((tfp8, "fp8_consts"),
                      (QuantizedLayerBase, "_fold_values")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    _forward(model, x, False)
    assert calls == []


def test_prepare_for_deployment_host_moves_back():
    """prepare_for_deployment_host: bake and prepare on the host, the model
    back on its device, logits as prepare_for_deployment's."""
    x = _x()
    model = _resnet(FP8, "fused")
    calibrate(model, [x], device="cpu")
    other = copy.deepcopy(model)
    bake.prepare_for_deployment_host(model, (1, 32, 32, 3))
    bake.prepare_for_deployment(other, torch.zeros((1, 32, 32, 3)))
    assert next(model.parameters()).device.type == "cpu"
    assert torch.equal(_forward(model, x, False), _forward(other, x, False))


# ---- JAX's prepared variables in the port ---------------------------------------

def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jax_resnet(engine, cfg=FP8):
    jmodel = JResNet(stage_sizes=RESNET, bottleneck=False, num_classes=CLASSES,
                     config=j_make_config(engine=engine, **cfg))
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(_x()))
    sd = convert.random_resnet_state_dict(SEED, RESNET, num_classes=CLASSES)
    return jmodel, merge_variables(jvars, *convert_resnet(sd, RESNET,
                                                          bottleneck=False))


def _jax_mnv2(engine, bn_mode):
    jmodel = jmnv2.mobilenetv2_quantized(
        j_make_config(engine=engine, bn_mode=bn_mode, **FP8),
        num_classes=CLASSES, settings=MNV2)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(_x()))
    sd = convert.random_mobilenet_v2_state_dict(SEED, MNV2, CLASSES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmnv2, "INVERTED_RESIDUAL_SETTING", MNV2)
        params, stats = convert_mobilenet_v2(sd)
    return jmodel, merge_variables(jvars, params, stats)


def _jax_vit(engine, size=16):
    jmodel = JViT(num_classes=CLASSES, config=j_make_config(engine=engine, **FP8),
                  **VIT)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(_x(size)))
    sd = convert.random_vit_state_dict(
        SEED, depth=VIT["depth"], dim=VIT["dim"], mlp_ratio=VIT["mlp_ratio"],
        patch_size=VIT["patch_size"], image_size=size, num_classes=CLASSES)
    return jmodel, merge_variables(jvars, *convert_vit(sd, depth=VIT["depth"]))


JAX_CASES = {
    **{f"resnet-{e}": (lambda e=e: _jax_resnet(JAX_ENGINE[e]),
                       lambda e=e: _resnet(FP8, e), 32, "fc")
       for e in JAX_ENGINE},
    **{f"resnet-int8-output-quant-{e}": (
        lambda e=e: _jax_resnet(JAX_ENGINE[e], INT8_OQ),
        lambda e=e: _resnet(INT8_OQ, e), 32, "fc") for e in JAX_ENGINE},
    **{f"mnv2-{bn}": (lambda bn=bn: _jax_mnv2("pallas", bn),
                      lambda bn=bn: _mnv2("fused", bn), 32, "classifier")
       for bn in ("fp32_after", "folded")},
    "vit-fused": (lambda: _jax_vit("pallas"), lambda: _vit("fused"), 16, "head"),
}


def _jq_node(tree, name):
    for part in name.split("."):
        tree = tree.get(part) if isinstance(tree, dict) else None
        if tree is None:
            return None
    return tree


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_prepared_variables_carry_over(name):
    jbuild, build, size, head = JAX_CASES[name]
    x = _x(size)
    jmodel, jvars = jbuild()
    jvars = j_calibrate(jmodel, jvars, [jnp.asarray(x)])
    with _pallas_gates_off():
        jprep = _np_tree(jax.jit(lambda v, xx: j_prepare(jmodel, v, xx))(
            jvars, jnp.zeros((1, size, size, 3))))
    jlogits = np.asarray(jax.jit(lambda v, xx: jmodel.apply(
        v, xx, mode="fixed", quant_w=False))(jprep, jnp.asarray(x)))

    model = build()
    convert.load_jax_variables(model, jprep)
    carried = 0
    for qname, qz in model.named_modules():
        if not isinstance(qz, Quantizer) or qz.qprep is None:
            continue
        jc = _jq_node(jprep["qprep"], qname)["c"]
        _check_consts(tq.fixed_consts(qz.spec, qz.state()).numpy(), jc,
                      qz.maxval.shape, qname)
        carried += 1
    int8 = "int8" in name
    assert carried == 0 if int8 else carried >= 3   # JAX prepares FP8 only
    with_jax = _forward(model, x, False)
    bake.prepare_inference(model, torch.zeros((1, size, size, 3)), quant_w=False)
    assert torch.equal(with_jax, _forward(model, x, False))
    assert _prepared(model)

    logits = with_jax.numpy()
    q = jprep["quant"][head]["act_q"]["q"]
    if int8:        # one step of the fc's integer grid
        step = float(np.maximum(np.asarray(q["delta"]), 1e-8)) * (1 + 1e-6)
    else:
        step = (np.maximum(np.abs(logits), np.abs(jlogits)) * 2.0 ** -4
                + float(np.asarray(q["maxval"])) * 2.0 ** -10)
    near = (np.abs(logits - jlogits) <= step).mean()
    assert near >= 0.98, (near, np.abs(logits - jlogits).max())
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))
