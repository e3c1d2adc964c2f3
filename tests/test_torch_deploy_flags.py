"""The deployment flags of the port (``deploy_cast_quant``,
``deploy_cast_ieee``, ``deploy_act_f8``, ``conv_out_bf16``,
``int8_assume_signed``) against the JAX package (CPU).

* The configs: ``make_layer_config`` sets the same spec and config fields
  as JAX's.
* 1-byte norms: every consumer gives from a ``deploy_act_f8`` norm what it
  gives from the bfloat16 norm of the same values, bit for bit: the
  factored helpers per format, and whole tiny models (composed convs,
  linears, depthwise convs, pools, adds, means, LayerNorms and the
  kernels' plain versions) with ``factored.storage_dtype`` switched to
  bfloat16 storage.
* ``ops/int8`` with ``out_bf16`` / ``signed_static`` against JAX's, bit
  for bit (a bfloat16 result), and the ``int8_assume_signed`` bake raising
  on an unsigned grid as JAX's does.
* The bfloat16 promotion trap: a quantizer given a bfloat16 tensor
  computes in float32, as JAX's promotion does (torch keeps bfloat16 for a
  0-dim float32 operand).
* bench.py's five rows at small size (a few blocks, narrow widths, 8
  images of 32x32, the ViT 16x16): JAX calibrates, its state goes into the
  port (``load_jax_variables``), each package deploys (prepare_for_deployment,
  or the int8 bake) and runs bfloat16 serving input.
  - ``deploy_cast_quant`` alone (``int8_assume_signed`` alone on the INT8
    row) gives logits bit-equal to the exact config, on 'bf16' and
    'fused' (JAX's own test pins it there): the cast path's norms and
    factors are the exact ones scaled by powers of two, and the dropped
    ``s_w`` terms are zero.
  - The port's 'bf16' against JAX's 'bf16' with the row's flags: FP8 rows
    within one step of the last quantizer's grid (``max(|a|, |b|) * 2^-M
    + maxval * 2^-10``) on >= 95% of the logits, top-1 identical.  The two
    sum convolutions in other orders in float32; an ulp moves a value
    across a bin of the next grid now and then, and that is at most one
    step where the logit is read.  (Most rows are bit-equal at these
    seeds; MobileNetV2 is not, with the flags or without.)  The INT8 row's
    logits are stored in bfloat16 (``out_bf16``) with no quantizer after,
    so there the step is 2^-5 of the largest logit: the conv outputs'
    bfloat16 stores expose the last-bit differences of the BN scale
    (XLA's CPU rsqrt is not correctly rounded) as one-ulp flips, which
    move a few of the fc's input bins, each by ``a_delta`` times a weight
    (about 1% of the largest logit here); the exact and cast configs of
    that row are bit-equal to JAX at these seeds.
  - The port's 'fused' (the kernels' plain versions) against its 'bf16'
    with the flags: top-1 identical, and no logit further apart than the
    flags move 'bf16' (deploy against exact, the same images) plus one
    step: the kernels ignore ``conv_out_bf16`` and f8 storage, as the
    Pallas kernels do, so 'fused' keeps the exact grid where 'bf16'
    takes the flags.
* JAX's prepared variables with the cast constants carried into the port:
  the ``(12, C)`` constants and the logits of the port's own prepare.
* One CPU run of ``validate-quantized`` with ``--deploy-cast-quant
  --conv-out-bf16 --deploy-act-f8``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fp8_quantization_tpu.models.mobilenet_v2 as jmnv2
from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models import resnet as jresnet
from fp8_quantization_tpu.models.convert import (
    convert_mobilenet_v2, convert_resnet, convert_vit, merge_variables)
from fp8_quantization_tpu.models.vit import QuantizedViT as JViT
from fp8_quantization_tpu.nn import bake as jbake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.ops import int8 as jint8
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu.ops.s2d import space_to_depth as j_s2d
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.models import vit as tvit
from fp8_quantization_tpu_torch.models.resnet import QuantizedResNet, resnet_configs
from fp8_quantization_tpu_torch.nn import bake, factored
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.factored import Factored
from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
from fp8_quantization_tpu_torch.ops import fp8 as tfp8
from fp8_quantization_tpu_torch.ops import int8 as tint8
from fp8_quantization_tpu_torch.ops import quantizer as tq
from fp8_quantization_tpu_torch.ops.s2d import space_to_depth

torch.set_num_threads(1)

SEED, CLASSES, N = 5, 10, 8
FP8 = dict(qmethod="fp_quantizer", per_channel_weights=True,
           fp8_mantissa_bits=4, fp8_set_maxval=True,
           weight_range_method="current_minmax", act_range_method="allminmax",
           engine="bf16")
INT8 = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
            per_channel_weights=True, quantize_input=True,
            weight_range_method="current_minmax", act_range_method="allminmax",
            engine="bf16", int8_mxu=True)
DEPLOY = dict(deploy_cast_quant=True, conv_out_bf16=True)
MNV2 = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1))
VIT = dict(patch_size=4, dim=32, depth=2, num_heads=2, mlp_ratio=2)
STAGES = (1, 1, 1, 1)
# bench.py's rows (lines 198-266): arch, base config, the row's flags, the
# cast-only flags, preset, stem_s2d
ROWS = {
    "mnv2": ("mnv2", FP8, DEPLOY, dict(deploy_cast_quant=True),
             "dw_bf16_acts", False),
    "vit": ("vit", FP8, DEPLOY, dict(deploy_cast_quant=True), None, False),
    "resnet50": ("resnet50", FP8, dict(DEPLOY, deploy_act_f8=True),
                 dict(deploy_cast_quant=True), None, False),
    "resnet18_int8": ("resnet18", INT8,
                      dict(conv_out_bf16=True, int8_assume_signed=True),
                      dict(int8_assume_signed=True), None, False),
    "resnet18_fp8": ("resnet18", FP8, DEPLOY, dict(deploy_cast_quant=True),
                     None, "input"),
}


def _x(arch, n=N, seed=SEED):
    s = 16 if arch == "vit" else 32
    return np.random.RandomState(seed).standard_normal((n, s, s, 3)).astype(
        np.float32)


def _sd(arch):
    if arch == "mnv2":
        return convert.random_mobilenet_v2_state_dict(SEED, MNV2, CLASSES)
    if arch == "vit":
        return convert.random_vit_state_dict(
            SEED, depth=VIT["depth"], dim=VIT["dim"], mlp_ratio=VIT["mlp_ratio"],
            patch_size=VIT["patch_size"], image_size=16, num_classes=CLASSES)
    return convert.random_resnet_state_dict(SEED, STAGES, arch == "resnet50",
                                            CLASSES)


def _jax_model(arch, cfg, setup=None, s2d=False):
    c = j_make_config(**cfg)
    if arch == "mnv2":
        return jmnv2.mobilenetv2_quantized(c, quant_setup=setup,
                                           num_classes=CLASSES, settings=MNV2)
    if arch == "vit":
        return JViT(num_classes=CLASSES, config=c, **VIT)
    return jresnet.QuantizedResNet(
        stage_sizes=STAGES, bottleneck=arch == "resnet50",
        num_classes=CLASSES, stem_s2d=s2d, **jresnet.resnet_configs(c, setup))


def _port_model(arch, cfg, setup=None, s2d=False):
    c = make_layer_config(**cfg)
    if arch == "mnv2":
        model = tmnv2.mobilenetv2_quantized(c, quant_setup=setup,
                                            num_classes=CLASSES,
                                            settings=MNV2, device="cpu")
    elif arch == "vit":
        model = tvit.QuantizedViT(num_classes=CLASSES, image_size=16,
                                  config=c, **VIT)
    else:
        model = QuantizedResNet(STAGES, arch == "resnet50", CLASSES,
                                stem_s2d=s2d, **resnet_configs(c, setup))
    return model.eval()


def _jax_params(arch, sd):
    if arch == "mnv2":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmnv2, "INVERTED_RESIDUAL_SETTING", MNV2)
            return convert_mobilenet_v2(sd)
    if arch == "vit":
        return convert_vit(sd, depth=VIT["depth"])
    return convert_resnet(sd, STAGES, bottleneck=arch == "resnet50")


def _jax_calibrated(arch, cfg, setup, x):
    jmodel = _jax_model(arch, cfg, setup)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    jvars = merge_variables(jvars, *_jax_params(arch, _sd(arch)))
    return j_calibrate(jmodel, jvars, [jnp.asarray(x)])


def _last_quantizer(model):
    """The quantizer that sets the logits' grid: the classifier's."""
    for name in ("fc", "classifier", "head"):
        if hasattr(model, name):
            return getattr(model, name).act_q
    raise AssertionError("no classifier")


def _step(a, b, quantizer):
    """One step of the logits' grid (see the module docstring)."""
    if quantizer.spec.is_fp8:
        mbits = float(quantizer.state()["mantissa_bits"])
        return (np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -mbits
                + float(quantizer.state()["maxval"]) * 2.0 ** -10)
    return np.abs(b).max() * 2.0 ** -5


def _jax_deployed(arch, c, setup, s2d, jvars, x, xb):
    """JAX's deployed variables and its logits on ``xb`` (the int8 bake, or
    prepare_for_deployment with its bake jitted: only the prepare pass
    needs concrete values, for the cast constants' eligibility), run op by
    op: each bfloat16 store is then a real bfloat16 array, where XLA's CPU
    compiler may keep excess precision under jit
    (``xla_allow_excess_precision``) and skip conv_out_bf16's rounding."""
    jmodel = _jax_model(arch, c, setup)
    int8 = c.get("int8_mxu", False)
    if int8:
        jv = jbake.bake_int8_weights(jmodel, jvars, jnp.asarray(x[:1]))
    else:
        example = jnp.zeros((1,) + x.shape[1:])
        baked = jax.jit(lambda v, e: jbake.bake_weights(jmodel, v, e))(
            jvars, example)
        jv = jbake.prepare_inference(jmodel, baked, example, quant_w=False)
    return jv, np.asarray(_jax_model(arch, c, setup, s2d).apply(
        jv, xb, mode="fixed", quant_w=int8))


_RUNS = {}


def _row_run(row):
    """Logits of the row's three configs ('exact', 'cast', 'deploy') on the
    port's 'bf16' and 'fused', and of 'deploy' on JAX's 'bf16', all from
    JAX's calibrated state, on bfloat16 serving input."""
    if row in _RUNS:
        return _RUNS[row]
    arch, cfg, flags, cast, setup, s2d = ROWS[row]
    int8 = cfg is INT8
    x = _x(arch)
    jvars = _jax_calibrated(arch, cfg, setup, x)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if s2d == "input":
        xb, xt = j_s2d(xb), space_to_depth(xt)
    out = {}
    for name, extra in (("exact", {}), ("cast", cast), ("deploy", flags)):
        c = dict(cfg, **extra)
        res = {}
        if name == "deploy":
            res["jax_vars"], res["jax"] = _jax_deployed(arch, c, setup, s2d,
                                                        jvars, x, xb)
        for engine in ("bf16", "fused"):
            model = _port_model(arch, dict(c, engine=engine), setup, s2d)
            convert.load_jax_variables(model, jax.tree.map(np.asarray, jvars))
            example = torch.zeros(model.input_shape((1,) + x.shape[1:]))
            if int8:
                bake.bake_int8_weights(model)
                bake.prepare_inference(model, example, quant_w=True)
            else:
                bake.prepare_for_deployment(model, example)
            with torch.no_grad():
                res[engine] = model(xt, mode="fixed", quant_w=int8).float().numpy()
            res["quantizer"] = _last_quantizer(model)
        out[name] = res
    _RUNS[row] = out
    return out


@pytest.mark.parametrize("row", list(ROWS))
def test_row_cast_only_is_bit_exact(row):
    """The cast flag alone (INT8: the signed-grid flag alone) changes no
    logit, on 'bf16' and 'fused' (JAX's tests/test_cast_quant.py pins the
    same in JAX)."""
    run = _row_run(row)
    for key in ("bf16", "fused"):
        np.testing.assert_array_equal(run["cast"][key], run["exact"][key],
                                      err_msg=key)


@pytest.mark.parametrize("row", list(ROWS))
def test_row_bf16_matches_jax(row):
    """The port's 'bf16' against JAX's 'bf16' with the row's flags
    (tolerance in the module docstring)."""
    res = _row_run(row)["deploy"]
    a, b = res["bf16"], res["jax"]
    assert a.shape == (N, CLASSES) and np.isfinite(a).all()
    q = res["quantizer"]
    near = (np.abs(a - b) <= _step(a, b, q)).mean()
    assert near >= (0.95 if q.spec.is_fp8 else 1.0), (near, np.abs(a - b).max())
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("row", list(ROWS))
def test_row_fused_matches_bf16(row):
    """The port's 'fused' against its 'bf16' with the row's flags (bound in
    the module docstring); without the flags the two are within one step
    on >= 98% of the logits, as the model tests hold them."""
    run = _row_run(row)
    dep, exact = run["deploy"], run["exact"]
    a, b = dep["fused"], dep["bf16"]
    q = dep["quantizer"]
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    flags_gap = np.abs(dep["bf16"] - exact["bf16"]).max()
    assert np.all(np.abs(a - b) <= flags_gap + _step(a, b, q)), (
        np.abs(a - b).max(), flags_gap)
    a, b = exact["fused"], exact["bf16"]
    assert (np.abs(a - b) <= _step(a, b, q)).mean() >= (
        0.5 if row == "vit" else 0.98)


# ---- the configs -----------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    {}, dict(deploy_cast_quant=True), dict(deploy_cast_ieee=True),
    dict(deploy_act_f8=True), dict(deploy_cast_quant=True, deploy_act_f8=True),
    dict(conv_out_bf16=True), dict(int8_assume_signed=True, int8_mxu=True)],
    ids=lambda f: "-".join(f) or "defaults")
def test_flags_build_as_in_jax(flags):
    ours, theirs = make_layer_config(**flags), j_make_config(**flags)
    for field in ("cast_fastpath", "store_f8", "cast_ieee_subnorm"):
        for spec in ("weight_quant", "act_quant"):
            assert (getattr(getattr(ours, spec), field)
                    == getattr(getattr(theirs, spec), field)), (spec, field)
    for field in ("conv_out_bf16", "int8_assume_signed", "int8_mxu"):
        assert getattr(ours, field) == getattr(theirs, field), field


# ---- 1-byte norms ----------------------------------------------------------------

@pytest.mark.parametrize("mbits", [2, 3, 4])
def test_factored_helpers_read_one_byte_norms(mbits):
    """split, materialize, fadd, fmax_pool and fmean give from a 1-byte
    norm exactly what they give from its bfloat16 upcast."""
    spec = tq.QuantizerSpec(mantissa_bits=mbits, cast_fastpath=True,
                            store_f8=True)
    state = {"maxval": torch.tensor(3.0), "mantissa_bits": torch.tensor(float(mbits)),
             "sign_bits": torch.tensor(1, dtype=torch.int32)}
    x = torch.from_numpy(np.random.RandomState(mbits).normal(
        0, 1, (2, 6, 6, 8)).astype(np.float32))
    norm, factor = tq.apply_prepared(spec, tq.fixed_consts(spec, state), x,
                                     factored=True)
    assert norm.element_size() == 1
    one = Factored(factored.storage_dtype(norm), factor)
    bf = Factored(factored.upcast(norm), factor)
    assert bf.norm.dtype == torch.bfloat16
    for fn in (lambda f: factored.split(f)[0], factored.materialize,
               lambda f: factored.fadd(f, f),
               lambda f: factored.fmax_pool(f, 3, 2, 1).norm,
               lambda f: factored.fmean(f, (1, 2))):
        assert torch.equal(fn(one), fn(bf))


def _store_bf16(monkeypatch):
    """Store every quantizer output in bfloat16 (the same values)."""
    monkeypatch.setattr(factored, "storage_dtype",
                        lambda n: factored.upcast(n).to(torch.bfloat16))


CONSUMERS = {
    "resnet50": ("resnet50", None),
    "mnv2-fp32_after": ("mnv2", "fp32_after"),
    "mnv2-folded": ("mnv2", "folded"),
    "vit": ("vit", None),
}


@pytest.mark.parametrize("engine", ["bf16", "fused"])
@pytest.mark.parametrize("name", list(CONSUMERS))
def test_models_read_one_byte_norms_exactly(name, engine, monkeypatch):
    """A whole model under deploy_act_f8 gives bit-equal logits when every
    1-byte norm is stored as its bfloat16 upcast instead: each consumer
    (composed conv and linear, depthwise conv, pools, residual adds,
    means, LayerNorm, and on 'fused' the qmatmul, qconv3x3, qdwconv3x3 and
    qblock plain versions) reads the 1-byte array exactly.  The model is built so that 1-byte norms do reach
    them."""
    arch, bn_mode = CONSUMERS[name]
    cfg = dict(FP8, engine=engine, deploy_act_f8=True, deploy_cast_quant=True)
    if bn_mode:
        cfg["bn_mode"] = bn_mode
    model = _port_model(arch, cfg)
    {"mnv2": convert.load_tonylins_mobilenet_v2, "vit": convert.load_timm_vit,
     "resnet50": convert.load_torchvision_resnet}[arch](model, _sd(arch))
    x = _x(arch, n=2)
    calibrate(model, [x], device="cpu")
    bake.prepare_for_deployment(model, torch.zeros((1,) + x.shape[1:]))
    seen = []
    store = factored.storage_dtype
    monkeypatch.setattr(factored, "storage_dtype",
                        lambda n: seen.append(n.dtype) or store(n))
    with torch.no_grad():
        one = model(torch.from_numpy(x), mode="fixed", quant_w=False)
    assert torch.bits8 in seen
    _store_bf16(monkeypatch)
    with torch.no_grad():
        two = model(torch.from_numpy(x), mode="fixed", quant_w=False)
    assert torch.isfinite(one).all()
    assert torch.equal(one, two)


# ---- the int8 route ----------------------------------------------------------------

@pytest.mark.parametrize("signed_static", [False, True])
@pytest.mark.parametrize("out_bf16", [False, True])
@pytest.mark.parametrize("op", ["conv", "matmul"])
def test_int8_ops_flags_match_jax(op, out_bf16, signed_static):
    """int8_conv / int8_matmul with out_bf16 and signed_static equal JAX
    ops/int8, dtype included; a signed grid under signed_static equals the
    full algebra."""
    rs = np.random.RandomState(3)
    x = rs.normal(0, 1, (2, 8, 8, 16) if op == "conv" else (40, 24)).astype(
        np.float32)
    cout = 12
    w = rs.randint(-100, 100, (3, 3, 16, cout) if op == "conv" else (24, cout)
                   ).astype(np.int8)
    w_delta = rs.uniform(0.01, 0.02, cout).astype(np.float32)
    signed, a_delta, a_zero = np.float32(1), np.float32(0.03), np.float32(120.3)
    scale = rs.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = rs.normal(0, 0.1, cout).astype(np.float32)
    kw = dict(out_bf16=out_bf16, signed_static=signed_static)
    j = (jint8.int8_conv if op == "conv" else jint8.int8_matmul)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_delta), jnp.asarray(signed),
        jnp.asarray(a_delta), jnp.asarray(a_zero), 8, scale=jnp.asarray(scale),
        shift=jnp.asarray(shift), act_fn=jax.nn.relu, **kw)
    t = torch.from_numpy
    wt = t(w).permute(3, 2, 0, 1) if op == "conv" else t(w).t()
    ours = (tint8.int8_conv if op == "conv" else tint8.int8_matmul)(
        t(x), wt, t(w_delta), torch.tensor(signed), torch.tensor(a_delta),
        torch.tensor(a_zero), 8, scale=t(scale), shift=t(shift),
        act_fn=torch.relu, **kw)
    assert ours.dtype == (torch.bfloat16 if out_bf16 else torch.float32)
    assert j.dtype == (jnp.bfloat16 if out_bf16 else jnp.float32)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(j, np.float32))


def _int8_resnet(flags, unsigned_layer=None):
    model = _port_model("resnet18", dict(INT8, **flags))
    sd = _sd("resnet18")
    if unsigned_layer:
        sd[unsigned_layer] = np.abs(sd[unsigned_layer])
    convert.load_torchvision_resnet(model, sd)
    calibrate(model, [_x("resnet18", n=2)], device="cpu")
    return model, sd


def test_int8_assume_signed_bake_raises_on_unsigned_grids():
    """bake_int8_weights validates int8_assume_signed against the baked
    signedness and raises with JAX's message; signed grids pass, and
    without the flag an unsigned grid bakes."""
    model, _ = _int8_resnet(dict(int8_assume_signed=True))
    bake.bake_int8_weights(model)
    assert all(float(m.w_signed) == 1.0 for m in model.modules()
               if getattr(m, "w_signed", None) is not None)
    layer = "layer1.0.conv2.weight"
    model, sd = _int8_resnet(dict(int8_assume_signed=True), layer)
    with pytest.raises(ValueError, match=r"int8_assume_signed=True but "
                       r"unsigned weight grids were baked for: "
                       r"\['layer1_0/conv2'\]"):
        bake.bake_int8_weights(model)
    # JAX raises for the same grid
    x = _x("resnet18", n=2)
    jmodel = _jax_model("resnet18", dict(INT8, int8_assume_signed=True))
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    jvars = merge_variables(jvars, *convert_resnet(sd, STAGES, bottleneck=False))
    jvars = j_calibrate(jmodel, jvars, [jnp.asarray(x)])
    with pytest.raises(ValueError, match="layer1_0/conv2"):
        jbake.bake_int8_weights(jmodel, jvars, jnp.asarray(x[:1]))
    model, _ = _int8_resnet({}, layer)
    bake.bake_int8_weights(model)
    assert float(model.layer1_0.conv2.w_signed) == 0.0


def test_bf16_input_quantizes_in_float32_as_jax():
    """The promotion trap: torch keeps bfloat16 for bf16 * a 0-dim float32
    tensor, JAX promotes to float32.  A quantizer given a bfloat16 tensor
    (the int8 route's output under conv_out_bf16) equals JAX's quantizer on
    it and its own on the float32 values, per tensor FP8 and asymmetric."""
    x = np.random.RandomState(2).normal(0, 2, (64, 16)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for method, state in (
            ("fp_quantizer", {"maxval": 3.1, "mantissa_bits": 4.0,
                              "sign_bits": 1}),
            ("asymmetric_uniform", {"delta": 0.0371, "zero_float": 117.3})):
        spec = tq.QuantizerSpec(method=tq.QMethod(method))
        quantizer = Quantizer(spec, make_layer_config().act_range)
        quantizer.load_state(state)
        ours = quantizer(xb, mode="fixed")
        assert ours.dtype == torch.float32
        assert torch.equal(ours, quantizer(xb.float(), mode="fixed"))
        jstate = {k: jnp.asarray(v.numpy()) for k, v in quantizer.state().items()}
        j = jq.apply(jq.QuantizerSpec(method=jq.QMethod(method)), jstate,
                     jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
        assert j.dtype == jnp.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(j))


# ---- JAX's prepared cast constants ------------------------------------------------

def test_jax_cast_constants_carry_over():
    """JAX's prepared ResNet-50 row (deploy_cast_quant, conv_out_bf16,
    deploy_act_f8): its qprep dicts (with ``cast_probe``) load as the (12,
    C) constants the port's own prepare pass computes, and the port's
    logits with them equal its logits after its own prepare pass."""
    arch, cfg, flags, _, setup, _ = ROWS["resnet50"]
    jprep = jax.tree.map(np.asarray, _row_run("resnet50")["deploy"]["jax_vars"])
    model = _port_model(arch, dict(cfg, **flags), setup)
    convert.load_jax_variables(model, jprep)
    cast = [q for q in model.modules()
            if isinstance(q, Quantizer) and q.qprep is not None]
    assert cast and all(q.qprep.shape[0] == 12 for q in cast)
    for q in cast:
        assert torch.equal(q.qprep[6:], tq.fixed_consts(q.spec, q.state())[6:])
    x = torch.from_numpy(_x(arch)).to(torch.bfloat16)
    with torch.no_grad():
        with_jax = model(x, mode="fixed", quant_w=False)
    bake.prepare_inference(model, torch.zeros((1, 32, 32, 3)), quant_w=False)
    with torch.no_grad():
        assert torch.equal(with_jax, model(x, mode="fixed", quant_w=False))


# ---- the CLI ------------------------------------------------------------------------

def test_cli_deploy_flags_cpu(capsys):
    """validate-quantized with the three CLI flags on the CPU prints its
    JSON metrics line."""
    image_net.main(["validate-quantized", "--device", "cpu",
                    "--architecture", "resnet50_quantized", "--engine", "bf16",
                    "--per-channel", "--fp8-set-maxval", "--deploy-cast-quant",
                    "--conv-out-bf16", "--deploy-act-f8", "--num-est-batches",
                    "1", "--max-eval-batches", "1", "--batch-size", "2"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2
    assert np.isfinite(metrics["loss"])
