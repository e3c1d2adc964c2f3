"""The port's INT8 slice against the JAX package (CPU).

The same numpy inputs, made from a seed, go through fp8_quantization_tpu
(the reference) and fp8_quantization_tpu_torch:

* the uniform quantizers: values, state and the gradient w.r.t. x, bit for
  bit;
* ops/int8 (int8_conv, int8_matmul) against JAX ops/int8, and each int8
  kernel's plain version (what its wrapper takes for CPU tensors) against
  the JAX Pallas int8 kernel in interpret mode: rtol = atol = 2e-5, the
  tolerance of tests/test_xla_int8_layers.py, tests/test_pallas_qmatmul.py
  (lines 194-230) and tests/test_pallas_qconv.py (lines 142-178).  The
  integer sums are exact on both sides; the plain versions form the exact
  integer total before converting it to float, where JAX adds the
  corrections in float32, so the two differ only where a sum passes 2^24;
* the layers and the slice, a QuantizedResNet(stage_sizes=(1, 1, 1, 1)) on
  32x32 inputs with the int8 config (per-channel symmetric weights,
  asymmetric inputs, quantize_input, current_minmax / allminmax,
  int8_mxu), against JAX engine='bf16' + int8_mxu (its XLA s8 route):
  logits within 2e-5 and top-1 identical from one shared calibrated state.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models.convert import convert_resnet, merge_variables
from fp8_quantization_tpu.models.resnet import QuantizedResNet as JResNet
from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.bake import _pallas_gates_off
from fp8_quantization_tpu.nn.bake import bake_int8_weights as j_bake_int8
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.ops import int8 as jint8
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu.ops.pallas.qconv import (
    FusedConvConfig as JConvCfg, fused_quant_conv3x3 as j_conv)
from fp8_quantization_tpu.ops.pallas.qmatmul import (
    FusedQuantMatmulConfig as JMatCfg, fused_quant_matmul as j_matmul,
    int8_shifted_grid as j_grid)
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet_configs)
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import bake_int8_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.factored import Factored
from fp8_quantization_tpu_torch.ops import int8 as tint8
from fp8_quantization_tpu_torch.ops import quantizer as tq
from fp8_quantization_tpu_torch.ops.kernels import qconv_int8, qmatmul_int8

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
STAGES, CLASSES, SEED = (1, 1, 1, 1), 10, 5
INT8 = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
            per_channel_weights=True, quantize_input=True, int8_mxu=True,
            weight_range_method="current_minmax", act_range_method="allminmax")


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def _close(out, ref):
    out = out.detach().to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


# ---- uniform quantizers, bit for bit --------------------------------------

UNIFORM = {"sym_signed": "symmetric_uniform", "sym_unsigned": "symmetric_uniform",
           "asym": "asymmetric_uniform"}


@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("kind", list(UNIFORM))
def test_uniform_quantizer_bit_exact(kind, per_channel, n_bits):
    """set_quant_range, apply, apply_factored and d apply / dx, with ties:
    values on half steps and on the clip bounds (where jnp.clip and the
    port's min/max split the gradient in half)."""
    rng = np.random.RandomState(n_bits + 3 * per_channel + len(kind))
    w = (rng.standard_normal((16, 40)) * 0.3).astype(np.float32)   # (C, K)
    if kind == "sym_unsigned":
        w = np.abs(w)
    method = jq.QMethod(UNIFORM[kind])
    jspec = jq.QuantizerSpec(method=method, n_bits=n_bits, per_channel=per_channel)
    tspec = tq.QuantizerSpec(method=tq.QMethod(UNIFORM[kind]), n_bits=n_bits,
                             per_channel=per_channel)
    c = 16 if per_channel else None
    lo = w.min(axis=1) if per_channel else w.min()
    hi = w.max(axis=1) if per_channel else w.max()
    js = jq.set_quant_range(jspec, jq.init_state(jspec, c), jnp.asarray(lo),
                            jnp.asarray(hi))
    ts = tq.set_quant_range(tspec, tq.init_state(tspec, c), _t(lo), _t(hi))
    assert set(js) == set(ts)
    for k in js:
        _eq(js[k], ts[k])
    if kind == "sym_unsigned":
        assert int(ts["signed"]) == 0
    # ties: half steps, the bounds and beyond them, in every channel
    delta = np.broadcast_to(np.asarray(ts["delta"]), (16,)).astype(np.float32)
    zf = np.asarray(ts.get("zero_float", np.zeros(())), np.float32)
    top = np.float32(2.0 ** n_bits - 1 if kind != "sym_signed"
                     else 2.0 ** (n_bits - 1) - 1)
    top = top - np.round(np.broadcast_to(zf, (16,))) if kind == "asym" else top
    w[:, 0] = delta * np.float32(1.5)
    w[:, 1] = delta * np.float32(2.5)
    w[:, 2] = delta * top
    w[:, 3] = delta * (top + 3)
    if kind != "sym_unsigned":
        w[:, 4] = -delta * np.float32(0.5)
    wt = _t(w)
    _eq(jq.apply(jspec, js, jnp.asarray(w.T)).T, tq.apply(tspec, ts, wt, channel_axis=0))
    jn, jf = jq.apply_factored(jspec, js, jnp.asarray(w.T))
    tn, tf = tq.apply_factored(tspec, ts, wt, channel_axis=0)
    _eq(jn.T, tn)
    _eq(jnp.reshape(jf, -1), tf.reshape(-1))
    assert torch.equal(tn.to(torch.bfloat16).to(torch.float32), tn)

    g = rng.standard_normal(w.shape).astype(np.float32)
    jgrad = jax.grad(lambda xx: jnp.sum(jq.apply(jspec, js, xx) * g.T))(
        jnp.asarray(w.T))
    wg = _t(w).requires_grad_()
    (tq.apply(tspec, ts, wg, channel_axis=0) * _t(g)).sum().backward()
    _eq(jgrad.T, wg.grad)


# ---- ops/int8 against JAX ops/int8 ----------------------------------------

CONV_CASES = {
    # name: (kernel, stride, padding, cin, hw)
    "stem7x7_s2": (7, 2, 3, 3, 16),
    "conv3x3_s1": (3, 1, 1, 16, 8),
    "conv3x3_s2": (3, 2, 1, 16, 8),
    "conv1x1_s2": (1, 2, 0, 16, 8),
}


def _weight_state(w_last, signed: bool, n_bits=8):
    """(delta (C,), signed) of a per-channel symmetric quantizer over the
    last axis, as JAX calibrates it."""
    spec = jq.QuantizerSpec(method=jq.QMethod.symmetric_uniform,
                            per_channel=True, n_bits=n_bits)
    c = w_last.shape[-1]
    flat = w_last.reshape(-1, c)
    lo = flat.min(axis=0) if not signed else -np.abs(flat).max(axis=0)
    st = jq.set_quant_range(spec, jq.init_state(spec, c), jnp.asarray(lo),
                            jnp.asarray(flat.max(axis=0)))
    return np.asarray(st["delta"]), np.float32(st["signed"])


def _act_state(x):
    spec = jq.QuantizerSpec(method=jq.QMethod.asymmetric_uniform)
    st = jq.set_quant_range(spec, jq.init_state(spec), jnp.min(x), jnp.max(x))
    return np.float32(st["delta"]), np.float32(st["zero_float"])


def _operands(rng, wshape, signed, cout):
    w = (rng.standard_normal(wshape) * 0.2).astype(np.float32)
    if not signed:
        w = np.abs(w)
    delta, sgn = _weight_state(w, signed)
    wsg = np.asarray(j_grid(jnp.asarray(w), jnp.asarray(delta), jnp.float32(sgn),
                            8)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return w, wsg, delta, sgn, scale, shift


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_ops_int8_conv_matches_jax(case, signed):
    k, s, p, cin, hw = CONV_CASES[case]
    rng = np.random.RandomState(len(case) + signed)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    _, wsg, delta, sgn, scale, shift = _operands(rng, (k, k, cin, 8), signed, 8)
    ad, az = _act_state(x)
    ref = jint8.int8_conv(jnp.asarray(x), jnp.asarray(wsg), jnp.asarray(delta),
                          jnp.float32(sgn), jnp.float32(ad), jnp.float32(az), 8,
                          strides=(s, s), padding=((p, p), (p, p)),
                          scale=jnp.asarray(scale), shift=jnp.asarray(shift),
                          act_fn=jax.nn.relu)
    out = tint8.int8_conv(_t(x), _t(wsg.transpose(3, 2, 0, 1)), _t(delta),
                          torch.tensor(sgn), torch.tensor(ad), torch.tensor(az),
                          8, stride=s, padding=p, scale=_t(scale),
                          shift=_t(shift), act_fn=torch.relu)
    _close(out, ref)


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_ops_int8_matmul_matches_jax(signed):
    rng = np.random.RandomState(2 + signed)
    x = rng.standard_normal((13, 72)).astype(np.float32)
    _, wsg, delta, sgn, scale, shift = _operands(rng, (72, 40), signed, 40)
    ad, az = _act_state(x)
    ref = jint8.int8_matmul(jnp.asarray(x), jnp.asarray(wsg), jnp.asarray(delta),
                            jnp.float32(sgn), jnp.float32(ad), jnp.float32(az),
                            8, scale=jnp.asarray(scale), shift=jnp.asarray(shift))
    out = tint8.int8_matmul(_t(x), _t(wsg.T), _t(delta), torch.tensor(sgn),
                            torch.tensor(ad), torch.tensor(az), 8,
                            scale=_t(scale), shift=_t(shift))
    _close(out, ref)


# ---- each kernel's plain version against the Pallas int8 kernel ------------

MATMUL_CASES = {
    # name: (M, K, N, prequant, signed, activation)
    "prequant_signed_relu": (24, 64, 32, True, True, "relu"),
    "inkernel_signed": (24, 64, 32, False, True, None),
    "inkernel_unsigned_relu": (24, 64, 32, False, False, "relu"),
    "prequant_unsigned_ragged_mnk": (13, 72, 40, True, False, None),
    "fc_ragged_n": (5, 96, 100, True, True, None),
}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_qmatmul_int8_plain_matches_pallas(case):
    M, K, N, pre, signed, act = MATMUL_CASES[case]
    rng = np.random.RandomState(len(case))
    x = rng.standard_normal((M, K)).astype(np.float32)
    w, wsg, delta, sgn, scale, shift = _operands(rng, (K, N), signed, N)
    ad, az = _act_state(x)
    ws, as_ = np.float32([0.0, sgn]), np.float32([ad, az, 0.0])
    jcfg = JMatCfg(weight_method="int_sym", act_method="int_asym",
                   quantize_input=True, activation=act, mxu_dtype="int8",
                   w_prequant=pre)
    ref = j_matmul(jnp.asarray(x), jnp.asarray(wsg if pre else w),
                   jnp.asarray(delta), jnp.asarray(ws), jnp.asarray(as_),
                   jnp.asarray(scale), jnp.asarray(shift), cfg=jcfg,
                   interpret=True)
    out = qmatmul_int8.fused_quant_matmul_int8(
        _t(x), _t((wsg if pre else w).T), _t(delta), _t(ws), _t(as_),
        _t(scale), _t(shift), cfg=qmatmul_int8.Int8MatmulConfig(activation=act))
    assert out.dtype == torch.float32
    _close(out, ref)


QCONV_CASES = {
    # name: (stride, prequant, signed, activation)
    "s1_prequant_signed_relu": (1, True, True, "relu"),
    "s2_prequant_signed_relu": (2, True, True, "relu"),
    "s1_inkernel_unsigned": (1, False, False, None),
    "s2_inkernel_signed": (2, False, True, None),
    "s2_prequant_unsigned_relu": (2, True, False, "relu"),
}


@pytest.mark.parametrize("case", list(QCONV_CASES))
def test_qconv3x3_int8_plain_matches_pallas(case):
    stride, pre, signed, act = QCONV_CASES[case]
    n, hw, cin, cout = 2, 8, 16, 24
    rng = np.random.RandomState(3 + len(case))
    x = rng.standard_normal((n, hw, hw, cin)).astype(np.float32)
    w, wsg, delta, sgn, scale, shift = _operands(rng, (3, 3, cin, cout), signed,
                                                 cout)
    ad, az = _act_state(x)
    ws, as_ = np.float32([0.0, sgn]), np.float32([ad, az, 0.0])
    jcfg = JConvCfg(act_method="int_asym", activation=act, mxu_dtype="int8",
                    imgs_per_block=2, w_prequant=pre, stride=stride)
    ref = j_conv(jnp.asarray(x), jnp.asarray(wsg if pre else w), jnp.asarray(as_),
                 jnp.asarray(scale), jnp.asarray(shift),
                 weight_channel_param=jnp.asarray(delta),
                 weight_scalars=jnp.asarray(ws), cfg=jcfg, interpret=True)
    wm = (wsg if pre else w).transpose(3, 0, 1, 2).reshape(cout, -1)
    out = qconv_int8.fused_quant_conv3x3_int8(
        _t(x), _t(wm), _t(delta), _t(ws), _t(as_), _t(scale), _t(shift),
        cfg=qconv_int8.Int8ConvConfig(stride=stride, activation=act))
    _close(out, ref)


def test_int8_wrappers_take_plain_version_on_cpu():
    """CPU tensors never reach a kernel: the launch counts stay put."""
    before = (qmatmul_int8.fused_quant_matmul_int8.launches,
              qconv_int8.fused_quant_conv3x3_int8.launches)
    test_qmatmul_int8_plain_matches_pallas("inkernel_signed")
    test_qconv3x3_int8_plain_matches_pallas("s2_inkernel_signed")
    assert (qmatmul_int8.fused_quant_matmul_int8.launches,
            qconv_int8.fused_quant_conv3x3_int8.launches) == before
    with pytest.raises(ValueError, match="<= 8-bit"):
        qmatmul_int8.Int8MatmulConfig(n_bits=16)


# ---- layers ----------------------------------------------------------------

LAYER_CASES = {
    # name: (kind, kernel, stride, padding, input shape, bake)
    "conv3x3_s1": ("conv", 3, 1, 1, (2, 8, 8, 16), False),
    "conv3x3_s2_baked": ("conv", 3, 2, 1, (2, 8, 8, 16), True),
    "conv1x1_s2": ("conv", 1, 2, 0, (2, 8, 8, 16), False),
    "stem7x7_s2": ("conv", 7, 2, 3, (2, 16, 16, 3), False),
    "linear_baked": ("linear", 0, 0, 0, (4, 24), True),
}


@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layers_match_jax_int8_after_carry_over(case, engine):
    kind, k, s, p, shape, bake = LAYER_CASES[case]
    x = np.random.RandomState(9).standard_normal(shape).astype(np.float32)
    jcfg = j_make_config(engine="bf16", **INT8)
    tcfg = make_layer_config(engine=engine, **INT8)
    if kind == "conv":
        jmod = jlayers.QuantConv(features=16, kernel_size=(k, k), strides=(s, s),
                                 padding=((p, p), (p, p)), bn=True,
                                 activation="relu", config=jcfg)
        tmod = layers.QuantConv(shape[-1], 16, k, s, p, bn=True,
                                activation="relu", config=tcfg)
    else:
        jmod = jlayers.QuantLinear(features=12, config=jcfg)
        tmod = layers.QuantLinear(shape[-1], 12, config=tcfg)
    jv = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(8)
    if "batch_stats" in jv:
        jv = {**jv, "batch_stats": jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            jv["batch_stats"])}
    _, upd = jmod.apply(jv, jnp.asarray(x), mode="calibrate", mutable=["quant"])
    jv = {**jv, **upd}
    if bake:
        jv = j_bake_int8(jmod, jv, jnp.asarray(x))
        assert "baked_int8" in jv
    ref = jmod.apply(jv, jnp.asarray(x), mode="fixed")
    convert.load_jax_variables(tmod, _np_tree(jv))
    assert (tmod.w_int8 is not None) == bake
    with torch.no_grad():
        out = tmod(_t(x), mode="fixed")
    _close(out, ref)


def test_factored_input_to_1x1_and_fc_on_fused_equals_bf16():
    """A Factored block output (integer norm, factor) is materialized and
    re-quantized by the layer's own input quantizer on every engine; the
    JAX 'pallas' engine under FP8TPU_PALLAS_AUTOTUNE=always instead scales
    the norm by this layer's step (ROADMAP.md, section C)."""
    rng = np.random.RandomState(4)
    norm = torch.from_numpy(rng.randint(-40, 200, (2, 8, 8, 16)).astype(np.float32))
    xin = Factored(norm.to(torch.bfloat16), torch.tensor(0.037))
    outs = {}
    for engine in ("bf16", "fused"):
        torch.manual_seed(0)
        conv = layers.QuantConv(16, 32, 1, 2, 0, bn=True,
                                config=make_layer_config(engine=engine, **INT8))
        fc = layers.QuantLinear(16, 10, config=make_layer_config(engine=engine, **INT8))
        for mod in (conv, fc):
            calibrate(mod, [xin.norm.float() * xin.factor if mod is conv else
                            (xin.norm.float() * xin.factor).mean(dim=(1, 2))],
                      device="cpu")
        pooled = Factored(xin.norm[:, 0, 0, :], xin.factor)
        with torch.no_grad():
            outs[engine] = (conv(xin, mode="fixed"), fc(pooled, mode="fixed"))
    for a, b in zip(outs["fused"], outs["bf16"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ---- the slice --------------------------------------------------------------

def _port_model(engine="fused"):
    return QuantizedResNet(STAGES, False, CLASSES, **resnet_configs(
        make_layer_config(engine=engine, **INT8), None))


@pytest.fixture(scope="module")
def slice_run():
    sd = convert.random_resnet_state_dict(SEED, STAGES, num_classes=CLASSES)
    x = np.random.RandomState(SEED).standard_normal((2, 32, 32, 3)).astype(np.float32)

    jmodel = JResNet(stage_sizes=STAGES, bottleneck=False, num_classes=CLASSES,
                     config=j_make_config(engine="bf16", **INT8))
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    params, stats = convert_resnet(sd, STAGES, bottleneck=False)
    jvars = j_calibrate(jmodel, merge_variables(jvars, params, stats),
                        [jnp.asarray(x)])
    with _pallas_gates_off():
        jbaked = j_bake_int8(jmodel, jvars, jnp.asarray(x))
    apply = jax.jit(lambda v, xx: jmodel.apply(v, xx, mode="fixed", quant_w=True))
    jlogits = apply(jbaked, jnp.asarray(x))

    own = _port_model()
    convert.load_torchvision_resnet(own, sd)
    calibrate(own, [x], device="cpu")
    carried = _port_model()
    convert.load_jax_variables(carried, _np_tree(jvars))
    bake_int8_weights(carried)
    with torch.no_grad():
        logits = carried(_t(x), mode="fixed", quant_w=True)
    return dict(sd=sd, x=x, jvars=_np_tree(jvars), jbaked=_np_tree(jbaked),
                jlogits=np.asarray(jlogits), own=own, carried=carried,
                logits=logits.numpy())


def _quant_nodes(model):
    """(port quantizer path, module) of every quantizer in the model."""
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, Quantizer)]


def test_slice_calibrated_state_matches_jax(slice_run):
    """One calibration batch in each package: weight ranges bit-exact, input
    ranges equal to fp32 summation noise (activations are summed in
    another order)."""
    jq_tree, n_w, n_a = slice_run["jvars"]["quant"], 0, 0
    for name, qmod in _quant_nodes(slice_run["own"]):
        node = jq_tree
        for part in name.split("."):
            node = node[part]
        for k, v in qmod.state().items():
            if name.endswith("weight_q"):
                np.testing.assert_array_equal(v.numpy(), node["q"][k])
            else:
                np.testing.assert_allclose(v.numpy(), node["q"][k],
                                           rtol=1e-4, atol=1e-5)
        n_w += name.endswith("weight_q")
        n_a += not name.endswith("weight_q")
    assert n_w == 1 + 8 + 3 + 1 and n_a == n_w + 4


def test_slice_int8_bake_matches_jax(slice_run):
    """From the JAX-calibrated state, each package's int8 bake gives the
    same grids, steps and signedness, in every quantized layer."""
    jb, carried, n = slice_run["jbaked"]["baked_int8"], slice_run["carried"], 0
    for name, mod in carried.named_modules():
        if not isinstance(mod, layers.QuantizedLayerBase):
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
    assert n == 13


def test_slice_fused_logits_match_jax(slice_run):
    logits, jlogits = slice_run["logits"], slice_run["jlogits"]
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, jlogits, **TOL)
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def test_slice_jax_int8_bake_carries_over(slice_run):
    """load_jax_variables carries baked_int8: the JAX-baked state in a
    fresh port model gives JAX's logits."""
    model = _port_model()
    convert.load_jax_variables(model, slice_run["jbaked"])
    with torch.no_grad():
        logits = model(_t(slice_run["x"]), mode="fixed", quant_w=True).numpy()
    np.testing.assert_allclose(logits, slice_run["jlogits"], **TOL)


def test_slice_routes_on_fused(slice_run, monkeypatch):
    """On 'fused' the 3x3 convs take the int8 conv wrapper, the 1x1s and the
    fc the int8 matmul's, the stem ops/int8.int8_conv, and no FP8 kernel
    runs (on the CPU the wrappers take their plain versions)."""
    calls = {"qconv3x3_int8": 0, "qmatmul_int8": 0, "stem": 0, "fp8": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(qconv_int8, "qconv3x3_int8_plain",
                        spy("qconv3x3_int8", qconv_int8.qconv3x3_int8_plain))
    monkeypatch.setattr(qmatmul_int8, "qmatmul_int8_plain",
                        spy("qmatmul_int8", qmatmul_int8.qmatmul_int8_plain))
    monkeypatch.setattr(tint8, "int8_conv", spy("stem", tint8.int8_conv))
    for mod, name in ((layers.qconv, "fused_quant_conv3x3"),
                      (layers.qmatmul, "fused_quant_matmul")):
        monkeypatch.setattr(mod, name, spy("fp8", getattr(mod, name)))
    from fp8_quantization_tpu_torch.models import resnet
    monkeypatch.setattr(resnet.qstem, "fused_quant_stem",
                        spy("fp8", resnet.qstem.fused_quant_stem))
    with torch.no_grad():
        slice_run["carried"](_t(slice_run["x"]), mode="fixed", quant_w=True)
    assert calls == {"qconv3x3_int8": 8, "qmatmul_int8": 4, "stem": 1, "fp8": 0}


def test_cli_bake_keeps_int8_weights_quantized(slice_run):
    """The port's CLI bake under the int8 config (bake_for_eval) bakes the
    int8 grid and evaluates with quant_w=True: the logits equal the unbaked
    quantized run's, and differ from unquantized weights (what the JAX CLI's
    bake_weights + quant_w=False gives, ROADMAP.md section C)."""
    x = _t(slice_run["x"])
    model = _port_model("bf16")
    model.load_state_dict(slice_run["own"].state_dict())
    with torch.no_grad():
        quantized = model(x, mode="fixed", quant_w=True)
        unquantized = model(x, mode="fixed", quant_w=False)
        quant_w = image_net.bake_for_eval(model, True, True)
        baked = model(x, mode="fixed", quant_w=quant_w)
    assert quant_w is True and model.fc.w_int8 is not None
    assert torch.equal(baked, quantized)
    assert (baked - unquantized).abs().max() > 1e-3


def test_cli_int8_validate_quantized_cpu(capsys):
    image_net.main(["validate-quantized", "--device", "cpu", "--engine", "fused",
                    "--qmethod", "symmetric_uniform",
                    "--qmethod-act", "asymmetric_uniform", "--per-channel",
                    "--quantize-input", "--int8-mxu",
                    "--weight-quant-method", "current_minmax",
                    "--act-quant-method", "allminmax", "--num-est-batches", "1",
                    "--max-eval-batches", "1", "--batch-size", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    metrics = json.loads(line)
    assert metrics["num_examples"] == 4 and np.isfinite(metrics["loss"])


def test_fused_rejects_what_its_kernels_do_not_carry():
    """Under 'fused' in fixed mode, FP8 with input quantization and uniform
    output quantizers off the int8 datapath now run on the kernels' plain
    versions and agree with 'bf16' (their own tests are in
    tests/test_torch_int_grids.py); the int8 datapath with a depthwise conv
    runs ops/int8's grouped int8_conv on every engine (against JAX in
    tests/test_torch_int8_mobilenet.py)."""
    x = torch.randn(2, 8, 8, 16)
    cases = [dict(quantize_input=True),
             dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform")]
    for kw in cases:
        outs = {}
        for engine in ("bf16", "fused"):
            torch.manual_seed(0)
            conv = layers.QuantConv(16, 16, 1, 1, 0, bn=True,
                                    config=make_layer_config(engine=engine, **kw))
            calibrate(conv, [x], device="cpu")
            with torch.no_grad():
                outs[engine] = conv(x, mode="fixed")
            assert torch.isfinite(outs[engine]).all()
        torch.testing.assert_close(outs["fused"], outs["bf16"], rtol=1e-5,
                                   atol=1e-5)
    outs = {}
    for engine in ("bf16", "fused"):
        torch.manual_seed(0)
        dw = layers.QuantConv(16, 16, 3, 1, 1, groups=16, bn=True,
                              activation="relu6",
                              config=make_layer_config(engine=engine, **INT8))
        calibrate(dw, [x], device="cpu")
        with torch.no_grad():
            outs[engine] = dw(x, mode="fixed")
    assert torch.equal(outs["fused"], outs["bf16"])
