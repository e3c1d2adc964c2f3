"""The MobileNetV2 slice's kernels and layers against the JAX package (CPU).

* The two kernel modules (their plain versions, which the wrappers take for
  CPU tensors) against the JAX Pallas kernels in interpret mode:
  ``qdwconv3x3`` with the tolerance of tests/test_pallas_qconv.py
  (rtol = atol = 2e-2, >= 98% exact); ``qblock`` with that of
  tests/test_pallas_qblock.py (rtol = atol = 1e-5), except where the port's
  exact exponent read and the Pallas ``log2`` + ``floor`` pick different
  FP8 bins: there at most one grid step, on < 1% of the elements.
* Folded BN on a depthwise and a 1x1 ``QuantConv`` against JAX
  ``bn_mode='folded'``: the baked (folded, quantized) weights and the
  folded shift bit-exact, outputs within one FP8 grid step; the folded bake
  is the identity after the fold.

The model, its routes, the CLI and the loaders: tests/test_torch_mobilenet.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.ops.pallas.qblock import (
    FusedBlockConfig as JBlockCfg, fused_inverted_residual as j_block)
from fp8_quantization_tpu.ops.pallas.qconv import (
    FusedConvConfig as JConvCfg, fused_quant_dwconv3x3 as j_dwconv)
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import bake_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
from fp8_quantization_tpu_torch.ops.kernels import qblock, qdwconv

torch.set_num_threads(1)

MBITS = 4
MAIN = dict(per_channel_weights=True, fp8_mantissa_bits=MBITS,
            fp8_set_maxval=True, weight_range_method="current_minmax",
            act_range_method="allminmax")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)


def _one_grid_step(out, ref, maxval, min_exact=0.98, min_near=1.0,
                   mbits=MBITS):
    """At least ``min_near`` of the elements within one FP8 grid step of the
    larger magnitude, and at least ``min_exact`` of them equal."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    step = (np.maximum(np.abs(out), np.abs(ref)) * 2.0 ** -mbits
            + maxval * 2.0 ** -10)
    near = (np.abs(out - ref) <= step).mean()
    assert near >= min_near, (near, np.abs(out - ref).max())
    exact = (out == ref).mean()
    assert exact >= min_exact, exact


def _act(maxval, mbits=MBITS):
    """(JAX act scalars, port (6, 1) constants) of one act quantizer, E3M4
    unless ``mbits`` says otherwise."""
    return (np.asarray([maxval, mbits, 1.0], np.float32),
            fp8_consts(torch.tensor([maxval], dtype=torch.float32), mbits))


# ---- (a) the depthwise kernel ------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
def test_qdwconv3x3_plain_matches_pallas(stride, emit):
    _qdwconv_case(stride, emit, MBITS)


@pytest.mark.parametrize("mbits", [2.0, 3.0, 5.0])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
def test_qdwconv3x3_plain_matches_pallas_other_formats(stride, emit, mbits):
    _qdwconv_case(stride, emit, mbits)


def _qdwconv_case(stride, emit, mbits):
    """The depthwise kernel with an output quantizer of M = ``mbits``."""
    c = 32
    rng = np.random.RandomState(41 + stride)
    x = _bf16(rng.normal(0, 1, (2, 8, 8, c)))
    w = _bf16(rng.normal(0, 0.3, (3, 3, c)))
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = rng.normal(0, 0.1, c).astype(np.float32)
    ja, ta = _act(4.0, mbits)
    ref = j_dwconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ja),
                   jnp.asarray(scale), jnp.asarray(shift),
                   cfg=JConvCfg(act_method="fp8", activation="relu6",
                                emit_norm=emit, stride=stride),
                   interpret=True)
    out = qdwconv.fused_quant_dwconv3x3(
        _t(x).to(torch.bfloat16), _t(w), ta, _t(scale), _t(shift),
        cfg=qdwconv.DwConvConfig(act_method="fp8", activation="relu6",
                                 emit_norm=emit, stride=stride))
    assert out.dtype == (torch.bfloat16 if emit else torch.float32)
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    assert out.shape == ref.shape == (2, 8 // stride, 8 // stride, c)
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)
    assert np.isclose(out, ref, rtol=1e-6, atol=1e-7).mean() >= 0.98


def test_dw_taps_sum_pads_with_zeros_and_adds_in_tap_order():
    """The plain stencil equals a float64 depthwise conv to float32
    rounding, and an image of ones gives the tap counts at the border."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(0, 1, (1, 5, 6, 3)))
    w = torch.from_numpy(rng.normal(0, 1, (3, 3, 3)))
    for s in (1, 2):
        ref = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w.permute(2, 0, 1)[:, None], stride=s,
            padding=1, groups=3).permute(0, 2, 3, 1)
        got = qdwconv.dw_taps_sum(x.float(), w.float(), s)
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)
    ones = qdwconv.dw_taps_sum(torch.ones(1, 4, 4, 1), torch.ones(3, 3, 1), 1)
    assert ones[0, 0, 0, 0] == 4 and ones[0, 1, 1, 0] == 9


# ---- (b) the block kernel ----------------------------------------------------

BLOCK_CASES = {
    # (expand, stride, use_res, cout, methods)
    "res": (True, 1, True, 16, ("fp8",) * 4),
    "stride2": (True, 2, False, 24, ("fp8",) * 4),
    "t1": (False, 1, False, 16, ("fp8",) * 4),
    "s1_no_res": (True, 1, False, 24, ("fp8",) * 4),
    "dw_bf16_acts": (True, 1, True, 16, ("none", "none", "fp8", "fp8")),
}


@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_qblock_plain_matches_pallas(case, emit):
    _qblock_case(case, emit, MBITS)


@pytest.mark.parametrize("mbits", [2.0, 3.0, 5.0])
@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_qblock_plain_matches_pallas_other_formats(case, emit, mbits):
    _qblock_case(case, emit, mbits)


def _qblock_case(case, emit, mbits):
    """One BLOCK_CASES block, its four quantizers of M = ``mbits``; held as
    at E3M4 (> 99% within 1e-5, all within one grid step), with a 95%
    bit-equal share in place of 99% for a float32 output at M = 2 and 3."""
    expand, stride, use_res, cout, methods = BLOCK_CASES[case]
    rng = np.random.RandomState(len(case))
    n, h, cin = 2, 8, 16
    hid = cin * 4 if expand else cin
    x = _bf16(rng.normal(0, 1, (n, h, h, cin)))
    w1 = _bf16(rng.normal(0, 0.2, (cin, hid))) if expand else None
    wd = _bf16(rng.normal(0, 0.2, (3, 3, hid)))
    w2 = _bf16(rng.normal(0, 0.2, (hid, cout)))
    vec = lambda c, lo, hi: rng.uniform(lo, hi, c).astype(np.float32)  # noqa: E731
    s1, b1 = (vec(hid, 0.5, 1.5), vec(hid, -0.1, 0.1)) if expand else (None, None)
    sd, bd = vec(hid, 0.5, 1.5), vec(hid, -0.1, 0.1)
    s2, b2 = vec(cout, 0.5, 1.5), vec(cout, -0.1, 0.1)
    maxvals = (6.0, 6.0, 4.0, 5.0)
    ja = np.asarray([[m, mbits, 1.0] for m in maxvals], np.float32)
    ta = torch.cat([_act(m, mbits)[1] for m in maxvals], dim=1)
    xf = np.float32(0.7)
    jcfg = JBlockCfg(expand=expand, stride=stride, use_res=use_res,
                     emit_norm=emit, methods=methods, imgs_per_block=2)
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = j_block(jnp.asarray(x), opt(w1), jnp.asarray(wd), jnp.asarray(w2),
                  jnp.asarray(ja), opt(s1), opt(b1), jnp.asarray(sd),
                  jnp.asarray(bd), jnp.asarray(s2), jnp.asarray(b2),
                  x_factor=jnp.asarray(xf) if use_res else None, cfg=jcfg,
                  interpret=True)
    topt = lambda a, dt=torch.float32: None if a is None else _t(a).to(dt)  # noqa: E731
    tcfg = qblock.FusedBlockConfig(expand=expand, stride=stride,
                                   use_res=use_res, emit_norm=emit,
                                   methods=methods)
    out = qblock.fused_inverted_residual(
        _t(x).to(torch.bfloat16), topt(w1, torch.bfloat16), _t(wd),
        _t(w2).to(torch.bfloat16), ta, topt(s1), topt(b1), _t(sd), _t(bd),
        _t(s2), _t(b2), torch.tensor(xf) if use_res else None, cfg=tcfg)
    assert out.dtype == (torch.bfloat16 if tcfg.out_bf16 else torch.float32)
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    assert out.shape == ref.shape == (n, h // stride, h // stride, cout)
    assert not np.allclose(out, 0)
    near = np.isclose(out, ref, rtol=1e-5, atol=1e-5)
    assert near.mean() > 0.99, near.mean()
    final = maxvals[3 if use_res else 2] * (2.0 ** -10 if not emit else 1.0)
    # float32 outputs at M = 2 and 3: the Pallas tile's bin step,
    # exp2(log_scales - M - 2^E + 1) (ops/pallas/qmatmul.py:94), reaches
    # 2^-17 and 2^-32 there, where XLA's CPU exp2 is 9 and 1 ulps off
    # (exact at M = 4 and 5's lowest bins, 2^-10 and 2^-7), so the tile is
    # off the composed quantizer the port follows on 0.06-0.18% of values
    # (ROADMAP.md section C, "Settled"), and the project sum carries them
    min_exact = 0.99 if emit or mbits >= MBITS else 0.95
    _one_grid_step(out, ref, final, min_exact=min_exact, mbits=mbits)


# ---- (c) folded BN -------------------------------------------------------------

FOLDED_CASES = {
    # name: (kernel, stride, groups, activation)
    "dw3x3_s1": (3, 1, 32, "relu6"),
    "dw3x3_s2": (3, 2, 32, "relu6"),
    "conv1x1": (1, 1, 1, None),
}


class _JaxLayer(fnn.Module):
    """One JAX QuantConv in a parent scope ("conv"): the JAX bake_weights
    neutralizes BN by the layer's path and reads ``bn_mode`` from the
    model's config."""
    case: str
    config: object

    @fnn.compact
    def __call__(self, x, **kw):
        k, s, groups, act = FOLDED_CASES[self.case]
        return jlayers.QuantConv(
            features=32, kernel_size=(k, k), strides=(s, s),
            padding=((k // 2, k // 2),) * 2, feature_group_count=groups,
            bn=True, activation=act, config=self.config, name="conv")(x, **kw)


def _jax_layer(case, engine, bn_mode):
    return _JaxLayer(case, j_make_config(engine=engine, bn_mode=bn_mode,
                                         **MAIN))


def _layer_vars(variables):
    """The "conv" scope of each collection of ``_JaxLayer``'s variables."""
    return {col: tree["conv"] for col, tree in variables.items()
            if "conv" in tree}


def _port_layer(case, engine, bn_mode, **over):
    k, s, groups, act = FOLDED_CASES[case]
    return layers.QuantConv(32, 32, k, s, k // 2, bn=True, activation=act,
                            groups=groups,
                            config=make_layer_config(engine=engine,
                                                     bn_mode=bn_mode,
                                                     **{**MAIN, **over}))


@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
@pytest.mark.parametrize("case", list(FOLDED_CASES))
def test_folded_layers_match_jax(case, engine):
    x = np.random.RandomState(9).normal(0, 1, (2, 8, 8, 32)).astype(np.float32)
    jmod = _jax_layer(case, "pallas" if engine == "fused" else engine, "folded")
    jv = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(8)
    # var + eps a power of 4, so that rsqrt is exact in both packages (XLA's
    # CPU rsqrt is not correctly rounded: it differs from torch.rsqrt in the
    # last bit on about a third of float32 inputs); gamma, beta and the mean
    # are random, so the fold is not trivial
    eps = np.float32(1e-5)
    var = (np.float32(4.0) ** rng.randint(-2, 2, 32)).astype(np.float32) - eps
    conv = jv["params"]["conv"]
    jv = {**jv, "batch_stats": {"conv": {
        "mean": jnp.asarray(rng.normal(0, 0.5, 32), jnp.float32),
        "var": jnp.asarray(var, jnp.float32)}}}
    jv = {**jv, "params": {"conv": {
        **conv,
        "gamma": jnp.asarray(rng.uniform(0.5, 1.5, 32), jnp.float32),
        "beta": jnp.asarray(rng.normal(0, 0.1, 32), jnp.float32)}}}
    _, upd = jmod.apply(jv, jnp.asarray(x), mode="calibrate", mutable=["quant"])
    jv = {**jv, **upd}
    with _pallas_gates_off():
        jb = _layer_vars(_np_tree(j_bake(jmod, jv, jnp.asarray(x))))
    ref = jax.jit(lambda v, xx: jmod.apply(v, xx, mode="fixed",
                                           quant_w=False))(
        {col: {"conv": tree} for col, tree in jb.items()}, jnp.asarray(x))
    jv = _layer_vars(_np_tree(jv))

    tmod = _port_layer(case, engine, "folded")
    convert.load_jax_variables(tmod, jv)
    calibrate(tmod, [x], device="cpu")
    bake_weights(tmod)
    # the folded, quantized weight and the folded shift are JAX's, bit for bit
    np.testing.assert_array_equal(tmod.weight.detach().numpy(),
                                  jb["params"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tmod.bn_bias.detach().numpy(),
                                  jb["params"]["beta"])
    np.testing.assert_array_equal(tmod.running_var.numpy(),
                                  jb["batch_stats"]["var"])
    with torch.no_grad():
        out = tmod(_t(x), mode="fixed", quant_w=False)
    maxval = float(jv["quant"]["act_q"]["q"]["maxval"])
    _one_grid_step(out.numpy(), np.asarray(ref), maxval)


def test_folded_differs_from_fp32_after_and_bake_is_identity():
    """Folding BN before quantizing changes the numbers (per-tensor weights:
    per channel, the fold would only rescale each channel's grid); after
    the folded bake the fold multiplies by exactly 1, so the baked forward
    equals the unbaked one bit for bit (bf16 engine)."""
    x = _t(np.random.RandomState(3).normal(0, 1, (2, 8, 8, 32)))
    outs = {}
    for mode in ("fp32_after", "folded"):
        torch.manual_seed(0)
        conv = _port_layer("dw3x3_s1", "bf16", mode,
                           per_channel_weights=False)
        with torch.no_grad():
            conv.running_var.uniform_(0.5, 1.5)
            conv.bn_weight.uniform_(0.5, 1.5)
            conv.bn_bias.normal_(0, 0.1)
        calibrate(conv, [x], device="cpu")
        with torch.no_grad():
            outs[mode] = before = conv(x, mode="fixed")
            folded_shift = conv._fold(None, None)[1].clone()
            bake_weights(conv)
            after = conv(x, mode="fixed", quant_w=False)
            assert torch.equal(conv._kernel(), conv.weight)
        assert torch.equal(before, after)
        if mode == "folded":
            assert torch.equal(conv._fold(None, None)[1], folded_shift)
            assert torch.equal(conv.bn_weight, torch.ones(32))
    assert not torch.equal(outs["fp32_after"], outs["folded"])


def test_folded_rejects_train_bn_and_int8_rejects_depthwise():
    conv = _port_layer("dw3x3_s1", "parity", "folded")
    with pytest.raises(ValueError, match="inference-time"):
        conv(torch.zeros(1, 4, 4, 32), mode="calibrate", train_bn=True)
    # the int8 datapath now takes a depthwise conv (through the grouped
    # ops/int8.int8_conv), and a grouped conv builds and runs on the
    # composed path (tests/test_torch_int8_mobilenet.py and
    # tests/test_torch_layer_options.py hold them against JAX)
    int8 = make_layer_config(qmethod="symmetric_uniform",
                             act_qmethod="asymmetric_uniform",
                             quantize_input=True, int8_mxu=True)
    x = torch.randn(2, 4, 4, 32)
    for conv in (layers.QuantConv(32, 32, 3, 1, 1, groups=32, config=int8),
                 layers.QuantConv(32, 64, 3, 1, 1, groups=2)):
        calibrate(conv, [x], device="cpu")
        with torch.no_grad():
            y = conv(x, mode="fixed")
        assert y.shape == (2, 4, 4, conv.features) and torch.isfinite(y).all()
    assert layers.QuantConv(32, 32, 3, 1, 1, groups=32, config=int8).int8_capable
    assert not layers.QuantConv(32, 64, 3, 1, 1, groups=2,
                                config=int8).int8_capable
    with pytest.raises(ValueError, match="must divide"):
        layers.QuantConv(32, 64, 3, 1, 1, groups=3)


@pytest.mark.parametrize("bn_mode", ["fp32_after", "folded"])
def test_resnet_stem_route_follows_bn_mode(bn_mode, monkeypatch):
    """Under folded BN the stem has no fused state, so a baked 'fused'
    ResNet runs its stem as a layer plus fmax_pool (JAX nn/layers.py:
    795-799), and the forward still equals the 'bf16' engine's bit for bit
    on the CPU; under fp32_after the stem runs qstem."""
    from fp8_quantization_tpu_torch.models.resnet import (
        QuantizedResNet, resnet_configs)
    from fp8_quantization_tpu_torch.ops.kernels import qstem
    stages = (1, 1, 1, 1)
    x = np.random.RandomState(5).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    sd = convert.random_resnet_state_dict(5, stages, num_classes=10)
    models = {}
    for engine in ("fused", "bf16"):
        m = QuantizedResNet(stages, False, 10, **resnet_configs(
            make_layer_config(engine=engine, bn_mode=bn_mode, **MAIN), None))
        convert.load_torchvision_resnet(m, sd)
        models[engine] = m
    calibrate(models["fused"], [x], device="cpu")
    models["bf16"].load_state_dict(models["fused"].state_dict())
    calls = []
    stem = qstem.fused_quant_stem
    monkeypatch.setattr(qstem, "fused_quant_stem",
                        lambda *a, **k: calls.append(1) or stem(*a, **k))
    with torch.no_grad():
        out = {}
        for engine, m in models.items():
            bake_weights(m)
            out[engine] = m(_t(x), mode="fixed", quant_w=False)
    assert len(calls) == (0 if bn_mode == "folded" else 1)
    assert torch.isfinite(out["fused"]).all()
    assert torch.equal(out["fused"], out["bf16"])
