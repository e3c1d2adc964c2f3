"""The integer grids of the fused FP8/bf16 kernel bodies and input
quantization in the quant-matmul, against the JAX package (CPU).

* Each kernel module's plain version (what its wrapper takes for CPU
  tensors) against the JAX Pallas kernel in interpret mode, with the output
  quant ``int_asym``: qmatmul at rtol = atol = 1e-5
  (tests/test_pallas_qmatmul.py:123), also with ``int_sym`` weights on the
  signed and the unsigned grid and with FP8 and ``int_asym`` input quant;
  qconv3x3, qstem, qdwconv3x3 and qblock (mixed ``int_asym`` / "none"
  stages) within one INT grid step everywhere and >= 98% exact, the
  matching tests' share (tests/test_pallas_qconv.py): the plain versions
  sum in another order than the Pallas bodies, so a value on a half step
  can round to the neighbouring integer.
* BASELINE config 2 (INT8 PTQ with output quant: per-channel
  ``symmetric_uniform`` weights, ``asymmetric_uniform`` activations,
  current_minmax / allminmax) on the layers and on a tiny ResNet and
  MobileNetV2: port 'fused' against JAX 'pallas', both from JAX's
  calibrated state, the JAX bake run inside nn/bake._pallas_gates_off()
  (ROADMAP.md section C).  Logits within one INT grid step of the last
  layer's output quantizer on >= 98% of elements, top-1 identical.
* The routes: which kernels the INT8 and the FP8 ``quantize_input`` models
  reach under 'fused', the composed route for quantizers the kernels do not
  take, and a ``Factored`` input to an input-quantizing qmatmul.
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
    convert_mobilenet_v2, convert_resnet, merge_variables)
from fp8_quantization_tpu.models.resnet import QuantizedResNet as JResNet
from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.ops.pallas.qblock import (
    FusedBlockConfig as JBlockCfg, fused_inverted_residual as j_block)
from fp8_quantization_tpu.ops.pallas.qconv import (
    FusedConvConfig as JConvCfg, fused_quant_conv3x3 as j_conv,
    fused_quant_dwconv3x3 as j_dwconv)
from fp8_quantization_tpu.ops.pallas.qmatmul import (
    FusedQuantMatmulConfig as JMatCfg, fused_quant_matmul as j_matmul)
from fp8_quantization_tpu.ops.pallas.qstem import (
    FusedStemConfig as JStemCfg, fused_quant_stem as j_stem)
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet_configs)
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import bake_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.factored import Factored
from fp8_quantization_tpu_torch.ops import kernels
from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
from fp8_quantization_tpu_torch.ops.kernels import (
    qblock, qconv, qconv_int8, qdwconv, qmatmul, qmatmul_int8, qstem)
from fp8_quantization_tpu_torch.ops.uniform import (
    asymmetric_set_quant_range, int_asym_consts, int_sym_consts,
    symmetric_set_quant_range)

torch.set_num_threads(1)

INT8_OQ = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
               per_channel_weights=True, weight_range_method="current_minmax",
               act_range_method="allminmax")
FP8_QI = dict(per_channel_weights=True, fp8_mantissa_bits=4, fp8_set_maxval=True,
              weight_range_method="current_minmax", act_range_method="allminmax",
              quantize_input=True)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)


def _act(x):
    """(JAX act scalars [delta, zero_float, 0], port (6, 1) constants) of an
    asymmetric 8-bit quantizer calibrated on ``x``'s range."""
    delta, zf = asymmetric_set_quant_range(torch.tensor(float(x.min())),
                                           torch.tensor(float(x.max())), 8)
    return (np.asarray([delta, zf, 0.0], np.float32),
            int_asym_consts(delta, zf, 8))


def _one_int_step(out, ref, step, min_exact=0.98):
    """Every element within one INT grid step, >= ``min_exact`` equal."""
    out = out.detach().to(torch.float32).numpy() if torch.is_tensor(out) else out
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    assert np.all(diff <= step * (1 + 1e-6) + 1e-6), diff.max() / step
    assert (diff == 0).mean() >= min_exact, (diff == 0).mean()


# ---- the kernels' plain versions against the Pallas bodies -------------------

MATMUL_CASES = {
    # name: (M, K, N, weight method, signed, act method, quantize_input,
    #        activation, emit_norm)
    "int_sym_w_int_asym_out_relu": (24, 96, 48, "int_sym", True, "int_asym",
                                    False, "relu", False),
    "int_sym_unsigned_w_emit_norm": (24, 96, 48, "int_sym", False, "int_asym",
                                     False, None, True),
    "baked_downsample_emit_norm": (40, 64, 128, "none", True, "int_asym",
                                   False, None, True),
    "ragged_fc_int_asym_logits": (5, 72, 100, "int_sym", True, "int_asym",
                                  False, None, False),
    "fp8_input_quant": (24, 96, 48, "fp8", True, "fp8", True, "relu", False),
    "int_asym_input_quant": (13, 72, 40, "int_sym", False, "int_asym", True,
                             None, False),
}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_qmatmul_int_plain_matches_pallas(case):
    M, K, N, wm, signed, am, qin, act, emit = MATMUL_CASES[case]
    rng = np.random.RandomState(len(case))
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.3).astype(np.float32)
    if not signed:
        w = np.abs(w)          # an all-non-negative layer: the [0, 255] grid
    scale = rng.uniform(0.5, 1.5, N).astype(np.float32)
    shift = (rng.standard_normal(N) * 0.1).astype(np.float32)
    if wm == "int_sym":
        delta, sgn = symmetric_set_quant_range(_t(w.min(axis=0)),
                                               _t(w.max(axis=0)), 8)
        assert int(sgn) == int(signed)
        jwc, jws = np.asarray(delta), np.float32([0.0, float(sgn)])
        w_c = int_sym_consts(delta, sgn, 8)
    elif wm == "fp8":
        jwc, jws = np.abs(w).max(axis=0), np.float32([4.0, 1.0])
        w_c = fp8_consts(_t(jwc), 4.0)
    else:                   # baked: weights already on the normalized grid
        x, w = _bf16(x), _bf16(w)
        jwc, jws, w_c = np.ones(N, np.float32), np.zeros(2, np.float32), None
    if am == "fp8":
        ja = np.float32([np.abs(x).max() * 0.8, 4.0, 1.0])
        ta = fp8_consts(torch.tensor([float(ja[0])]), 4.0)
    else:
        y = x @ w * scale if not qin else x
        ja, ta = _act(y * 0.8)
    jcfg = JMatCfg(weight_method=wm, act_method=am, quantize_input=qin,
                   activation=act, emit_norm=emit)
    ref = j_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(jwc),
                   jnp.asarray(jws), jnp.asarray(ja), jnp.asarray(scale),
                   jnp.asarray(shift), cfg=jcfg, interpret=True)
    out = qmatmul.fused_quant_matmul(
        _t(x), _t(w.T), w_c, ta, _t(scale), _t(shift),
        cfg=qmatmul.FusedQuantMatmulConfig(weight_method=wm, act_method=am,
                                           quantize_input=qin, activation=act,
                                           emit_norm=emit))
    assert out.dtype == (torch.bfloat16 if emit else torch.float32)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-5, atol=1e-5)


CONV_CASES = {
    # name: (stride, residual, emit_norm)
    "s1": (1, False, False),
    "s1_residual_emit_norm": (1, True, True),
    "s2_emit_norm": (2, False, True),
    "s2_residual": (2, True, False),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_qconv3x3_int_asym_plain_matches_pallas(case):
    stride, res, emit = CONV_CASES[case]
    n, h, cin, cout = 2, 8, 16, 8
    rng = np.random.RandomState(7 + stride + 2 * res)
    x = _bf16(rng.standard_normal((n, h, h, cin)))
    w = _bf16(rng.standard_normal((3, 3, cin, cout)) * 0.2)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    ho = h // stride
    residual = rng.standard_normal((n, ho, ho, cout)).astype(np.float32) if res else None
    ja, ta = _act(np.float32([-1.5, 5.0]))
    jcfg = JConvCfg(act_method="int_asym", activation="relu", residual=res,
                    emit_norm=emit, stride=stride)
    ref = j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ja),
                 jnp.asarray(scale), jnp.asarray(shift),
                 None if residual is None else jnp.asarray(residual),
                 cfg=jcfg, interpret=True)
    out = qconv.fused_quant_conv3x3(
        _t(x).to(torch.bfloat16), qconv.weight_matrix(_t(w.transpose(3, 2, 0, 1))),
        ta, _t(scale), _t(shift), None if residual is None else _t(residual),
        cfg=qconv.FusedConvConfig(act_method="int_asym", activation="relu",
                                  residual=res, emit_norm=emit, stride=stride))
    assert float(np.abs(np.asarray(ref)).max()) > 0
    _one_int_step(out, ref, 1.0 if emit else float(ta[0, 0]))


@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
def test_qstem_int_asym_plain_matches_pallas(emit):
    n, s, cin, cout = 2, 32, 3, 16
    rng = np.random.RandomState(11)
    x = rng.standard_normal((n, s, s, cin)).astype(np.float32)
    w = _bf16(rng.standard_normal((7, 7, cin, cout)) * 0.1)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    ja, ta = _act(np.float32([0.0, 3.0]))
    ref = j_stem(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ja),
                 jnp.asarray(scale), jnp.asarray(shift),
                 cfg=JStemCfg(act_method="int_asym", emit_norm=emit),
                 interpret=True)
    out = qstem.fused_quant_stem(
        _t(x), qstem.weight_matrix(_t(w.transpose(3, 2, 0, 1))), ta, _t(scale),
        _t(shift), cfg=qstem.FusedStemConfig(act_method="int_asym",
                                             emit_norm=emit))
    _one_int_step(out, ref, 1.0 if emit else float(ta[0, 0]))


@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
def test_qdwconv3x3_int_asym_plain_matches_pallas(stride, emit):
    c = 32
    rng = np.random.RandomState(43 + stride)
    x = _bf16(rng.normal(0, 1, (2, 8, 8, c)))
    w = _bf16(rng.normal(0, 0.3, (3, 3, c)))
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = rng.normal(0, 0.1, c).astype(np.float32)
    ja, ta = _act(np.float32([0.0, 4.0]))
    ref = j_dwconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ja),
                   jnp.asarray(scale), jnp.asarray(shift),
                   cfg=JConvCfg(act_method="int_asym", activation="relu6",
                                emit_norm=emit, stride=stride),
                   interpret=True)
    out = qdwconv.fused_quant_dwconv3x3(
        _t(x).to(torch.bfloat16), _t(w), ta, _t(scale), _t(shift),
        cfg=qdwconv.DwConvConfig(act_method="int_asym", activation="relu6",
                                 emit_norm=emit, stride=stride))
    assert out.dtype == (torch.bfloat16 if emit else torch.float32)
    _one_int_step(out, ref, 1.0 if emit else float(ta[0, 0]))


BLOCK_CASES = {
    # (expand, stride, use_res, cout, methods)
    "res": (True, 1, True, 16, ("int_asym",) * 4),
    "stride2": (True, 2, False, 24, ("int_asym",) * 4),
    "t1": (False, 1, False, 16, ("none", "int_asym", "int_asym", "none")),
    "dw_bf16_acts": (True, 1, True, 16, ("none", "none", "int_asym", "int_asym")),
}


@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_qblock_int_asym_plain_matches_pallas(case, emit):
    expand, stride, use_res, cout, methods = BLOCK_CASES[case]
    rng = np.random.RandomState(3 * len(case))
    n, h, cin = 2, 8, 16
    hid = cin * 4 if expand else cin
    x = _bf16(rng.normal(0, 1, (n, h, h, cin)))
    w1 = _bf16(rng.normal(0, 0.2, (cin, hid))) if expand else None
    wd = _bf16(rng.normal(0, 0.2, (3, 3, hid)))
    w2 = _bf16(rng.normal(0, 0.2, (hid, cout)))
    vec = lambda c, lo, hi: rng.uniform(lo, hi, c).astype(np.float32)  # noqa: E731
    s1, b1 = (vec(hid, 0.5, 1.5), vec(hid, -0.1, 0.1)) if expand else (None, None)
    sd, bd = vec(hid, 0.02, 0.05), vec(hid, -0.1, 0.1)
    s2, b2 = vec(cout, 0.02, 0.05), vec(cout, -0.1, 0.1)
    # relu6 stages on [0, 6]; the project and the block around 0
    ranges = ([0.0, 6.0], [0.0, 6.0], [-2.0, 2.0], [-3.0, 3.0])
    packed = [_act(np.float32(r)) for r in ranges]
    ja = np.stack([p[0] for p in packed])
    ta = torch.cat([p[1] for p in packed], dim=1)
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
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape == (n, h // stride, h // stride, cout)
    assert np.abs(ref).max() > 0
    final = tcfg.final_row
    step = 1.0 if tcfg.out_bf16 else float(ta[0, final])
    _one_int_step(out, ref, step)


def test_wrappers_take_plain_version_on_cpu_for_int_grids():
    """CPU tensors never reach a kernel, whatever the method: the launch
    counts stay put."""
    before = kernels.launch_counts()
    test_qmatmul_int_plain_matches_pallas("int_sym_w_int_asym_out_relu")
    test_qconv3x3_int_asym_plain_matches_pallas("s2_residual")
    test_qblock_int_asym_plain_matches_pallas("t1", True)
    assert kernels.launch_counts() == before


def test_int_consts_rows_and_the_unsigned_grid():
    """int_asym: the step floored at 1e-8, the zero point rounded half to
    even and clipped; int_sym: the signed or the unsigned grid."""
    c = int_asym_consts(torch.tensor(1e-9), torch.tensor(300.5), 8)
    assert c.shape == (6, 1)
    np.testing.assert_array_equal(c[:, 0].numpy(),
                                  np.float32([1e-8, 255, 0, 255, 0, 1e-9]))
    c = int_asym_consts(torch.tensor(0.5), torch.tensor(2.5), 8)
    assert float(c[1, 0]) == 2.0
    c = int_sym_consts(torch.tensor([0.1, 0.2]), torch.tensor(0), 8)
    np.testing.assert_array_equal(c[2:4].numpy(), [[0, 0], [255, 255]])
    c = int_sym_consts(torch.tensor([0.1, 0.2]), torch.tensor(1), 8)
    np.testing.assert_array_equal(c[2:4].numpy(), [[-128, -128], [127, 127]])
    np.testing.assert_array_equal(c[5].numpy(), np.float32([0.1, 0.2]))


# ---- the layers (extends tests/test_torch_int8.py LAYER_CASES) --------------

LAYER_CASES = {
    # name: (kind, kernel, stride, padding, input shape, bake)
    "conv3x3_s1": ("conv", 3, 1, 1, (2, 8, 8, 16), False),
    "conv3x3_s2_baked": ("conv", 3, 2, 1, (2, 8, 8, 16), True),
    "conv1x1_s2": ("conv", 1, 2, 0, (2, 8, 8, 16), False),
    "conv1x1_s1_baked": ("conv", 1, 1, 0, (2, 8, 8, 16), True),
    "stem7x7_s2": ("conv", 7, 2, 3, (2, 16, 16, 3), False),
    "linear_baked": ("linear", 0, 0, 0, (4, 24), True),
}


def _jax_layer(kind, k, s, p, shape, jcfg):
    if kind == "conv":
        return jlayers.QuantConv(features=16, kernel_size=(k, k), strides=(s, s),
                                 padding=((p, p), (p, p)), bn=True,
                                 activation="relu", config=jcfg)
    return jlayers.QuantLinear(features=12, config=jcfg)


def _port_layer(kind, k, s, p, shape, tcfg):
    if kind == "conv":
        return layers.QuantConv(shape[-1], 16, k, s, p, bn=True,
                                activation="relu", config=tcfg)
    return layers.QuantLinear(shape[-1], 12, config=tcfg)


def _carried_layer(case, engine, config):
    """(port layer with the JAX-calibrated [and baked] state, JAX output, x,
    quant_w): the JAX layer calibrated on x, baked inside
    _pallas_gates_off() where the case bakes."""
    kind, k, s, p, shape, bake = LAYER_CASES[case]
    x = np.random.RandomState(9).standard_normal(shape).astype(np.float32)
    jeng = "pallas" if engine == "fused" else engine
    jmod = _jax_layer(kind, k, s, p, shape, j_make_config(engine=jeng, **config))
    tmod = _port_layer(kind, k, s, p, shape, make_layer_config(engine=engine, **config))
    jv = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(8)
    if "batch_stats" in jv:
        jv = {**jv, "batch_stats": jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            jv["batch_stats"])}
    _, upd = jmod.apply(jv, jnp.asarray(x), mode="calibrate", mutable=["quant"])
    jv = {**jv, **upd}
    if bake:
        with _pallas_gates_off():
            jv = j_bake(jmod, jv, jnp.asarray(x))
    ref = jax.jit(lambda v, xx: jmod.apply(v, xx, mode="fixed",
                                           quant_w=not bake))(jv, jnp.asarray(x))
    convert.load_jax_variables(tmod, _np_tree(jv))
    return tmod, np.asarray(ref), x, not bake, _np_tree(jv)


@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layers_match_jax_int8_out_quant_after_carry_over(case, engine):
    """BASELINE config 2 on one layer: the output on the act quantizer's
    grid, within one INT step of JAX's and >= 98% equal."""
    tmod, ref, x, quant_w, jv = _carried_layer(case, engine, INT8_OQ)
    with torch.no_grad():
        out = tmod(_t(x), mode="fixed", quant_w=quant_w)
    delta = float(np.maximum(jv["quant"]["act_q"]["q"]["delta"], 1e-8))
    _one_int_step(out, ref, delta)


@pytest.mark.parametrize("case", ["conv1x1_s2", "conv1x1_s1_baked", "linear_baked"])
def test_layers_match_jax_fp8_quantize_input_on_fused(case):
    """FP8 input quantization in the qmatmul kernel against JAX 'pallas'
    (its _qmatmul_kernel quantizes x in the kernel too): rtol = atol =
    1e-5, tests/test_pallas_qmatmul.py's tolerance."""
    tmod, ref, x, quant_w, _ = _carried_layer(case, "fused", FP8_QI)
    calls = []
    wrapped = qmatmul.qmatmul_plain

    def spy(*a):
        calls.append(a[-1])
        return wrapped(*a)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qmatmul, "qmatmul_plain", spy)
        with torch.no_grad():
            out = tmod(_t(x), mode="fixed", quant_w=quant_w)
    assert [c.quantize_input and c.act_method for c in calls] == ["fp8"]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_bake_bakes_the_symmetric_grid_with_its_scale():
    """bake_weights under BASELINE config 2 (no int8_mxu): every layer holds
    its integer grid and w_factor is the weight quantizer's scale, as
    JAX's bake stores them; bake_for_eval takes bake_weights and evaluates
    with quant_w=False."""
    tmod, _, x, _, jv = _carried_layer("conv3x3_s1", "bf16", INT8_OQ)
    wq = tmod.weight_q.state()
    bake_weights(tmod)
    w = tmod.weight.detach()
    assert torch.equal(w, torch.round(w)) and float(w.abs().max()) <= 128
    torch.testing.assert_close(tmod.w_factor, wq["delta"].reshape(-1),
                               rtol=0, atol=0)
    with _pallas_gates_off():
        jb = j_bake(_jax_layer("conv", 3, 1, 1, None,
                               j_make_config(engine="bf16", **INT8_OQ)),
                    {k: jnp.asarray(v) if not isinstance(v, dict) else
                     jax.tree.map(jnp.asarray, v) for k, v in jv.items()},
                    jnp.asarray(x))
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jb["params"]["kernel"]).transpose(3, 2, 0, 1))
    model = QuantizedResNet((1, 1, 1, 1), False, 10, **resnet_configs(
        make_layer_config(engine="fused", **INT8_OQ), None))
    assert image_net.bake_for_eval(model, True, True) is False
    assert model.fc.w_factor is not None and model.fc.w_int8 is None


# ---- the tiny models ------------------------------------------------------------

STAGES, CLASSES, SEED = (1, 1, 1, 1), 10, 6
MNV2_TINY = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1))


def _spy_plain(monkeypatch, calls):
    """Count the plain versions the wrappers take on the CPU."""
    for mod, name in ((qstem, "qstem_plain"), (qconv, "qconv3x3_plain"),
                      (qmatmul, "qmatmul_plain"), (qdwconv, "qdwconv3x3_plain"),
                      (qblock, "qblock_plain"),
                      (qconv_int8, "qconv3x3_int8_plain"),
                      (qmatmul_int8, "qmatmul_int8_plain")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)


def _resnet(engine, config):
    return QuantizedResNet(STAGES, False, CLASSES, **resnet_configs(
        make_layer_config(engine=engine, **config), None))


@pytest.fixture(scope="module")
def resnet_run():
    """The tiny ResNet under BASELINE config 2: JAX 'pallas' calibrated and
    baked (inside _pallas_gates_off()), its logits; the port 'fused' model
    from JAX's calibrated state, baked by the port."""
    sd = convert.random_resnet_state_dict(SEED, STAGES, num_classes=CLASSES)
    x = np.random.RandomState(SEED).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jmodel = JResNet(stage_sizes=STAGES, bottleneck=False, num_classes=CLASSES,
                     config=j_make_config(engine="pallas", **INT8_OQ))
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    params, stats = convert_resnet(sd, STAGES, bottleneck=False)
    jvars = j_calibrate(jmodel, merge_variables(jvars, params, stats),
                        [jnp.asarray(x)])
    with _pallas_gates_off():
        jbaked = j_bake(jmodel, jvars, jnp.asarray(x))
    jlogits = jax.jit(lambda v, xx: jmodel.apply(v, xx, mode="fixed",
                                                 quant_w=False))(jbaked, jnp.asarray(x))
    model = _resnet("fused", INT8_OQ)
    convert.load_jax_variables(model, _np_tree(jvars))
    bake_weights(model)
    return dict(sd=sd, x=x, jvars=_np_tree(jvars), jbaked=_np_tree(jbaked),
                jlogits=np.asarray(jlogits), model=model)


def _fc_delta(jvars, name="fc"):
    return float(np.maximum(jvars["quant"][name]["act_q"]["q"]["delta"], 1e-8))


def test_tiny_resnet_int8_out_quant_matches_jax_pallas(resnet_run, monkeypatch):
    """1 qstem, 4 qconv3x3 and 4 qmatmul (3 downsamples, the fc) per
    forward, no int8 kernel, no launch on the CPU; the logits within one
    INT step of JAX's on >= 98% of elements, top-1 identical."""
    calls = {}
    _spy_plain(monkeypatch, calls)
    before = kernels.launch_counts()
    with torch.no_grad():
        logits = resnet_run["model"](_t(resnet_run["x"]), mode="fixed",
                                     quant_w=False).numpy()
    assert calls == {"qstem_plain": 1, "qconv3x3_plain": 8, "qmatmul_plain": 4}
    assert kernels.launch_counts() == before
    jlogits = resnet_run["jlogits"]
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    step = _fc_delta(resnet_run["jvars"])
    assert (np.abs(logits - jlogits) <= step * (1 + 1e-6)).mean() >= 0.98
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def test_tiny_resnet_int8_bake_matches_jax(resnet_run):
    """From JAX's calibrated state each package's bake stores the same
    integer grids and factors in every quantized layer."""
    jb, n = resnet_run["jbaked"], 0
    for name, mod in resnet_run["model"].named_modules():
        if not isinstance(mod, layers.QuantizedLayerBase):
            continue
        kernel = jb["params"]
        wf = jb["baked"]
        for part in name.split("."):
            kernel, wf = kernel[part], wf[part]
        k = kernel["kernel"]
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        np.testing.assert_array_equal(mod.weight.detach().numpy(), k)
        np.testing.assert_array_equal(mod.w_factor.numpy(), wf["w_factor"])
        n += 1
    assert n == 13


def test_tiny_resnet_fused_equals_bf16_on_cpu(resnet_run):
    """The plain versions and the bf16 engine compute the same arithmetic
    on the CPU: equal logits, the block tail re-quantizing the Factored
    residual sum with integer norms on both."""
    bf16 = _resnet("bf16", INT8_OQ)
    convert.load_jax_variables(bf16, resnet_run["jvars"])
    bake_weights(bf16)
    with torch.no_grad():
        a = resnet_run["model"](_t(resnet_run["x"]), mode="fixed", quant_w=False)
        b = bf16(_t(resnet_run["x"]), mode="fixed", quant_w=False)
    assert torch.equal(a, b)


def test_tiny_resnet_fp8_quantize_input_routes(monkeypatch):
    """FP8 with quantize_input on 'fused': the 1x1 downsamples and the fc
    run qmatmul with the input quantized in the kernel; the stem and the
    3x3 convs take the bf16 path, as in JAX (deploy_ok needs output quant,
    nn/layers.py:901-903)."""
    sd = convert.random_resnet_state_dict(SEED, STAGES, num_classes=CLASSES)
    x = np.random.RandomState(SEED).standard_normal((2, 32, 32, 3)).astype(np.float32)
    model = _resnet("fused", FP8_QI)
    convert.load_torchvision_resnet(model, sd)
    calibrate(model, [x], device="cpu")
    bake_weights(model)
    calls = {}
    _spy_plain(monkeypatch, calls)
    with torch.no_grad():
        logits = model(_t(x), mode="fixed", quant_w=False)
    assert calls == {"qmatmul_plain": 4}
    assert torch.isfinite(logits).all()


def test_factored_input_to_a_quantizing_qmatmul_is_materialized():
    """A Factored block output reaching a 1x1 conv that quantizes its input
    is materialized and re-quantized by the layer's own input quantizer (as
    on parity and the int8 datapath), so it gives what the materialized
    value gives, on 'fused' and on 'bf16' alike (up to summation order);
    the JAX 'pallas' engine instead quantizes the norm with this layer's
    scale, JAX's bf16 engine takes it unquantized (ROADMAP.md section C,
    tests/test_torch_quantize_input.py)."""
    rng = np.random.RandomState(4)
    norm = torch.from_numpy(rng.randint(0, 31, (2, 8, 8, 16)).astype(np.float32) / 4)
    xin = Factored(norm.to(torch.bfloat16), torch.tensor(0.37))
    value = xin.norm.float() * xin.factor
    torch.manual_seed(0)
    conv = layers.QuantConv(16, 32, 1, 2, 0, bn=True,
                            config=make_layer_config(engine="fused", **FP8_QI))
    calibrate(conv, [value * 0.6], device="cpu")   # a range that clips
    with torch.no_grad():
        a = conv(xin, mode="fixed")
        b = conv(value, mode="fixed")
        conv.config = conv.config.replace(engine="bf16")
        c = conv(xin, mode="fixed")
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) <= 1e-5 * float(a.abs().max())


def test_composed_route_for_quantizers_the_kernels_do_not_take(monkeypatch):
    """Asymmetric weights or symmetric activations under 'fused' take the
    bf16 path, as JAX's _pallas_supported sends them to its composed path:
    no kernel runs and the output equals the bf16 engine's."""
    x = torch.from_numpy(np.random.RandomState(2).standard_normal((2, 8, 8, 16))
                         .astype(np.float32))
    for kw in (dict(qmethod="asymmetric_uniform"),
               dict(qmethod="symmetric_uniform", act_qmethod="symmetric_uniform")):
        outs = {}
        for engine in ("fused", "bf16"):
            torch.manual_seed(0)
            conv = layers.QuantConv(16, 16, 1, 1, 0, bn=True, activation="relu",
                                    config=make_layer_config(engine=engine, **kw))
            calibrate(conv, [x], device="cpu")
            calls = {}
            _spy_plain(monkeypatch, calls)
            with torch.no_grad():
                outs[engine] = conv(x, mode="fixed")
            assert calls == {}
            assert conv.fused_state(True, True) is None
        assert torch.equal(outs["fused"], outs["bf16"])


def _jax_mnv2(bn_mode, sd, x, settings=MNV2_TINY):
    jmodel = jmnv2.mobilenetv2_quantized(
        j_make_config(engine="pallas", bn_mode=bn_mode, **INT8_OQ),
        num_classes=CLASSES, settings=settings)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmnv2, "INVERTED_RESIDUAL_SETTING", settings)
        params, stats = convert_mobilenet_v2(sd)
    jvars = j_calibrate(jmodel, merge_variables(jvars, params, stats),
                        [jnp.asarray(x)])
    with _pallas_gates_off():
        jbaked = j_bake(jmodel, jvars, jnp.asarray(x))
    logits = jax.jit(lambda v, xx: jmodel.apply(v, xx, mode="fixed",
                                                quant_w=False))(jbaked, jnp.asarray(x))
    return _np_tree(jvars), np.asarray(logits)


# per bn mode: the plain versions one tiny forward takes (under fp32_after
# the blocks with 12 channels run layer by layer: qblock.channels_ok)
MNV2_ROUTES = {"fp32_after": {"qblock_plain": 1, "qdwconv3x3_plain": 3,
                              "qmatmul_plain": 8},
               "folded": {"qdwconv3x3_plain": 4, "qmatmul_plain": 9}}
# a tiny MobileNetV2 whose block widths are all multiples of 8: under
# fp32_after every block (no expand, stride 2, residual) takes qblock
MNV2_TINY8 = ((1, 8, 1, 1), (6, 16, 2, 2), (6, 16, 1, 1))
MNV2_ROUTES8 = {"fp32_after": {"qblock_plain": 4, "qmatmul_plain": 2},
                "folded": {"qdwconv3x3_plain": 4, "qmatmul_plain": 9}}


@pytest.mark.parametrize("bn_mode", ["fp32_after", "folded"])
def test_tiny_mobilenet_int8_out_quant_matches_jax_pallas(bn_mode, monkeypatch):
    """MobileNetV2 under BASELINE config 2's quantizers on 'fused' (qblock
    with int_asym stages, or qdwconv3x3 + qmatmul under folded BN) from
    JAX's calibrated state: logits within one INT step of JAX 'pallas' on
    >= 98% of elements, top-1 identical."""
    _hold_int8_out_quant_mnv2(bn_mode, MNV2_TINY, MNV2_ROUTES, monkeypatch)


@pytest.mark.parametrize("bn_mode", ["fp32_after", "folded"])
def test_tiny_mobilenet_widths_of_8_int8_out_quant_matches_jax_pallas(
        bn_mode, monkeypatch):
    """The same at block widths that are multiples of 8, where every block
    under fp32_after runs qblock's integer branches."""
    _hold_int8_out_quant_mnv2(bn_mode, MNV2_TINY8, MNV2_ROUTES8, monkeypatch)


def _hold_int8_out_quant_mnv2(bn_mode, settings, routes, monkeypatch):
    sd = convert.random_mobilenet_v2_state_dict(SEED, settings, CLASSES)
    x = np.random.RandomState(SEED).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jvars, jlogits = _jax_mnv2(bn_mode, sd, x, settings)
    model = tmnv2.mobilenetv2_quantized(
        make_layer_config(engine="fused", bn_mode=bn_mode, **INT8_OQ),
        num_classes=CLASSES, settings=settings, device="cpu")
    convert.load_jax_variables(model, jvars)
    bake_weights(model)
    calls = {}
    _spy_plain(monkeypatch, calls)
    with torch.no_grad():
        logits = model(_t(x), mode="fixed", quant_w=False).numpy()
    assert calls == routes[bn_mode]
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    step = _fc_delta(jvars, "classifier")
    assert (np.abs(logits - jlogits) <= step * (1 + 1e-6)).mean() >= 0.98
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def test_cli_int8_out_quant_validate_quantized_cpu(capsys):
    """BASELINE config 2 through validate-quantized on the CPU."""
    image_net.main(["validate-quantized", "--device", "cpu", "--engine", "fused",
                    "--qmethod", "symmetric_uniform",
                    "--qmethod-act", "asymmetric_uniform", "--per-channel",
                    "--weight-quant-method", "current_minmax",
                    "--act-quant-method", "allminmax", "--num-est-batches", "1",
                    "--max-eval-batches", "1", "--batch-size", "2"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2 and np.isfinite(metrics["loss"])
