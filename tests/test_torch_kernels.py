"""Each kernel module of the port (its plain PyTorch version, which the
wrapper takes for CPU tensors) against the JAX package's Pallas kernel in
interpret mode, at the JAX tests' small shapes and with their tolerances.

The Pallas tiles pick the FP8 bin with log2 + floor, the port reads the
exponent exactly, so outputs may differ by one grid step where a value sits
within an ulp of a bin boundary: fused_quant_matmul is held to
rtol=atol=1e-5 (tests/test_pallas_qmatmul.py), the conv and the stem to
rtol=atol=2e-2 with at least 98% of elements exact
(tests/test_pallas_qconv.py, tests/test_pallas_qstem.py).  Each case also
runs at other mantissa widths M (the MSE search's vote gives each
quantizer its own): 2, 3 and 5, and for the quant-matmul also 1 and 6, at
the same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.ops.pallas.qconv import (
    FusedConvConfig as JConvCfg, fused_quant_conv3x3 as j_conv)
from fp8_quantization_tpu.ops.pallas.qmatmul import (
    FusedQuantMatmulConfig as JMatCfg, fused_quant_matmul as j_matmul)
from fp8_quantization_tpu.ops.pallas.qstem import (
    FusedStemConfig as JStemCfg, fused_quant_stem as j_stem)
from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts
from fp8_quantization_tpu_torch.ops.kernels import qconv, qmatmul, qstem

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(out, ref, rtol, atol, min_exact=None):
    out = out.to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)
    if min_exact is not None:
        exact = np.isclose(out, ref, rtol=1e-6, atol=1e-7).mean()
        assert exact >= min_exact, exact


def _act(maxval, mbits=4.0, sign=1.0):
    """(JAX act_scalars, port (6, 1) constants) of one act quantizer."""
    return (jnp.asarray([maxval, mbits, sign], jnp.float32),
            fp8_consts(torch.tensor([max(maxval, 1e-30)], dtype=torch.float32),
                       mbits, 8, int(sign)))


MATMUL_CASES = {
    # (M, K, N, weight_method, act, relu, emit_norm, bn)
    "fp8w_outquant_relu": (24, 96, 48, "fp8", True, True, False, False),
    "fp8w_bn_emit_norm": (24, 96, 48, "fp8", True, True, True, True),
    "baked_downsample_emit_norm": (40, 64, 128, "none", True, False, True, True),
    "ragged_fc_logits": (5, 72, 100, "fp8", True, False, False, False),
    "no_act_quant": (24, 96, 48, "fp8", False, False, False, True),
}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_qmatmul_plain_matches_pallas(case):
    _qmatmul_case(case, 4.0)


@pytest.mark.parametrize("mbits", [1.0, 2.0, 3.0, 5.0, 6.0])
@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_qmatmul_plain_matches_pallas_other_formats(case, mbits):
    _qmatmul_case(case, mbits)


def _qmatmul_case(case, mbits):
    """One MATMUL_CASES case with weight and output quantizers of M =
    ``mbits``."""
    M, K, N, wm, act, relu, emit, bn = MATMUL_CASES[case]
    rng = np.random.RandomState(len(case))
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.3).astype(np.float32)
    wmax = np.abs(w).max(axis=0)
    if wm == "none":      # baked: weights already on the normalized bf16 grid
        x = x.astype(jnp.bfloat16).astype(np.float32)
        w = np.asarray(jnp.asarray(w).astype(jnp.bfloat16), np.float32)
    scale = (rng.uniform(0.5, 1.5, N) if bn else np.ones(N)).astype(np.float32)
    shift = (rng.standard_normal(N) * 0.1).astype(np.float32)
    y_max = float(np.abs(x @ w).max() * scale.max() * 0.6)
    ja, ta = _act(y_max, mbits)
    activation = "relu" if relu else None
    jcfg = JMatCfg(weight_method=wm, act_method="fp8" if act else "none",
                   activation=activation, emit_norm=emit)
    ref = j_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(wmax),
                   jnp.asarray([mbits, 1.0]), ja, jnp.asarray(scale),
                   jnp.asarray(shift), cfg=jcfg, interpret=True)
    tcfg = qmatmul.FusedQuantMatmulConfig(
        weight_method=wm, act_method="fp8" if act else "none",
        activation=activation, emit_norm=emit)
    w_c = fp8_consts(_t(wmax), mbits) if wm == "fp8" else None
    out = qmatmul.fused_quant_matmul(
        _t(x), _t(w.T), w_c, ta if act else None, _t(scale), _t(shift),
        cfg=tcfg)
    assert out.dtype == (torch.bfloat16 if emit else torch.float32)
    _close(out, ref, 1e-5, 1e-5)


CONV_CASES = {
    # (stride, residual, emit_norm)
    "s1": (1, False, False),
    "s1_residual_emit_norm": (1, True, True),
    "s2_emit_norm": (2, False, True),
    "s2_residual": (2, True, False),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_qconv3x3_plain_matches_pallas(case):
    _qconv_case(case, 4.0)


@pytest.mark.parametrize("mbits", [2.0, 3.0, 5.0])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_qconv3x3_plain_matches_pallas_other_formats(case, mbits):
    _qconv_case(case, mbits)


def _qconv_case(case, mbits):
    """One CONV_CASES case with an output quantizer of M = ``mbits``."""
    stride, res, emit = CONV_CASES[case]
    n, h, w_, cin, cout = 2, 8, 8, 16, 8
    rng = np.random.RandomState(3 + stride)
    x = rng.standard_normal((n, h, w_, cin)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)  # norms
    w = np.asarray(jnp.asarray(rng.standard_normal((3, 3, cin, cout)) * 0.2)
                   .astype(jnp.bfloat16), np.float32)              # baked grid
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    ho = (h - 1) // stride + 1
    residual = (rng.standard_normal((n, ho, ho, cout)).astype(np.float32)
                if res else None)
    ja, ta = _act(6.0, mbits)
    ref = j_conv(jnp.asarray(x), jnp.asarray(w), ja, jnp.asarray(scale),
                 jnp.asarray(shift),
                 None if residual is None else jnp.asarray(residual),
                 cfg=JConvCfg(act_method="fp8", activation="relu",
                              residual=res, emit_norm=emit, stride=stride),
                 interpret=True)
    wm = qconv.weight_matrix(_t(w.transpose(3, 2, 0, 1)))
    out = qconv.fused_quant_conv3x3(
        _t(x).to(torch.bfloat16), wm, ta, _t(scale), _t(shift),
        None if residual is None else _t(residual),
        cfg=qconv.FusedConvConfig(act_method="fp8", activation="relu",
                                  residual=res, emit_norm=emit, stride=stride))
    _close(out, ref, 2e-2, 2e-2, min_exact=0.98)


@pytest.mark.parametrize("s", [32, 64])
@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
def test_qstem_plain_matches_pallas(s, emit):
    _qstem_case(s, emit, 4.0)


@pytest.mark.parametrize("mbits", [2.0, 3.0, 5.0])
@pytest.mark.parametrize("emit", [False, True], ids=["value", "norm"])
def test_qstem_plain_matches_pallas_other_formats(emit, mbits):
    _qstem_case(32, emit, mbits)


def _qstem_case(s, emit, mbits):
    """The stem at S x S with an output quantizer of M = ``mbits``."""
    n, cin, cout = 2, 3, 16
    rng = np.random.RandomState(s)
    x = rng.standard_normal((n, s, s, cin)).astype(np.float32)
    w = np.asarray(jnp.asarray(rng.standard_normal((7, 7, cin, cout)) * 0.1)
                   .astype(jnp.bfloat16), np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    ja, ta = _act(4.0, mbits)
    ref = j_stem(jnp.asarray(x), jnp.asarray(w), ja, jnp.asarray(scale),
                 jnp.asarray(shift),
                 cfg=JStemCfg(act_method="fp8", emit_norm=emit), interpret=True)
    out = qstem.fused_quant_stem(
        _t(x), qstem.weight_matrix(_t(w.transpose(3, 2, 0, 1))), ta,
        _t(scale), _t(shift),
        cfg=qstem.FusedStemConfig(act_method="fp8", emit_norm=emit))
    _close(out, ref, 2e-2, 2e-2, min_exact=0.98)


def test_wrappers_take_plain_version_on_cpu_and_reject_int8():
    """CPU tensors never reach a kernel (the launch counts stay put); the
    configs take the Pallas bodies' integer methods (int_sym weights,
    int_asym activations, tests/test_torch_int_grids.py) and reject any
    other method (the int8 datapath has kernels of its own,
    tests/test_torch_int8.py)."""
    before = (qmatmul.fused_quant_matmul.launches,
              qconv.fused_quant_conv3x3.launches,
              qstem.fused_quant_stem.launches)
    test_qmatmul_plain_matches_pallas("fp8w_outquant_relu")
    assert (qmatmul.fused_quant_matmul.launches,
            qconv.fused_quant_conv3x3.launches,
            qstem.fused_quant_stem.launches) == before
    qmatmul.FusedQuantMatmulConfig(weight_method="int_sym",
                                   act_method="int_asym", quantize_input=True)
    qconv.FusedConvConfig(act_method="int_asym")
    qstem.FusedStemConfig(act_method="int_asym")
    with pytest.raises(ValueError, match="weight_method"):
        qmatmul.FusedQuantMatmulConfig(weight_method="int_asym")
    with pytest.raises(ValueError, match="act_method"):
        qconv.FusedConvConfig(act_method="int_sym")
