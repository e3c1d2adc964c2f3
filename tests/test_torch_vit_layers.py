"""The ViT slice's kernel and layers against the JAX package (CPU).

* ``flash_mha_plain`` (which the wrapper takes for CPU tensors) against the
  JAX ``flash_mha`` (the Pallas TPU flash-attention kernel in interpret
  mode) at (2, 3, S, 64) for S in {50, 128, 197, 256} (one key block, and
  two blocks with and without padding) and at (2, 2, 17, 32): >= 99% of
  the outputs bit-equal and all within 2 bf16 ulps, at the weighted mean
  of |v| where the weighted sum cancels (the two sum the same products in
  other orders and take exp from other libraries, so a p or an output
  rounds to a neighbouring bf16 value now and then); real rows within
  rtol = atol = 2e-2 of the float32 softmax chain, the bound of
  tests/test_attention.py.
* ``QuantLayerNorm`` against JAX in calibrate and fixed mode on each
  engine: the gamma and output quantizers' states bit-exact, the output
  before its quant within rtol = atol = 1e-6 (both sum in float32, in
  other orders, and XLA's CPU rsqrt is not correctly rounded, PERF.md), the
  quantized output within one FP8 grid step (a last-bit difference can move
  a value across a bin's edge); the bake stores JAX's baked gamma.
* ``QuantLinear`` with gelu on a (B, S, D) ``Factored`` input on each
  engine against JAX, with the same bounds; it never takes the qmatmul
  kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.bake import bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.nn.factored import Factored as JFactored
from fp8_quantization_tpu.ops.pallas.attention import flash_mha as j_flash
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import bake_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.factored import Factored, materialize
from fp8_quantization_tpu_torch.ops.fp8 import fp8_consts, fp8_quantize_prepared
from fp8_quantization_tpu_torch.ops.kernels import attention, qmatmul

torch.set_num_threads(1)

MBITS = 4
MAIN = dict(per_channel_weights=True, fp8_mantissa_bits=MBITS,
            fp8_set_maxval=True, weight_range_method="current_minmax",
            act_range_method="allminmax")
ENGINES = {"parity": "parity", "bf16": "bf16", "fused": "pallas"}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _one_grid_step(out, ref, maxval, min_exact):
    """Every element within one FP8 grid step of the larger magnitude, and
    at least ``min_exact`` of them equal."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    step = (np.maximum(np.abs(out), np.abs(ref)) * 2.0 ** -MBITS
            + maxval * 2.0 ** -10)
    assert (np.abs(out - ref) <= step).all(), np.abs(out - ref).max()
    exact = (out == ref).mean()
    assert exact >= min_exact, exact


def _bf16_ulp(a):
    """The spacing of bf16 values at |a| (8 significant bits)."""
    _, e = np.frexp(np.maximum(np.abs(a), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


# ---- flash attention ------------------------------------------------------------

FLASH_SHAPES = [(2, 3, 50, 64), (2, 3, 128, 64), (2, 3, 197, 64),
                (2, 3, 256, 64), (2, 2, 17, 32)]


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: f"S{s[2]}_D{s[3]}")
def test_flash_mha_plain_matches_pallas(shape):
    q, k, v = _qkv(shape, shape[2])
    scale = 1.0 / shape[3] ** 0.5
    ref = np.asarray(j_flash(*(jnp.asarray(t) for t in (q, k, v)),
                             sm_scale=scale))
    out = attention.flash_mha_plain(_t(q), _t(k), _t(v), sm_scale=scale).numpy()
    assert out.shape == ref.shape == shape
    assert (out == ref).mean() >= 0.99, (out == ref).mean()
    # the float32 softmax chain on the bf16-rounded operands
    qb, kb, vb = (_t(t).to(torch.bfloat16).float() for t in (q, k, v))
    attn = torch.softmax(qb @ kb.transpose(-1, -2) * scale, dim=-1)
    np.testing.assert_allclose(out, (attn @ vb).numpy(), rtol=2e-2, atol=2e-2)
    # 2 bf16 ulps at the larger output, or at the weighted mean of |v| where
    # the weighted sum cancels: a p that rounds to its neighbouring bf16
    # value moves the sum by a step of the terms, not of the sum
    scale_of = np.maximum(np.maximum(np.abs(out), np.abs(ref)),
                          (attn @ vb.abs()).numpy())
    err = np.abs(out - ref)
    assert (err <= 2 * _bf16_ulp(scale_of)).all(), err.max()


@pytest.mark.parametrize("s, blocks", [(17, 1), (128, 1), (129, 2), (300, 3)])
def test_padded_len_takes_the_pallas_blocks(s, blocks):
    assert attention.padded_len(s) == 128 * blocks


def test_flash_mha_on_cpu_takes_the_plain_version_through_strides():
    """Views of a (B, S, 3, H, D) qkv tensor, as the ViT passes them: the
    CPU wrapper gives the plain result on contiguous copies and launches
    nothing."""
    rng = np.random.RandomState(7)
    qkv = _t(rng.normal(0, 1, (2, 197, 3, 3, 64)))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous() and q.stride(-1) == 1
    attention.flash_mha.launches = 0
    out = attention.flash_mha(q, k, v, sm_scale=0.125)
    ref = attention.flash_mha_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), sm_scale=0.125)
    assert torch.equal(out, ref) and out.dtype == torch.float32
    assert attention.flash_mha.launches == 0
    with pytest.raises(ValueError, match="one shape"):
        attention.flash_mha(q, k[:, :, :10], v, sm_scale=0.125)


# ---- QuantLayerNorm -----------------------------------------------------------------

@pytest.fixture(scope="module")
def ln_input():
    rng = np.random.RandomState(11)
    x = (rng.normal(0.3, 2.0, (2, 9, 48))).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    beta = rng.normal(0, 0.1, 48).astype(np.float32)
    return x, gamma, beta


def _jax_ln(engine, x, gamma, beta):
    """(calibrated JAX variables, its calibrate-mode output)."""
    jmod = jlayers.QuantLayerNorm(config=j_make_config(engine=engine, **MAIN))
    jv = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jv = {**jv, "params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    y, upd = jmod.apply(jv, jnp.asarray(x), mode="calibrate", mutable=["quant"])
    return jmod, {**jv, **upd}, np.asarray(y)


def _quant_state(q):
    return {k: v.numpy() for k, v in q.state().items()}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_layernorm_matches_jax(engine, ln_input):
    x, gamma, beta = ln_input
    jmod, jv, jy = _jax_ln(ENGINES[engine], x, gamma, beta)
    tmod = layers.QuantLayerNorm(48, make_layer_config(engine=engine, **MAIN))
    convert.load_jax_variables(tmod, {"params": _np_tree(jv["params"])})
    with torch.no_grad():
        ty = tmod(_t(x), mode="calibrate")
    for name in ("weight_q", "act_q"):
        jq = jv["quant"][name]["q"]
        for key, value in _quant_state(getattr(tmod, name)).items():
            np.testing.assert_array_equal(value.reshape(-1),
                                          np.asarray(jq[key]).reshape(-1))
    maxval = float(jv["quant"]["act_q"]["q"]["maxval"])
    _one_grid_step(ty.numpy(), jy, maxval, min_exact=0.95)

    def jrun(**kw):
        return jmod.apply(jv, jnp.asarray(x), mode="fixed", **kw)
    with torch.no_grad():
        pre = tmod(_t(x), mode="fixed", quant_a=False).numpy()
        val = tmod(_t(x), mode="fixed").numpy()
        fac = tmod(_t(x), mode="fixed", out="factored")
    np.testing.assert_allclose(pre, np.asarray(jrun(quant_a=False)),
                               rtol=1e-6, atol=1e-6)
    _one_grid_step(val, np.asarray(jrun()), maxval, min_exact=0.95)
    jfac = jrun(out="factored")
    assert isinstance(fac, Factored) == (engine != "parity")
    assert isinstance(jfac, JFactored) == (engine != "parity")
    if engine != "parity":
        assert fac.norm.dtype == torch.bfloat16
        np.testing.assert_array_equal(fac.factor.numpy(), np.asarray(jfac.factor))
        _one_grid_step(materialize(fac).numpy(),
                       np.asarray(jfac.norm, np.float32) * np.asarray(jfac.factor),
                       maxval, min_exact=0.95)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_layernorm_bake_stores_jax_baked_gamma(engine, ln_input):
    """The bake stores the full-scale fake-quant gamma, JAX's baked
    ``scale`` bit for bit, and no factor; the baked forward with
    ``quant_w=False`` equals the unbaked one."""
    x, gamma, beta = ln_input
    jmod, jv, _ = _jax_ln(ENGINES[engine], x, gamma, beta)
    jb = _np_tree(j_bake(jmod, jv, jnp.asarray(x)))
    tmod = layers.QuantLayerNorm(48, make_layer_config(engine=engine, **MAIN))
    convert.load_jax_variables(tmod, _np_tree(jv))
    with torch.no_grad():
        before = tmod(_t(x), mode="fixed")
        bake_weights(tmod)
        after = tmod(_t(x), mode="fixed", quant_w=False)
    np.testing.assert_array_equal(tmod.weight.detach().numpy(),
                                  jb["params"]["scale"])
    assert "baked" not in jb and not hasattr(tmod, "w_factor")
    assert torch.equal(before, after)


def test_layernorm_uses_jax_eps_and_its_own_statistics():
    """eps 1e-5 (JAX's QuantLayerNorm; timm uses 1e-6), and per-row
    statistics over the last axis only."""
    ln = layers.QuantLayerNorm(4, make_layer_config(**MAIN))
    assert ln.epsilon == 1e-5
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0], [10.0, 10.0, 10.0, 10.0]])
    with torch.no_grad():
        y = ln(x, mode="fp32")
    ref = torch.nn.functional.layer_norm(x, (4,), eps=1e-5)
    torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(y[1], torch.zeros(4))


# ---- the gelu MLP layer -------------------------------------------------------------

@pytest.mark.parametrize("engine", list(ENGINES))
def test_gelu_linear_on_factored_input_matches_jax(engine, monkeypatch):
    """mlp1 of a ViT block: a (B, S, D) Factored input (an LN output on the
    E3M4 grid), exact gelu, output quant; on 'fused' it stays on the
    composed path (the kernels take no gelu), as JAX's pallas engine does."""
    rng = np.random.RandomState(12)
    c = fp8_consts(torch.tensor([3.0]), MBITS)
    norm = fp8_quantize_prepared(_t(rng.normal(0, 1, (2, 9, 32))), c,
                                 normalized=True).to(torch.bfloat16)
    factor = c[5, 0]
    w = rng.normal(0, 0.2, (32, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    jx = JFactored(jnp.asarray(norm.float().numpy()).astype(jnp.bfloat16),
                   jnp.asarray(factor.numpy()))
    jmod = jlayers.QuantLinear(features=64, activation="gelu", use_bias=True,
                               config=j_make_config(engine=ENGINES[engine],
                                                    **MAIN))
    jv = jmod.init(jax.random.PRNGKey(0), jx)
    jv = {**jv, "params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    _, upd = jmod.apply(jv, jx, mode="calibrate", mutable=["quant"])
    jv = {**jv, **upd}
    tmod = layers.QuantLinear(32, 64, activation="gelu",
                              config=make_layer_config(engine=engine, **MAIN))
    convert.load_jax_variables(tmod, _np_tree(jv))
    calls = []
    monkeypatch.setattr(qmatmul, "fused_quant_matmul",
                        lambda *a, **k: calls.append(1))
    maxval = float(jv["quant"]["act_q"]["q"]["maxval"])
    with torch.no_grad():
        for out in ("value", "factored"):
            y = materialize(tmod(Factored(norm, factor), mode="fixed", out=out))
            jy = jmod.apply(jv, jx, mode="fixed", out=out)
            jy = (np.asarray(jy.norm, np.float32) * np.asarray(jy.factor)
                  if isinstance(jy, JFactored) else np.asarray(jy))
            _one_grid_step(y.numpy(), jy, maxval, min_exact=0.98)
    assert calls == []
