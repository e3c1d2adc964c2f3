"""Port quantizer numerics against the JAX package, bit for bit (CPU).

The same numpy inputs go through fp8_quantization_tpu (the reference) and
fp8_quantization_tpu_torch; values, quantizer state and the gradients
w.r.t. x, maxval and mantissa_bits must be identical, not merely close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.calibration import estimators as jest
from fp8_quantization_tpu.ops import fp8 as jfp8
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu_torch.calibration import estimators as test_
from fp8_quantization_tpu_torch.ops import fp8 as tfp8
from fp8_quantization_tpu_torch.ops import quantizer as tq

torch.set_num_threads(1)

MBITS = list(range(1, 8))


def _data(seed, shape=(64, 24), scale=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    # a few values on and next to powers of two: where a log2 bin read slips
    x.flat[:8] = np.float32([1.0, 2.0, 0.5, -4.0, np.nextafter(1.0, 0.0),
                             np.nextafter(2.0, 3.0), 0.0, -0.25])
    return x


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.detach().cpu().numpy())


@pytest.mark.parametrize("mbits", MBITS)
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("normalized", [False, True], ids=["value", "norm"])
def test_quantize_to_fp8_bit_exact(mbits, per_channel, normalized):
    x = _data(mbits)
    maxval = (np.abs(x).max(axis=0) if per_channel
              else np.float32(np.abs(x).max() * 0.7)).astype(np.float32)
    ref = jfp8.quantize_to_fp8(jnp.asarray(x), jnp.asarray(maxval),
                               jnp.float32(mbits), normalized=normalized)
    out = tfp8.quantize_to_fp8(torch.from_numpy(x), torch.from_numpy(np.asarray(maxval)),
                               torch.tensor(float(mbits)), normalized=normalized)
    _eq(ref, out)
    # the kernels' prepared form gives the same values
    c = tfp8.fp8_consts(torch.from_numpy(np.asarray(maxval)), float(mbits))
    _eq(ref, tfp8.fp8_quantize_prepared(torch.from_numpy(x), c,
                                        normalized=normalized))


@pytest.mark.parametrize("mbits", [2, 3, 4])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("normalized", [False, True], ids=["value", "norm"])
def test_ste_gradients_bit_exact(mbits, per_channel, normalized):
    """Gradients w.r.t. x, maxval and mantissa_bits, bit for bit.  maxval
    and mantissa_bits are broadcast to x's shape so that each element's
    gradient is compared before any reduction (a reduction sums the same
    terms in another order; that case is held to 1e-5 below)."""
    x = _data(10 + mbits, scale=2.0)
    g = np.random.RandomState(1).standard_normal(x.shape).astype(np.float32)
    # current_minmax makes the channel max equal maxval: the clip tie case
    maxval = (np.abs(x).max(axis=0) if per_channel
              else np.float32(np.abs(x).max())).astype(np.float32)
    maxval = np.broadcast_to(maxval, x.shape).copy()
    mbits = np.full(x.shape, mbits, np.float32)

    def jloss(xx, mv, mb):
        return jnp.sum(jfp8.quantize_to_fp8(xx, mv, mb, normalized=normalized) * g)

    def tgrads(xx, mv, mb):
        ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in (xx, mv, mb)]
        (tfp8.quantize_to_fp8(*ts, normalized=normalized)
         * torch.from_numpy(g)).sum().backward()
        return [t.grad for t in ts]

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(maxval),
                                           jnp.asarray(mbits))
    for a, b in zip(jg, tgrads(x, maxval, mbits)):
        _eq(a, b)
    # reduced to a scalar mantissa_bits
    jmb = jax.grad(jloss, argnums=2)(jnp.asarray(x), jnp.asarray(maxval),
                                     jnp.float32(mbits[0, 0]))
    np.testing.assert_allclose(float(jmb),
                               float(tgrads(x, maxval, mbits[0, 0])[2]),
                               rtol=1e-5)


@pytest.mark.parametrize("mbits", [3, 4, 5])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
def test_apply_factored_and_set_quant_range(mbits, per_channel):
    """Weights (C leading in torch, trailing in JAX): same state, same
    fake-quant, same normalized grid and factor."""
    w = _data(20 + mbits, shape=(16, 9 * 8), scale=0.1)       # (C, K)
    jspec = jq.QuantizerSpec(method=jq.QMethod.fp_quantizer, mantissa_bits=mbits,
                             per_channel=per_channel, set_maxval=True)
    tspec = tq.QuantizerSpec(mantissa_bits=mbits, per_channel=per_channel,
                             set_maxval=True)
    c = 16 if per_channel else None
    lo = w.min(axis=1) if per_channel else w.min()
    hi = w.max(axis=1) if per_channel else w.max()
    js = jq.set_quant_range(jspec, jq.init_state(jspec, c), jnp.asarray(lo),
                            jnp.asarray(hi))
    ts = tq.set_quant_range(tspec, tq.init_state(tspec, c), torch.tensor(lo),
                            torch.tensor(hi))
    for k in ("maxval", "mantissa_bits", "sign_bits", "initialized"):
        _eq(js[k], ts[k])
    wt = torch.from_numpy(w)
    _eq(jq.apply(jspec, js, jnp.asarray(w.T), channel_axis=-1).T,
        tq.apply(tspec, ts, wt, channel_axis=0))
    jn, jf = jq.apply_factored(jspec, js, jnp.asarray(w.T), channel_axis=-1)
    tn, tf = tq.apply_factored(tspec, ts, wt, channel_axis=0)
    _eq(jn.T, tn)
    _eq(jnp.reshape(jf, -1), tf.reshape(-1))
    assert torch.equal(tn.to(torch.bfloat16).to(torch.float32), tn)


@pytest.mark.parametrize("kind", ["current_minmax", "allminmax", "running_minmax"])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
def test_minmax_estimators_same_state(kind, per_channel):
    jspec = jest.EstimatorSpec(kind=jest.RangeEstimators(kind))
    tspec = test_.EstimatorSpec(kind=test_.RangeEstimators(kind))
    jqs = jq.QuantizerSpec(method=jq.QMethod.fp_quantizer, per_channel=per_channel)
    tqs = tq.QuantizerSpec(per_channel=per_channel)
    c = 8 if per_channel else None
    js, ts = jest.init_state(jspec, jqs, c), test_.init_state(tspec, tqs, c)
    for seed in range(3):
        x = _data(30 + seed, shape=(8, 50))
        x_cn = x if per_channel else x.reshape(1, -1)
        js, jlo, jhi, _ = jest.update(jspec, jqs, js, jnp.asarray(x_cn))
        ts, tlo, thi, _ = test_.update(tspec, tqs, ts, torch.from_numpy(x_cn))
        _eq(jlo, tlo)
        _eq(jhi, thi)
        for k in js:
            _eq(js[k], ts[k])


def test_grid_oracles_match():
    for e, b in ((4, 8), (3, 4), (5, 16)):
        np.testing.assert_array_equal(jfp8.generate_all_values_fp(8, e, b),
                                      tfp8.generate_all_values_fp(8, e, b))
        assert jfp8.get_max_value(e, b) == tfp8.get_max_value(e, b)
    for m in MBITS[:-1]:
        assert jfp8.default_fp8_maxval(m) == tfp8.default_fp8_maxval(m)
    x = _data(40)
    for unsigned in (False, True):
        jm, jsb = jfp8.fp8_set_quant_range(jnp.asarray(np.abs(x).min()),
                                           jnp.asarray(x.max()),
                                           allow_unsigned=unsigned)
        tm, tsb = tfp8.fp8_set_quant_range(torch.tensor(np.abs(x).min()),
                                           torch.tensor(x.max()),
                                           allow_unsigned=unsigned)
        _eq(jm, tm)
        _eq(jsb, tsb)


def test_not_ported_methods_raise():
    """Nothing of make_layer_config raises any more: QAT's flags and LSQ
    gradient scaling (held against JAX in tests/test_torch_rounding.py) and
    the deployment flags (tests/test_torch_deploy_flags.py) build; an
    unknown option is a TypeError."""
    from fp8_quantization_tpu_torch.nn.config import make_layer_config
    from fp8_quantization_tpu_torch.ops import uniform as tuni
    y = tuni.quantize_uniform_symmetric(torch.ones(3), torch.tensor(0.1),
                                        torch.tensor(1), 8, grad_scaling=True)
    assert torch.equal(y, torch.ones(3))
    for flag in ("fp8_learn_maxval", "fp8_learn_mantissa_bits", "grad_scaling"):
        make_layer_config(**{flag: True})
    for flag in ("deploy_cast_quant", "deploy_act_f8", "deploy_cast_ieee",
                 "conv_out_bf16", "int8_assume_signed"):
        cfg = make_layer_config(**{flag: True})
        assert cfg != make_layer_config(), flag
    with pytest.raises(TypeError):
        make_layer_config(no_such_flag=True)
