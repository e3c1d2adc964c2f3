"""The deployment cast path of the port (ops/fp8.fp8_cast_consts,
fp8_quantize_cast, the 1-byte IEEE storage; ops/quantizer's prepared
dispatch) against the JAX package, bit for bit (CPU).

The cases are JAX's tests/test_cast_quant.py: M in {2, 3, 4} at maxval
1.0, 3.7, 57.0 and 0.013 on uniform values over 1.5x the range and a
narrow normal that fills the region below the smallest normal.  Every
comparison is exact: the cast path's values and normalized values (with
their factor) equal JAX's bit for bit and the exact pipeline's by value
(-0 and +0 apart, as JAX's test holds them); ``store_f8`` bytes
equal JAX's f8 arrays viewed as uint8, E3M4 included (torch has no E3M4
dtype: the port encodes the codes itself); ``ieee_subnorm`` values equal
the decoded ``store_f8`` values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.ops import fp8 as jfp8
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu_torch.ops import fp8 as tfp8
from fp8_quantization_tpu_torch.ops import quantizer as tq

torch.set_num_threads(1)

MBITS = [2, 3, 4]
MAXVALS = [1.0, 3.7, 57.0, 0.013]


def _x(maxval, n=50_000):
    rng = np.random.RandomState(0)
    return np.concatenate([
        rng.uniform(-1.5 * maxval, 1.5 * maxval, n),
        rng.normal(0, maxval / 50, n),
        [0.0, -0.0, maxval, -maxval, maxval * 1e-9, -maxval * 1e-9],
    ]).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _consts(maxval, mbits):
    c = tfp8.fp8_cast_consts(torch.tensor(np.float32(maxval)), mbits)
    jc = jfp8.fp8_cast_consts(jnp.float32(maxval), mbits)
    return c, jc


@pytest.mark.parametrize("maxval", MAXVALS)
@pytest.mark.parametrize("mbits", MBITS)
def test_cast_values_match_jax_and_exact(mbits, maxval):
    """Values and normalized values with their factor: the port's cast
    equals JAX's bit for bit and the exact pipeline by value, ties
    included."""
    x = _x(maxval)
    c, jc = _consts(maxval, mbits)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ours = tfp8.fp8_quantize_cast(xt, c)
    np.testing.assert_array_equal(_bits(ours), _bits(jfp8.fp8_quantize_cast(xj, jc)))
    exact = tfp8.quantize_to_fp8(xt, torch.tensor(np.float32(maxval)),
                                 torch.tensor(float(mbits)))
    # by value, as JAX's test: the magic round gives +0 where the exact
    # pipeline keeps the sign of a zero
    np.testing.assert_array_equal(ours.numpy(), exact.numpy())
    norm = tfp8.fp8_quantize_cast(xt, c, normalized=True)
    jnorm = jfp8.fp8_quantize_cast(xj, jc, normalized=True)
    assert norm.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(norm.float()),
                                  _bits(np.asarray(jnorm, np.float32)))
    np.testing.assert_array_equal(_bits(c[0, 0]), _bits(jc["cast_scale"]))
    np.testing.assert_array_equal(_bits(norm.float() * c[0, 0]), _bits(ours))


@pytest.mark.parametrize("maxval", MAXVALS)
@pytest.mark.parametrize("mbits", MBITS)
def test_store_f8_bytes_and_ieee_subnorm_match_jax(mbits, maxval):
    """``store_f8``: one byte per element, JAX's bytes; decoded, the values
    of ``ieee_subnorm``, which equal JAX's ``ieee_subnorm``."""
    x = _x(maxval)
    c, jc = _consts(maxval, mbits)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    stored = tfp8.fp8_quantize_cast(xt, c, normalized=True, store_f8=True)
    jstored = jfp8.fp8_quantize_cast(xj, jc, normalized=True, store_f8=True)
    assert stored.element_size() == 1
    assert stored.dtype == (torch.bits8 if mbits == 4 else tfp8.IEEE_F8[mbits][2])
    np.testing.assert_array_equal(stored.view(torch.uint8).numpy(),
                                  np.asarray(jstored).view(np.uint8))
    sub = tfp8.fp8_quantize_cast(xt, c, normalized=True, ieee_subnorm=True)
    jsub = jfp8.fp8_quantize_cast(xj, jc, normalized=True, ieee_subnorm=True)
    np.testing.assert_array_equal(_bits(tfp8.ieee_decode(stored).float()),
                                  _bits(sub.float()))
    np.testing.assert_array_equal(_bits(sub.float()),
                                  _bits(np.asarray(jsub, np.float32)))
    full = tfp8.fp8_quantize_cast(xt, c, ieee_subnorm=True)
    np.testing.assert_array_equal(
        _bits(full), _bits(jfp8.fp8_quantize_cast(xj, jc, ieee_subnorm=True)))


@pytest.mark.parametrize("mbits", MBITS)
def test_ieee_codes_round_trip_every_code(mbits):
    """Every finite code of the format: JAX's value -> the port's byte is
    the same code, and the port's decode gives JAX's value; midpoints
    between neighbours round as JAX rounds them (ties to even)."""
    dt = jfp8.fp8_cast_dtype(mbits)
    codes = np.arange(256, dtype=np.uint8)
    vals = np.asarray(jnp.asarray(codes.view(dt)).astype(jnp.float32))
    ok = np.isfinite(vals)
    v = torch.from_numpy(vals[ok])
    stored = tfp8.ieee_store(v, mbits).view(torch.uint8).numpy()
    np.testing.assert_array_equal(
        stored, np.asarray(jnp.asarray(vals[ok]).astype(dt)).view(np.uint8))
    np.testing.assert_array_equal(
        _bits(tfp8.ieee_decode(tfp8.ieee_store(v, mbits)).float()), _bits(vals[ok]))
    grid = np.unique(vals[ok])
    mids = ((grid[1:].astype(np.float64) + grid[:-1]) / 2).astype(np.float32)
    np.testing.assert_array_equal(
        tfp8.ieee_store(torch.from_numpy(mids), mbits).view(torch.uint8).numpy(),
        np.asarray(jnp.asarray(mids).astype(dt)).view(np.uint8))


def test_e3m4_codes_take_no_arithmetic():
    """E3M4 codes live in torch.bits8: a cast or an arithmetic op on them
    raises, so only ops/fp8.ieee_decode reads them as numbers."""
    codes = tfp8.ieee_store(torch.tensor([0.5, -3.0]), 4)
    assert codes.dtype == torch.bits8
    with pytest.raises(Exception):
        codes.to(torch.bfloat16)
    with pytest.raises(Exception):
        codes + 1


def test_cast_consts_eligibility():
    """JAX's eligibility cases: an unsigned grid, M = 5 and n_bits = 7 have
    no cast path; the eligible constants equal JAX's rows."""
    one = torch.tensor(1.0)
    assert tfp8.fp8_cast_consts(one, 4, sign_bits=0) is None
    assert tfp8.fp8_cast_consts(one, 5) is None
    assert tfp8.fp8_cast_consts(one, 4, n_bits=7) is None
    assert jfp8.fp8_cast_consts(jnp.float32(1.0), 4, sign_bits=0) is None
    for mbits in MBITS:
        c, jc = _consts(3.7, mbits)
        assert c.shape == (6, 1)
        for row, name in zip(c, tfp8.CAST_CONST_ROWS[:5]):
            np.testing.assert_array_equal(_bits(row), _bits(jc[name]).reshape(-1))
        assert tfp8.cast_mbits(c) == mbits
        # cast_scale is the exact pipeline's factor over a power of two
        factor = tfp8.fp8_consts(torch.tensor(3.7), torch.tensor(float(mbits)))[5]
        pow2 = tfp8.IEEE_F8[mbits][0] / (2.0 - 2.0 ** -mbits)
        assert torch.equal(c[0] * pow2, factor)
        # the IEEE E4M3 constants, not finfo(float8_e4m3fn)'s
        assert float(c[2, 0]) == float(jnp.finfo(jfp8.fp8_cast_dtype(mbits)).max)


@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
def test_prepared_dispatch_uses_cast_iff_opted_in(per_channel):
    """JAX's dispatch test: fixed_consts carries the cast rows iff the spec
    opts in; both prepared paths equal the exact quantizer; factored, the
    cast gives JAX's norm and factor, and the unsigned or M = 5 state
    falls back to the exact rows."""
    shape = (5,) if per_channel else ()
    maxval = np.linspace(0.5, 3.0, 5).astype(np.float32).reshape(shape) \
        if per_channel else np.float32(3.0)
    state = {"maxval": torch.tensor(maxval), "mantissa_bits": torch.tensor(4.0),
             "sign_bits": torch.tensor(1, dtype=torch.int32)}
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    x = np.linspace(-4, 4, 1005, dtype=np.float32).reshape(201, 5)
    xt = torch.from_numpy(x)
    kw = dict(per_channel=per_channel)
    on, off = (tq.QuantizerSpec(cast_fastpath=True, **kw),
               tq.QuantizerSpec(**kw))
    c_on, c_off = tq.fixed_consts(on, state), tq.fixed_consts(off, state)
    c = 5 if per_channel else 1
    assert c_on.shape == (12, c) and c_off.shape == (6, c)
    assert tq.uses_cast(on, c_on) and not tq.uses_cast(off, c_off)
    assert not tq.uses_cast(off, c_on)
    exact = tq.apply(off, state, xt)
    for spec, consts in ((on, c_on), (off, c_off)):
        assert torch.equal(tq.apply_prepared(spec, consts, xt), exact)
    jspec = jq.QuantizerSpec(cast_fastpath=True, **kw)
    jc = jq.fixed_consts(jspec, jstate)
    assert "cast_probe" in jc
    norm, factor = tq.apply_prepared(on, c_on, xt, factored=True)
    jnorm, jfactor = jq.apply_prepared(jspec, jc, jnp.asarray(x), factored=True)
    np.testing.assert_array_equal(_bits(norm.float()),
                                  _bits(np.asarray(jnorm, np.float32)))
    np.testing.assert_array_equal(_bits(np.broadcast_to(factor, (1, c))),
                                  _bits(np.broadcast_to(np.asarray(jfactor), (1, c))))
    for bad in ({"sign_bits": torch.tensor(0, dtype=torch.int32)},
                {"mantissa_bits": torch.tensor(5.0)}):
        assert tq.fixed_consts(on, {**state, **bad}).shape == (6, c)


def test_store_f8_spec_stores_one_byte():
    """A spec with ``store_f8``: the factored prepared output is the 1-byte
    array of JAX's bytes, with JAX's factor."""
    state = {"maxval": torch.tensor(2.5), "mantissa_bits": torch.tensor(3.0),
             "sign_bits": torch.tensor(1, dtype=torch.int32)}
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    x = np.random.RandomState(1).normal(0, 0.5, (64, 8)).astype(np.float32)
    spec = tq.QuantizerSpec(mantissa_bits=3, cast_fastpath=True, store_f8=True)
    jspec = jq.QuantizerSpec(mantissa_bits=3, cast_fastpath=True, store_f8=True)
    norm, factor = tq.apply_prepared(spec, tq.fixed_consts(spec, state),
                                     torch.from_numpy(x), factored=True)
    jnorm, jfactor = jq.apply_prepared(jspec, jq.fixed_consts(jspec, jstate),
                                       jnp.asarray(x), factored=True)
    assert norm.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(norm.view(torch.uint8).numpy(),
                                  np.asarray(jnorm).view(np.uint8))
    np.testing.assert_array_equal(_bits(factor), _bits(jfactor))


def test_cast_under_jit_is_ineligible_in_jax_only():
    """JAX decides eligibility on concrete values and returns None under
    tracing; the port reads its values eagerly and always decides."""
    out = {}

    def f(m):
        out["c"] = jfp8.fp8_cast_consts(m, 4)
        return m
    jax.jit(f)(jnp.float32(1.0))
    assert out["c"] is None
    assert tfp8.fp8_cast_consts(torch.tensor(1.0), 4) is not None


def test_quantizer_records_the_cast_format_where_qprep_is_set():
    """``Quantizer.cast_m``, the format its prepared forward passes to the
    cast, is recorded where ``qprep`` is set: by the prepare forward, and
    again when a state dict with other constants is loaded into a prepared
    quantizer, whose forward then equals the loaded one's."""
    from fp8_quantization_tpu_torch.calibration import estimators as est
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer

    x = torch.from_numpy(_x(3.7))

    def prepared(mbits):
        quant = Quantizer(tq.QuantizerSpec(mantissa_bits=mbits, cast_fastpath=True),
                          est.EstimatorSpec())
        quant.load_state({"maxval": 3.7, "mantissa_bits": float(mbits)})
        quant._preparing = True
        quant(x[:4], mode="fixed")
        quant._preparing = False
        return quant

    e3m4, e4m3 = prepared(4), prepared(3)
    assert (e3m4.cast_m, e4m3.cast_m) == (4, 3)
    want = e4m3(x, mode="fixed")
    e3m4.load_state_dict(e4m3.state_dict())
    assert e3m4.cast_m == 3
    np.testing.assert_array_equal(_bits(e3m4(x, mode="fixed")), _bits(want))
    np.testing.assert_array_equal(
        _bits(want), _bits(tfp8.fp8_quantize_cast(x, _consts(3.7, 3)[0])))
