"""The QAT rounding estimators and the learned-range gradients of the port
against the JAX package (CPU).

* Each estimator's forward and backward bit for bit against JAX's
  ``custom_vjp`` run op by op (a jitted JAX step may fuse its backward's
  multiply-add into one fma, which is XLA's choice, not the estimator's).
  Stochastic rounding cannot reproduce JAX's random bits: it is held to
  its expectation and its identity gradient.
* The fake-quantizers with each estimator, and the uniform ones with and
  without LSQ ``grad_scaling``: the gradients w.r.t. x, maxval,
  mantissa_bits, delta and zero_float bit for bit.  The range parameters
  are broadcast to x's shape so each element's gradient is compared before
  any reduction (a reduction sums the same terms in another order).
* The ``Quantizer`` module in mode ``learn`` with its ranges made
  trainable: x's gradient bit for bit, a per-channel range with one
  element per channel bit for bit.  A per-tensor range's gradient is a sum
  over x of per-element terms (bit-exact, as above) that the two packages
  add in different orders: it is held to the float32 summation bound
  ``n * 2^-23 * sum(|term|)`` around JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.calibration import estimators as jest
from fp8_quantization_tpu.nn import quantizers as jquant
from fp8_quantization_tpu.ops import fp8 as jfp8
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu.ops import rounding as jr
from fp8_quantization_tpu.ops import uniform as juni
from fp8_quantization_tpu_torch.calibration import estimators as test_
from fp8_quantization_tpu_torch.nn import quantizers as tquant
from fp8_quantization_tpu_torch.ops import fp8 as tfp8
from fp8_quantization_tpu_torch.ops import quantizer as tq
from fp8_quantization_tpu_torch.ops import rounding as tr
from fp8_quantization_tpu_torch.ops import uniform as tuni

torch.set_num_threads(1)


def _data(seed, shape=(48, 40), scale=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    # grid midpoints and integers: where round-half-even and the residual
    # of EWGS and the stacked sigmoid meet their edge cases
    x.flat[:6] = np.float32([0.5, 1.5, -2.5, 3.0, 0.0, -0.49999997])
    return x


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.detach().cpu().numpy())


def _grads(fn, *arrays):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    fn(*ts).backward()
    return [t.grad for t in ts]


# ---- the estimators ------------------------------------------------------------

@pytest.mark.parametrize("kind,param", [("ste", None), ("ewgs", 0.2),
                                        ("ewgs", 0.5), ("stacked_sigmoid", 1.0),
                                        ("stacked_sigmoid", 4.0)])
def test_estimator_forward_and_backward_bit_exact(kind, param):
    x = _data(0)
    g = np.random.RandomState(1).standard_normal(x.shape).astype(np.float32)
    jfn = {"ste": lambda a: jr.round_ste(a),
           "ewgs": lambda a: jr.ewgs_round(a, jnp.float32(param)),
           "stacked_sigmoid": lambda a: jr.stacked_sigmoid_round(a, jnp.float32(param))}[kind]
    tfn = {"ste": tr.round_ste,
           "ewgs": lambda a: tr.ewgs_round(a, param),
           "stacked_sigmoid": lambda a: tr.stacked_sigmoid_round(a, param)}[kind]
    _eq(jfn(jnp.asarray(x)), tfn(torch.from_numpy(x)))
    jg = jax.grad(lambda a: jnp.sum(jfn(a) * g))(jnp.asarray(x))
    tg, = _grads(lambda a: (tfn(a) * torch.from_numpy(g)).sum(), x)
    _eq(jg, tg)


def test_make_discretizer_matches_jax_choices():
    assert tr.make_discretizer("ste") is tr.round_ste
    # stoch_round rounds to nearest outside training, needs a generator in it
    assert tr.make_discretizer("stoch_round", training=False) is tr.round_ste
    with pytest.raises(ValueError):
        tr.make_discretizer("stoch_round", training=True)
    with pytest.raises(ValueError):
        tr.make_discretizer("nope")
    x = _data(2)
    for kind in ("ewgs", "stacked_sigmoid"):
        jd = jr.make_discretizer(kind, scaling_factor=0.3, alpha=2.0)
        td = tr.make_discretizer(kind, scaling_factor=0.3, alpha=2.0)
        jg = jax.grad(lambda a: jnp.sum(jd(a) ** 2))(jnp.asarray(x))
        tg, = _grads(lambda a: (td(a) ** 2).sum(), x)
        _eq(jg, tg)


def test_stochastic_round_expectation_and_identity_gradient():
    """JAX ``tests/test_grad_estimators.py::test_stochastic_round_expectation``
    with a torch.Generator: values in {0, 1} with mean 0.3 (atol 0.02 at
    20,000 draws, about 6 standard errors), gradient 1; the same generator
    state gives the same draws, and the global random state is untouched."""
    gen = torch.Generator().manual_seed(0)
    before = torch.get_rng_state()
    x = torch.full((20000,), 0.3, requires_grad=True)
    out = tr.stochastic_round_ste(x, gen)
    assert set(out.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(out.detach().mean()) - 0.3) <= 0.02
    out.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert torch.equal(torch.get_rng_state(), before)
    again = tr.stochastic_round_ste(x.detach(), torch.Generator().manual_seed(0))
    assert torch.equal(again, out.detach())


def test_scale_gradient_bit_exact():
    x = _data(3)
    jg = jax.grad(lambda a: jnp.sum(jr.scale_gradient(a, 0.37) ** 2))(jnp.asarray(x))
    tg, = _grads(lambda a: (tr.scale_gradient(a, 0.37) ** 2).sum(), x)
    _eq(jg, tg)


# ---- fake-quantizers with the estimators -----------------------------------------

@pytest.mark.parametrize("kind", ["ste", "ewgs", "stacked_sigmoid"])
@pytest.mark.parametrize("mbits", [3, 4])
@pytest.mark.parametrize("normalized", [False, True], ids=["value", "norm"])
def test_fp8_gradients_with_estimators_bit_exact(kind, mbits, normalized):
    x = _data(10 + mbits)
    g = np.random.RandomState(5).standard_normal(x.shape).astype(np.float32)
    maxval = np.broadcast_to(np.abs(x).max(axis=0) * 0.8, x.shape).astype(np.float32)
    mb = np.full(x.shape, mbits, np.float32)
    jd = jr.make_discretizer(kind, scaling_factor=0.2, alpha=1.0)
    td = tr.make_discretizer(kind, scaling_factor=0.2, alpha=1.0)
    jgs = jax.grad(lambda a, m, b: jnp.sum(jfp8.quantize_to_fp8(
        a, m, b, discretizer=jd, normalized=normalized) * g),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(maxval), jnp.asarray(mb))
    tgs = _grads(lambda a, m, b: (tfp8.quantize_to_fp8(
        a, m, b, discretizer=td, normalized=normalized)
        * torch.from_numpy(g)).sum(), x, maxval, mb)
    for j, t in zip(jgs, tgs):
        _eq(j, t)


@pytest.mark.parametrize("grad_scaling", [False, True], ids=["plain", "lsq"])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("kind", ["ste", "ewgs"])
def test_uniform_gradients_bit_exact(grad_scaling, per_channel, kind):
    """delta, zero_float and x of both uniform quantizers; the LSQ scale of
    the symmetric grid is a float32 power, as XLA computes it."""
    x = _data(20)
    g = np.random.RandomState(6).standard_normal(x.shape).astype(np.float32)
    delta = np.full(x.shape, 0.05, np.float32)
    zf = np.full(x.shape, 100.3, np.float32)
    kw = dict(grad_scaling=grad_scaling, per_channel=per_channel, channel_axis=0)
    jd, td = jr.make_discretizer(kind), tr.make_discretizer(kind)
    jgs = jax.grad(lambda a, d, z: jnp.sum(juni.quantize_uniform_asymmetric(
        a, d, z, 8, discretizer=jd, **kw) * g), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(delta), jnp.asarray(zf))
    tgs = _grads(lambda a, d, z: (tuni.quantize_uniform_asymmetric(
        a, d, z, 8, discretizer=td, **kw) * torch.from_numpy(g)).sum(),
        x, delta, zf)
    for j, t in zip(jgs, tgs):
        _eq(j, t)
    for signed in (1, 0):
        xs = x if signed else np.abs(x)
        jgs = jax.grad(lambda a, d: jnp.sum(juni.quantize_uniform_symmetric(
            a, d, jnp.int32(signed), 8, discretizer=jd, **kw) * g),
            argnums=(0, 1))(jnp.asarray(xs), jnp.asarray(delta))
        tgs = _grads(lambda a, d: (tuni.quantize_uniform_symmetric(
            a, d, torch.tensor(signed, dtype=torch.int32), 8, discretizer=td,
            **kw) * torch.from_numpy(g)).sum(), xs, delta)
        for j, t in zip(jgs, tgs):
            _eq(j, t)


def test_lsq_grad_scale_matches_jax():
    x = torch.zeros(6, 5, 3)
    jx = jnp.zeros((6, 5, 3))
    assert tuni.lsq_grad_scale(x, 255.0, False) == juni.lsq_grad_scale(jx, 255.0, False)
    assert tuni.lsq_grad_scale(x, 255.0, True, 0) == juni.lsq_grad_scale(jx, 255.0, True, 0)
    for signed in (0, 1):
        _, jmax = juni.symmetric_int_bounds(8, jnp.int32(signed))
        _, tmax = tuni.symmetric_int_bounds(8, torch.tensor(signed))
        for pc in (False, True):
            assert np.float32(juni.lsq_grad_scale(jx, jmax, pc, 0)) == np.float32(
                tuni.lsq_grad_scale(x, tmax, pc, 0))


# ---- the Quantizer module in learn mode -------------------------------------------

QSPECS = {
    "fp8": dict(method=jq.QMethod.fp_quantizer, set_maxval=True,
                learn_maxval=True, learn_mantissa_bits=True),
    "sym": dict(method=jq.QMethod.symmetric_uniform),
    "asym": dict(method=jq.QMethod.asymmetric_uniform),
    "sym_lsq": dict(method=jq.QMethod.symmetric_uniform, grad_scaling=True),
    "asym_lsq": dict(method=jq.QMethod.asymmetric_uniform, grad_scaling=True),
}


def _module_pair(name, per_channel, channels):
    kw = dict(QSPECS[name])
    kw["method"] = tq.QMethod(kw["method"].value)
    tspec = tq.QuantizerSpec(per_channel=per_channel, **kw)
    jspec = jq.QuantizerSpec(per_channel=per_channel, **QSPECS[name])
    rspec = jest.EstimatorSpec(kind=jest.RangeEstimators.current_minmax)
    tr_spec = test_.EstimatorSpec(kind=test_.RangeEstimators.current_minmax)
    n = channels if per_channel else None
    jmod = jquant.Quantizer(spec=jspec, range_spec=rspec, num_channels=n,
                            channel_axis=-1)
    tmod = tquant.Quantizer(tspec, tr_spec, num_channels=n, channel_axis=0)
    return jspec, jmod, tmod


@pytest.mark.parametrize("name", list(QSPECS))
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
def test_quantizer_learn_mode_gradients(name, per_channel):
    """Calibrate both modules on the same data, make the port's ranges
    trainable, then differentiate a learn-mode forward w.r.t. x and every
    range entry that ``trainable_param_names`` names.  Per channel, x is
    (C, 1) in the port and (1, C) in JAX: one element a channel, so the
    range gradients take no reduction and are compared bit for bit."""
    c = 24
    x = _data(30, (c, 1) if per_channel else (c, 16))
    if name.startswith("sym"):
        x = x.copy()            # signed data; the unsigned grid is in
    g = np.random.RandomState(7).standard_normal(x.shape).astype(np.float32)
    jspec, jmod, tmod = _module_pair(name, per_channel, c)
    jx = jnp.asarray(x.T if per_channel else x)
    jg_ct = jnp.asarray(g.T if per_channel else g)
    variables = jmod.init(jax.random.PRNGKey(0), jx, mode="calibrate")
    _, upd = jmod.apply(variables, jx, mode="calibrate", mutable=["quant"])
    qvars = upd["quant"]
    tmod.load_state({k: np.asarray(v) for k, v in qvars["q"].items()},
                    {k: np.asarray(v) for k, v in qvars["est"].items()})
    names = jq.trainable_param_names(jspec)
    assert tq.trainable_param_names(tmod.spec) == names
    tmod.make_range_trainable()
    assert {n for n, _ in tmod.named_parameters()} == set(names)

    def jloss(xx, qt):
        q = {**qvars["q"], **qt}
        return jnp.sum(jmod.apply({"quant": {"q": q, "est": qvars["est"]}}, xx,
                                  mode="learn") * jg_ct)

    jgx, jgq = jax.grad(jloss, argnums=(0, 1))(
        jx, {n: qvars["q"][n] for n in names})
    tx = torch.from_numpy(x.copy()).requires_grad_()
    (tmod(tx, mode="learn") * torch.from_numpy(g)).sum().backward()
    _eq(jgx.T if per_channel else jgx, tx.grad)
    for n in names:
        ref, got = np.asarray(jgq[n]), getattr(tmod, n).grad
        if ref.ndim:            # per channel: one term a channel
            _eq(ref, got)
        elif np.isnan(ref):     # a zero channel's maxval: NaN in both
            assert torch.isnan(got)
        else:
            terms = _per_element_terms(tmod, x, g, n)
            bound = terms.numel() * 2.0 ** -23 * float(terms.abs().sum())
            assert abs(float(got) - float(ref)) <= bound, (got, ref, bound)


def _per_element_terms(tmod, x, g, name):
    """The per-element gradient terms of a per-tensor range entry: the
    module's arithmetic with the entry broadcast to x's shape."""
    st = tmod.state()
    full = st[name].expand(x.shape).clone().requires_grad_()
    st[name] = full
    spec = tmod.spec
    xt = torch.from_numpy(x.copy())
    if spec.is_fp8:
        y = tfp8.quantize_to_fp8(xt, st["maxval"], st["mantissa_bits"],
                                 sign_bits=st["sign_bits"])
    elif spec.method == tq.QMethod.symmetric_uniform:
        y = tuni.quantize_uniform_symmetric(
            xt, st["delta"], st["signed"], spec.n_bits,
            grad_scaling=spec.grad_scaling)
    else:
        y = tuni.quantize_uniform_asymmetric(
            xt, st["delta"], st["zero_float"], spec.n_bits,
            grad_scaling=spec.grad_scaling)
    (y * torch.from_numpy(g)).sum().backward()
    return full.grad


def test_quantizer_modes_and_estimator_choice():
    """calibrate_train re-estimates the range and stops its gradient;
    learn without trainable ranges runs on the buffers; stoch_round rounds
    to nearest without a generator (as JAX does without its rng stream)
    and stochastically with one."""
    spec = tq.QuantizerSpec(set_maxval=True, learn_maxval=True,
                            grad_estimator="stoch_round")
    mod = tquant.Quantizer(spec, test_.EstimatorSpec(
        kind=test_.RangeEstimators.current_minmax))
    mod.make_range_trainable()
    x = torch.from_numpy(_data(40)).requires_grad_()
    y = mod(x, mode="calibrate_train")
    assert float(mod.maxval) == float(x.detach().abs().max())
    y.sum().backward()
    assert mod.maxval.grad is None
    near = mod(x.detach(), mode="learn")
    assert torch.equal(near, mod(x.detach(), mode="fixed"))
    tquant.set_quant_noise(mod, torch.Generator().manual_seed(1))
    assert not torch.equal(mod(x.detach(), mode="learn"), near)
    with pytest.raises(ValueError):
        mod(x, mode="nope")
