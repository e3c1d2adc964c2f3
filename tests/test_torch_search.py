"""The port's range searches against the JAX package (CPU): the MSE grid
search with its mantissa-bit sweep and vote, its integer branch, percentile
clipping, the line search, ``stop_after`` and the network format search,
and the CLI running them on a tiny model.

The JAX functions run compiled, as its calibration step runs them.
Tolerances: the search grid's steps and the percentile are bit-equal to
``jnp.linspace`` / ``jnp.percentile`` as such a step computes them; the
grid itself agrees to 2 ulps (XLA fuses the steps with the channels'
absmax and may round a point an ulp apart); the MSE tables agree to rtol
5e-5 (torch and XLA sum a few hundred to a few thousand float32 squares
in other orders, each order off by up to about n * 6e-8), the voted
mantissa bits exactly and the chosen candidates exactly, except that where
an argmin picks another candidate the two picks' accumulated errors agree
to rtol 1e-6 (a tie within the summation order).  The line search picks the
same thresholds, or ties within the summation order.  On a tiny ResNet the calibrated weight quantizers equal
JAX's in format and to 2 ulps in range (weights are the same in both
packages); each activation quantizer votes as JAX's estimator does on the
same input, and as JAX's own calibration does (or on a tie within the
summation order), with its range to rtol 1e-4 (JAX's inputs carry its
summation orders); the format search makes JAX's assignment.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.calibration import estimators as jest
from fp8_quantization_tpu.calibration import line_search as jls
from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.calibration.format_search import (
    network_format_search as j_format_search)
from fp8_quantization_tpu.models.convert import convert_resnet, merge_variables
from fp8_quantization_tpu.models.resnet import QuantizedResNet as JResNet
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu_torch.calibration import estimators as test_
from fp8_quantization_tpu_torch.calibration import line_search as tls
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.calibration.format_search import (
    find_fp8_quantizers, network_format_search)
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import QuantizedResNet, resnet_configs
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.quantizers import channel_major_view
from fp8_quantization_tpu_torch.ops import quantizer as tq

torch.set_num_threads(1)

STAGES, CLASSES, SEED = (1, 1, 1, 1), 10, 3


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---- grid and percentile -------------------------------------------------------

@pytest.mark.parametrize("num", [111, 37, 250, 2])
def test_search_steps_bit_equal_jnp_linspace(num):
    """The MSE grid's points, the default 111 and --num-candidates values,
    bit for bit against jnp.linspace(0.1, 1.2, num) as a compiled step
    evaluates it (a constant, as in the calibration step)."""
    ours = test_.search_steps(num).numpy()
    ref = np.asarray(jax.jit(lambda: jnp.linspace(0.1, 1.2, num))())
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_search_steps_at_1000_points_within_one_ulp():
    """At 1,000 points XLA does not fold the steps but computes them at
    run time with a fused multiply-add: the port's points lie within one
    ulp of those (about a fifth of them one ulp apart)."""
    ours = _bits(test_.search_steps(1000).numpy())
    ref = _bits(jax.jit(lambda: jnp.linspace(0.1, 1.2, 1000))())
    assert np.abs(ours - ref).max() <= 1


PERCENTILE_CASES = [((1, 1000), 1.0), ((4, 257), 0.1), ((3, 50), 12.5),
                    ((2, 9), 49.0), ((1, (1 << 24) + 3), 0.01)]


@pytest.mark.parametrize("shape, p", PERCENTILE_CASES,
                         ids=[f"{s[0]}x{s[1]}-p{p}" for s, p in PERCENTILE_CASES])
def test_percentile_bit_equal_jnp_percentile(shape, p):
    """The clipped range at [p, 100 - p] along the last axis, bit for bit
    against the JAX estimator's jnp.percentile (current_minmax with
    ``percentile``, per channel for several rows, per tensor for one),
    compiled as the calibration step compiles it; the
    last case lies above torch.quantile's 2^24-element limit (float32 n - 1
    is not exact there)."""
    x = np.random.RandomState(shape[1] % 97).standard_t(3, shape).astype(np.float32)
    pc = shape[0] > 1
    ours = test_.percentile(torch.from_numpy(x), [p, 100.0 - p]).numpy()
    _, jlo, jhi, _ = jax.jit(lambda a: jest.update(
        jest.EstimatorSpec(percentile=p), jq.QuantizerSpec(per_channel=pc), {},
        a))(jnp.asarray(x))
    ref = np.stack([np.reshape(jlo, -1), np.reshape(jhi, -1)])
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_current_minmax_percentile_matches_jax():
    """Percentile clipping through the estimators, per tensor and per
    channel."""
    x = np.random.RandomState(0).standard_normal((6, 300)).astype(np.float32)
    for pc in (False, True):
        qs = tq.QuantizerSpec(per_channel=pc)
        jqs = jq.QuantizerSpec(per_channel=pc)
        xc = x if pc else x.reshape(1, -1)
        _, lo, hi, _ = test_.update(test_.EstimatorSpec(percentile=0.5), qs, {},
                                    torch.from_numpy(xc))
        _, jlo, jhi, _ = jax.jit(lambda a, _q=jqs: jest.update(
            jest.EstimatorSpec(percentile=0.5), _q, {}, a))(jnp.asarray(xc))
        assert lo.shape == np.shape(jlo) and hi.shape == np.shape(jhi)
        np.testing.assert_array_equal(_bits(lo), _bits(jlo))
        np.testing.assert_array_equal(_bits(hi), _bits(jhi))


# ---- the MSE search ------------------------------------------------------------

def _batches(shape, seed):
    """Two calibration batches, channels with different spreads and tails."""
    rs = np.random.RandomState(seed)
    c = shape[0]
    scale = rs.uniform(0.2, 3.0, (c, 1))
    return [(rs.standard_t(4, shape) * scale).astype(np.float32)
            for _ in range(2)]


MSE_CASES = {
    "fp8-per-channel-sweep": (dict(per_channel=True), (8, 300)),
    "fp8-per-tensor-sweep": (dict(), (1, 2000)),
    "fp8-per-channel-e4m3": (dict(per_channel=True, mantissa_bits=3,
                                  mse_include_mantissa_bits=False), (6, 200)),
    "fp8-per-tensor-unsigned": (dict(allow_unsigned=True), (1, 500)),
    "int-per-channel": (dict(method="symmetric_uniform", per_channel=True),
                        (5, 300)),
    "int-per-tensor": (dict(method="symmetric_uniform"), (1, 800)),
}


def _check_pick(grid, mses, jgrid, jmses, ours, ref, best):
    """Each channel's pick: the same candidate index as JAX's, or, where the
    argmin picks another, the two picks' accumulated errors within rtol
    1e-6 in both tables (a tie within the summation order)."""
    ours, ref = np.atleast_1d(ours), np.atleast_1d(ref)
    for c in range(grid.shape[1]):
        i = int(np.nonzero(grid[:, c] == ours[c])[0][0])
        j = int(np.nonzero(jgrid[:, c] == ref[c])[0][0])
        if i != j:
            for table in (mses, jmses):
                np.testing.assert_allclose(table[best, i, c], table[best, j, c],
                                           rtol=1e-6)


@pytest.mark.parametrize("name", list(MSE_CASES))
def test_mse_estimator_matches_jax(name):
    """Two batches accumulated, against the JAX estimator compiled as the
    calibration step compiles it: search grid (within 2 ulps: XLA fuses
    the linspace with the channels' absmax), MSE table, voted mantissa
    bits, chosen candidate and sign, batch by batch."""
    kw, shape = MSE_CASES[name]
    if name.endswith("unsigned"):
        batches = [np.abs(b) for b in _batches(shape, 1)]
    else:
        batches = _batches(shape, 1)
    qs, jqs = tq.QuantizerSpec(**kw), jq.QuantizerSpec(**kw)
    spec = test_.EstimatorSpec(kind=test_.RangeEstimators.MSE)
    jspec = jest.EstimatorSpec(kind=jest.RangeEstimators.MSE)
    c = shape[0] if kw.get("per_channel") else None
    st = test_.init_state(spec, qs, c)
    jst = jest.init_state(jspec, jqs, c)
    assert {k: tuple(v.shape) for k, v in st.items()} == {
        k: tuple(v.shape) for k, v in jst.items()}
    jupdate = jax.jit(lambda s, x: jest.update(jspec, jqs, s, x))
    for b in batches:
        st, lo, hi, upd = test_.update(spec, qs, st, torch.from_numpy(b))
        jst, jlo, jhi, jupd = jupdate(jst, jnp.asarray(b))
        grid, mses = st["search_grid"].numpy(), st["mses"].numpy()
        jgrid, jmses = np.asarray(jst["search_grid"]), np.asarray(jst["mses"])
        np.testing.assert_allclose(grid, jgrid, rtol=2.0 ** -22)
        np.testing.assert_allclose(mses, jmses, rtol=5e-5)
        assert sorted(upd) == sorted(jupd)
        best = 0
        if "mantissa_bits" in upd:
            assert float(upd["mantissa_bits"]) == float(jupd["mantissa_bits"])
            best = test_.mbit_list(qs).index(float(upd["mantissa_bits"]))
        _check_pick(grid, mses, jgrid, jmses, hi.numpy(), np.asarray(jhi), best)
        np.testing.assert_array_equal(np.sign(lo.numpy()), np.sign(jlo))


def test_mse_sweep_chunks_give_the_same_values(monkeypatch):
    """The candidate sweep in chunks of 1 and in one chunk: equal tables."""
    assert test_.sweep_chunk(torch.zeros(64, 112, 112, 64)) == 3
    b = _batches((4, 100), 2)[0]
    qs = tq.QuantizerSpec(per_channel=True)
    spec = test_.EstimatorSpec(kind=test_.RangeEstimators.MSE, num_candidates=20)
    out = []
    for chunk in (1, 20):
        monkeypatch.setattr(test_, "sweep_chunk", lambda x, _c=chunk: _c)
        st = test_.init_state(spec, qs, 4)
        out.append(test_.update(spec, qs, st, torch.from_numpy(b))[0]["mses"])
    assert torch.equal(out[0], out[1])


# ---- the line search -----------------------------------------------------------

LS_SPECS = {"fp8": dict(), "fp8-e5m2": dict(mantissa_bits=2),
            "int-asym": dict(method="asymmetric_uniform")}


def _check_ls_pick(thresholds, losses, jlosses, ours, ref):
    """Each channel's threshold equal to JAX's, or, where the argmin picks
    another, the two picks' accumulated losses within rtol 1e-6 in both
    tables (a tie within the summation order)."""
    for c in np.nonzero(ours != ref)[0]:
        i = int(np.nonzero(thresholds == ours[c])[0][0])
        j = int(np.nonzero(thresholds == ref[c])[0][0])
        for table in (losses, jlosses):
            np.testing.assert_allclose(table[i, c], table[j, c], rtol=1e-6)


@pytest.mark.parametrize("name", list(LS_SPECS))
def test_line_search_estimator_matches_jax(name):
    """The per-channel estimator over two batches: the same thresholds and
    picks; losses to rtol 1e-5 on the FP8 grids.  On the asymmetric
    integer grid a symmetric range puts the zero point at 127.5, on a
    rounding tie, and inside its traced sweep XLA divides the range by 255
    as a product with the reciprocal, which moves the step by an ulp and
    the zero point by one for some thresholds: there only the picks are
    held."""
    kw = LS_SPECS[name]
    qs, jqs = tq.QuantizerSpec(per_channel=True, **kw), jq.QuantizerSpec(
        per_channel=True, **kw)
    spec = test_.EstimatorSpec(kind=test_.RangeEstimators.line_search,
                               num_candidates=60)
    jspec = jest.EstimatorSpec(kind=jest.RangeEstimators.line_search,
                               num_candidates=60)
    st, jst = test_.init_state(spec, qs, 4), jest.init_state(jspec, jqs, 4)
    for b in _batches((4, 150), 3):
        st, lo, hi, _ = test_.update(spec, qs, st, torch.from_numpy(b))
        jst, jlo, jhi, _ = jest.update(jspec, jqs, jst, jnp.asarray(b))
        thr = st["thresholds"].numpy()
        np.testing.assert_array_equal(_bits(thr), _bits(jst["thresholds"]))
        losses, jlosses = st["losses"].numpy(), np.asarray(jst["losses"])
        if not name.startswith("int"):
            np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        _check_ls_pick(thr, losses, jlosses, hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(np.sign(lo.numpy()), np.sign(jlo))


@pytest.mark.parametrize("name", list(LS_SPECS))
def test_line_search_range_matches_jax(name):
    """line_search_range (grid) and LineSearchEstimator over two batches,
    one-sided data included; golden section lands within 2% of JAX's."""
    kw = LS_SPECS[name]
    qs, jqs = tq.QuantizerSpec(**kw), jq.QuantizerSpec(**kw)
    b1, b2 = (b.reshape(-1) for b in _batches((2, 400), 4))
    for x in (b1, np.abs(b1)):
        assert tls.line_search_range(x, qs, 200) == jls.line_search_range(
            x, jqs, 200)
    gs = tls.line_search_range(b1, qs, 200, opt_method="golden_section")
    jgs = jls.line_search_range(b1, jqs, 200, opt_method="golden_section")
    np.testing.assert_allclose(gs, jgs, rtol=0.02)
    est, jestm = tls.LineSearchEstimator(qs, 150), jls.LineSearchEstimator(jqs, 150)
    for x in (b1, b2):
        assert est.update(x) == jestm.update(x)


# ---- calibration on a tiny ResNet: MSE, stop_after, format search ---------------

MSE_CFG = dict(per_channel_weights=True, fp8_set_maxval=True,
               weight_range_method="MSE", act_range_method="MSE",
               num_candidates=31, act_num_candidates=21)


def _x():
    return np.random.RandomState(SEED).standard_normal((2, 32, 32, 3)).astype(np.float32)


def _sd():
    return convert.random_resnet_state_dict(SEED, STAGES, num_classes=CLASSES)


def _jax_resnet(cfg, engine="parity"):
    jmodel = JResNet(stage_sizes=STAGES, bottleneck=False, num_classes=CLASSES,
                     config=j_make_config(engine=engine, **cfg))
    x = jnp.asarray(_x())
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)
    return jmodel, merge_variables(jvars, *convert_resnet(_sd(), STAGES,
                                                          bottleneck=False))


def _port_resnet(cfg, engine="parity"):
    model = QuantizedResNet(STAGES, False, CLASSES, **resnet_configs(
        make_layer_config(engine=engine, **cfg), None))
    convert.load_torchvision_resnet(model, _sd())
    return model


def _jq_node(jquant, name):
    node = jquant
    for part in name.split("."):
        node = node[part]
    return node["q"]


def _port_quantizers(model):
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
    return [(n, m) for n, m in model.named_modules() if isinstance(m, Quantizer)]


@pytest.fixture(scope="module")
def mse_calibrated():
    """JAX's and the port's tiny ResNet after one MSE calibration batch,
    with each port quantizer's estimator input (name -> (C, N) view)."""
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
    jmodel, jvars = _jax_resnet(MSE_CFG)
    jvars = jax.tree.map(np.asarray, j_calibrate(jmodel, jvars, [jnp.asarray(_x())]))
    model = _port_resnet(MSE_CFG)
    names = {id(qz): n for n, qz in _port_quantizers(model)}
    inputs, calibrate_one = {}, Quantizer._calibrate

    def record(qz, x):
        inputs[names[id(qz)]] = channel_major_view(
            x.to(torch.float32), qz.channel_axis if qz.spec.per_channel else None).clone()
        calibrate_one(qz, x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Quantizer, "_calibrate", record)
        calibrate(model, [_x()], device="cpu")
    return jmodel, jvars, model, inputs


def _jax_specs(qz):
    """JAX's quantizer and estimator specs equal to the port quantizer's."""
    qs = jq.QuantizerSpec(**{f.name: getattr(qz.spec, f.name)
                             for f in dataclasses.fields(qz.spec)})
    es = jest.EstimatorSpec(**{f.name: getattr(qz.range_spec, f.name)
                               for f in dataclasses.fields(qz.range_spec)})
    return qs, es


def _best_mse(table, mbits_list, m):
    """Each channel's least accumulated error at mantissa bits ``m``."""
    return table[mbits_list.index(m)].min(axis=0)


def test_tiny_resnet_mse_calibration_matches_jax(mse_calibrated):
    """Every quantizer after one MSE calibration batch.  Weight quantizers
    (same weights) equal JAX's maxval and voted M.  Each activation
    quantizer's own input in the port, given to JAX's estimator compiled as
    the calibration step compiles it, gives the port's voted M, or the two
    formats' least accumulated errors agree within rtol 1e-6 in both tables
    (a tie within the summation order), and the port's pick (_check_pick).
    Against JAX's own calibration, whose activations carry its summation
    orders, the voted M is equal or, where not, such a tie on the port's
    input; where equal, the maxval agrees to rtol 1e-4."""
    _, jvars, model, inputs = mse_calibrated
    n_act, n_tie = 0, 0
    for name, qz in _port_quantizers(model):
        jnode = _jq_node(jvars["quant"], name)
        m, jm = float(qz.mantissa_bits), float(jnode["mantissa_bits"])
        if name.endswith("weight_q"):
            assert m == jm, name
            np.testing.assert_allclose(qz.maxval.numpy(), jnode["maxval"],
                                       rtol=2.0 ** -22, err_msg=name)
            continue
        n_act += 1
        jqs, jspec = _jax_specs(qz)
        x = inputs[name]
        c = x.shape[0] if qz.spec.per_channel else None
        jst, _, jhi, jupd = jax.jit(lambda s, a, _q=jqs, _e=jspec: jest.update(
            _e, _q, s, a))(jest.init_state(jspec, jqs, c), jnp.asarray(x.numpy()))
        mbits = test_.mbit_list(qz.spec)
        mses, jmses = qz.est_mses.numpy(), np.asarray(jst["mses"])
        np.testing.assert_allclose(mses, jmses, rtol=5e-5, err_msg=name)
        for other in {float(jupd["mantissa_bits"]), jm} - {m}:
            n_tie += 1
            for table in (mses, jmses):
                np.testing.assert_allclose(
                    _best_mse(table, mbits, m), _best_mse(table, mbits, other),
                    rtol=1e-6, err_msg=f"{name}: M {m} against {other}")
        if float(jupd["mantissa_bits"]) == m:
            _check_pick(qz.est_search_grid.numpy(), mses,
                        np.asarray(jst["search_grid"]), jmses,
                        np.atleast_1d(qz.maxval.numpy()), np.atleast_1d(jhi),
                        mbits.index(m))
        if m == jm:
            np.testing.assert_allclose(qz.maxval.numpy(), jnode["maxval"],
                                       rtol=1e-4, err_msg=name)
    assert n_act >= 10, n_act
    ms = {float(qz.mantissa_bits) for _, qz in _port_quantizers(model)}
    assert ms != {4.0}, ms         # the vote replaced the initial E3M4


def test_mse_estimator_state_carries_over(mse_calibrated):
    """load_jax_variables carries the MSE estimators' carries and the voted
    mantissa bits of the JAX-calibrated model."""
    _, jvars, _, _ = mse_calibrated
    model = _port_resnet(MSE_CFG)
    convert.load_jax_variables(model, jvars)
    for name, qz in _port_quantizers(model):
        jnode = _jq_node(jvars["quant"], name)
        assert float(qz.mantissa_bits) == float(jnode["mantissa_bits"]), name
        node = jvars["quant"]
        for part in name.split("."):
            node = node[part]
        np.testing.assert_array_equal(qz.est_mses.numpy(), node["est"]["mses"])
        np.testing.assert_array_equal(qz.est_search_grid.numpy(),
                                      node["est"]["search_grid"])


def _exec_order_tree(model):
    """The port's quantizers nested by module path in the order the
    forward first calls them, each leaf its name."""
    from fp8_quantization_tpu_torch.calibration import calibrate as cal_mod
    order = []
    hooks = [qz.register_forward_pre_hook(
        lambda m, a, _n=n: order.append(_n) if _n not in order else None)
        for n, qz in _port_quantizers(model)]
    with torch.no_grad():
        model(torch.from_numpy(_x()), mode="fixed")
    for h in hooks:
        h.remove()
    tree = {}
    for name in order:
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["q"] = name
    assert len(order) == len(_port_quantizers(model))
    return tree, cal_mod


@pytest.mark.parametrize("stop_after", ["layer1_0", "layer2_0_downsample",
                                        "layer3_0/conv1", "stem"])
def test_stop_after_keeps_the_execution_order_prefix(stop_after):
    """calibrate(stop_after=...) updates exactly the quantizers that JAX's
    partial_quant_updates keeps on the port's quantizers in execution
    order, and the port's partial_quant_updates masks as JAX's does.  (The
    JAX calibrate step itself gets its collection back with sorted keys
    from jit, so there the mask runs in sorted order, not in execution
    order as its docstring and the reference mean.)"""
    from fp8_quantization_tpu.calibration.calibrate import (
        partial_quant_updates as j_partial)
    cfg = dict(per_channel_weights=True, fp8_set_maxval=True)
    model = _port_resnet(cfg)
    tree, cal_mod = _exec_order_tree(model)
    old = jax.tree.map(lambda n: "old " + n, tree)
    kept = j_partial(tree, old, stop_after)
    assert cal_mod.partial_quant_updates(tree, old, stop_after) == kept
    want = {leaf for leaf in jax.tree.leaves(kept) if not leaf.startswith("old")}
    calibrate(model, [_x()], device="cpu", stop_after=stop_after)
    touched = {n for n, qz in _port_quantizers(model) if bool(qz.initialized)}
    assert touched == want and 0 < len(touched) < len(_port_quantizers(model))
    with pytest.raises(ValueError, match="matched no module"):
        cal_mod.partial_quant_updates(tree, old, "no_such_layer")


def test_network_format_search_matches_jax():
    """One pass on a min/max-calibrated tiny ResNet: JAX's assignment, a
    non-increasing history close to JAX's, and each quantizer's path."""
    cfg = dict(per_channel_weights=True, fp8_set_maxval=True)
    jmodel, jvars = _jax_resnet(cfg)
    x = [jnp.asarray(_x())]
    jvars = j_calibrate(jmodel, jvars, x)
    _, jassign, jhist = j_format_search(jmodel, jvars, x, passes=1)
    model = _port_resnet(cfg)
    calibrate(model, [_x()], device="cpu")
    _, assign, hist = network_format_search(model, [_x()], device="cpu", passes=1)
    assert [p for p, _ in find_fp8_quantizers(model)] == list(jassign)
    assert assign == jassign
    assert all(b <= a for a, b in zip(hist, hist[1:]))
    np.testing.assert_allclose(hist, jhist, rtol=1e-3)
    assert hist[-1] < hist[0]


def test_cli_mse_format_search_on_a_tiny_model(monkeypatch, capsys):
    """validate-quantized --weight-quant-method MSE --act-quant-method MSE
    --format-search-passes 1 on --device cpu, the model cut to
    stage_sizes (1, 1, 1, 1) and the images to 32x32: one JSON metrics
    line; the quantizers carry their searched formats and the model was
    prepared."""
    from fp8_quantization_tpu_torch.calibration import calibrate as cal_mod
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.data import imagenet
    from fp8_quantization_tpu_torch.models import resnet

    def tiny(base, quant_setup=None, num_classes=1000, device="cuda"):
        return QuantizedResNet(STAGES, False, num_classes,
                               **resnet_configs(base, quant_setup)).to(device)

    make = imagenet.make_dataloaders
    monkeypatch.setitem(resnet.QUANT_ARCHITECTURES, "resnet18_quantized", tiny)
    monkeypatch.setattr(imagenet, "make_dataloaders",
                        lambda *a, **k: make(*a, **{**k, "image_size": 32}))
    seen = {}
    evaluate = cal_mod.evaluate

    def spy(model, *a, **k):
        seen["model"] = model
        return evaluate(model, *a, **k)
    monkeypatch.setattr(cal_mod, "evaluate", spy)
    image_net.main(["validate-quantized", "--device", "cpu", "--engine", "fused",
                    "--per-channel", "--fp8-set-maxval",
                    "--weight-quant-method", "MSE", "--act-quant-method", "MSE",
                    "--num-candidates", "21", "--act-num-candidates", "11",
                    "--format-search-passes", "1", "--num-est-batches", "1",
                    "--max-eval-batches", "1", "--batch-size", "2"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2 and np.isfinite(metrics["loss"])
    model = seen["model"]
    assert model.fc.weight_q.est_mses.shape == (6, 21, 1000)
    assert model.stem.act_q.est_mses.shape == (6, 11, 1)
    assert bool(model.stem.act_q.est_seen)
    assert model.stem.act_q.kprep is not None and model.fc.prep_fold is not None
