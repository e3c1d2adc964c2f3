"""``make_train_step(remat=True)`` of the port (training/qat.py) on the CPU.

* On the tiny MobileNetV2 of tests/test_torch_qat.py with classifier
  dropout 0.2, stochastic rounding, SGD with momentum and weight decay,
  Adam on the learned maxvals, oscillation dampening and freezing: two
  ``remat`` steps equal two plain steps bit for bit in modes ``learn`` and
  ``calibrate_train`` (parameters, BN buffers, the quantizers' and
  estimators' state, both optimizers' state, ``step`` and ``osc_state``),
  and so do the losses.  The recompute really runs: the model's forward
  is entered twice a step, against once a plain step.
* Against JAX ``make_train_step(remat=True)`` on JAX's TinyModel
  (tests/test_training.py ``test_train_step_with_remat_matches``, FP8 with
  learned maxval and mantissa bits, SGD 1e-2), the port's tiny model
  carrying JAX's calibrated variables: the loss within rtol 1e-6 and every
  parameter within rtol 1e-5 / atol 1e-7, JAX's own bounds between its
  remat and plain steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import training as jtr
from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.training import qat as tqat
from fp8_quantization_tpu_torch.training.oscillation import OscillationConfig
from tests._tiny import TinyModel as JTiny
from tests._tiny_torch import tiny_model
from tests.test_torch_qat import CLASSES, FP8_LEARN, SEED, TINY, batch

torch.set_num_threads(1)


def _mobilenet_state(mode):
    model = tmnv2.mobilenetv2_quantized(
        make_layer_config(grad_estimator="stoch_round", **FP8_LEARN),
        num_classes=CLASSES, settings=TINY, device="cpu", dropout_rate=0.2)
    convert.load_tonylins_mobilenet_v2(
        model, convert.random_mobilenet_v2_state_dict(SEED, TINY, CLASSES))
    calibrate(model, [batch()[0]], device="cpu")
    state = tqat.init_qat_state(
        model, model.config,
        tqat.make_optimizer("SGD", 0.01, momentum=0.9, weight_decay=1e-4),
        tqat.make_optimizer("Adam", 1e-3),
        oscillation=OscillationConfig(dampen_weight=0.01, freeze_threshold=0.02,
                                      total_steps=4))
    calls = []
    model.register_forward_pre_hook(lambda *_: calls.append(mode))
    return state, calls


def _snapshot(state):
    opt = [o.state_dict()["state"] for o in (state.optimizer, state.quant_optimizer)]
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "opt": [{p: {k: torch.as_tensor(v).clone() for k, v in s.items()}
                     for p, s in o.items()} for o in opt],
            "step": state.step,
            "osc": {k: {n: t.clone() for n, t in v.items()}
                    for k, v in state.osc_state.items()}}


def _assert_bit_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_bit_equal(u, v, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("mode", ["learn", "calibrate_train"])
def test_remat_step_equals_plain_step_bit_for_bit(mode):
    runs = {}
    for remat in (False, True):
        state, calls = _mobilenet_state(mode)
        step = tqat.make_train_step(state, mode=mode, remat=remat)
        losses = []
        for seed in (SEED, SEED + 1):
            x, y = batch(seed)
            state, m = step(state, x, y)
            losses.append(m)
        runs[remat] = (_snapshot(state), losses, len(calls))
    (plain, plain_m, plain_calls), (remat, remat_m, remat_calls) = runs[False], runs[True]
    assert plain_m == remat_m
    _assert_bit_equal(remat, plain)
    assert remat["step"] == 2 and remat["osc"]
    assert any("frozen" in k for k in remat_m[-1])
    # every BN buffer moved once a step, as in the plain step
    before, _ = _mobilenet_state(mode)
    moved = [k for k, v in before.model.state_dict().items()
             if "running" in k and not torch.equal(v, remat["model"][k])]
    assert moved
    assert (plain_calls, remat_calls) == (2, 4)


def test_remat_step_matches_jax_remat_step():
    """tests/test_training.py's remat case, the port against JAX."""
    cfg = dict(qmethod="fp_quantizer", per_channel_weights=True,
               fp8_set_maxval=True, fp8_learn_maxval=True,
               fp8_learn_mantissa_bits=True, weight_range_method="current_minmax",
               act_range_method="allminmax")
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (8, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.int32)
    jcfg = j_make_config(**cfg)
    jmodel = JTiny(config=jcfg)
    jvars = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jvars = j_calibrate(jmodel, jvars, [jnp.asarray(x)])
    jstate, aux = jtr.init_qat_state(jvars, jcfg, jtr.make_optimizer("SGD", 1e-2))
    jstate, jm = jtr.make_train_step(jmodel, aux, donate=False, remat=True)(
        jstate, jnp.asarray(x), jnp.asarray(y))

    model = tiny_model(make_layer_config(**cfg))
    convert.load_jax_variables(model, jax.tree.map(np.asarray, jvars))
    state = tqat.init_qat_state(model, model.config, tqat.make_optimizer("SGD", 1e-2))
    state, m = tqat.make_train_step(state, remat=True)(state, x, y)
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-6)

    ref = tiny_model(make_layer_config(**cfg))
    convert.load_jax_variables(ref, jax.tree.map(np.asarray, jstate.variables()))
    ref_params = dict(ref.named_parameters())
    quant_ids = {id(p) for p in tqat.partition_quant(model)[1]}
    params = [(k, p) for k, p in model.named_parameters() if id(p) not in quant_ids]
    assert len(params) == 8         # 2 x (weight, BN scale, BN bias), fc weight, bias
    for k, p in params:
        np.testing.assert_allclose(p.detach().numpy(), ref_params[k].detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
