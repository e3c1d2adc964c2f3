"""Oscillation dampening and freezing of the port against the JAX package
(CPU), on the tiny MobileNetV2 of tests/test_torch_qat.py.

* ``dampening_loss`` on one calibrated state, with the base weight spec
  and with the model's ``weight_spec_fn``: rtol 1e-5 (the same per-element
  terms, summed in another order).
* Freezing, driven with the same sequence of latent weights in both
  packages (half of the elements pushed back and forth across their bin,
  the rest drifting one way): after each of eight steps the frozen masks,
  the frozen values and the weights after the pass equal JAX's bit for bit
  and the oscillation frequencies agree to 1e-6 absolute; no optimizer
  is involved, so the trajectories cannot separate.
* One QAT step with dampening and freezing on: the loss, dampening term
  included, within rtol 1e-4 of JAX's (tests/test_torch_qat.py says why
  not bit for bit).
* ``weight_spec_fn`` resolves the fc4 (ResNet-18) and fc4_dw8
  (MobileNetV2) presets as JAX's does (tests/test_oscillation.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import training as jtr
from fp8_quantization_tpu.models import mobilenetv2_quantized as j_mnv2
from fp8_quantization_tpu.models import resnet18_quantized as j_resnet18
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.training import oscillation as josc
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.models.resnet import QUANT_ARCHITECTURES
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.training import oscillation as tosc
from fp8_quantization_tpu_torch.training import qat as tqat
from tests.test_torch_qat import FP8_LEARN, batch, jax_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("resolver", [False, True], ids=["base", "per_layer"])
def test_dampening_loss_matches_jax(resolver):
    jmodel, jcfg, jvars, model = jax_pair()
    jspec = jmodel.weight_spec_fn() if resolver else jcfg.weight_quant
    tspec = model.weight_spec_fn() if resolver else model.config.weight_quant
    ref = float(josc.dampening_loss(jvars["params"], jvars["quant"], jspec))
    got = tosc.dampening_loss(model, tspec)
    assert ref > 0
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)
    # its gradient pulls each weight towards its grid point
    got.backward()
    w = model.stem.weight
    wq = model.stem.weight_q(w.detach(), mode="fixed")
    torch.testing.assert_close(w.grad, 2 * (w.detach() - wq), rtol=1e-6, atol=0)


def _kernels(params):
    """(path, kernel) of every 'kernel' leaf."""
    for k, v in params.items():
        if isinstance(v, dict):
            for p, kern in _kernels(v):
                yield (k,) + p, kern
        elif k == "kernel":
            yield (), v


def _set_kernels(params, fn, path=()):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _set_kernels(v, fn, path + (k,))
        else:
            out[k] = fn(path, v) if k == "kernel" else v
    return out


def test_freezing_matches_jax():
    jmodel, jcfg, jvars, model = jax_pair()
    spec_j, spec_t = jcfg.weight_quant, model.config.weight_quant
    cfg = dict(freeze_threshold=0.05, freeze_threshold_final=0.02,
               freeze_anneal_start=0.25, freeze_ema_momentum=0.5,
               total_steps=8)
    jcfg_osc, tcfg_osc = josc.OscillationConfig(**cfg), tosc.OscillationConfig(**cfg)
    jstate = josc.init_osc_state(jvars["params"], jvars["quant"], spec_j)
    tstate = tosc.init_osc_state(model, spec_t)
    rng = np.random.RandomState(0)
    base = {p: np.asarray(k) for p, k in _kernels(jvars["params"])}
    push = {p: (rng.uniform(0.02, 0.08, k.shape) * np.abs(k).max()
                * np.where(rng.rand(*k.shape) < 0.5, 1.0, 0.0)).astype(np.float32)
            for p, k in base.items()}
    drift = {p: (rng.uniform(0, 0.01, k.shape) * np.abs(k).max()).astype(np.float32)
             for p, k in base.items()}
    params = jvars["params"]
    for step in range(8):
        sign = 1.0 if step % 2 == 0 else -1.0
        params = _set_kernels(params, lambda p, k, s=step, sg=sign: (
            base[p] + sg * push[p] + s * drift[p]).astype(np.float32))
        convert.load_jax_variables(model, {**jvars, "params": params})
        new_params, jstate, jstats = josc.apply_freezing(
            params, jvars["quant"], jstate, spec_j, jnp.int32(step), jcfg_osc)
        tstats = tosc.apply_freezing(model, tstate, spec_t, step, tcfg_osc)
        params = jax.tree.map(np.asarray, new_params)
        ref = tmnv2.mobilenetv2_quantized(
            make_layer_config(**FP8_LEARN), num_classes=10,
            settings=model.settings, device="cpu")
        convert.load_jax_variables(ref, {**jvars, "params": params})
        for path, layer in tosc.quantized_layers(model):
            jst = jstate
            for k in path:
                jst = jst[k]
            jst = jst["kernel"]
            tst = tstate[".".join(path)]
            perm = (3, 2, 0, 1) if tst["frozen"].ndim == 4 else (1, 0)
            np.testing.assert_array_equal(
                np.asarray(jst["frozen"]).transpose(perm), tst["frozen"].numpy())
            np.testing.assert_array_equal(
                np.asarray(jst["frozen_val"]).transpose(perm),
                tst["frozen_val"].numpy())
            np.testing.assert_allclose(np.asarray(jst["freq"]).transpose(perm),
                                       tst["freq"].numpy(), rtol=0, atol=1e-6)
            torch.testing.assert_close(
                layer.weight.detach(), ref.get_submodule(".".join(path)).weight,
                rtol=0, atol=0)
        np.testing.assert_allclose(tstats["frozen_fraction"],
                                   float(jstats["frozen_fraction"]), rtol=1e-6)
    assert 0 < tstats["frozen_fraction"] < 1


def test_step_with_dampening_and_freezing_matches_jax():
    jmodel, jcfg, jvars, model = jax_pair()
    x, y = batch()
    kw = dict(dampen_weight=0.5, dampen_weight_final=0.1, freeze_threshold=0.1,
              total_steps=4)
    jstate, aux = jtr.init_qat_state(
        jvars, jcfg, jtr.make_optimizer("SGD", 0.01),
        jtr.make_optimizer("Adam", 1e-3),
        oscillation=josc.OscillationConfig(**kw), model=jmodel)
    state = tqat.init_qat_state(
        model, model.config, tqat.make_optimizer("SGD", 0.01),
        tqat.make_optimizer("Adam", 1e-3),
        oscillation=tosc.OscillationConfig(**kw))
    assert callable(state.weight_spec) and state.osc_state is not None
    jstate, jm = jtr.make_train_step(jmodel, aux, donate=False)(
        jstate, jnp.asarray(x), jnp.asarray(y))
    state, m = tqat.make_train_step(state)(state, x, y)
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-4)
    assert m["frozen_fraction"] == float(jm["frozen_fraction"])


def test_anneal_matches_jax():
    for step in range(0, 12):
        ref = josc._anneal(1.0, 0.1, jnp.int32(step), 10, 0.25)
        got = tosc._anneal(1.0, 0.1, step, 10, 0.25)
        np.testing.assert_allclose(float(got), float(ref), rtol=0,
                                   atol=float(np.spacing(np.float32(ref))))
    assert float(tosc._anneal(0.3, None, 5, 10, 0.25)) == np.float32(0.3)


@pytest.mark.parametrize("arch", ["resnet18", "mobilenet_v2"])
def test_weight_spec_fn_resolves_presets_as_jax(arch):
    base = dict(qmethod="fp_quantizer", per_channel_weights=True,
                fp8_set_maxval=True)
    if arch == "resnet18":
        jmodel = j_resnet18(j_make_config(**base), quant_setup="fc4", num_classes=8)
        model = QUANT_ARCHITECTURES["resnet18_quantized"](
            make_layer_config(**base), quant_setup="fc4", num_classes=8,
            device="cpu")
        paths = [("fc",), ("stem",), ("layer1_0", "conv1"), ("layer4_1", "conv1"),
                 ("layer4_1", "conv2"), ("layer2_0_downsample",)]
    else:
        jmodel = j_mnv2(j_make_config(**base), quant_setup="fc4_dw8", num_classes=8)
        model = tmnv2.mobilenetv2_quantized(make_layer_config(**base),
                                            quant_setup="fc4_dw8", num_classes=8,
                                            device="cpu")
        paths = [("classifier",), ("stem",), ("block2_0", "dw"),
                 ("block2_0", "expand"), ("block2_0", "project"), ("head",)]
    jfn, tfn = jmodel.weight_spec_fn(), model.weight_spec_fn()
    for p in paths:
        assert tfn(p).n_bits == jfn(p).n_bits, p
    assert {tfn(p).n_bits for p in paths} == {4, 8}
