"""The port's W4A8 MobileNetV2 QAT demo (fp8_quantization_tpu_torch/tools/
qat_mnv2_w4a8.py) on the CPU.

* ``--smoke --device cpu``: JAX's assertions (tests/test_qat_model_scale.py):
  four trajectory entries and QAT's top-1 at least PTQ's less 0.05; the
  losses finite and the frozen fraction reported.
* The fp32 pretraining step against JAX's (the step of
  ``tools/qat_mnv2_w4a8.py``, written here as that script writes it inside
  its ``main``) for two steps from JAX's initial variables, on the smoke
  MobileNetV2 with the fc4_dw8 preset and ``dropout_rate=0``.  With the
  demo's Adam the two losses within rtol 1e-5; with SGD also every weight,
  BN parameter and BN statistic within rtol 1e-5 / atol 1e-6.  Adam's
  first steps move each parameter by about the learning rate whatever its
  gradient's size, so a gradient at rounding-noise level (a BN bias ahead
  of another BN has none) moves it by +-3e-3 on a sign the summation order
  decides; SGD's update is linear in the gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fp8_quantization_tpu.models import mobilenetv2_quantized as j_mnv2
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.training import (
    init_qat_state as j_init_qat_state, make_optimizer as j_make_optimizer)
from fp8_quantization_tpu_torch.data.imagenet import SyntheticImageNet
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.mobilenet_v2 import mobilenetv2_quantized
from fp8_quantization_tpu_torch.tools import qat_mnv2_w4a8 as demo
from fp8_quantization_tpu_torch.training import qat as tqat

torch.set_num_threads(1)
CLASSES = 16


def test_smoke_run_holds_jax_assertions():
    result = demo.main(["--smoke", "--device", "cpu"])
    assert len(result["trajectory"]) == 4
    assert result["qat_top1"] >= result["ptq_top1"] - 0.05
    assert result["device"] == "cpu" and result["qat_steps"] == 16
    assert np.isfinite(result["fp32_loss"]) and np.all(np.isfinite(result["qat_losses"]))
    assert 0.0 <= result["frozen_fraction"] <= 1.0


def _jax_fp32_step(model, model_tx):
    """tools/qat_mnv2_w4a8.py's ``fp32_step``."""
    @jax.jit
    def fp32_step(state, x, y):
        def _loss(params):
            logits, upd = model.apply(
                {"params": params, "quant": state.quant,
                 "batch_stats": state.batch_stats},
                x, mode="fp32", quant_w=False, quant_a=False, train_bn=True,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.fold_in(jax.random.PRNGKey(5),
                                                    state.step)})
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), upd

        (loss, upd), g = jax.value_and_grad(_loss, has_aux=True)(state.params)
        p_up, opt_state = model_tx.update(g, state.opt_state, state.params)
        return dataclasses.replace(
            state, params=optax.apply_updates(state.params, p_up),
            batch_stats=upd["batch_stats"], opt_state=opt_state,
            step=state.step + 1), loss
    return fp32_step


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_fp32_step_matches_jax(optimizer):
    kw = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
              n_bits=4, n_bits_act=8, per_channel_weights=True,
              weight_range_method="current_minmax", act_range_method="allminmax")
    batches = list(SyntheticImageNet(image_size=32, batch_size=16, num_batches=2,
                                     num_classes=CLASSES, seed=0))
    jcfg = j_make_config(**kw)
    jmodel = j_mnv2(jcfg, quant_setup="fc4_dw8", num_classes=CLASSES,
                    dropout_rate=0.0, settings=demo.SMOKE_SETTINGS)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(batches[0][0][:2]))
    jstate, aux = j_init_qat_state(jvars, jcfg, j_make_optimizer(optimizer, 3e-3))
    jstep = _jax_fp32_step(jmodel, aux["model_tx"])

    model = mobilenetv2_quantized(demo.w4a8_config(), quant_setup="fc4_dw8",
                                  num_classes=CLASSES, settings=demo.SMOKE_SETTINGS,
                                  device="cpu", dropout_rate=0.0)
    convert.load_jax_variables(model, jax.tree.map(np.asarray, jvars))
    state = tqat.init_qat_state(model, model.config, tqat.make_optimizer(optimizer, 3e-3))
    for x, y in batches:
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        state, loss = demo.fp32_step(state, x, y)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == int(jstate.step) == 2
    if optimizer == "Adam":
        return
    ref = mobilenetv2_quantized(demo.w4a8_config(), quant_setup="fc4_dw8",
                                num_classes=CLASSES, settings=demo.SMOKE_SETTINGS,
                                device="cpu")
    convert.load_jax_variables(ref, jax.tree.map(np.asarray, jstate.variables()))
    ref_state = ref.state_dict()
    params = [k for k, _ in model.named_parameters()
              if not k.split(".")[-2].endswith("_q")]
    stats = [k for k in ref_state if "running" in k]
    assert len(params) > 40 and len(stats) > 20
    for k in params + stats:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), ref_state[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
