"""Checkpoints of the port (utils/checkpoint.py) and the CLI's
``--save-checkpoint-dir`` / ``--load-type quantized`` (CPU).

* JAX's tests/test_checkpoint.py cases: a calibrated model's round trip at
  ``step=3`` with ``latest_step``, ``keep=2`` pruning and the restore of a
  named older step; no step is ``FileNotFoundError``.
* A calibrated small ResNet restored into a fresh model (other weights),
  then baked, prepared and run on 'fused' (the kernels' plain versions):
  logits bit-equal to the original's.  An unbaked INT8 model's operand
  cache (nn/layers.py ``_operand``) rebuilds after a restore.
* ``save_checkpoint`` of a baked or prepared model raises.
* A ``QATState`` (SGD with momentum on the weights, Adam on the learned
  maxvals, oscillation freezing) restored into the state
  ``init_qat_state`` builds takes its next step bit-equal to the
  uninterrupted run.
* The CLI: ``--save-checkpoint-dir`` then ``--load-type quantized`` gives
  the same metrics line; ``quantized`` without a directory is a usage
  error (exit status 2); ``train-quantized --save-checkpoint-dir`` writes
  ``step_<epoch>``, keeps the newest, and it restores.
* Against JAX: the JAX model saved and restored by JAX's own
  ``save_checkpoint`` / ``restore_checkpoint`` (orbax), carried into the
  port by ``load_jax_variables``, saved and restored by the port: its
  logits within tests/test_torch_resnet.py's tolerance of JAX's (one step
  of the fc's FP8 output grid, >= 98% exact, top-1 identical).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.utils.checkpoint import (
    restore_checkpoint as j_restore, save_checkpoint as j_save)
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet_configs)
from fp8_quantization_tpu_torch.nn import bake
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.training import qat as tqat
from fp8_quantization_tpu_torch.training.oscillation import OscillationConfig
from fp8_quantization_tpu_torch.utils.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint)
from tests._tiny import TinyModel as JTiny, japply
from tests._tiny_torch import tiny_model

torch.set_num_threads(1)

CFG = dict(qmethod="fp_quantizer", per_channel_weights=True,
           fp8_set_maxval=True)
FP8 = dict(per_channel_weights=True, fp8_mantissa_bits=4, fp8_set_maxval=True,
           weight_range_method="current_minmax", act_range_method="allminmax")
INT8 = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
            per_channel_weights=True, quantize_input=True, int8_mxu=True,
            weight_range_method="current_minmax", act_range_method="allminmax")
RESNET = (1, 1, 1, 1)


def _x(b=2, size=16, seed=0):
    return np.random.RandomState(seed).normal(
        0, 1, (b, size, size, 3)).astype(np.float32)


def _calibrated(**kw):
    model = tiny_model(make_layer_config(**CFG, **kw))
    calibrate(model, [_x()], device="cpu")
    return model


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def _fwd(model, x, quant_w, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(x), mode="fixed", quant_w=quant_w, **kw)


# ---- JAX's cases -----------------------------------------------------------------

def test_variables_round_trip(tmp_path):
    model = _calibrated()
    save_checkpoint(str(tmp_path / "ck"), model, step=3)
    assert latest_step(str(tmp_path / "ck")) == 3
    fresh = tiny_model(make_layer_config(**CFG))
    assert restore_checkpoint(str(tmp_path / "ck"), fresh) is fresh
    _assert_same_state(model, fresh)


def test_keep_pruning(tmp_path):
    model = _calibrated()
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path / "ck"), model, step=s, keep=2)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_3"]
    # restore of an explicitly-named older step still works
    fresh = restore_checkpoint(str(tmp_path / "ck"),
                               tiny_model(make_layer_config(**CFG)), step=2)
    _assert_same_state(model, fresh)


def test_no_checkpoint(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    (tmp_path / "empty").mkdir()
    assert latest_step(str(tmp_path / "empty")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"),
                           tiny_model(make_layer_config(**CFG)))


# ---- restore, then deploy --------------------------------------------------------

def _resnet(cfg, seed):
    model = QuantizedResNet(RESNET, False, 10, **resnet_configs(
        make_layer_config(engine="fused", **cfg), None))
    convert.load_torchvision_resnet(model, convert.random_resnet_state_dict(
        seed, RESNET, num_classes=10))
    return model


def test_restored_resnet_deploys_bit_equal(tmp_path):
    """Calibrated, saved, restored into a model of other weights; both
    baked, prepared and run on 'fused': the same logits."""
    x = _x(2, 32)
    model = _resnet(FP8, seed=1)
    calibrate(model, [x], device="cpu")
    save_checkpoint(str(tmp_path / "ck"), model)
    fresh = restore_checkpoint(str(tmp_path / "ck"), _resnet(FP8, seed=2))
    outs = []
    for m in (model, fresh):
        bake.prepare_for_deployment(m, torch.zeros((1, 32, 32, 3)))
        outs.append(_fwd(m, x, quant_w=False))
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(*outs)


def test_operand_cache_rebuilds_after_restore(tmp_path):
    """An unbaked INT8 model on 'fused' caches its float32 weight matrices
    (nn/layers.py ``_operand``); a restore of other weights in place
    rebuilds them: its logits become the saved model's."""
    x = _x(2, 32)
    saved = _resnet(INT8, seed=1)
    calibrate(saved, [x], device="cpu")
    save_checkpoint(str(tmp_path / "ck"), saved)
    other = _resnet(INT8, seed=2)
    calibrate(other, [x], device="cpu")
    before = _fwd(other, x, quant_w=True)
    assert any(m._operand_cache for m in other.modules()
               if hasattr(m, "_operand_cache"))
    restore_checkpoint(str(tmp_path / "ck"), other)
    after = _fwd(other, x, quant_w=True)
    assert not torch.equal(before, after)
    assert torch.equal(after, _fwd(saved, x, quant_w=True))


@pytest.mark.parametrize("engine", ["parity", "fused"])
def test_save_of_a_baked_or_prepared_model_raises(engine, tmp_path):
    """A baked model (on 'parity' its weights are quantized in place,
    with no new buffer) and a prepared one are refused; the calibrated
    model itself saves."""
    ck = str(tmp_path / "ck")
    model = _calibrated(engine=engine)
    baked = copy.deepcopy(model)
    bake.bake_for_inference(baked)
    with pytest.raises(ValueError, match="baked or prepared"):
        save_checkpoint(ck, baked)
    prepared = bake.prepare_inference(copy.deepcopy(model),
                                      torch.zeros((1, 16, 16, 3)))
    if engine == "fused":
        with pytest.raises(ValueError, match="baked or prepared"):
            save_checkpoint(ck, prepared)
    assert latest_step(ck) is None
    save_checkpoint(ck, model)
    assert latest_step(ck) == 0


# ---- the QAT state ---------------------------------------------------------------

LEARN = dict(CFG, fp8_learn_maxval=True, weight_range_method="current_minmax",
             act_range_method="allminmax")


def _qat_state():
    model = tiny_model(make_layer_config(**LEARN))
    calibrate(model, [_x(4)], device="cpu")
    return tqat.init_qat_state(
        model, model.config,
        tqat.make_optimizer("SGD", 0.05, momentum=0.9, weight_decay=1e-4),
        tqat.make_optimizer("Adam", 1e-3),
        oscillation=OscillationConfig(freeze_threshold=0.02, total_steps=8))


def _train(state, steps, start=0):
    step = tqat.make_train_step(state)
    for i in range(start, start + steps):
        rng = np.random.RandomState(100 + i)
        x = rng.normal(0, 1, (4, 16, 16, 3)).astype(np.float32)
        state, _ = step(state, x, rng.randint(0, 4, 4))
    return state


def test_qat_state_resumes_bit_equal(tmp_path):
    """Two steps, save, one more step; a fresh state restored from the
    save takes that third step to the same weights, ranges, BN statistics,
    optimizer moments and oscillation state, bit for bit."""
    state = _train(_qat_state(), 2)
    save_checkpoint(str(tmp_path / "ck"), state, step=state.step)
    saved = copy.deepcopy(state.model)
    state = _train(state, 1, start=2)

    fresh = _qat_state()
    assert not torch.equal(fresh.model.fc.weight, saved.fc.weight)
    fresh = restore_checkpoint(str(tmp_path / "ck"), fresh)
    assert fresh.step == 2
    _assert_same_state(fresh.model, saved)
    assert fresh.model.fc.act_q.maxval.requires_grad     # still learning
    fresh = _train(fresh, 1, start=2)
    assert fresh.step == state.step == 3
    _assert_same_state(fresh.model, state.model)
    for a, b in ((fresh.optimizer, state.optimizer),
                 (fresh.quant_optimizer, state.quant_optimizer)):
        for sa, sb in zip(a.state_dict()["state"].values(),
                          b.state_dict()["state"].values()):
            for k in sa:
                assert torch.equal(sa[k], sb[k]), k
    for layer, s in state.osc_state.items():
        for k, v in s.items():
            assert torch.equal(fresh.osc_state[layer][k], v), (layer, k)


# ---- the CLI ---------------------------------------------------------------------

VALIDATE = ["validate-quantized", "--device", "cpu", "--engine", "fused",
            "--per-channel", "--fp8-set-maxval", "--num-est-batches", "1",
            "--max-eval-batches", "1", "--batch-size", "2"]


def _metrics(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_save_then_load_quantized(capsys, tmp_path):
    ck = str(tmp_path / "ck")
    image_net.main(VALIDATE + ["--save-checkpoint-dir", ck, "--deterministic"])
    first = _metrics(capsys)
    assert os.listdir(ck) == ["step_0"]
    image_net.main(VALIDATE + ["--load-type", "quantized",
                               "--load-checkpoint-dir", ck])
    assert _metrics(capsys) == first
    with pytest.raises(SystemExit) as err:
        image_net.main(VALIDATE + ["--load-type", "quantized"])
    assert err.value.code == 2
    assert "--load-checkpoint-dir" in capsys.readouterr().err


def test_cli_train_quantized_saves_each_epoch(capsys, tmp_path):
    ck = tmp_path / "ck"
    args = ["train-quantized", "--device", "cpu", "--architecture",
            "mobilenet_v2_quantized", "--engine", "fused", "--per-channel",
            "--fp8-set-maxval", "--fp8-learn-maxval", "--sep-quant-optimizer",
            "--num-est-batches", "1", "--max-train-batches", "1",
            "--max-eval-batches", "1", "--batch-size", "2", "--max-epochs",
            "2", "--no-reestimate-bn-stats", "--save-checkpoint-dir", str(ck)]
    image_net.main(args)
    assert np.isfinite(_metrics(capsys)["loss"])
    assert sorted(p.name for p in ck.iterdir()) == ["step_1"]
    parsed = image_net.build_parser().parse_args(args)
    model = image_net.build_model(parsed)
    state = tqat.init_qat_state(model, model.config,
                                tqat.make_optimizer("SGD", 1e-3),
                                tqat.make_optimizer("Adam", 1e-5))
    state = restore_checkpoint(str(ck), state)
    assert state.step == 2 and state.quant_optimizer.state_dict()["state"]


# ---- against JAX -----------------------------------------------------------------

def test_jax_checkpoint_carried_into_the_port(tmp_path):
    """JAX's orbax round trip, then the port's own, then the logits."""
    jcfg = j_make_config(**CFG)
    jmodel = JTiny(config=jcfg)
    x = jnp.asarray(_x(4))
    jvars = j_calibrate(jmodel, jmodel.init(jax.random.PRNGKey(0), x), [x])
    j_save(str(tmp_path / "jck"), jvars, step=1)
    jvars = j_restore(str(tmp_path / "jck"), jvars)
    jlogits = np.asarray(japply(jmodel, jvars, x, mode="fixed"))

    model = tiny_model(make_layer_config(**CFG))
    convert.load_jax_variables(model, jax.tree.map(np.asarray, jvars))
    save_checkpoint(str(tmp_path / "ck"), model, step=1)
    fresh = restore_checkpoint(str(tmp_path / "ck"),
                               tiny_model(make_layer_config(**CFG)))
    out = _fwd(fresh, np.asarray(x), quant_w=True).numpy()
    st = fresh.fc.act_q.state()
    step = (np.maximum(np.abs(out), np.abs(jlogits))
            * 2.0 ** -float(st["mantissa_bits"])
            + float(st["maxval"]) * 2.0 ** -10)
    assert np.all(np.abs(out - jlogits) <= step), np.abs(out - jlogits).max()
    assert (out == jlogits).mean() >= 0.98
    np.testing.assert_array_equal(out.argmax(-1), jlogits.argmax(-1))
