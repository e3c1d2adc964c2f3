"""QAT of the port (BASELINE config 5) against the JAX package (CPU).

The tiny MobileNetV2 of tests/test_torch_mobilenet.py (settings ((1, 8,
1, 1), (6, 12, 2, 2), (6, 16, 1, 1)), 10 classes) at 32x32, batch 4, is
calibrated in JAX and its variables loaded into the port, so both start
from one state; both then train on the same batch with deterministic
estimators (STE) and no dropout.

* ``quant_trainable_mask`` picks the same quantizer entries as JAX's.
* ``make_schedule`` gives optax's float32 learning rate at every step
  (multistep exactly; cosine within one float32 ulp: XLA's ``cos`` and
  torch's may round the last bit apart).
* One and three QAT steps against JAX's jitted step: SGD with momentum
  0.9 and weight decay 1e-4, Adam as the separate quant optimizer (or SGD
  on the ranges too), modes ``learn`` and ``calibrate_train``, engines
  ``parity`` and ``bf16``.  The forwards agree bit for bit in fixed mode,
  but with batch statistics (``train_bn``) the two packages sum each BN's
  mean and variance in another order; a last-bit difference there moves
  an activation across a quantizer's bin now and then, and from there the
  trajectories separate like a chaotic system's (PR 11's finding for
  50-layer FP8 nets).  So, after one step: every loss within rtol 1e-4;
  all weight and BN updates together within 1e-2 relative L2 of JAX's and
  at cosine >= 0.999, and so is each tensor whose update is not rounding
  noise (>= 1e-3 of the largest tensor's update norm: a BN bias ahead of
  another BN has zero true gradient); BN statistics within rtol 1e-5;
  every learned range's update within 10% of JAX's plus two float32 ulps
  of the range (an update is a difference of two float32 values), but for
  at most 1% of them, which may differ by up to twice the largest update:
  Adam's first step moves a range by the learning rate whatever its
  gradient's size, so a gradient at rounding-noise level whose sign the
  summation order decides moves it by +-lr (3 of 1,801 ranges on bf16,
  none on parity, when this was written).  After
  three steps (trajectories apart): losses within rtol 2e-2, all updates
  together at cosine >= 0.97, BN statistics within 5e-2 of their scale,
  and the learned ranges' updates together at cosine >= 0.5.
* JAX's ``bf16`` engine cannot take a gradient here (the transpose of its
  bf16 convolution with a float32 result type raises a dtype error); its
  reference step runs with that convolution's bf16 operands converted to
  float32 first, which changes no value (their products are exact in
  float32).  A test pins the error.
* ``reestimate_bn_stats`` against JAX's (which recovers each batch's
  statistics by algebra over the momentum update): rtol 1e-4.
* ``train-quantized --device cpu`` on MobileNetV2 at batch 2: a finite
  validation line, training on the composed path (no kernel wrapper
  called) and the deployed model on the fused engine's plain versions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fp8_quantization_tpu.models.mobilenet_v2 as jmnv2
from fp8_quantization_tpu import training as jtr
from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models.convert import (
    convert_mobilenet_v2, merge_variables)
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import mobilenet_v2 as tmnv2
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.ops.kernels import qblock, qdwconv, qmatmul
from fp8_quantization_tpu_torch.training import qat as tqat
from fp8_quantization_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)

TINY = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 1, 1))
CLASSES, SEED, BATCH = 10, 4, 4
FP8_LEARN = dict(per_channel_weights=True, fp8_mantissa_bits=4,
                 fp8_set_maxval=True, fp8_learn_maxval=True,
                 weight_range_method="current_minmax",
                 act_range_method="allminmax")


def batch(seed=SEED):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (BATCH, 32, 32, 3)).astype(np.float32),
            rng.randint(0, CLASSES, BATCH).astype(np.int32))


def jax_pair(engine="parity", quant=FP8_LEARN, setup=None, calibrate=True):
    """(JAX model, its config, its calibrated variables as numpy, the port
    model of the same config with those variables loaded)."""
    jcfg = j_make_config(engine=engine, **quant)
    jmodel = jmnv2.mobilenetv2_quantized(jcfg, quant_setup=setup,
                                         num_classes=CLASSES, settings=TINY)
    x, _ = batch()
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmnv2, "INVERTED_RESIDUAL_SETTING", TINY)
        params, stats = convert_mobilenet_v2(
            convert.random_mobilenet_v2_state_dict(SEED, TINY, CLASSES))
    jvars = merge_variables(jvars, params, stats)
    if calibrate:
        jvars = j_calibrate(jmodel, jvars, [jnp.asarray(x)])
    jvars = jax.tree.map(np.asarray, jvars)
    model = tmnv2.mobilenetv2_quantized(
        make_layer_config(engine=engine, **quant), quant_setup=setup,
        num_classes=CLASSES, settings=TINY, device="cpu")
    convert.load_jax_variables(model, jvars)
    return jmodel, jcfg, jvars, model


def _flat_true(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_true(v, prefix + (k,))
        elif bool(v):
            yield prefix + (k,)


@pytest.mark.parametrize("quant,setup", [
    (FP8_LEARN, None),
    (dict(FP8_LEARN, fp8_learn_mantissa_bits=True), "FP_logits"),
    (dict(FP8_LEARN, fp8_learn_maxval=False), None),
    (dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
          per_channel_weights=True), "fc4_dw8")],
    ids=["fp8_maxval", "fp8_both_fp_logits", "fp8_none", "int8_fc4_dw8"])
def test_trainable_mask_matches_jax(quant, setup):
    jmodel, jcfg, jvars, model = jax_pair(quant=quant, setup=setup,
                                          calibrate=False)
    jmask = jtr.quant_trainable_mask(jvars["quant"], jcfg)
    ref = {"/".join(p[:-2] + p[-1:]) for p in _flat_true(jmask)}
    mask = tqat.quant_trainable_mask(model, model.config)
    got = {"/".join(path.split(".") + [n]) for path, names in mask.items()
           for n in names}
    assert got == ref and (got or not any(quant.get(k) for k in (
        "fp8_learn_maxval", "fp8_learn_mantissa_bits")))
    state = tqat.init_qat_state(model, model.config,
                                tqat.make_optimizer("SGD", 0.1))
    _, quant_params = tqat.partition_quant(model)
    assert len(quant_params) == len(got)
    assert (state.quant_optimizer is None) == (not got)


@pytest.mark.parametrize("spec,kw,steps", [
    ("multistep:2:4", dict(steps_per_epoch=3), 20),
    ("multistep:1", dict(steps_per_epoch=100), 250),
    ("cosine:0.01", dict(max_steps=20), 25),
    ("cosine", dict(max_steps=7), 10)])
def test_schedule_matches_optax(spec, kw, steps):
    ref = jtr.make_schedule(0.1, spec, **kw)
    got = tqat.make_schedule(0.1, spec, **kw)
    for i in range(steps):
        r = np.float32(ref(jnp.int32(i)))
        tol = np.spacing(r) if spec.startswith("cosine") else 0.0
        assert abs(got(i) - float(r)) <= tol, (i, got(i), r)
    assert tqat.make_schedule(0.1, None) == 0.1
    assert tqat.make_optimizer("SGD", 0.1, scheduler=spec, **kw).lr_at(3) == got(3)


def test_make_optimizer_kinds():
    p = [torch.nn.Parameter(torch.zeros(3))]
    sgd = tqat.make_optimizer("SGD", 0.1, momentum=0.9, weight_decay=1e-4).build(p)
    assert isinstance(sgd, torch.optim.SGD)
    assert sgd.defaults["momentum"] == 0.9 and sgd.defaults["weight_decay"] == 1e-4
    assert isinstance(tqat.make_optimizer("Adam", 1e-3).build(p), torch.optim.Adam)
    with pytest.raises(ValueError):
        tqat.make_optimizer("bogus")


# ---- train steps against JAX -------------------------------------------------

_CONV = jax.lax.conv_general_dilated


def _conv_f32(lhs, rhs, *a, **k):
    """JAX's bf16 convolution with its operands in float32 (exact)."""
    if (lhs.dtype == jnp.bfloat16 and rhs.dtype == jnp.bfloat16
            and k.get("preferred_element_type") == jnp.float32):
        lhs, rhs = lhs.astype(jnp.float32), rhs.astype(jnp.float32)
    return _CONV(lhs, rhs, *a, **k)


def test_jax_bf16_engine_cannot_take_a_gradient():
    """Why the bf16 reference step needs _conv_f32 (see the docstring)."""
    jmodel, jcfg, jvars, _ = jax_pair("bf16")
    x, y = batch()
    state, aux = jtr.init_qat_state(jvars, jcfg, jtr.make_optimizer("SGD", 0.01))
    step = jtr.make_train_step(jmodel, aux, donate=False)
    with pytest.raises(TypeError, match="same dtypes"):
        step(state, jnp.asarray(x), jnp.asarray(y))


def _updates(model, before):
    """{name: (update, kind)} of the float32 state the step moved."""
    out = {}
    for k, v in model.state_dict().items():
        if v.dtype != torch.float32 or "est_" in k or "prep" in k:
            continue
        kind = ("stats" if "running" in k else
                "quant" if k.rsplit(".", 1)[-1] in ("maxval", "mantissa_bits",
                                                    "delta", "zero_float")
                else "param")
        out[k] = (v.detach().numpy() - before[k].numpy(), kind,
                  v.detach().numpy())
    return out


def _cos(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _compare(got, ref, tight):
    """The bounds of the module docstring, one step (tight) or three."""
    params = [k for k in ref if ref[k][1] == "param"]
    da = np.concatenate([got[k][0].ravel() for k in params])
    db = np.concatenate([ref[k][0].ravel() for k in params])
    top = max(np.linalg.norm(ref[k][0]) for k in params)
    if tight:
        assert np.linalg.norm(da - db) <= 1e-2 * np.linalg.norm(db)
        assert _cos(da, db) >= 0.999
        for k in params:
            if np.linalg.norm(ref[k][0]) >= 1e-3 * top:
                assert _cos(got[k][0].ravel(), ref[k][0].ravel()) >= 0.999, k
    else:
        assert _cos(da, db) >= 0.97
    for k in (k for k in ref if ref[k][1] == "stats"):
        scale = np.abs(ref[k][2]).max()
        diff = np.abs(got[k][2] - ref[k][2]).max()
        assert diff <= (1e-5 if tight else 5e-2) * scale, (k, diff, scale)
    quant = [k for k in ref if ref[k][1] == "quant" and k in got
             and np.abs(ref[k][0]).max() + np.abs(got[k][0]).max() > 0]
    if not quant:           # calibrate_train on one batch: nothing moved
        return
    qa = np.concatenate([got[k][0].ravel() for k in quant])
    qb = np.concatenate([ref[k][0].ravel() for k in quant])
    ulp = np.concatenate([np.spacing(np.abs(ref[k][2])).ravel() for k in quant])
    if tight:
        bad = np.abs(qa - qb) > 0.1 * np.abs(qb) + 2 * ulp
        assert bad.mean() <= 0.01, (bad.sum(), bad.size)
        assert np.all(np.abs(qa - qb)[bad] <= 2 * np.abs(qb).max())
    else:
        assert _cos(qa, qb) >= 0.5


CASES = {"parity_learn_adam": ("parity", "learn", True),
         "parity_calibrate_train_sgd": ("parity", "calibrate_train", False),
         "parity_learn_sgd": ("parity", "learn", False),
         "bf16_learn_adam": ("bf16", "learn", True)}


@pytest.mark.parametrize("case", list(CASES))
def test_qat_steps_match_jax(case, monkeypatch):
    engine, mode, sep = CASES[case]
    if engine == "bf16":
        monkeypatch.setattr(jax.lax, "conv_general_dilated", _conv_f32)
    jmodel, jcfg, jvars, model = jax_pair(engine)
    x, y = batch()
    jstate, aux = jtr.init_qat_state(
        jvars, jcfg, jtr.make_optimizer("SGD", 0.01, momentum=0.9,
                                        weight_decay=1e-4),
        jtr.make_optimizer("Adam", 1e-3) if sep else None, model=jmodel)
    jstep = jtr.make_train_step(jmodel, aux, mode=mode, donate=False)
    state = tqat.init_qat_state(
        model, model.config, tqat.make_optimizer("SGD", 0.01, momentum=0.9,
                                                 weight_decay=1e-4),
        tqat.make_optimizer("Adam", 1e-3) if sep else None)
    step = tqat.make_train_step(state, mode=mode)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        state, m = step(state, x, y)
        np.testing.assert_allclose(m["loss"], float(jm["loss"]),
                                   rtol=1e-4 if i == 0 else 2e-2)
        if i in (0, 2):
            ref_model = tmnv2.mobilenetv2_quantized(
                make_layer_config(engine=engine, **FP8_LEARN),
                num_classes=CLASSES, settings=TINY, device="cpu")
            convert.load_jax_variables(
                ref_model, jax.tree.map(np.asarray, jstate.variables()))
            _compare(_updates(model, before), _updates(ref_model, before),
                     tight=i == 0)
    assert state.step == 3 and int(jstate.step) == 3


def test_train_epoch_and_metrics_logger(tmp_path):
    _, _, _, model = jax_pair()
    state = tqat.init_qat_state(model, model.config,
                                tqat.make_optimizer("Adam", 1e-3))
    state, metrics = tqat.train_epoch(state, [batch(), batch(5)])
    assert set(metrics) == {"loss", "accuracy"} and state.step == 2
    with pytest.raises(ValueError):
        tqat.train_epoch(state, [])
    with MetricsLogger(str(tmp_path), run_name="tiny") as mlog:
        mlog.log(0, metrics, prefix="train/")
    line = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    assert line["run"] == "tiny" and line["train/loss"] == metrics["loss"]


def test_reestimate_bn_stats_matches_jax():
    jmodel, _, jvars, model = jax_pair()
    x1, x2 = batch()[0], batch(7)[0]
    ref = jtr.reestimate_bn_stats(jmodel, jvars, [x1, x2], num_batches=2)
    tqat.reestimate_bn_stats(model, [x1, x2], num_batches=2)
    for name in ("stem", "block1_0.expand", "block2_0.project"):
        layer = model.get_submodule(name)
        stats = ref["batch_stats"]
        for part in name.split("."):
            stats = stats[part]
        np.testing.assert_allclose(layer.running_mean.numpy(), stats["mean"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(layer.running_var.numpy(), stats["var"],
                                   rtol=1e-4, atol=1e-6)
        assert layer.bn_momentum == 0.1
    with pytest.raises(ValueError):
        tqat.reestimate_bn_stats(model, [])


def test_dropout_draws_from_its_generator():
    """MobileNetV2's classifier dropout: only in training forwards, the
    mask from ``dropout_generator`` (the same seed, the same mask), scaled
    by 1/keep; without a generator a training forward raises."""
    model = tmnv2.mobilenetv2_quantized(
        make_layer_config(**FP8_LEARN), num_classes=CLASSES, settings=TINY,
        device="cpu", dropout_rate=0.5)
    x = torch.from_numpy(batch()[0])
    with torch.no_grad():
        plain = model(x, mode="fp32")
        assert torch.equal(plain, model(x, mode="fp32"))
        with pytest.raises(ValueError):
            model(x, mode="fp32", train_bn=True)
        outs = []
        for _ in range(2):
            model.dropout_generator = torch.Generator().manual_seed(3)
            outs.append(model(x, mode="fp32", train_bn=True))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], plain)


def _spy(monkeypatch, calls):
    for mod, name in ((qblock, "fused_inverted_residual"),
                      (qdwconv, "fused_quant_dwconv3x3"),
                      (qmatmul, "fused_quant_matmul")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)


TRAIN_ARGS = ["train-quantized", "--device", "cpu",
              "--architecture", "mobilenet_v2_quantized", "--engine", "fused",
              "--per-channel", "--fp8-set-maxval", "--fp8-learn-maxval",
              "--num-est-batches", "1", "--max-train-batches", "2",
              "--max-eval-batches", "1", "--batch-size", "2",
              "--sep-quant-optimizer", "--oscillations-dampen-weight", "0.01",
              "--oscillations-freeze-threshold", "0.01"]


def test_cli_train_quantized_cpu(capsys, monkeypatch):
    """Training runs composed (no kernel wrapper), the deployed copy runs
    the fused route's plain versions: 17 qblock and 2 qmatmul a forward
    (the prepare pass and one evaluation batch); the prepare pass under the
    kernel gate's default mode also runs each block's layers (nn/layers.
    gated_route): 16 expand and 17 project qmatmul and 17 qdwconv3x3."""
    calls = {}
    _spy(monkeypatch, calls)
    image_net.main(TRAIN_ARGS)
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2 and np.isfinite(metrics["loss"])
    assert calls == {"fused_inverted_residual": 34,
                     "fused_quant_matmul": 4 + 16 + 17,
                     "fused_quant_dwconv3x3": 17}


def test_cli_train_quantized_options_and_errors(capsys, monkeypatch,
                                                tmp_path):
    """The options run; --save-checkpoint-dir writes the epoch's step
    (tests/test_torch_checkpoint.py holds what it writes)."""
    ck = tmp_path / "ck"
    image_net.main(TRAIN_ARGS[:-4] + ["--estimate-ranges-train",
                                      "--no-reestimate-bn-stats",
                                      "--learning-rate-schedule", "cosine:0.0001",
                                      "--save-checkpoint-dir", str(ck)])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["loss"])
    assert sorted(p.name for p in ck.iterdir()) == ["step_0"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        image_net.main([a for a in TRAIN_ARGS if a not in ("--device", "cpu")])


def test_cli_validate_quantized_reestimates_bn(capsys, monkeypatch):
    seen = []
    real = tqat.reestimate_bn_stats
    monkeypatch.setattr(tqat, "reestimate_bn_stats",
                        lambda *a, **k: seen.append(k) or real(*a, **k))
    image_net.main(["validate-quantized", "--device", "cpu",
                    "--architecture", "mobilenet_v2_quantized",
                    "--engine", "bf16", "--per-channel", "--fp8-set-maxval",
                    "--num-est-batches", "1", "--max-eval-batches", "1",
                    "--batch-size", "2", "--reestimate-bn-stats"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["loss"]) and seen == [{"num_batches": 1}]


def test_learned_mantissa_bits_deploy_at_the_composed_paths_format():
    """After --fp8-learn-mantissa-bits a quantizer's mantissa_bits is a
    non-integer float; the kernels' constants (ops/fp8.fp8_consts) round
    it half to even and clip it as the composed quantizer does, so the
    baked, prepared 'fused' model (its kernels' plain versions here) equals
    'bf16' bit for bit, at M = 3 (from 3.4), 4 (from 4.5, a tie) and 5."""
    from fp8_quantization_tpu_torch.nn.bake import bake_weights, prepare_inference
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
    quant = dict(FP8_LEARN, fp8_learn_mantissa_bits=True)
    _, _, jvars, bf16 = jax_pair("bf16", quant=quant)
    fused = tmnv2.mobilenetv2_quantized(make_layer_config(engine="fused", **quant),
                                        num_classes=CLASSES, settings=TINY, device="cpu")
    convert.load_jax_variables(fused, jvars)
    x = torch.from_numpy(batch()[0])
    for model in (fused, bf16):
        for i, qz in enumerate(m for m in model.modules() if isinstance(m, Quantizer)):
            qz.make_range_trainable()
            with torch.no_grad():
                qz.mantissa_bits.fill_((3.4, 4.5, 4.6)[i % 3])
        bake_weights(model)
        prepare_inference(model, torch.zeros(1, 32, 32, 3), quant_w=False)
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, calls)
        with torch.no_grad():
            a = fused(x, mode="fixed", quant_w=False)
    b = bf16(x, mode="fixed", quant_w=False)
    # block0_0 on qblock; the blocks with 12 channels layer by layer
    # (qblock.channels_ok): 3 depthwise and 8 1x1 / fc kernel calls
    assert calls == {"fused_inverted_residual": 1, "fused_quant_dwconv3x3": 3,
                     "fused_quant_matmul": 8}
    assert torch.equal(a, b)
