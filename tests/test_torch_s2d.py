"""The space-to-depth stem (ops/s2d.py, ``QuantConv(s2d=...)``,
``QuantizedResNet(stem_s2d=...)``, ``--stem-s2d``) against the JAX package
(CPU).

* ``space_to_depth`` and ``s2d_stem_kernel`` are pure re-indexing: bit-equal
  to JAX's.
* The s2d stem layer from one JAX-calibrated state against JAX's s2d layer
  on the same input (``True``: the image; ``'input'``: its s2d form) on
  every engine: the 4x4 conv sums in another order, so within one grid
  step of the output quantizer, >= 98% exact (tests/test_torch_resnet.py's
  layer tolerance).
* The tiny ResNet-18 with ``stem_s2d=True`` and ``'input'`` from JAX's
  calibrated state against JAX's s2d model and against the port's default
  stem, at tests/test_s2d.py's tolerances (rtol = atol = 1e-3: the same
  products summed in another order, where an output bin flips a logit
  moves by a step of the fc's grid); ``'input'`` also prepared, bit-equal
  to unprepared.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.models import resnet as jresnet
from fp8_quantization_tpu.nn import factored as jfactored
from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.ops import s2d as js2d
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet_configs)
from fp8_quantization_tpu_torch.nn import bake, layers
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.factored import materialize
from fp8_quantization_tpu_torch.ops import int8 as int8_ops
from fp8_quantization_tpu_torch.ops import s2d
from fp8_quantization_tpu_torch.ops.kernels import qstem
from tests._resnet_pair import (
    CLASSES, INT8, JAX_ENGINE, MAIN, STAGES, jax_calibrated, jax_logits,
    np_tree, t)

torch.set_num_threads(1)

SEED = 4
S2D_TOL = dict(rtol=1e-3, atol=1e-3)


# ---- the transform -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_space_to_depth_and_kernel_bit_equal_to_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 16)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = s2d.space_to_depth(torch.from_numpy(x).to(tdt)).float().numpy()
    ref = np.asarray(js2d.space_to_depth(jnp.asarray(x).astype(dtype)), np.float32)
    np.testing.assert_array_equal(got, ref)
    w2, strides, padding = s2d.s2d_stem_kernel(torch.from_numpy(w).to(tdt))
    jw2, jstrides, jpadding = js2d.s2d_stem_kernel(jnp.asarray(w).astype(dtype))
    np.testing.assert_array_equal(w2.float().numpy(), np.asarray(jw2, np.float32))
    assert (strides, padding) == (tuple(jstrides), tuple(map(tuple, jpadding)))
    with pytest.raises(ValueError, match="not divisible"):
        s2d.space_to_depth(torch.zeros(1, 5, 4, 3))
    with pytest.raises(ValueError, match="7x7"):
        s2d.s2d_stem_kernel(torch.zeros(3, 3, 3, 8))


# ---- the stem layer --------------------------------------------------------------

def _stem_pair(engine, config=MAIN, mode=True):
    """(JAX s2d stem layer, its JAX-calibrated variables, the port's s2d
    stem on them, the image)."""
    x = np.random.RandomState(SEED).standard_normal((2, 16, 16, 3)).astype(np.float32)
    jcfg = j_make_config(engine=JAX_ENGINE[engine], **config)
    jmod = jlayers.QuantConv(features=16, kernel_size=(7, 7), strides=(2, 2),
                             padding=((3, 3), (3, 3)), bn=True, activation="relu",
                             config=jcfg, s2d=mode)
    plain = jmod.clone(s2d=False)
    jv = plain.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(8)
    jv = {**jv, "batch_stats": jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        jv["batch_stats"])}
    _, upd = plain.apply(jv, jnp.asarray(x), mode="calibrate", mutable=["quant"])
    jv = np_tree({**jv, **upd})
    tmod = layers.QuantConv(3, 16, 7, 2, 3, bn=True, activation="relu",
                            config=make_layer_config(engine=engine, **config), s2d=mode)
    convert.load_jax_variables(tmod, jv)
    return jmod, jv, tmod, x


@pytest.mark.parametrize("mode", [True, "input"], ids=["true", "input"])
@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
def test_s2d_stem_layer_matches_jax(engine, mode):
    """Unbaked and baked, the port's s2d stem against JAX's on the same
    input: within one step of the output grid, >= 98% exact."""
    jmod, jv, tmod, x = _stem_pair(engine, mode=mode)
    xin = x if mode is True else np.asarray(js2d.space_to_depth(jnp.asarray(x)))
    out_kw = dict(out="factored") if engine != "parity" else {}
    for quant_w in (True, False):
        if not quant_w:
            with _pallas_gates_off():
                jv = np_tree(j_bake(jmod.clone(s2d=False), jv, jnp.asarray(x)))
            bake.bake_weights(tmod)
        ref = np.asarray(jfactored.materialize(jmod.apply(
            jv, jnp.asarray(xin), mode="fixed", quant_w=quant_w, **out_kw)), np.float32)
        with torch.no_grad():
            out = materialize(tmod(t(xin), mode="fixed", quant_w=quant_w,
                                   **out_kw)).numpy()
        assert out.shape == ref.shape == (2, 8, 8, 16)
        maxval = float(jv["quant"]["act_q"]["q"]["maxval"])
        step = np.maximum(np.abs(out), np.abs(ref)) * 2.0 ** -4 + maxval * 2.0 ** -10
        assert np.all(np.abs(out - ref) <= step), np.abs(out - ref).max()
        assert (out == ref).mean() >= 0.98, (out == ref).mean()


def test_s2d_stem_stays_off_the_int8_route(monkeypatch):
    """Under the int8 datapath an s2d stem takes the general conv path, as
    in JAX (nn/layers.py:845-847), and equals JAX's s2d stem there; the
    same stem without s2d runs ops/int8.int8_conv."""
    calls = []
    fn = int8_ops.int8_conv
    monkeypatch.setattr(int8_ops, "int8_conv",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    jmod, jv, tmod, x = _stem_pair("bf16", INT8)
    with torch.no_grad():
        out = tmod(t(x), mode="fixed").numpy()
    assert not calls
    ref = np.asarray(jmod.apply(jv, jnp.asarray(x), mode="fixed"))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    tmod.s2d = False
    with torch.no_grad():
        tmod(t(x), mode="fixed")
    assert calls == [1]


# ---- the model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_state():
    """The tiny ResNet-18's image and its JAX-calibrated FP8 state."""
    sd = convert.random_resnet_state_dict(SEED, STAGES, num_classes=CLASSES)
    x = np.random.RandomState(SEED).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jmodel = jresnet.QuantizedResNet(
        stage_sizes=STAGES, bottleneck=False, num_classes=CLASSES,
        **jresnet.resnet_configs(j_make_config(engine="parity", **MAIN), None))
    return x, np_tree(jax_calibrated(jmodel, sd, x, bottleneck=False))


def _models(engine, mode):
    cfgs = resnet_configs(make_layer_config(engine=engine, **MAIN), None)
    jcfgs = jresnet.resnet_configs(j_make_config(engine=JAX_ENGINE[engine], **MAIN), None)
    return (QuantizedResNet(STAGES, False, CLASSES, stem_s2d=mode, **cfgs),
            QuantizedResNet(STAGES, False, CLASSES, **cfgs),
            jresnet.QuantizedResNet(stage_sizes=STAGES, bottleneck=False,
                                    num_classes=CLASSES, stem_s2d=mode, **jcfgs))


@pytest.mark.parametrize("mode", [True, "input"], ids=["true", "input"])
@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
def test_stem_s2d_model_matches_jax_and_the_default_stem(resnet_state, engine, mode,
                                                         monkeypatch):
    """From JAX's calibrated state, baked by each package: the port's s2d
    model against JAX's s2d model and against the port's default stem
    (S2D_TOL); no qstem call under 'fused'; the 'input' model prepared on
    an s2d example (QuantizedResNet.input_shape), bit-equal to unprepared."""
    x, jvars = resnet_state
    model, default, jmodel = _models(engine, mode)
    for m in (model, default):
        convert.load_jax_variables(m, jvars)
        bake.bake_weights(m)
    with _pallas_gates_off():
        jbaked = np_tree(j_bake(jmodel.clone(stem_s2d=False), jvars, jnp.asarray(x)))
    xin = x if mode is True else np.asarray(js2d.space_to_depth(jnp.asarray(x)))
    stems = []
    monkeypatch.setattr(qstem, "qstem_plain", lambda *a, **k: stems.append(1))
    with torch.no_grad():
        out = model(t(xin), mode="fixed", quant_w=False)
    assert not stems
    monkeypatch.undo()
    with torch.no_grad():
        ref_default = default(t(x), mode="fixed", quant_w=False).numpy()
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), jax_logits(jmodel, jbaked, xin, False),
                               **S2D_TOL)
    np.testing.assert_allclose(out.numpy(), ref_default, **S2D_TOL)
    if mode == "input" and engine != "parity":
        assert model.input_shape((1, 32, 32, 3)) == (1, 16, 16, 12)
        bake.prepare_inference(model, torch.zeros(model.input_shape((1, 32, 32, 3))),
                               quant_w=False)
        with torch.no_grad():
            assert torch.equal(model(t(xin), mode="fixed", quant_w=False), out)


def test_stem_s2d_rejects_other_modes():
    for bad in ("yes", 2):
        with pytest.raises(ValueError, match="s2d must be one of"):
            QuantizedResNet(STAGES, False, CLASSES, stem_s2d=bad)


def test_cli_stem_s2d_on_a_tiny_run(monkeypatch):
    """validate-quantized --stem-s2d on the CPU: the stem takes the s2d
    path (space_to_depth once per forward of the calibration, the prepare
    pass and the evaluation), and the metrics equal the default stem's."""
    calls = []
    fn = s2d.space_to_depth
    monkeypatch.setattr(s2d, "space_to_depth",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    argv = ["validate-quantized", "--device", "cpu", "--engine", "fused",
            "--per-channel", "--fp8-set-maxval", "--num-est-batches", "1",
            "--max-eval-batches", "1", "--batch-size", "2", "--seed", "3"]
    metrics = {}
    for extra in ([], ["--stem-s2d"]):
        args = image_net.build_parser().parse_args(argv + extra)
        assert args.stem_s2d == bool(extra)
        metrics[bool(extra)] = image_net.validate_quantized(args)
    assert len(calls) == 3
    assert metrics[True]["num_examples"] == 2
    np.testing.assert_allclose(metrics[True]["loss"], metrics[False]["loss"], rtol=1e-3)
    json.dumps(metrics[True])
