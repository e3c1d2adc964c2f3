"""The port's slice end to end against the JAX package (CPU), plus its
layers and its packaging rules.

The slice: a QuantizedResNet with stage_sizes=(1, 1, 1, 1) on 32x32 inputs,
batch 2, from one random_resnet_state_dict(seed) in the torchvision layout,
with the main path's config (per-channel E3M4 weights, current_minmax
weights, allminmax activations, --fp8-set-maxval).  Both packages calibrate
on one batch and bake; the port evaluates with engine='fused' (its kernels'
plain versions on CPU) and JAX with engine='pallas' (interpret mode).  The
JAX bake runs inside nn/bake._pallas_gates_off(): its pallas-engine bake
leaves the fc and the 1x1 downsample convs unbaked (ROADMAP.md section C).

Tolerances: logits lie on the fc's FP8 output grid, so they may differ by
one grid step where a value sits at a bin boundary (summation order, and
the Pallas tiles' log2 bin read); at least 98% must be exact and top-1
identical.  Calibrated ranges are min/max of activations summed in another
order: relative 1e-4.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models.convert import convert_resnet, merge_variables
from fp8_quantization_tpu.models.resnet import QuantizedResNet as JResNet
from fp8_quantization_tpu.nn import layers as jlayers
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet18_quantized, resnet_configs)
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import bake_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config

torch.set_num_threads(1)

STAGES, CLASSES, SEED = (1, 1, 1, 1), 10, 3
MAIN = dict(per_channel_weights=True, fp8_mantissa_bits=4, fp8_set_maxval=True,
            weight_range_method="current_minmax", act_range_method="allminmax")


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _one_grid_step(out, ref, maxval, mbits=4):
    """|out - ref| within one FP8 grid step of the larger magnitude (steps
    are at most 2^-M of a value, plus the subnormal step near 0)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    step = np.maximum(np.abs(out), np.abs(ref)) * 2.0 ** -mbits + maxval * 2.0 ** -10
    assert np.all(np.abs(out - ref) <= step), np.abs(out - ref).max()
    exact = (out == ref).mean()
    assert exact >= 0.98, exact


@pytest.fixture(scope="module")
def slice_run():
    sd = convert.random_resnet_state_dict(SEED, STAGES, num_classes=CLASSES)
    x = np.random.RandomState(SEED).standard_normal((2, 32, 32, 3)).astype(np.float32)

    # JAX reference
    jcfg = j_make_config(engine="pallas", **MAIN)
    jmodel = JResNet(stage_sizes=STAGES, bottleneck=False, num_classes=CLASSES,
                     config=jcfg)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    params, stats = convert_resnet(sd, STAGES, bottleneck=False)
    jvars = merge_variables(jvars, params, stats)
    jvars = j_calibrate(jmodel, jvars, [jnp.asarray(x)])
    with _pallas_gates_off():
        jbaked = j_bake(jmodel, jvars, jnp.asarray(x))
    jlogits = jax.jit(lambda v, xx: jmodel.apply(
        v, xx, mode="fixed", quant_w=False))(jbaked, jnp.asarray(x))

    # port
    model = QuantizedResNet(STAGES, False, CLASSES,
                            **resnet_configs(make_layer_config(engine="fused",
                                                               **MAIN), None))
    convert.load_torchvision_resnet(model, sd)
    calibrate(model, [x], device="cpu")
    calibrated = {k: v.clone() for k, v in model.state_dict().items()}
    bake_weights(model)
    with torch.no_grad():
        logits = model(torch.from_numpy(x), mode="fixed", quant_w=False)
    return dict(sd=sd, x=x, jmodel=jmodel, jvars=_np_tree(jvars),
                jbaked=_np_tree(jbaked), jlogits=np.asarray(jlogits),
                model=model, calibrated=calibrated, logits=logits.numpy())


def _fc_act_maxval(jvars):
    return float(jvars["quant"]["fc"]["act_q"]["q"]["maxval"])


def test_slice_calibrated_state_matches_jax(slice_run):
    """Every quantizer's range after one calibration batch."""
    jq, cal = slice_run["jvars"]["quant"], slice_run["calibrated"]
    n = 0
    for key, value in cal.items():
        if not key.endswith(".maxval"):
            continue
        node = jq
        for part in key.split(".")[:-1]:
            node = node[part]
        np.testing.assert_allclose(value.numpy(), node["q"]["maxval"],
                                   rtol=1e-4)
        n += 1
    assert n == len([k for k in cal if k.endswith(".maxval")]) and n > 20


def test_slice_fused_logits_match_jax_pallas(slice_run):
    logits, jlogits = slice_run["logits"], slice_run["jlogits"]
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    _one_grid_step(logits, jlogits, _fc_act_maxval(slice_run["jvars"]))
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def test_jax_calibrated_state_carries_over(slice_run):
    """load_jax_variables: the JAX-calibrated, JAX-baked state in a fresh port
    model gives JAX's logits."""
    model = QuantizedResNet(STAGES, False, CLASSES,
                            **resnet_configs(make_layer_config(engine="fused",
                                                               **MAIN), None))
    convert.load_jax_variables(model, slice_run["jbaked"])
    with torch.no_grad():
        logits = model(torch.from_numpy(slice_run["x"]), mode="fixed",
                       quant_w=False).numpy()
    _one_grid_step(logits, slice_run["jlogits"],
                   _fc_act_maxval(slice_run["jvars"]))
    np.testing.assert_array_equal(logits.argmax(-1),
                                  slice_run["jlogits"].argmax(-1))


def test_bake_covers_fc_and_downsample_convs(slice_run):
    """The port bakes every quantized layer, the fc and the 1x1 downsample
    convs included; baking leaves the bf16 engine's logits bit-identical."""
    model = slice_run["model"]
    baked = {n for n, m in model.named_modules()
             if isinstance(m, layers.QuantizedLayerBase)
             and m.w_factor is not None}
    assert {"fc", "layer2_0_downsample", "layer3_0_downsample",
            "layer4_0_downsample", "stem"} <= baked
    assert len(baked) == 1 + 2 * 4 + 3 + 1
    # the JAX bake, run inside _pallas_gates_off(), reaches the same layers
    assert {"fc", "layer2_0_downsample"} <= set(slice_run["jbaked"]["baked"])

    x = torch.from_numpy(slice_run["x"])
    bf16 = QuantizedResNet(STAGES, False, CLASSES,
                           **resnet_configs(make_layer_config(engine="bf16",
                                                              **MAIN), None))
    convert.load_torchvision_resnet(bf16, slice_run["sd"])
    calibrate(bf16, [slice_run["x"]], device="cpu")
    with torch.no_grad():
        before = bf16(x, mode="fixed")
        bake_weights(bf16)
        after = bf16(x, mode="fixed", quant_w=False)
    assert torch.equal(before, after)


LAYER_CASES = {
    # name: (kind, kwargs, input shape, bake)
    "conv3x3_s1": ("conv", dict(k=3, s=1, p=1, act="relu"), (2, 8, 8, 16), False),
    "conv3x3_s2_baked": ("conv", dict(k=3, s=2, p=1, act="relu"), (2, 8, 8, 16), True),
    "conv1x1_s2": ("conv", dict(k=1, s=2, p=0, act=None), (2, 8, 8, 16), False),
    "linear": ("linear", {}, (4, 24), False),
}


@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layers_match_jax_after_carry_over(case, engine):
    kind, kw, shape, bake = LAYER_CASES[case]
    x = np.random.RandomState(7).standard_normal(shape).astype(np.float32)
    jeng = "pallas" if engine == "fused" else engine
    jcfg, tcfg = j_make_config(engine=jeng, **MAIN), make_layer_config(engine=engine, **MAIN)
    if kind == "conv":
        jmod = jlayers.QuantConv(features=16, kernel_size=(kw["k"],) * 2,
                                 strides=(kw["s"],) * 2,
                                 padding=((kw["p"], kw["p"]),) * 2, bn=True,
                                 activation=kw["act"], config=jcfg)
        tmod = layers.QuantConv(shape[-1], 16, kw["k"], kw["s"], kw["p"], bn=True,
                                activation=kw["act"], config=tcfg)
    else:
        jmod = jlayers.QuantLinear(features=12, config=jcfg)
        tmod = layers.QuantLinear(shape[-1], 12, config=tcfg)
    jv = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    rng = np.random.RandomState(8)
    if "batch_stats" in jv:
        jv = {**jv, "batch_stats": jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
            jv["batch_stats"])}
    _, upd = jmod.apply(jv, jnp.asarray(x), mode="calibrate", mutable=["quant"])
    jv = {**jv, **upd}
    quant_w = True
    if bake:
        with _pallas_gates_off():
            jv = j_bake(jmod, jv, jnp.asarray(x))
        quant_w = False
    ref = jax.jit(lambda v, xx: jmod.apply(v, xx, mode="fixed",
                                           quant_w=quant_w))(jv, jnp.asarray(x))
    convert.load_jax_variables(tmod, _np_tree(jv))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), mode="fixed", quant_w=quant_w)
    maxval = float(jv["quant"]["act_q"]["q"]["maxval"])
    _one_grid_step(out.numpy(), np.asarray(ref), maxval)


def test_port_sources_import_no_jax():
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "fp8_quantization_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = re.compile(r"^\s*(import jax|from jax)|\bfp8_quantization_tpu\."
                     r"|from fp8_quantization_tpu import", re.M)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert len(files) > 20 and not offenders, offenders


def test_entry_points_need_cuda_or_an_explicit_cpu():
    cfg = make_layer_config(engine="fused", **MAIN)
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet18_quantized(cfg)
    from fp8_quantization_tpu_torch.cli.image_net import build_parser, validate_quantized
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate_quantized(build_parser().parse_args(["validate-quantized"]))
    assert resnet18_quantized(cfg, device="cpu").fc.weight.device.type == "cpu"
