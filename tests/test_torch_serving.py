"""The serving export of the port (serving/export.py) and its torch ops
(ops/kernels/library.py), against the live port and the JAX package's
artifacts (CPU).

* JAX's four cases of tests/test_serving.py at their shapes (TinyModel,
  batch 4, 16x16): a fixed batch, a symbolic batch served at 1, 4 and 7,
  the full deployment config ('bf16', the cast quant, bf16 conv stores,
  f8 activation storage at E3M4) and the baked int8 model.  JAX
  calibrates and its variables go into the port's TinyModel
  (models/convert.load_jax_variables); each package exports and loads
  its artifact.  The port's artifact equals its live deployed model bit
  for bit; against JAX's artifact it is held as the port's tests hold that
  engine: FP8 logits within one step of the fc's output grid, >= 98%
  exact, top-1 identical ('parity', tests/test_torch_resnet.py); on
  'bf16' with the flags within one step on >= 95%, top-1 identical, of
  JAX's forward run op by op (tests/test_torch_deploy_flags.py; JAX's
  jitted artifact is one step plus its own gap to that forward away, see
  the test); INT8 within rtol = atol = 2e-5 (tests/test_torch_int8.py).
* 'fused' exports of small models that together use all eight
  ``fp8tpu::*`` ops (the CPU implementations are the kernels' plain
  versions): each op found by name in the exported graph, the artifact
  bit-equal to the live model at batches 1 and 3 of one symbolic-batch
  artifact, and one artifact forward calling each op as often as the
  live forward.
* ``torch.library.opcheck`` on each op, on the arguments a live forward
  gave it.
* One load in a subprocess that imports neither ``models`` nor
  ``nn.layers``.
* Each artifact carries its convolutions' cuDNN TF32 setting (off on
  'parity' and the int8 datapath, on elsewhere), which the live code sets
  around each call and a program cannot record, and reads its lifted
  constants in place (no copy a forward).
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.nn.bake import (
    bake_int8_weights as j_bake_int8, prepare_for_deployment as j_prepare)
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.serving import (
    export_quantized_model as j_export, load_exported as j_load)
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.nn import bake
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.layers import gated_route, route_log
from fp8_quantization_tpu_torch.ops.kernels import WRAPPERS
from fp8_quantization_tpu_torch.ops.kernels.library import OPS
from fp8_quantization_tpu_torch.serving import (
    export_quantized_model, load_exported)
from fp8_quantization_tpu_torch.serving.export import SETTINGS
from tests._tiny import TinyModel as JTiny
from tests._tiny_torch import tiny_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(qmethod="fp_quantizer", per_channel_weights=True,
           fp8_set_maxval=True, weight_range_method="current_minmax",
           act_range_method="allminmax")
INT8 = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
            per_channel_weights=True, quantize_input=True, int8_mxu=True,
            weight_range_method="current_minmax", act_range_method="allminmax")


def _x(b, seed=0, size=16):
    return np.random.RandomState(seed).normal(
        0, 1, (b, size, size, 3)).astype(np.float32)


def _pair(jcfg, port_cfg):
    """(JAX TinyModel, its calibrated variables, the port TinyModel with
    them loaded, x): JAX's _setup of tests/test_serving.py."""
    jmodel = JTiny(config=jcfg)
    x = jnp.asarray(_x(4))
    jvars = j_calibrate(jmodel, jmodel.init(jax.random.PRNGKey(0), x), [x])
    model = tiny_model(make_layer_config(**port_cfg))
    convert.load_jax_variables(model, jax.tree.map(np.asarray, jvars))
    return jmodel, jvars, model, np.asarray(x)


def _live(model, x, quant_w):
    with torch.no_grad():
        return model(torch.from_numpy(x), mode="fixed", quant_w=quant_w)


def _fp8_step(out, ref, model):
    """One step of the fc's output grid at the larger magnitude."""
    st = model.fc.act_q.state()
    return (np.maximum(np.abs(out), np.abs(ref))
            * 2.0 ** -float(st["mantissa_bits"])
            + float(st["maxval"]) * 2.0 ** -10)


def _conv_tf32(path):
    """The artifact's cuDNN setting for its composed convolutions."""
    extra = {SETTINGS: ""}
    torch.export.load(path, extra_files=extra)
    return json.loads(extra[SETTINGS])["cudnn_allow_tf32"]


def _one_grid_step(out, ref, model):
    """tests/test_torch_resnet.py's tolerance for FP8 logits."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.all(np.abs(out - ref) <= _fp8_step(out, ref, model)), (
        np.abs(out - ref).max())
    assert (out == ref).mean() >= 0.98, (out == ref).mean()
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


# ---- JAX's four cases ------------------------------------------------------------

@pytest.fixture(scope="module")
def fp8_pair():
    return _pair(j_make_config(**CFG), CFG)


def test_export_fixed_batch_round_trip(fp8_pair, tmp_path):
    jmodel, jvars, model, x = fp8_pair
    model = copy.deepcopy(model)
    path, spec = export_quantized_model(model, str(tmp_path / "model.pt2"),
                                        batch_size=4, image_size=16,
                                        device="cpu")
    assert spec == (4, 16, 16, 3)
    assert _conv_tf32(path) is False        # 'parity': full float32 convs
    out = load_exported(path, device="cpu")(torch.from_numpy(x))
    assert torch.equal(out, _live(model, x, quant_w=False))
    jpath, _ = j_export(jmodel, jvars, str(tmp_path / "model.bin"),
                        batch_size=4, image_size=16)
    _one_grid_step(out.numpy(), j_load(jpath)(jnp.asarray(x)), model)


def test_export_polymorphic_batch(fp8_pair, tmp_path):
    jmodel, jvars, model, _ = fp8_pair
    model = copy.deepcopy(model)
    path, spec = export_quantized_model(model, str(tmp_path / "model.pt2"),
                                        batch_size=None, image_size=16,
                                        device="cpu")
    assert spec == (None, 16, 16, 3)
    fn = load_exported(path, device="cpu")
    jpath, _ = j_export(jmodel, jvars, str(tmp_path / "model.bin"),
                        batch_size=None, image_size=16)
    jfn = j_load(jpath)
    for b in (1, 4, 7):
        xb = _x(b, seed=b)
        out = fn(torch.from_numpy(xb))
        assert out.shape == (b, 4)
        assert torch.equal(out, _live(model, xb, quant_w=False))
        _one_grid_step(out.numpy(), jfn(jnp.asarray(xb)), model)


def test_export_full_deployment_config(tmp_path):
    """The production path ('bf16', the cast quant, bf16 conv stores, f8
    activation storage at E3M4), deployment-prepared and exported as it
    stands (``quant_w=False``): the E3M4 norms travel as uint8 codes
    inside the program (ops/fp8.py), bit-equal to the live model's
    torch.bits8 ones.  tests/test_torch_deploy_flags.py holds this engine
    against JAX's forward run op by op (XLA's CPU jit may keep excess
    precision across the bf16 stores); so does this test, and against
    JAX's artifact, which is jitted, every logit lies within one step plus
    that artifact's own gap to JAX's op-by-op forward, top-1 identical."""
    jcfg = j_make_config(**CFG)
    dcfg = jcfg.replace(
        engine="bf16", conv_out_bf16=True,
        weight_quant=jcfg.weight_quant.replace(cast_fastpath=True),
        act_quant=jcfg.act_quant.replace(cast_fastpath=True, store_f8=True))
    jmodel, jvars, _, x = _pair(jcfg, CFG)
    djmodel = JTiny(config=dcfg)
    djvars = j_prepare(djmodel, jvars, jnp.asarray(x[:1]))
    jpath, _ = j_export(djmodel, djvars, str(tmp_path / "deploy.bin"),
                        batch_size=4, image_size=16, quant_w=False)
    jart = np.asarray(j_load(jpath)(jnp.asarray(x)))
    with jax.disable_jit():
        ref = np.asarray(djmodel.apply(djvars, jnp.asarray(x), mode="fixed",
                                       quant_w=False))

    model = tiny_model(make_layer_config(
        engine="bf16", deploy_cast_quant=True, conv_out_bf16=True,
        deploy_act_f8=True, **CFG))
    convert.load_jax_variables(model, jax.tree.map(np.asarray, jvars))
    bake.prepare_for_deployment(model, torch.from_numpy(x[:1]))
    assert model.conv1.act_q.cast_m == 4
    path, _ = export_quantized_model(model, str(tmp_path / "deploy.pt2"),
                                     batch_size=4, image_size=16,
                                     quant_w=False, device="cpu")
    out = load_exported(path, device="cpu")(torch.from_numpy(x))
    assert torch.equal(out, _live(model, x, quant_w=False))
    assert _conv_tf32(path) is True         # bf16-exact operands
    program = torch.export.load(path)
    assert any(n.meta.get("val") is not None
               and getattr(n.meta["val"], "dtype", None) == torch.uint8
               for n in program.graph.nodes)
    out = out.numpy()
    near = (np.abs(out - ref) <= _fp8_step(out, ref, model)).mean()
    assert near >= 0.95, (near, np.abs(out - ref).max())
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    jit_gap = np.abs(jart - ref).max()
    assert np.all(np.abs(out - jart) <= jit_gap + _fp8_step(out, jart, model))
    np.testing.assert_array_equal(out.argmax(-1), jart.argmax(-1))


def test_export_baked_int8_round_trip(tmp_path):
    """The int8 datapath: the export's bake stores int8 weight grids,
    which the program holds as int8 constants."""
    jcfg = j_make_config(engine="pallas", **{
        k: v for k, v in INT8.items() if k != "int8_mxu"}).replace(int8_mxu=True)
    jmodel, jvars, model, x = _pair(jcfg, dict(INT8, engine="fused"))
    jbaked = j_bake_int8(jmodel, jvars, jnp.asarray(x))
    jpath, _ = j_export(jmodel, jbaked, str(tmp_path / "int8.bin"),
                        batch_size=4, image_size=16)
    ref = np.asarray(j_load(jpath)(jnp.asarray(x)))

    path, _ = export_quantized_model(model, str(tmp_path / "int8.pt2"),
                                     batch_size=4, image_size=16,
                                     device="cpu")
    program = torch.export.load(path)
    assert any(t.dtype == torch.int8 for t in program.state_dict.values())
    assert _conv_tf32(path) is False        # ops/int8's exact convolutions
    out = load_exported(path, device="cpu")(torch.from_numpy(x))
    assert torch.equal(out, _live(model, x, quant_w=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


# ---- the eight ops on the 'fused' engine ------------------------------------------

class OpCalls(TorchDispatchMode):
    """Counts the ``fp8tpu::*`` calls made while active and keeps the
    first arguments of each op (detached)."""

    def __init__(self):
        super().__init__()
        self.counts, self.args = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "fp8tpu":
            name = func._schema.name.split("::")[1]
            self.counts[name] = self.counts.get(name, 0) + 1
            self.args.setdefault(name, tuple(
                a.detach().clone() if isinstance(a, torch.Tensor) else a
                for a in args))
        return func(*args, **(kwargs or {}))


RESNET, MNV2 = (1, 1, 1, 1), ((1, 8, 1, 1), (6, 16, 2, 2), (6, 16, 1, 1))
FP8 = dict(CFG, fp8_mantissa_bits=4)
VIT = dict(patch_size=4, dim=32, depth=1, num_heads=2, mlp_ratio=2)


def _fused_model(name):
    from fp8_quantization_tpu_torch.models import mobilenet_v2, vit
    from fp8_quantization_tpu_torch.models.resnet import (
        QuantizedResNet, resnet_configs)
    if name.startswith("resnet"):
        cfg = make_layer_config(engine="fused", **(INT8 if "int8" in name
                                                   else FP8))
        model = QuantizedResNet(RESNET, False, 10, **resnet_configs(cfg, None))
        convert.load_torchvision_resnet(model, convert.random_resnet_state_dict(
            7, RESNET, num_classes=10))
        return model, 32
    if name.startswith("mnv2"):
        model = mobilenet_v2.mobilenetv2_quantized(
            make_layer_config(engine="fused", bn_mode=name.split("-")[1],
                              **FP8),
            num_classes=10, settings=MNV2, device="cpu")
        convert.load_tonylins_mobilenet_v2(
            model, convert.random_mobilenet_v2_state_dict(7, MNV2, 10))
        return model, 32
    model = vit.QuantizedViT(num_classes=10, image_size=16,
                             config=make_layer_config(engine="fused", **FP8),
                             **VIT)
    convert.load_timm_vit(model, convert.random_vit_state_dict(
        7, depth=VIT["depth"], dim=VIT["dim"], mlp_ratio=VIT["mlp_ratio"],
        patch_size=VIT["patch_size"], image_size=16, num_classes=10))
    return model, 16


# the ops each small model's fused forward calls
FUSED_OPS = {"resnet-fp8": {"qstem", "qconv3x3", "qmatmul"},
             "resnet-int8": {"qconv3x3_int8", "qmatmul_int8"},
             "mnv2-fp32_after": {"qblock", "qmatmul"},
             "mnv2-folded": {"qdwconv3x3", "qmatmul"},
             "vit": {"flash_mha", "qmatmul"}}


@pytest.fixture(scope="module")
def fused_exports(tmp_path_factory):
    """name -> (model exported with a symbolic batch, artifact path, image
    size, quant_w, the live forward's op calls at batch 3)."""
    out = {}
    tmp = tmp_path_factory.mktemp("fused")
    for name in FUSED_OPS:
        model, size = _fused_model(name)
        calibrate(model, [_x(2, size=size)], device="cpu")
        path, _ = export_quantized_model(model, str(tmp / f"{name}.pt2"),
                                         image_size=size, device="cpu")
        quant_w = name == "resnet-int8"
        with OpCalls() as calls:
            _live(model, _x(3, seed=3, size=size), quant_w)
        out[name] = (model, path, size, quant_w, calls)
    return out


def test_fused_exports_cover_the_eight_ops():
    assert set().union(*FUSED_OPS.values()) == set(WRAPPERS) == set(OPS)


@pytest.mark.parametrize("name", list(FUSED_OPS))
def test_fused_export_holds_its_ops(name, fused_exports):
    model, path, size, quant_w, live_calls = fused_exports[name]
    program = torch.export.load(path)
    found = {str(n.target).split(".")[1] for n in program.graph.nodes
             if str(n.target).startswith("fp8tpu.")}
    assert found == FUSED_OPS[name]
    # host-made constants (the INT8 block quantizers' bounds) read in place
    assert bool(program.constants) == (name == "resnet-int8")
    assert not any("lift_fresh_copy" in str(n.target)
                   for n in program.graph.nodes)
    fn = load_exported(path, device="cpu")
    for b in (1, 3):
        x = _x(b, seed=b, size=size)
        with OpCalls() as calls:
            out = fn(torch.from_numpy(x))
        assert torch.equal(out, _live(model, x, quant_w))
    assert calls.counts == live_calls.counts


@pytest.mark.parametrize("op", sorted(OPS))
def test_opcheck(op, fused_exports):
    """Schema, fake against real (symbolic shapes included) and the
    dispatcher registrations, on the arguments of a live call."""
    args = next(calls.args[op] for *_, calls in fused_exports.values()
                if op in calls.args)
    torch.library.opcheck(OPS[op], args)


def test_loaded_without_model_code(fused_exports, tmp_path):
    """A server process: load_exported runs the artifact with the op
    library and without models/ or nn/layers.py."""
    model, path, size, quant_w, _ = fused_exports["resnet-fp8"]
    x = _x(2, seed=9, size=size)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "from fp8_quantization_tpu_torch.serving import load_exported\n"
        f"fn = load_exported({path!r}, device='cpu')\n"
        f"y = fn(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy())\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.startswith('fp8_quantization_tpu'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    mods = json.loads(done.stdout.strip().splitlines()[-1])
    assert "fp8_quantization_tpu_torch.ops.kernels.library" in mods
    assert not [m for m in mods if m.startswith(
        ("fp8_quantization_tpu_torch.models", "fp8_quantization_tpu."))]
    assert "fp8_quantization_tpu_torch.nn.layers" not in mods
    assert torch.equal(torch.from_numpy(np.load(tmp_path / "y.npy")),
                       _live(model, x, quant_w))


def test_replay_without_a_recorded_route_raises():
    site = torch.nn.Linear(2, 2)
    with route_log(site, "replay"), pytest.raises(RuntimeError,
                                                  match="no route"):
        gated_route(site, None, lambda: 1, lambda: 0)
    with route_log(site, "record"):
        assert gated_route(site, lambda **r: False, lambda: 1, lambda: 0) == 0
    with route_log(site, "replay"):
        assert gated_route(site, None, lambda: 1, lambda: 0) == 0
    assert gated_route(site, lambda **r: True, lambda: 1, lambda: 0) == 1
