"""The ViT on the int8 datapath, and its s8 interchange, against the JAX
package (CPU).

* ``prequant_s8``, ``PrequantS8`` and ``ops/int8.int8_matmul`` with
  ``x_prequant`` / ``emit_s8``: s8 outputs bit-exact, float outputs within
  rtol = atol = 2e-5 (tests/test_torch_int8.py's bound between the
  packages); ``qmatmul_int8_plain`` with an int8 x against
  ``int8_matmul(x_prequant=True)`` within 2e-5.
* JAX's tiny ViT of tests/test_int8_interchange.py (patch 4, dim 32,
  depth 2, 2 heads, MLP ratio 2, 5 classes, 16x16 images: 17 tokens,
  padded to 32 off 'fused') from one random timm-layout state dict, the
  int8 config (per-channel symmetric weights, asymmetric inputs,
  ``quantize_input``, ``int8_mxu``, current_minmax / allminmax) with
  ``conv_out_bf16`` and ``int8_assume_signed`` off and on.  JAX calibrates
  once on 'bf16'; both packages then evaluate that state (and JAX's int8
  bake of it) on each engine: port 'parity' and 'bf16' against JAX's,
  port 'fused' against JAX 'pallas' under its default gate mode, which on
  the CPU runs the Pallas flash kernel in interpret mode and takes the XLA
  s8 route for every int8 matmul (its gates pick no Pallas int8 kernel
  outside 'always'), as the port's plain versions do.  Every interchange
  operand of block 0 is bit-exact, and the logits are within 2e-5: the
  integer sums are exact on both sides, and the grids hold the last-bit
  differences of the LayerNorm statistics and the softmax below a step on
  these inputs.
* The routes: all 9 int8 matmuls of depth 2 take an s8 input; on 'fused'
  the kernel's s8 branch (its plain version here) runs for qkv, proj, mlp2
  and the head; calibration emits no ``PrequantS8``; the padded stream
  and the unpadded one give the same logits; the gate keys an s8 input
  apart from a float32 one; the CLI on the CPU.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models import vit as jvit
from fp8_quantization_tpu.models.convert import convert_vit, merge_variables
from fp8_quantization_tpu.nn.bake import _pallas_gates_off
from fp8_quantization_tpu.nn.bake import bake_int8_weights as j_bake_int8
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu.nn.factored import PrequantS8 as JPrequantS8
from fp8_quantization_tpu.ops import int8 as jint8
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import vit as tvit
from fp8_quantization_tpu_torch.nn import factored
from fp8_quantization_tpu_torch.nn.bake import bake_int8_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.factored import PrequantS8
from fp8_quantization_tpu_torch.ops import int8 as tint8
from fp8_quantization_tpu_torch.ops.kernels import attention, autotune, qmatmul_int8

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
CLASSES, SEED, DEPTH = 5, 7, 2
INT8 = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
            per_channel_weights=True, quantize_input=True, int8_mxu=True,
            weight_range_method="current_minmax", act_range_method="allminmax")
FLAGS = {"plain": {}, "bf16_signed": dict(conv_out_bf16=True,
                                          int8_assume_signed=True)}
ENGINES = {"parity": "parity", "bf16": "bf16", "fused": "pallas"}


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


# ---- the ops ------------------------------------------------------------------

def _operands(seed, m=13, k=72, n=40, signed=True):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    lo = -128 if signed else 0
    wsg = rng.randint(lo, 128, (k, n)).astype(np.int8)
    w_delta = rng.uniform(0.01, 0.1, n).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    shift = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, wsg, w_delta, np.float32(signed), scale, shift


@pytest.mark.parametrize("bits, zero", [(8, 127.6), (4, 7.4)])
def test_prequant_s8_and_its_value_bit_exact(bits, zero):
    x = _operands(0)[0]
    ref = jint8.prequant_s8(jnp.asarray(x), jnp.float32(0.05),
                            jnp.float32(zero), float(bits))
    out = tint8.prequant_s8(_t(x), torch.tensor(0.05), torch.tensor(zero), bits)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    jval = jnp.asarray(factored_value_jax(ref, 0.05, zero, bits))
    pre = PrequantS8(out, torch.tensor(0.05), torch.tensor(zero), bits)
    np.testing.assert_array_equal(factored.materialize(pre).numpy(),
                                  np.asarray(jval))
    np.testing.assert_array_equal(factored.split(pre)[0].numpy(),
                                  np.asarray(jval))


def factored_value_jax(xs8, delta, zero, bits):
    from fp8_quantization_tpu.nn.factored import materialize as jmat
    return jmat(JPrequantS8(xs8, jnp.float32(delta), jnp.float32(zero),
                            float(bits)))


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_int8_matmul_prequant_and_emit_s8_match_jax(signed):
    x, wsg, w_delta, sgn, scale, shift = _operands(1 + signed, signed=signed)
    ad, az = np.float32(0.05), np.float32(127.6)
    nd, nz = np.float32(0.03), np.float32(100.2)
    jxs8 = jint8.prequant_s8(jnp.asarray(x), ad, az, 8.0)
    jargs = (jnp.asarray(wsg), jnp.asarray(w_delta), jnp.float32(sgn),
             jnp.float32(ad), jnp.float32(az), 8.0)
    targs = (_t(wsg.T), _t(w_delta), torch.tensor(sgn), torch.tensor(ad),
             torch.tensor(az), 8)
    xs8 = _t(np.asarray(jxs8))
    ref = jint8.int8_matmul(jxs8, *jargs, scale=jnp.asarray(scale),
                            shift=jnp.asarray(shift), x_prequant=True)
    out = tint8.int8_matmul(xs8, *targs, scale=_t(scale), shift=_t(shift),
                            x_prequant=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # emit_s8: the next consumer's operand, bit-exact
    ref8 = jint8.int8_matmul(jxs8, *jargs, act_fn=jax.nn.gelu,
                             x_prequant=True, emit_s8=(nd, nz, 8.0))
    out8 = tint8.int8_matmul(xs8, *targs, act_fn=torch.nn.functional.gelu,
                             x_prequant=True, out_bf16=True,
                             emit_s8=(torch.tensor(nd), torch.tensor(nz), 8))
    assert out8.dtype == torch.int8
    np.testing.assert_array_equal(out8.numpy(), np.asarray(ref8))
    # the prologue skipped equals the prologue run
    full = tint8.int8_matmul(_t(x), *targs, scale=_t(scale), shift=_t(shift))
    assert torch.equal(full, out)


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_qmatmul_int8_plain_takes_an_s8_input(signed):
    """The kernel's plain version with an int8 x equals ops/int8 with
    ``x_prequant``, at ragged M, N and K (K % 4 == 0, the branch's
    condition); the wrapper launches nothing for CPU tensors."""
    x, wsg, w_delta, sgn, scale, shift = _operands(3 + signed, m=13, k=36,
                                                   n=40, signed=signed)
    ad, az = torch.tensor(0.05), torch.tensor(127.6)
    xs8 = tint8.prequant_s8(_t(x), ad, az, 8)
    want = tint8.int8_matmul(xs8, _t(wsg.T), _t(w_delta), torch.tensor(sgn),
                             ad, az, 8, scale=_t(scale), shift=_t(shift),
                             act_fn=torch.relu, x_prequant=True)
    before = qmatmul_int8.fused_quant_matmul_int8.launches
    out = qmatmul_int8.fused_quant_matmul_int8(
        xs8, _t(wsg.T).contiguous(), _t(w_delta),
        torch.tensor([0.0, sgn]), torch.stack([ad, az, torch.tensor(0.0)]),
        _t(scale), _t(shift),
        cfg=qmatmul_int8.Int8MatmulConfig(activation="relu"))
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    assert qmatmul_int8.fused_quant_matmul_int8.launches == before
    assert qmatmul_int8.s8_input_ok(36) and not qmatmul_int8.s8_input_ok(34)


# ---- the tiny ViT ----------------------------------------------------------------

def _sd():
    return convert.random_vit_state_dict(SEED, depth=DEPTH, dim=32,
                                         mlp_ratio=2, patch_size=4,
                                         image_size=16, num_classes=CLASSES)


def _x(seed=SEED):
    return np.random.RandomState(seed).normal(0, 1, (2, 16, 16, 3)).astype(
        np.float32)


def _jax_model(engine, flags):
    return jvit.QuantizedViT(num_classes=CLASSES, patch_size=4, dim=32,
                             depth=DEPTH, num_heads=2, mlp_ratio=2,
                             config=j_make_config(engine=engine, **INT8,
                                                  **FLAGS[flags]))


def _port_model(engine, flags):
    return tvit.QuantizedViT(
        num_classes=CLASSES, patch_size=4, dim=32, depth=DEPTH, num_heads=2,
        mlp_ratio=2, image_size=16,
        config=make_layer_config(engine=engine, **INT8, **FLAGS[flags]))


@functools.lru_cache(maxsize=None)
def _jax_state(flags):
    """(JAX-calibrated variables, their int8 bake), calibrated on 'bf16'."""
    jmodel = _jax_model("bf16", flags)
    x = jnp.asarray(_x())
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)
    jvars = merge_variables(jvars, *convert_vit(_sd(), depth=DEPTH))
    jvars = j_calibrate(jmodel, jvars, [x])
    with _pallas_gates_off():
        jbaked = j_bake_int8(jmodel, jvars, x)
    return _np_tree(jvars), _np_tree(jbaked)


@functools.lru_cache(maxsize=None)
def _jax_logits(engine, flags, baked):
    jvars = _jax_state(flags)[baked]
    jmodel = _jax_model(ENGINES[engine], flags)
    return np.asarray(jax.jit(lambda v, xx: jmodel.apply(
        v, xx, mode="fixed", quant_w=not baked))(jvars, jnp.asarray(_x())),
        np.float32)


def _carried(engine, flags, baked):
    model = _port_model(engine, flags)
    convert.load_jax_variables(model, _jax_state(flags)[baked])
    return model


def _forward(model, quant_w, x=None):
    with torch.no_grad():
        return model(_t(_x() if x is None else x), mode="fixed",
                     quant_w=quant_w).to(torch.float32).numpy()


CASES = [(e, f, b) for e in ENGINES for f in FLAGS for b in (False, True)]


@pytest.mark.parametrize("engine, flags, baked", CASES)
def test_tiny_vit_int8_matches_jax(engine, flags, baked):
    """JAX's calibrated state (``baked``: and its int8 bake, evaluated
    with quant_w=False as JAX does) on each engine: logits within 2e-5,
    top-1 identical."""
    model = _carried(engine, flags, baked)
    assert (model.block1.mlp2.w_int8 is not None) == baked
    logits = _forward(model, quant_w=not baked)
    ref = _jax_logits(engine, flags, baked)
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, ref, **TOL)
    np.testing.assert_array_equal(logits.argmax(-1), ref.argmax(-1))


def _capture_jax_block0(engine, flags):
    """The PrequantS8 operands JAX's block 0 hands its four matmuls, as
    outputs of one jitted forward (an eager forward through the Pallas
    kernels' interpret mode can deadlock between its callback thread and
    eager dispatch)."""
    jvars = _jax_state(flags)[0]
    jmodel = _jax_model(ENGINES[engine], flags)
    from fp8_quantization_tpu.nn import layers as jlayers
    orig = jlayers.QuantLinear.__call__

    def forward(v, xx):
        seen = {}

        def spy(self, x, *a, **k):
            if isinstance(x, JPrequantS8) and self.scope.path[0] == "block0":
                seen["/".join(self.scope.path[1:])] = x.xs8
            return orig(self, x, *a, **k)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jlayers.QuantLinear, "__call__", spy)
            jmodel.apply(v, xx, mode="fixed")
        return seen

    return _np_tree(jax.jit(forward)(jvars, jnp.asarray(_x())))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_block0_interchange_operands_bit_exact(engine, monkeypatch):
    """Every s8 operand of block 0 (ln1 -> qkv, attention -> proj, ln2 ->
    mlp1, mlp1 -> mlp2), padded rows included off 'fused', equals JAX's."""
    want = _capture_jax_block0(engine, "plain")
    assert set(want) == {"attn/qkv", "attn/proj", "mlp1", "mlp2"}
    model = _carried(engine, "plain", False)
    seen = {}
    for name in ("attn.qkv", "attn.proj", "mlp1", "mlp2"):
        layer = model.block0.get_submodule(name)
        orig = layer.forward

        def spy(x, *a, _orig=orig, _name=name, **k):
            if isinstance(x, PrequantS8):
                seen[_name.replace(".", "/")] = x.xs8.numpy()
            return _orig(x, *a, **k)
        monkeypatch.setattr(layer, "forward", spy)
    _forward(model, quant_w=True)
    assert set(seen) == set(want)
    rows = 2 * (17 if engine == "fused" else 32)
    for name, value in want.items():
        assert seen[name].shape[0] == rows
        np.testing.assert_array_equal(seen[name], value.reshape(rows, -1))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_every_int8_matmul_takes_an_s8_input(engine, monkeypatch):
    """Depth 2: qkv, proj, mlp1 and mlp2 twice and the head, 9 int8
    matmuls, each with an int8 operand.  On 'fused' mlp1 (gelu, which no
    kernel carries) and only mlp1 takes ops/int8; the other 7 take the
    kernel's s8 branch."""
    calls = {"composed": [], "kernel": []}
    for mod, name, key in ((tint8, "int8_matmul", "composed"),
                           (qmatmul_int8, "qmatmul_int8_plain", "kernel")):
        fn = getattr(mod, name)

        def spy(x, *a, _fn=fn, _key=key, **k):
            calls[_key].append(x.dtype == torch.int8)
            return _fn(x, *a, **k)
        monkeypatch.setattr(mod, name, spy)
    _forward(_carried(engine, "plain", False), quant_w=True)
    got = calls["composed"] + calls["kernel"]
    assert len(got) == 4 * DEPTH + 1 and all(got)
    if engine == "fused":
        assert len(calls["kernel"]) == 3 * DEPTH + 1
        assert len(calls["composed"]) == DEPTH
    else:
        assert calls["kernel"] == []


def test_flash_runs_unmasked_on_fused_and_never_padded(monkeypatch):
    """'fused' keeps the 17-token stream: flash_mha runs once a block, on
    S = 17; off 'fused' the attention is the masked float32 chain."""
    seen = []
    fn = attention.flash_mha

    def spy(q, *a, **k):
        seen.append(q.shape[2])
        return fn(q, *a, **k)
    monkeypatch.setattr(attention, "flash_mha", spy)
    _forward(_carried("fused", "plain", True), quant_w=False)
    assert seen == [17] * DEPTH
    seen.clear()
    _forward(_carried("bf16", "plain", True), quant_w=False)
    assert seen == []


def test_calibration_emits_no_prequant_s8(monkeypatch):
    """Calibration keeps the 3-D stream: no producer emits s8, so every
    estimator sees real values; afterwards the fixed-mode forward does."""
    calls = []
    fn = tint8.prequant_s8
    monkeypatch.setattr(tvit, "prequant_s8",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    model = _port_model("bf16", "plain")
    convert.load_timm_vit(model, _sd())
    calibrate(model, [_x()], device="cpu")
    assert calls == []
    _forward(model, quant_w=True)
    assert len(calls) == DEPTH + 1     # the attention outputs, the cls rows


@pytest.mark.parametrize("engine", ["parity", "bf16"])
def test_padded_and_unpadded_streams_agree(engine, monkeypatch):
    """The pad keys' softmax weight is exactly 0 (-1e9 added), and no
    other op mixes rows: the padded stream's logits equal the unpadded
    one's within 2e-5 (the attention sums over 32 keys, 15 of them exact
    zeros, where the unpadded one sums over 17)."""
    model = _carried(engine, "plain", True)
    padded = _forward(model, quant_w=False)
    monkeypatch.setattr(tvit, "SEQ_ALIGN", 1)
    unpadded = _forward(model, quant_w=False)
    np.testing.assert_allclose(padded, unpadded, **TOL)
    np.testing.assert_array_equal(padded.argmax(-1), unpadded.argmax(-1))


def test_port_int8_bake_equals_jax_and_is_signed_checked():
    """The port's int8 bake of JAX's calibrated state gives JAX's grids in
    every layer of the ViT (patch embed, the four linears of each block,
    the head) and checks ``int8_assume_signed``."""
    jbaked = _jax_state("bf16_signed")[1]["baked_int8"]
    model = _carried("fused", "bf16_signed", False)
    bake_int8_weights(model)
    n = 0
    for name, mod in model.named_modules():
        if getattr(mod, "w_int8", None) is None:
            continue
        node = jbaked
        for part in name.split("."):
            node = node[part]
        w = node["w_int8"]
        w = w.transpose(3, 0, 1, 2).reshape(w.shape[3], -1) if w.ndim == 4 else w.T
        np.testing.assert_array_equal(mod.w_int8.numpy(), w)
        np.testing.assert_array_equal(mod.w_delta.numpy(), node["w_delta"])
        n += 1
    assert n == 2 + 4 * DEPTH
    sd = _sd()
    sd["blocks.0.mlp.fc1.weight"] = np.abs(sd["blocks.0.mlp.fc1.weight"])
    model = _port_model("fused", "bf16_signed")
    convert.load_timm_vit(model, sd)
    calibrate(model, [_x()], device="cpu")
    with pytest.raises(ValueError, match=r"baked for: \['block0/mlp1'\]"):
        bake_int8_weights(model)


def test_presets_and_token_count_still_raise():
    int8 = make_layer_config(engine="fused", **INT8)
    with pytest.raises(ValueError, match="not supported for the ViT"):
        tvit.vit_small_quantized(int8, "LSQ", device="cpu")
    model = tvit.vit_small_quantized(int8, device="cpu", dim=32, depth=1,
                                     num_heads=2, mlp_ratio=2, patch_size=4,
                                     image_size=16)
    with pytest.raises(ValueError, match="position embedding"):
        model(torch.zeros(1, 32, 32, 3), mode="fixed")


def test_cli_vit_int8_validate_quantized_cpu(capsys):
    image_net.main(["validate-quantized", "--device", "cpu",
                    "--architecture", "vit_small_quantized", "--engine", "fused",
                    "--qmethod", "symmetric_uniform",
                    "--qmethod-act", "asymmetric_uniform", "--per-channel",
                    "--quantize-input", "--int8-mxu",
                    "--num-est-batches", "1", "--max-eval-batches", "1",
                    "--batch-size", "2"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2 and np.isfinite(metrics["loss"])


def test_gate_keys_s8_and_float_inputs_apart(tmp_path, monkeypatch):
    """int8_matmul_wins races an s8 input ('ims') and a float32 one ('im')
    at the same (M, K, N) as two keys, each with its own verdict."""
    cpu = torch.zeros(1)
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "cache.json"))
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_TIMES", {})
    monkeypatch.setattr(autotune, "_DISK_LOADED", False)
    monkeypatch.setattr(autotune, "MODE", "auto")
    monkeypatch.setattr(autotune, "on_card", lambda *t: True)
    routes = {False: (lambda: cpu, lambda: cpu), True: (lambda: cpu, lambda: cpu)}
    times = {routes[False][0]: 1.0, routes[False][1]: 1.1,     # float: composed
             routes[True][0]: 1.0, routes[True][1]: 2.0}       # s8: the kernel
    monkeypatch.setattr(autotune, "_time_fn", lambda fn, device: times[fn])
    got = {pre: autotune.int8_matmul_wins(12608, 384, 1152, pre, like=cpu,
                                          kernel=routes[pre][0],
                                          composed=routes[pre][1])
           for pre in (False, True)}
    assert got == {False: False, True: True}
    assert autotune.decisions() == {("im", 12608, 384, 1152): False,
                                    ("ims", 12608, 384, 1152): True}


def test_emit_s8_off_the_int8_route_raises():
    """Only the int8 route emits s8: asking for it in calibration (or off
    the datapath) is an error, where JAX ignores the request."""
    layer = tvit.QuantLinear(8, 4, config=make_layer_config(engine="bf16", **INT8))
    grid = (torch.tensor(0.1), torch.tensor(128.0), 8)
    with pytest.raises(ValueError, match="emit_s8"):
        layer(torch.randn(3, 8), mode="calibrate", emit_s8=grid)


def test_op_schema_takes_an_s8_input():
    """fp8tpu::qmatmul_int8 (ops/kernels/library.py) takes an int8 x: its
    fake and CPU implementation agree (torch.library.opcheck)."""
    x = torch.randint(-128, 128, (5, 8), dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 8), dtype=torch.int8)
    args = (x, w, torch.full((3,), 0.1), torch.tensor([0.0, 1.0]),
            torch.tensor([0.05, 128.0, 0.0]), torch.ones(3), torch.zeros(3),
            None, 8, 8)
    torch.library.opcheck(torch.ops.fp8tpu.qmatmul_int8.default, args)
