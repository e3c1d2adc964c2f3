"""The ViT slice of the port against the JAX package (CPU).

* Two tiny ViTs (patch 4, depth 2, 2 heads, MLP ratio 2, 10 classes):
  dim 32 on 16x16 images (17 tokens) and dim 64 on 32x32 images (65
  tokens), batch 2, from one random timm-layout state dict.  Each port
  engine against its JAX counterpart (``fused`` against ``pallas``, whose
  attention is the Pallas flash kernel in interpret mode and whose
  reference is baked inside nn/bake._pallas_gates_off(), ROADMAP.md section
  C):
  (a) JAX's calibrated and baked variables carried over by
      ``load_jax_variables``: top-1 identical and >= 98% of the logits
      within one grid step of the head's output quantizer;
  (b) each package calibrating on its own: every quantizer state within one
      float32 ulp of JAX's (two for the LayerNorms' output ranges, eight on
      parity), and >= 75% of the logits within one grid step, with the
      cause of the looser bound shown (see the test).
  The bound is one grid step, not equality: LayerNorm statistics, the
  softmax and gelu take their sums and transcendental functions from other
  libraries in the two packages (XLA's CPU rsqrt is not even correctly
  rounded), so a last-bit difference now and then moves a value across an
  FP8 bin's edge, and that step travels on to the logits.
* The routes (12 flash_mha and 37 qmatmul launches per ViT-S forward under
  ``fused`` scale down to depth 2 here; calibration never takes flash), the
  presets, the timm loader against ``convert_vit``, and the CLI on CPU.

The kernel and the layers: tests/test_torch_vit_layers.py.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models.convert import convert_vit, merge_variables
from fp8_quantization_tpu.models.vit import QuantizedViT as JViT
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models import vit as tvit
from fp8_quantization_tpu_torch.nn.bake import bake_weights
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.ops.kernels import attention, qmatmul

torch.set_num_threads(1)

MBITS = 4
MAIN = dict(per_channel_weights=True, fp8_mantissa_bits=MBITS,
            fp8_set_maxval=True, weight_range_method="current_minmax",
            act_range_method="allminmax")
CLASSES, SEED, DEPTH = 10, 6, 2
# name -> (dim, image size)
TINY = {"d32_17tok": (32, 16), "d64_65tok": (64, 32)}
ENGINES = {"parity": "parity", "bf16": "bf16", "fused": "pallas"}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _near(out, ref, maxval, min_near=0.98):
    """>= ``min_near`` of the logits within one grid step of the head's
    E3M4 output quantizer (at the larger magnitude), top-1 identical."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    step = (np.maximum(np.abs(out), np.abs(ref)) * 2.0 ** -MBITS
            + maxval * 2.0 ** -10)
    near = (np.abs(out - ref) <= step).mean()
    assert near >= min_near, (near, np.abs(out - ref).max())
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def _sd(name):
    dim, size = TINY[name]
    return convert.random_vit_state_dict(SEED, depth=DEPTH, dim=dim,
                                         mlp_ratio=2, patch_size=4,
                                         image_size=size, num_classes=CLASSES)


def _x(name):
    size = TINY[name][1]
    return np.random.RandomState(SEED).normal(0, 1, (2, size, size, 3)).astype(
        np.float32)


def _port_model(name, engine, head_config=None):
    dim, size = TINY[name]
    return tvit.QuantizedViT(
        num_classes=CLASSES, patch_size=4, dim=dim, depth=DEPTH, num_heads=2,
        mlp_ratio=2, image_size=size,
        config=make_layer_config(engine=engine, **MAIN), head_config=head_config)


def _jax_model(name, engine, fp_logits=False):
    cfg = j_make_config(engine=engine, **MAIN)
    return JViT(num_classes=CLASSES, patch_size=4, dim=TINY[name][0],
                depth=DEPTH, num_heads=2, mlp_ratio=2, config=cfg,
                head_config=cfg.fp32_acts() if fp_logits else None)


_JAX_RUNS = {}


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The timm weights in the JAX model's variables (the variable tree is
    the same on every engine, so one init serves all three)."""
    x = jnp.asarray(_x(name))
    jvars = jax.jit(_jax_model(name, "parity").init)(jax.random.PRNGKey(0), x)
    return merge_variables(jvars, *convert_vit(_sd(name), depth=DEPTH))


def _jax_apply(jmodel, variables, x):
    return np.asarray(jax.jit(lambda v, xx: jmodel.apply(
        v, xx, mode="fixed", quant_w=False))(variables, jnp.asarray(x)))


def _jax_run(name, engine):
    """(JAX-calibrated variables, JAX-baked variables, baked logits), once
    per tiny model and engine."""
    key = (name, engine)
    if key not in _JAX_RUNS:
        jmodel = _jax_model(name, engine)
        x = jnp.asarray(_x(name))
        jvars = j_calibrate(jmodel, _jax_init(name), [x])
        with _pallas_gates_off():
            jbaked = jax.jit(lambda v, xx: j_bake(jmodel, v, xx))(jvars, x)
        _JAX_RUNS[key] = (_np_tree(jvars), _np_tree(jbaked),
                          _jax_apply(jmodel, jbaked, x))
    return _JAX_RUNS[key]


def _head_maxval(jvars):
    return float(jvars["quant"]["head"]["act_q"]["q"]["maxval"])


def _forward(model, x):
    with torch.no_grad():
        return model(_t(x), mode="fixed", quant_w=False).numpy()


CASES = [(n, e) for n in TINY for e in ENGINES]


@pytest.mark.parametrize("name, engine", CASES)
def test_tiny_vit_jax_variables_carry_over(name, engine):
    """(a): the JAX-calibrated, JAX-baked ViT in a fresh port model."""
    _, jbaked, jlogits = _jax_run(name, ENGINES[engine])
    model = _port_model(name, engine)
    convert.load_jax_variables(model, jbaked)
    np.testing.assert_array_equal(model.pos_embed.detach().numpy(),
                                  jbaked["params"]["pos_embed"])
    np.testing.assert_array_equal(model.block1.ln2.weight.detach().numpy(),
                                  jbaked["params"]["block1"]["ln2"]["scale"])
    logits = _forward(model, _x(name))
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    _near(logits, jlogits, _head_maxval(jbaked))


def _quantizers(model):
    """Port quantizer path -> the module holding it, JAX style
    ("block0/attn/qkv/act_q")."""
    out = {}
    for name, mod in model.named_modules():
        for q in ("weight_q", "act_q"):
            if hasattr(mod, q) and isinstance(getattr(mod, q), torch.nn.Module):
                out["/".join(name.split(".") + [q])] = getattr(mod, q)
    return out


@pytest.mark.parametrize("name, engine", CASES)
def test_tiny_vit_calibrates_like_jax(name, engine):
    """(b): each package calibrates on its own from the same timm weights.
    On bf16 and fused every quantizer's state is within one float32 ulp of
    JAX's, except the LayerNorms' output ranges, within two: an LN's largest
    output is ``(x - mean) * rsqrt(var + eps) * gamma + beta``, whose mean
    and variance each package sums in its own order and whose rsqrt XLA's
    CPU backend does not round correctly, so two factors can each be one
    ulp off (measured: 2 ulps on block0/ln2 and block1/ln1).  On parity the
    products are float32 values off the bf16 grid (the attention output
    into proj, the LN output into the head), so they round, and XLA and
    torch add them in other orders: up to eight ulps (measured: 4 at dim
    32 and 5 at dim 64 on block0/attn/proj).

    The logits then move further than in (a): a range one ulp off moves
    every value of its grid by an ulp, and a value at a bin's edge lands in
    the next bin.  On the 65-token model under bf16 20% of the logits end
    more than one grid step from JAX's (top-1 the same), so the bound here
    is 75%, and the test shows the cause: the port's forward on JAX's
    calibrated ranges (baked by the port) is held to (a)'s 98%."""
    jvars, _, jlogits = _jax_run(name, ENGINES[engine])
    model = _port_model(name, engine)
    convert.load_timm_vit(model, _sd(name))
    calibrate(model, [_x(name)], device="cpu")
    quantizers = _quantizers(model)
    # patch_embed, ln_final, head: 2 each; a block: 2 LNs, qkv, proj, mlp1,
    # mlp2 with 2 each, and its 2 block quantizers
    assert len(quantizers) == 6 + 14 * DEPTH
    for path, quantizer in quantizers.items():
        node = jvars["quant"]
        for k in path.split("/"):
            node = node[k]
        ulps = (8 if engine == "parity"
                else 2 if path.split("/")[-2].startswith("ln") else 1)
        for key, value in quantizer.state().items():
            np.testing.assert_array_max_ulp(
                value.numpy().reshape(-1).astype(np.float32),
                np.asarray(node["q"][key]).reshape(-1).astype(np.float32),
                maxulp=ulps)
    bake_weights(model)
    maxval = _head_maxval(jvars)
    _near(_forward(model, _x(name)), jlogits, maxval, min_near=0.75)
    on_jax_ranges = _port_model(name, engine)
    convert.load_jax_variables(on_jax_ranges, jvars)
    bake_weights(on_jax_ranges)
    _near(_forward(on_jax_ranges, _x(name)), jlogits, maxval)


def test_fp_logits_preset_matches_jax():
    """FP_logits: the head's output is not quantized (JAX
    ``base.fp32_acts()`` for the head), on the fused engine; both packages
    evaluate the same baked variables (the head's unused output range
    included)."""
    name = "d32_17tok"
    _, jbaked, _ = _jax_run(name, "pallas")
    jlogits = _jax_apply(_jax_model(name, "pallas", fp_logits=True), jbaked,
                         _x(name))
    base = make_layer_config(engine="fused", **MAIN)
    model = tvit.vit_small_quantized(
        base, "FP_logits", num_classes=CLASSES, device="cpu", dim=32,
        depth=DEPTH, num_heads=2, mlp_ratio=2, patch_size=4, image_size=16)
    assert not model.head.config.quant_a and model.block0.mlp1.config.quant_a
    convert.load_jax_variables(model, jbaked)
    logits = _forward(model, _x(name))
    # unquantized logits: within one grid step of the last block's quantizer
    # carried through LN and the head, 1e-3 here
    np.testing.assert_allclose(logits, jlogits, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def _spy(monkeypatch, calls):
    for mod, fname in ((attention, "flash_mha"), (qmatmul, "fused_quant_matmul")):
        fn = getattr(mod, fname)

        def wrapped(*a, _fn=fn, _name=fname, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, fname, wrapped)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_routes(engine, monkeypatch):
    """Calibration takes the composed attention on every engine (flash runs
    in fixed mode only, as in JAX); a fixed-mode 'fused' forward runs one
    flash_mha per block and qmatmul for qkv, proj, mlp2 and the head, and
    equals the 'bf16' forward on the CPU up to flash's bf16 operands."""
    name = "d32_17tok"
    model = _port_model(name, engine)
    convert.load_timm_vit(model, _sd(name))
    calls = {}
    _spy(monkeypatch, calls)
    calibrate(model, [_x(name)], device="cpu")
    assert calls == {}
    bake_weights(model)
    logits = _forward(model, _x(name))
    want = ({"flash_mha": DEPTH, "fused_quant_matmul": 3 * DEPTH + 1}
            if engine == "fused" else {})
    assert calls == want and np.isfinite(logits).all()


def test_presets_int8_and_token_count_raise():
    base = make_layer_config(engine="fused", **MAIN)
    for setup in ("fc4", "LSQ", "dw_bf16_acts"):
        with pytest.raises(ValueError, match="not supported for the ViT"):
            tvit.vit_small_quantized(base, setup, device="cpu")
    # the int8 datapath builds and runs (tests/test_torch_int8_vit.py
    # holds it against JAX)
    int8 = make_layer_config(qmethod="symmetric_uniform",
                             act_qmethod="asymmetric_uniform",
                             quantize_input=True, int8_mxu=True,
                             engine="fused")
    tiny = tvit.vit_small_quantized(int8, device="cpu", num_classes=CLASSES,
                                    dim=32, depth=1, num_heads=2, mlp_ratio=2,
                                    patch_size=4, image_size=16)
    calibrate(tiny, [_x("d32_17tok")], device="cpu")
    logits = _forward(tiny, _x("d32_17tok"))
    assert logits.shape == (2, CLASSES) and np.isfinite(logits).all()
    model = _port_model("d32_17tok", "bf16")
    with pytest.raises(ValueError, match="position embedding"):
        model(torch.zeros(1, 32, 32, 3), mode="fixed")
    full = tvit.vit_small_quantized(base, device="cpu")
    assert full.pos_embed.shape == (1, 197, 384) and full.depth == 12
    assert full.block11.mlp1.weight.shape == (1536, 384)
    assert full.head.weight.shape == (1000, 384)


def test_timm_loader_matches_convert_vit():
    """random_vit_state_dict -> load_timm_vit gives the parameters that
    convert_vit + merge_variables give JAX, bit for bit."""
    name = "d64_65tok"
    sd = _sd(name)
    model = _port_model(name, "parity")
    convert.load_timm_vit(model, sd)
    assert set(convert.timm_vit_key_map(model)) == set(sd)
    params = _jax_init(name)["params"]
    own = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(own["cls_token"], params["cls_token"])
    np.testing.assert_array_equal(own["pos_embed"], params["pos_embed"])
    np.testing.assert_array_equal(own["patch_embed.weight"],
                                  params["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    for i in range(DEPTH):
        p = params[f"block{i}"]
        for ours, theirs in (("ln1", p["ln1"]), ("ln2", p["ln2"])):
            np.testing.assert_array_equal(own[f"block{i}.{ours}.weight"], theirs["scale"])
            np.testing.assert_array_equal(own[f"block{i}.{ours}.bias"], theirs["bias"])
        for ours, theirs in (("attn.qkv", p["attn"]["qkv"]),
                             ("attn.proj", p["attn"]["proj"]),
                             ("mlp1", p["mlp1"]), ("mlp2", p["mlp2"])):
            np.testing.assert_array_equal(own[f"block{i}.{ours}.weight"],
                                          theirs["kernel"].T)
            np.testing.assert_array_equal(own[f"block{i}.{ours}.bias"], theirs["bias"])
    np.testing.assert_array_equal(own["ln_final.weight"], params["ln_final"]["scale"])
    np.testing.assert_array_equal(own["head.weight"], params["head"]["kernel"].T)
    bad = dict(sd)
    bad.pop("blocks.1.mlp.fc2.bias")
    with pytest.raises(KeyError):
        convert.load_timm_vit(model, bad)


def test_cli_vit_validate_quantized_cpu(capsys):
    image_net.main(["validate-quantized", "--device", "cpu",
                    "--architecture", "vit_small_quantized", "--engine", "fused",
                    "--batch-size", "2", "--num-est-batches", "1",
                    "--max-eval-batches", "1"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_examples"] == 2 and np.isfinite(metrics["loss"])


def test_vit_entry_point_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        image_net.validate_quantized(image_net.build_parser().parse_args(
            ["validate-quantized", "--architecture", "vit_small_quantized"]))
