"""The bottleneck ResNet (ResNet-50's blocks) under BASELINE config 2
(INT8 output quant) and on the int8 datapath (``--int8-mxu
--quantize-input``), against the JAX package (CPU), on
tests/_resnet_pair.py's model.  Tolerances: config 2's logits within one
INT step (one delta of the fc's output quantizer) on >= 98% of elements
(tests/test_torch_int_grids.py); the int8 datapath's rtol = atol = 2e-5
(tests/test_torch_int8.py: exact integer sums, the float epilogue in
another order); top-1 identical; prepared bit-equal to unprepared.
"""

import jax.numpy as jnp
import numpy as np
import torch

from fp8_quantization_tpu.nn.bake import (
    _pallas_gates_off, bake_int8_weights as j_bake_int8, bake_weights as j_bake)
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.nn import layers
from fp8_quantization_tpu_torch.nn.bake import (
    bake_int8_weights, bake_weights, prepare_inference)
from tests._resnet_pair import (
    CLASSES, INT8, INT8_OQ, N_LAYERS, inputs, jax_calibrated, jax_logits,
    jax_model, np_tree, port_model, t)

torch.set_num_threads(1)

INT8_TOL = dict(rtol=2e-5, atol=2e-5)


def test_bottleneck_int8_output_quant_matches_jax_pallas():
    """BASELINE config 2 on the bottleneck: port 'fused' (the FP8 kernels'
    integer branches, their plain versions here) from JAX's calibrated
    state, baked by the port, against JAX 'pallas'; prepared bit-equal."""
    sd, x = inputs()
    jmodel = jax_model(dict(engine="pallas", **INT8_OQ))
    jvars = jax_calibrated(jmodel, sd, x)
    with _pallas_gates_off():
        jbaked = j_bake(jmodel, jvars, jnp.asarray(x))
    jlogits = jax_logits(jmodel, jbaked, x, False)
    model = port_model(dict(engine="fused", **INT8_OQ))
    convert.load_jax_variables(model, np_tree(jvars))
    bake_weights(model)
    with torch.no_grad():
        logits = model(t(x), mode="fixed", quant_w=False)
    out = logits.numpy()
    assert out.shape == (2, CLASSES) and np.isfinite(out).all()
    step = float(np.maximum(jvars["quant"]["fc"]["act_q"]["q"]["delta"], 1e-8))
    assert (np.abs(out - jlogits) <= step * (1 + 1e-6)).mean() >= 0.98
    np.testing.assert_array_equal(out.argmax(-1), jlogits.argmax(-1))
    prepare_inference(model, torch.zeros(1, 32, 32, 3), quant_w=False)
    with torch.no_grad():
        assert torch.equal(model(t(x), mode="fixed", quant_w=False), logits)


def test_bottleneck_int8_datapath_matches_jax():
    """``--int8-mxu --quantize-input`` on the bottleneck: the port 'fused'
    model (its int8 kernels' plain versions) from JAX's calibrated state,
    int8-baked by the port, against JAX 'bf16' with its int8 bake; the int8
    grids equal in every layer; prepared bit-equal."""
    sd, x = inputs()
    jmodel = jax_model(dict(engine="bf16", **INT8))
    jvars = jax_calibrated(jmodel, sd, x)
    with _pallas_gates_off():
        jbaked = np_tree(j_bake_int8(jmodel, jvars, jnp.asarray(x)))
    jlogits = jax_logits(jmodel, jbaked, x, True)
    model = port_model(dict(engine="fused", **INT8))
    convert.load_jax_variables(model, np_tree(jvars))
    bake_int8_weights(model)
    n = 0
    for name, mod in model.named_modules():
        if not isinstance(mod, layers.QuantizedLayerBase):
            continue
        node = jbaked["baked_int8"]
        for part in name.split("."):
            node = node[part]
        w = node["w_int8"]
        w = w.transpose(3, 0, 1, 2).reshape(w.shape[3], -1) if w.ndim == 4 else w.T
        np.testing.assert_array_equal(mod.w_int8.numpy(), w)
        n += 1
    assert n == N_LAYERS
    with torch.no_grad():
        logits = model(t(x), mode="fixed", quant_w=True)
    np.testing.assert_allclose(logits.numpy(), jlogits, **INT8_TOL)
    np.testing.assert_array_equal(logits.numpy().argmax(-1), jlogits.argmax(-1))
    prepare_inference(model, torch.zeros(1, 32, 32, 3), quant_w=True)
    with torch.no_grad():
        assert torch.equal(model(t(x), mode="fixed", quant_w=True), logits)
