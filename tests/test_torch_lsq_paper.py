"""The ResNet ``LSQ_paper`` preset (JAX models/resnet.py:286-297) on
ResNet-18's and ResNet-50's blocks, against the JAX package (CPU), on
tests/_resnet_pair.py's model (basic and bottleneck blocks).

``LSQ_paper`` quantizes every layer's input and leaves the logits
unquantized, so they are held within 1e-5 of the largest logit
(chip_smoke's bound for outputs with no quantizer after the product: sums
in another order).  An ulp upstream can flip an E3M4 input bin downstream
and move a logit by far more; at this size none does (measured on seeds
3, 5 and 11, every engine: at most 5.3e-7 of the largest).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.models import resnet as jresnet
from fp8_quantization_tpu.nn.bake import _pallas_gates_off, bake_weights as j_bake
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import resnet_configs
from fp8_quantization_tpu_torch.nn.bake import prepare_inference
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.ops.kernels import qmatmul
from tests._resnet_pair import (
    CLASSES, JAX_ENGINE, MAIN, SEED, STAGES, jax_calibrated, jax_logits,
    jax_model, np_tree, port_model, t)

torch.set_num_threads(1)

LSQ_NOISE = 1e-5


def test_lsq_paper_configs_match_jax():
    """resnet_configs(base, "LSQ_paper") is JAX's preset, field by field."""
    base = make_layer_config(**MAIN)
    jbase = j_make_config(**MAIN)
    ours, theirs = resnet_configs(base, "LSQ_paper"), jresnet.resnet_configs(
        jbase, "LSQ_paper")
    assert ours["tie_avgpool"] is False and theirs["tie_avgpool"] is False
    assert ours["last_block_config"] is None and theirs["last_block_config"] is None
    for key in ("config", "stem_config", "block_act_config", "fc_config"):
        for field in ("quantize_input", "quant_w", "quant_a"):
            assert getattr(ours[key], field) == getattr(theirs[key], field), (key, field)
        for spec in ("weight_quant", "act_quant"):
            assert (getattr(ours[key], spec).n_bits
                    == getattr(theirs[key], spec).n_bits), (key, spec)


@pytest.fixture(scope="module", params=[False, True], ids=["resnet18", "bottleneck"])
def calibrated(request):
    """(bottleneck, x, JAX's LSQ_paper state calibrated on x): the
    calibration runs in float32 whatever the engine, so one state serves
    all three."""
    bottleneck = request.param
    sd = convert.random_resnet_state_dict(SEED, STAGES, bottleneck=bottleneck,
                                          num_classes=CLASSES)
    x = np.random.RandomState(SEED).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jmodel = jax_model(dict(engine="parity", **MAIN), "LSQ_paper", bottleneck)
    return bottleneck, x, np_tree(jax_calibrated(jmodel, sd, x, bottleneck))


@pytest.mark.parametrize("engine", ["parity", "bf16", "fused"])
def test_lsq_paper_matches_jax(calibrated, engine, monkeypatch):
    """LSQ_paper from JAX's calibrated, baked state on each engine against
    the JAX engine of the same name: the logits within 1e-5 of the largest
    (LSQ_NOISE), top-1 identical; under 'fused' every 1x1 conv and the fc
    run qmatmul with input quant and nothing else launches a kernel;
    prepared bit-equal on bf16 and fused."""
    bottleneck, x, jvars = calibrated
    jmodel = jax_model(dict(engine=JAX_ENGINE[engine], **MAIN), "LSQ_paper",
                       bottleneck)
    with _pallas_gates_off():
        jbaked = np_tree(j_bake(jmodel, jvars, jnp.asarray(x)))
    jlogits = jax_logits(jmodel, jbaked, x, False)
    model = port_model(dict(engine=engine, **MAIN), "LSQ_paper", bottleneck)
    convert.load_jax_variables(model, jbaked)
    assert not model.tie_avgpool and not model.layer1_0_act.config.quant_a
    calls, plain = [], qmatmul.qmatmul_plain
    monkeypatch.setattr(qmatmul, "qmatmul_plain",
                        lambda *a, **k: calls.append(a[6]) or plain(*a, **k))
    with torch.no_grad():
        logits = model(t(x), mode="fixed", quant_w=False)
    out = logits.numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - jlogits).max() <= LSQ_NOISE * np.abs(jlogits).max()
    np.testing.assert_array_equal(out.argmax(-1), jlogits.argmax(-1))
    n_matmul = (2 * 4 if bottleneck else 0) + 3 + (1 if bottleneck else 0) + 1
    if engine == "fused":
        assert len(calls) == n_matmul and all(c.quantize_input for c in calls)
    else:
        assert not calls
    if engine != "parity":
        prepare_inference(model, torch.zeros(1, 32, 32, 3), quant_w=False)
        with torch.no_grad():
            assert torch.equal(model(t(x), mode="fixed", quant_w=False), logits)
