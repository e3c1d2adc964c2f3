"""The tiny ResNet pair of the port's ResNet tests: one random
torchvision-layout state dict from a seed, built as a QuantizedResNet in
the JAX package and in the port, and the JAX side calibrated and run.

STAGES = (1, 1, 1, 1) on 32x32 inputs at batch 2, bottleneck blocks by
default (ResNet-50's); the JAX ``pallas`` engine runs its kernels in
interpret mode and bakes inside nn/bake._pallas_gates_off() (ROADMAP.md
section C), as in tests/test_torch_resnet.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
from fp8_quantization_tpu.models import resnet as jresnet
from fp8_quantization_tpu.models.convert import convert_resnet, merge_variables
from fp8_quantization_tpu.nn.config import make_layer_config as j_make_config
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet_configs)
from fp8_quantization_tpu_torch.nn.config import make_layer_config

STAGES, CLASSES, SEED = (1, 1, 1, 1), 10, 11
MAIN = dict(per_channel_weights=True, fp8_mantissa_bits=4, fp8_set_maxval=True,
            weight_range_method="current_minmax", act_range_method="allminmax")
INT8_OQ = dict(qmethod="symmetric_uniform", act_qmethod="asymmetric_uniform",
               per_channel_weights=True, weight_range_method="current_minmax",
               act_range_method="allminmax")
INT8 = dict(INT8_OQ, quantize_input=True, int8_mxu=True)
# quantized layers of the (1, 1, 1, 1) bottleneck model: the stem, three
# convs a block, the four downsamples (layer1_0's at stride 1, 64 -> 256)
# and the fc
N_LAYERS = 1 + 3 * 4 + 4 + 1
JAX_ENGINE = {"parity": "parity", "bf16": "bf16", "fused": "pallas"}


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def t(x):
    return torch.from_numpy(np.array(x))


def inputs(seed=SEED, hw=32):
    sd = convert.random_resnet_state_dict(seed, STAGES, bottleneck=True,
                                          num_classes=CLASSES)
    x = np.random.RandomState(seed).standard_normal((2, hw, hw, 3)).astype(np.float32)
    return sd, x


def jax_model(config, setup=None, bottleneck=True, stages=STAGES):
    return jresnet.QuantizedResNet(
        stage_sizes=stages, bottleneck=bottleneck, num_classes=CLASSES,
        **jresnet.resnet_configs(j_make_config(**config), setup))


def port_model(config, setup=None, bottleneck=True, stages=STAGES):
    return QuantizedResNet(stages, bottleneck, CLASSES, **resnet_configs(
        make_layer_config(**config), setup))


def jax_calibrated(jmodel, sd, x, bottleneck=True, stages=STAGES):
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    params, stats = convert_resnet(sd, stages, bottleneck=bottleneck)
    return j_calibrate(jmodel, merge_variables(jvars, params, stats),
                       [jnp.asarray(x)])


def jax_logits(jmodel, jvars, x, quant_w):
    return np.asarray(jax.jit(lambda v, xx: jmodel.apply(
        v, xx, mode="fixed", quant_w=quant_w))(jvars, jnp.asarray(x)))


def one_grid_step(out, ref, maxval, mbits=4):
    """|out - ref| within one FP8 grid step of the larger magnitude, >= 98%
    exact, top-1 identical."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    step = np.maximum(np.abs(out), np.abs(ref)) * 2.0 ** -mbits + maxval * 2.0 ** -10
    assert np.all(np.abs(out - ref) <= step), np.abs(out - ref).max()
    assert (out == ref).mean() >= 0.98, (out == ref).mean()
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def fc_maxval(jvars):
    return float(jvars["quant"]["fc"]["act_q"]["q"]["maxval"])
