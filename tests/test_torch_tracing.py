"""The port's tracing on the CPU (utils/timing.py): spans on a profiler's
timeline and nothing without one, the set-up totals of the prepare pass,
and the composed-route counter beside the launch counters
(ops/kernels/__init__.py).

The model is ResNet-50's shape cut to one bottleneck block a stage
(stage_sizes (1, 1, 1, 1)) on 32x32 inputs at batch 2, FP8 on the fused
engine, calibrated, baked and prepared as the deploy path does; on the CPU
its kernels run their plain versions behind the same wrappers.
"""

import copy

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.models.resnet import (
    QuantizedResNet, resnet_configs)
from fp8_quantization_tpu_torch.nn.bake import bake_weights, prepare_inference
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.layers import QuantConv, QuantizedLayerBase
from fp8_quantization_tpu_torch.ops import kernels
from fp8_quantization_tpu_torch.ops.kernels import autotune
from fp8_quantization_tpu_torch.utils import timing

torch.set_num_threads(1)

STAGES, CLASSES, SEED = (1, 1, 1, 1), 10, 5
MAIN = dict(per_channel_weights=True, fp8_mantissa_bits=4, fp8_set_maxval=True,
            weight_range_method="current_minmax", act_range_method="allminmax")
# the stem, 3 convs and a downsample a block, the fc
N_LAYERS = 1 + 4 * 4 + 1
SPANS = ("forward", "layer", "quantizer", "residual")


def _model():
    model = QuantizedResNet(STAGES, True, CLASSES, **resnet_configs(
        make_layer_config(engine="fused", **MAIN), None))
    convert.load_torchvision_resnet(model, convert.random_resnet_state_dict(
        SEED, STAGES, bottleneck=True, num_classes=CLASSES))
    return model


@pytest.fixture(scope="module")
def deployed():
    """(model, x): calibrated, baked and prepared under the gate's
    ``auto`` mode (on the CPU: every gated site takes its kernel)."""
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(SEED))
    model = _model()
    calibrate(model, [x], device="cpu")
    bake_weights(model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(autotune, "MODE", "auto")
        prepare_inference(model, torch.zeros((1, 32, 32, 3)), quant_w=False)
    return model, x


def _forward(model, x):
    with torch.no_grad():
        return model(x, mode="fixed", quant_w=False)


def _ancestors(event):
    names = []
    event = event.cpu_parent
    while event is not None:
        names.append(event.name)
        event = event.cpu_parent
    return names


def test_span_without_profiler_calls_no_torch_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    first, second = timing.span("layer"), timing.span("forward")
    assert first is second          # one shared no-op
    with first:
        pass

    @timing.spanned("quantizer")
    def f(a, b=1):
        return a + b

    assert f(1, b=2) == 3
    # under a profiler the span opens record_function: the patch bites
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function called"):
            timing.span("layer")


def test_forward_ops_fall_under_forward_and_layer_spans(deployed):
    """Every aten op of the fixed-mode forward is inside ``forward``; every
    op a quantized layer launches (marked by hooks around each layer's
    call) is inside its ``layer``; ``kernel.*``, ``quantizer`` and
    ``residual`` each appear."""
    model, x = deployed
    stack = []

    def enter(module, args):
        rf = autograd_profiler.record_function("test.layer_call")
        rf.__enter__()
        stack.append(rf)

    def leave(module, args, out):
        stack.pop().__exit__(None, None, None)

    layers = [m for m in model.modules() if isinstance(m, QuantizedLayerBase)]
    assert len(layers) == N_LAYERS
    hooks = [h for m in layers for h in (m.register_forward_pre_hook(enter),
                                         m.register_forward_hook(leave))]
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _forward(model, x)
    finally:
        for h in hooks:
            h.remove()
    events = prof.events()
    names = {e.name for e in events}
    assert set(SPANS) <= names
    assert {"kernel.qstem", "kernel.qconv3x3", "kernel.qmatmul"} <= names
    ops = [e for e in events if e.name.startswith(("aten::", "fp8tpu::"))]
    assert ops
    for e in ops:
        up = _ancestors(e)
        assert "forward" in up, e.name
        if "test.layer_call" in up:
            # the layer's span lies between the op and the hook's range
            assert "layer" in up[:up.index("test.layer_call")], e.name
    for e in events:
        if e.name.startswith("fp8tpu::"):
            up = _ancestors(e)
            assert up[0].startswith("kernel.") and "layer" in up, e.name
    assert sum(e.name == "test.layer_call" for e in events) == N_LAYERS - 1
    # the stem's kernel route runs from the model, inside the stem's span
    assert sum(e.name == "layer" for e in events) == N_LAYERS


def test_logits_bit_identical_with_spans_on_and_off(deployed):
    model, x = deployed
    off = _forward(model, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _forward(model, x)
    assert any(e.name == "forward" for e in prof.events())
    assert torch.equal(off, on)


def test_composed_routes_counts_layers_sent_composed(deployed, monkeypatch):
    model, x = deployed
    kernels.reset_launch_counts()
    _forward(model, x)
    assert kernels.route_counts() == {"composed_routes": 0}
    # gate mode never: every quantized layer takes its composed product
    monkeypatch.setattr(autotune, "MODE", "never")
    _forward(model, x)
    assert kernels.route_counts() == {"composed_routes": N_LAYERS}
    kernels.reset_launch_counts()
    assert kernels.route_counts() == {"composed_routes": 0}
    assert all(n == 0 for n in kernels.launch_counts().values())
    # a shape no kernel takes (the 3x3 kernel needs Cin % 8 == 0), baked
    monkeypatch.setattr(autotune, "MODE", "auto")
    conv = QuantConv(3, 8, 3, 1, 1, bn=True, config=make_layer_config(
        engine="fused", **MAIN))
    xs = torch.randn((1, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    calibrate(conv, [xs], device="cpu")
    bake_weights(conv)
    kernels.reset_launch_counts()
    with torch.no_grad():
        conv(xs, mode="fixed", quant_w=False)
    assert kernels.route_counts() == {"composed_routes": 1}


def test_prepare_pass_totals_both_routes(deployed, monkeypatch):
    model, _ = deployed
    monkeypatch.setattr(autotune, "MODE", "auto")
    before = timing.totals()
    prepare_inference(copy.deepcopy(model), torch.zeros((1, 32, 32, 3)),
                      quant_w=False)
    after = timing.totals()
    for name in ("prepare.composed", "prepare.kernel"):
        assert after[name] > before.get(name, 0.0)


def test_nested_totals_count_the_outermost_only():
    before = timing.totals()
    with timing.span("test.outer", total=True):
        with timing.span("test.inner", total=True):
            pass
    after = timing.totals()
    assert after["test.outer"] > before.get("test.outer", 0.0)
    assert after.get("test.inner", 0.0) == before.get("test.inner", 0.0)
