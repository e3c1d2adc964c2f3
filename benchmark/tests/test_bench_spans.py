"""The span metrics' helper (``benchmark/spans.py``) on the CPU: the
innermost-span rule on a hand-built profile, the attribution of a tiny
ResNet-50 forward with host time in place of device time (its parts sum to
the whole), the device attribution and the idle-overlap arithmetic on
synthetic events, and nothing to read off the card."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness, spans
from benchmark.tests.tiny import tiny_cell

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _cpu_profile(body):
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(spans.WINDOW):
            body()
    return prof.events()


def test_innermost_span_rule():
    def body():
        with record_function("forward"):
            torch.zeros(4)
            with record_function("layer"):
                torch.ones(4)
                with record_function("kernel.qmatmul"):
                    torch.arange(4)
                with record_function("quantizer"):
                    torch.eye(4)
                with record_function("not.a.port.span"):
                    torch.linspace(0, 1, 4)
            with record_function("residual"):
                torch.full((4,), 2.0)
        torch.empty(4).fill_(1)

    events = _cpu_profile(body)
    where = {e.name: spans.innermost(e) for e in events
             if e.name.startswith("aten::") and e.cpu_parent is not None
             and not e.cpu_parent.name.startswith("aten::")}
    assert where == {"aten::zeros": "forward", "aten::ones": "layer",
                     "aten::arange": "kernel.qmatmul", "aten::eye": "quantizer",
                     "aten::linspace": "layer", "aten::full": "residual",
                     "aten::empty": spans.OUTSIDE, "aten::fill_": spans.OUTSIDE}
    seconds = spans.attribute(events, on_device=False)
    assert set(seconds) == {"forward", "layer", "kernel.qmatmul", "quantizer",
                            "residual", spans.OUTSIDE}


@pytest.fixture(scope="module")
def tiny():
    """The ResNet cell's run at the tests' CPU size, set up."""
    harness.cache_environment("cpu-tests")
    run = harness.Run(tiny_cell("r50_fp8.b256"), 2 ** 33 + 7, 0.5, "cpu")
    run.setup()
    return run


def test_tiny_forward_parts_sum_to_the_whole(tiny):
    events = _cpu_profile(lambda: tiny.forward(tiny.pool[0]))
    seconds = spans.attribute(events, on_device=False)
    assert {"forward", "layer", "quantizer", "residual", "kernel.qmatmul",
            "kernel.qconv3x3", "kernel.qstem"} <= set(seconds)
    window = next(e for e in events if e.name == spans.WINDOW)
    # every host operation's own time, the ranges' own left out
    whole = (window.cpu_time_total - window.self_cpu_time_total
             - sum(e.self_cpu_time_total for e in events
                   if spans.is_port_span(e.name)))
    assert sum(seconds.values()) * 1e6 == pytest.approx(whole, rel=1e-9)
    # the model's call is one forward span: nothing of it lies outside
    assert seconds.get(spans.OUTSIDE, 0.0) == 0.0


def test_off_the_card_nothing_to_read(tiny):
    assert spans.of(tiny) is None
    for name in ("spans.quantizer_ms", "spans.residual_ms", "spans.layer_glue_ms",
                 "spans.forward_idle_ms", "routes.composed"):
        assert harness.metric_value(name, tiny) is None
    for name in ("setup.prepare_composed_s", "setup.prepare_kernel_s"):
        assert harness.metric_value(name, tiny) > 0


def _event(name, start, end, device=CPU, parent=None, kernels=(),
           annotation=False):
    """An event as torch.profiler's FunctionEvent has it; ``kernels`` the
    (name, microseconds) of the device operations it launched."""
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=device, cpu_parent=parent, thread=1,
        kernels=[SimpleNamespace(name=k, device=0, duration=us) for k, us in kernels],
        is_user_annotation=annotation, self_cpu_time_total=end - start)


def test_device_attribution_and_idle_overlap():
    """Host ranges (us): the window [0, 100]; forward [0, 40] and
    [50, 90]; device work [5, 20] (a kernel), [25, 35] (a quantizer),
    [55, 85] (layer glue), [92, 95] (the logits' copy, outside)."""
    window = _event(spans.WINDOW, 0, 100, annotation=True)
    fwd1 = _event("forward", 0, 40, parent=window, annotation=True)
    fwd2 = _event("forward", 50, 90, parent=window, annotation=True)
    layer1 = _event("layer", 1, 30, parent=fwd1, annotation=True)
    kern = _event("kernel.qmatmul", 2, 10, parent=layer1, annotation=True)
    op_k = _event("fp8tpu::qmatmul", 3, 9, parent=kern, kernels=[("k", 15)])
    quant = _event("quantizer", 20, 38, parent=fwd1, annotation=True)
    op_q = _event("aten::clamp", 21, 24, parent=quant, kernels=[("q", 10)])
    # a device-side annotation linked to its host range is no work
    layer2 = _event("layer", 51, 80, parent=fwd2, annotation=True,
                    kernels=[("layer", 30)])
    op_g = _event("aten::copy_", 52, 53, parent=layer2, kernels=[("g", 30)])
    op_c = _event("aten::copy_", 91, 96, parent=window, kernels=[("c", 3)])
    device = [_event("k", 5, 20, CUDA), _event("q", 25, 35, CUDA),
              _event("g", 55, 85, CUDA), _event("c", 92, 95, CUDA),
              _event("layer", 55, 85, CUDA, annotation=True)]
    events = [window, fwd1, fwd2, layer1, kern, op_k, quant, op_q, layer2, op_g,
              op_c, *device]
    s = spans.Spans(events, batches=2, routes=4)
    assert s.found
    assert s.seconds == pytest.approx({"kernel.qmatmul": 15e-6, "quantizer": 10e-6,
                                       "layer": 30e-6, spans.OUTSIDE: 3e-6})
    assert s.busy_s == pytest.approx(58e-6)
    assert sum(s.seconds.values()) == pytest.approx(s.busy_s)
    # idle [0, 5], [20, 25], [35, 55], [85, 92], [95, 100]; inside forward
    # 5 + 5 + (5 + 5) + 5
    assert s.forward_idle_s == pytest.approx(25e-6)
    assert s.per_batch_ms("layer") == pytest.approx(1e3 * 15e-6)
    assert harness.metric_value("routes.composed", SimpleNamespace(span_profile=s)) == 2


def test_interval_arithmetic():
    busy = [[0, 2], [5, 13]]
    assert spans.gaps(busy, 0, 20) == [(2, 5), (13, 20)]
    assert spans.gaps(busy, 0, 13) == [(2, 5)]
    assert spans.gaps([], 0, 3) == [(0, 3)]
    assert spans.overlap([[0, 4], [6, 10]], [[2, 7], [9, 20]]) == 2 + 1 + 1
    assert spans.overlap([], [[0, 1]]) == 0.0


def test_program_without_spans_reports_nothing():
    window = _event(spans.WINDOW, 0, 10, annotation=True)
    op = _event("aten::mul", 1, 2, parent=window, kernels=[("m", 2)])
    s = spans.Spans([window, op, _event("m", 2, 4, CUDA)], batches=1)
    assert not s.found and s.per_batch_ms("quantizer") is None
    run = SimpleNamespace(span_profile=s)
    for name in ("spans.quantizer_ms", "spans.forward_idle_ms", "routes.composed"):
        assert harness.metric_value(name, run) is None
