"""The port's own spans and route counter, read from one more profile.

The port marks its forward with spans (``fp8_quantization_tpu_torch/utils/
timing.span``): ``forward`` around the model's call, ``layer`` around each
quantized layer, ``kernel.<name>`` around each call of a port kernel,
``quantizer`` around each fake-quant that runs composed, ``residual``
around each block's residual add (and relu).  A span is a
``record_function`` range while a profiler records, so each device
operation belongs to the innermost port span among the ancestors of the
host operation that launched it (torch.profiler's own link, which
``key_averages`` reads too); the profiled range's idle gaps are set
against the host's time inside ``forward``.

``of(run)`` profiles ``harness.PROFILE_BATCHES`` more batches the first
time a reader asks, on the card only (None elsewhere), with the port's
counters reset first, and keeps the result on the run.  A program without
the spans gives nothing to read (``found`` false), without
``route_counts`` no route count.
"""

from __future__ import annotations

import torch

from benchmark import harness
from benchmark.trace import _union

WINDOW = "bench.spans"
SPANS = ("forward", "layer", "quantizer", "residual")
KERNEL = "kernel."
OUTSIDE = "outside"          # the time of operations under no port span


def is_port_span(name: str) -> bool:
    return name in SPANS or name.startswith(KERNEL)


def innermost(event) -> str:
    """The innermost port span among ``event`` and its host ancestors, or
    ``OUTSIDE``."""
    while event is not None:
        if is_port_span(event.name):
            return event.name
        event = event.cpu_parent
    return OUTSIDE


def attribute(events, on_device: bool = True) -> dict:
    """{innermost port span: seconds} of the host operations in the
    ``WINDOW`` range: with ``on_device`` the device time each one launched
    (the profiler's link from a device operation to the host operation it
    came from; user annotations left out), else each one's own host time
    (its children's left out), which tests the rule on a CPU profile."""
    window = next(e for e in events if e.name == WINDOW)
    w0, w1 = window.time_range.start, window.time_range.end
    annotations = {e.name for e in events if e.is_user_annotation}
    out: dict = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CPU or e is window
                or e.thread != window.thread
                or not w0 <= e.time_range.start < w1):
            continue
        if on_device:
            us = sum(k.duration for k in e.kernels if k.name not in annotations)
        else:
            us = 0.0 if is_port_span(e.name) else e.self_cpu_time_total
        if us:
            span = innermost(e)
            out[span] = out.get(span, 0.0) + us / 1e6
    return out


def device_intervals(events, w0: float, w1: float) -> list:
    """(start, end) of each device operation inside [w0, w1] (us), clipped
    to it; user annotations left out."""
    return [(max(e.time_range.start, w0), min(e.time_range.end, w1))
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation
            and e.time_range.end > w0 and e.time_range.start < w1]


def gaps(busy, w0: float, w1: float) -> list:
    """The stretches of [w0, w1] that the merged intervals ``busy``
    (``trace._union``) leave free."""
    edges = [[None, w0]] + busy + [[w1, None]]
    return [(a[1], b[0]) for a, b in zip(edges, edges[1:]) if b[0] > a[1]]


def overlap(xs, ys) -> float:
    """Total length of the intersection of two sets of merged intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


class Spans:
    """What the span metrics read of one profile of ``batches`` batches:
    ``seconds`` by innermost port span, the device's busy time, its idle
    time inside ``forward``, and the composed routes counted."""

    def __init__(self, events, batches: int, routes=None):
        window = next(e for e in events if e.name == WINDOW)
        w0, w1 = window.time_range.start, window.time_range.end
        self.batches, self.routes = batches, routes
        self.seconds = attribute(events)
        busy_us, busy = _union(device_intervals(events, w0, w1))
        self.busy_s = busy_us / 1e6
        _, forward = _union([(e.time_range.start, e.time_range.end)
                             for e in events if e.name == "forward"
                             and e.device_type == torch.autograd.DeviceType.CPU
                             and e.thread == window.thread
                             and w0 <= e.time_range.start < w1])
        self.found = bool(forward)
        self.forward_idle_s = overlap(
            [list(g) for g in gaps(busy, w0, w1)], forward) / 1e6

    def per_batch_ms(self, span: str):
        """Device ms a batch under ``span``; None where the program has no
        spans."""
        if not self.found:
            return None
        return 1e3 * self.seconds.get(span, 0.0) / self.batches


def _profile(run) -> Spans:
    from torch.profiler import ProfilerActivity, profile, record_function

    from fp8_quantization_tpu_torch.ops import kernels
    n = harness.PROFILE_BATCHES
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as the window and the harness's profile
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for i in range(n):
                    run.forward(run.pool[i % len(run.pool)]).cpu()
                torch.cuda.synchronize()
    finally:
        torch.set_num_threads(threads)
    counts = getattr(kernels, "route_counts", None)
    return Spans(prof.events(), n,
                 None if counts is None else counts()["composed_routes"])


def of(run):
    """The run's ``Spans``, profiled the first time it is asked for; None
    off the card."""
    if "span_profile" not in vars(run):
        on_card = torch.device(run.device).type == "cuda"
        run.span_profile = _profile(run) if on_card else None
    return run.span_profile
