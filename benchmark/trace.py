"""Reading a ``torch.profiler`` trace of the profiled batches: device time
by kernel, the port's kernels apart from the composed work, launches, the
device's busy time and its idle gaps by what the host was doing.

The port's kernels are the ``__global__`` functions of its CUDA sources
(``fp8_quantization_tpu_torch/csrc``), read by name; a device operation is
the port's when one of those names appears in its own as a whole word.
The traced window is the ``bench.window`` range that the harness opens
around the profiled batches.
"""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path

import torch

WINDOW = "bench.window"
NAME_CHARS = 120            # a device operation's name as the breakdown keeps it
# prefixes that a kernel's name repeats and the breakdown drops, so that its
# functor fits in NAME_CHARS
_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "std::", "c10::")
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")


def port_kernel_names(csrc: Path) -> set:
    """The names of the port's CUDA kernels."""
    names = set()
    for p in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(p.read_text()))
    return names


def short_name(name: str) -> str:
    for noise in _NOISE:
        name = name.replace(noise, "")
    return name[:NAME_CHARS]


def _matches(name: str, kernels) -> bool:
    return any(re.search(rf"\b{k}\b", name) for k in kernels)


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _label_gaps(gaps, cpu_events):
    """The innermost host range open at each gap's start (the events of one
    thread nest), or ``host outside any op`` (the harness's own Python)."""
    events = sorted(cpu_events, key=lambda e: (e[1], -e[2]))
    labels, stack, i = [], [], 0
    for start, _ in gaps:
        while i < len(events) and events[i][1] <= start:
            stack.append(events[i])
            i += 1
        # the innermost open range is on top once the closed ones above it go
        while stack and stack[-1][2] <= start:
            stack.pop()
        labels.append(stack[-1][0] if stack else "host outside any op")
    return labels


class Trace:
    """What the metrics read of one profile of ``batches`` batches."""

    def __init__(self, prof, batches: int, port_names: set, work: dict):
        events = prof.events()
        window = next(e for e in events if e.name == WINDOW)
        w0, w1 = window.time_range.start, window.time_range.end
        device = [(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1))
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation
                  and e.time_range.end > w0 and e.time_range.start < w1]
        host = [(e.name, e.time_range.start, e.time_range.end) for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.thread == window.thread
                and e.time_range.start >= w0 and e.name != WINDOW]
        self.batches = batches
        self.window_s = (w1 - w0) / 1e6
        busy_us, merged = _union([(s, e) for _, s, e in device])
        self.busy_s = busy_us / 1e6
        self.launches = len(device)
        by_name = defaultdict(float)
        for name, s, e in device:
            by_name[name] += (e - s) / 1e6
        self.by_name = dict(by_name)
        self.port_s = sum(t for n, t in by_name.items() if _matches(n, port_names))
        self.nonport_s = sum(by_name.values()) - self.port_s
        self.kernel_s = {k: sum(t for n, t in by_name.items() if _matches(n, mod.KERNELS))
                         for k, mod in work.items()}
        gaps = [(a[1], b[0]) for a, b in zip([[None, w0]] + merged, merged + [[w1, None]])
                if b[0] > a[1]]
        totals = defaultdict(float)
        for (s, e), label in zip(gaps, _label_gaps(gaps, host)):
            totals[short_name(label)] += (e - s) / 1e6
        self.idle_gaps = sorted(totals.items(), key=lambda kv: -kv[1])

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[short_name(n), t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in self.idle_gaps[:top]]}
