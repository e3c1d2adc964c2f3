"""Timing and profiling utilities.

The counterpart of ``fp8_quantization_tpu/utils/timing.py``: ``time_cuda``
(the counterpart of ``time_jitted``: mean seconds per call, with the
device synchronized, since CUDA launches return before the work is done),
and the program's spans (``span``), where the JAX package wraps
``jax.profiler``.

On the card ``time_cuda`` times with CUDA events on the current stream.
For work on the CPU it takes the host clock: nothing there is
asynchronous.

A span names a stretch of the program on the timeline of whatever
``torch.profiler`` records it: while one records, ``span(name)`` opens
``torch.profiler.record_function(name)``, so the device operations the
host launches inside it sit under it, on the device's clock; while none
records it costs one read of the profiler's flag and calls no torch
function (a ``record_function`` alone costs microseconds even with no
profiler running).  ``spanned(name)`` is its decorator form.
``span(name, total=True)``, for set-up, also adds its host seconds to a
process-wide total (``totals()``); where CUDA is in use it synchronizes at
both edges, so that the device's work is counted in its own span.  Only
the outermost of nested totalled spans counts, so no second is counted
twice.  The names the program uses are listed in README.md.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.autograd import profiler as _profiler

_NOOP = contextlib.nullcontext()
_TOTALS: Dict[str, float] = defaultdict(float)
_open_totals = 0        # totalled spans open now (nested ones count nothing)


def span(name: str, total: bool = False):
    """A context manager that marks ``name`` on a recording profiler's
    timeline; with ``total`` it also adds its host seconds to
    ``totals()[name]`` (see the module docstring)."""
    if total:
        return _totalled(name)
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _profiler.record_function(name)


def spanned(name: str):
    """A decorator: ``span(name)`` around every call of the function."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def _totalled(name: str):
    global _open_totals
    outer = _open_totals == 0
    sync = outer and torch.cuda.is_initialized()
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _open_totals += 1
    try:
        with span(name):
            yield
        if sync:
            torch.cuda.synchronize()
    finally:
        _open_totals -= 1
        if outer:
            _TOTALS[name] += time.perf_counter() - t0


def totals() -> Dict[str, float]:
    """{name: host seconds} of every totalled span this process closed."""
    return dict(_TOTALS)


def _device_of(args, device) -> torch.device:
    """``device``, else that of the first tensor among ``args`` (tuples and
    lists looked into), else the CPU."""
    if device is not None:
        return torch.device(device)
    stack = list(args)
    while stack:
        a = stack.pop(0)
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (tuple, list)):
            stack[:0] = list(a)
    return torch.device("cpu")


def time_cuda(fn: Callable, *args, iters: int = 10, warmup: int = 3,
              device=None, **kwargs) -> float:
    """Mean seconds per call of ``fn(*args, **kwargs)`` over ``iters``
    calls after ``warmup`` untimed ones.  On a CUDA device (``device``, or
    that of the first tensor argument) the calls are timed by CUDA events
    and the device is synchronized; on the CPU by the host clock."""
    dev = _device_of(args, device)
    for _ in range(warmup):
        fn(*args, **kwargs)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
