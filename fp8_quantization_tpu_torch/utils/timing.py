"""Timing and profiling utilities.

The counterpart of ``fp8_quantization_tpu/utils/timing.py``: ``Stopwatch``
(a wall-clock timer), ``time_cuda`` (the counterpart of ``time_jitted``:
mean seconds per call, with the device synchronized, since CUDA launches
return before the work is done) and ``trace`` (``torch.profiler`` around a
block, where JAX wraps ``jax.profiler``).

On the card ``time_cuda`` times with CUDA events on the current stream.
For work on the CPU it takes the host clock: nothing there is
asynchronous.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch


class Stopwatch:
    """Wall-clock timer, usable as a context manager (stopwatch.py:9-83)."""

    def __init__(self):
        self._start = None
        self.elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self):
        if self._start is not None:
            self.elapsed += time.perf_counter() - self._start
            self._start = None
        return self.elapsed

    def reset(self):
        self._start, self.elapsed = None, 0.0

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


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


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over a block, CPU and (where there is one) CUDA
    activity; yields the profiler.  With ``log_dir`` the trace is written
    there for TensorBoard's profiler plugin."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(log_dir) if log_dir else None
    with profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof
