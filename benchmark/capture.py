"""The shape recorder: while active, every call of the port's kernel
wrappers that a work function (``benchmark/work/<kernel>.py``) covers is
counted by its shapes and config, and its work (bytes, operations,
datapath) is taken once per distinct call.  A copy of chip_smoke.py's
``Capture``, counting every call instead of keeping the operands.

The wrappers are replaced on their modules, where the port's layers look
them up; their launch counters (attributes of the wrapper that its launch
increments through the module's name) are carried over and back.
"""

from __future__ import annotations

import importlib

import torch

from benchmark import peaks

# the launch counters a wrapper keeps (ops/kernels/__init__.py)
COUNTS = ("launches", "s8_launches", "sm90_launches")


def _key(args, kwargs):
    parts = tuple((tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
                  else a for a in args)
    return parts, repr(kwargs.get("cfg")), kwargs.get("sm_scale")


class Capture:
    """``calls[kernel][key] = [bytes, operations, datapath, uses]``."""

    def __init__(self, work: dict):
        self.work = work
        self.calls: dict = {}
        self._saved = []

    def __enter__(self):
        for kname, mod in self.work.items():
            owner = importlib.import_module(mod.WRAPPER[0])
            fn = getattr(owner, mod.WRAPPER[1])
            self._saved.append((owner, mod.WRAPPER[1], fn))

            def record(*args, _fn=fn, _k=kname, _work=mod.work, **kw):
                calls = self.calls.setdefault(_k, {})
                key = _key(args, kw)
                if key not in calls:
                    calls[key] = [*_work(args, kw), 0]
                calls[key][3] += 1
                return _fn(*args, **kw)

            for count in COUNTS:
                if hasattr(fn, count):
                    setattr(record, count, getattr(fn, count))
            setattr(owner, mod.WRAPPER[1], record)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            for count in COUNTS:
                if hasattr(fn, count):
                    setattr(fn, count, getattr(getattr(owner, attr), count))
            setattr(owner, attr, fn)
        self._saved = []

    def least_seconds(self, kname: str) -> float:
        """The least time of every recorded call of ``kname`` (peaks.py)."""
        return sum(uses * peaks.least_seconds(b, ops, dp)
                   for b, ops, dp, uses in self.calls.get(kname, {}).values())


def kernel_roofline(run, kname: str):
    """A kernel's share of its roofline over a traced run (%): the least
    time of its recorded calls over its device time; None where it did
    not run."""
    t, cap = run.trace, run.capture
    if t is None or cap is None or t.kernel_s.get(kname, 0.0) <= 0:
        return None
    return 100.0 * cap.least_seconds(kname) / t.kernel_s[kname]
