"""spans.forward_idle_ms (ms): the device's idle time a batch that falls
while the host is inside the port's ``forward`` span, from the spans' own
profile (``benchmark/spans.py``); the idle time outside it is the
harness's (the logits' copy, its loop)."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.found:
        return None
    return 1e3 * s.forward_idle_s / s.batches
