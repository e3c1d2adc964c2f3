"""spans.residual_ms (ms): device time a batch of the operations under the
port's ``residual`` span (each block's residual add and relu), from the
spans' own profile (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.per_batch_ms("residual")
