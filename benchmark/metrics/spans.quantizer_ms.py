"""spans.quantizer_ms (ms): device time a batch of the operations under the
port's ``quantizer`` span and no deeper one (every fake-quant that runs
composed: the block activation quantizers with the store of their norms,
the tied avg-pool quantizer), from the spans' own profile
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.per_batch_ms("quantizer")
