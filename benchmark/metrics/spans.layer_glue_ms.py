"""spans.layer_glue_ms (ms): device time a batch of the operations under a
quantized layer's ``layer`` span and no deeper port span (not a
``kernel.*`` call, not a ``quantizer``): the casts, copies and layouts
around each kernel call and the composed routes' own work, from the spans'
own profile (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.per_batch_ms("layer")
