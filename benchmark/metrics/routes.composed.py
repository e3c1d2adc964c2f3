"""routes.composed (routes/batch): calls of a quantized layer's composed
product a batch (the port's ``composed_routes`` counter, read through
``route_counts``) over the spans' own profiled batches
(``benchmark/spans.py``): the layers no kernel took."""

from benchmark import spans


def read(run):
    s = spans.of(run)
    if s is None or s.routes is None:
        return None
    return s.routes / s.batches
