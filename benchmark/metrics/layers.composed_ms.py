"""layers.composed_ms (ms): device time a batch of every device operation
that is not one of the port's kernels (block tails, composed quantizers,
copies), from the profile."""


def read(run):
    t = run.trace
    return None if t is None else 1e3 * t.nonport_s / t.batches
