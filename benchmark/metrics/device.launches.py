"""device.launches (launches/batch): device operations (kernels, copies,
fills) a batch, from the profile's device records."""


def read(run):
    t = run.trace
    return None if t is None else t.launches / t.batches
