"""setup.prepare_composed_s (s): host seconds of the prepare pass's composed
routes at its gated sites, the device synchronized at each edge: the
port's ``prepare.composed`` total (``utils/timing.totals``)."""

from fp8_quantization_tpu_torch.utils import timing


def read(run):
    totals = getattr(timing, "totals", None)
    return None if totals is None else totals().get("prepare.composed")
