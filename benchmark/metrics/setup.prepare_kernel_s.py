"""setup.prepare_kernel_s (s): host seconds of the prepare pass's kernel
routes at its gated sites, the device synchronized at each edge: the
port's ``prepare.kernel`` total (``utils/timing.totals``)."""

from fp8_quantization_tpu_torch.utils import timing


def read(run):
    totals = getattr(timing, "totals", None)
    return None if totals is None else totals().get("prepare.kernel")
