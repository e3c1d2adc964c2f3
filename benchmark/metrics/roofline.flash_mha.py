"""roofline.flash_mha (%): the ViT's flash attention calls in the profile:
the sum of their least times (``benchmark/work/flash_mha.py``) over their
device time (``capture.kernel_roofline``).  Nothing where it did not run."""

from benchmark.capture import kernel_roofline


def read(run):
    return kernel_roofline(run, "flash_mha")
