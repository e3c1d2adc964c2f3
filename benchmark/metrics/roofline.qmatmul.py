"""roofline.qmatmul (%): the FP8 quant-matmul's calls in the profile: the
sum of their least times (``benchmark/work/qmatmul.py``) over their device
time (``capture.kernel_roofline``).  Nothing where it did not run."""

from benchmark.capture import kernel_roofline


def read(run):
    return kernel_roofline(run, "qmatmul")
