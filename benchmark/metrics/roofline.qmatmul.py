"""roofline.qmatmul (%): the FP8 quant-matmul's calls in the profile: the
sum of their least times (``benchmark/work/qmatmul.py``) over their device
time.  Nothing where it did not run."""


def read(run):
    t, cap = run.trace, run.capture
    if t is None or cap is None or t.kernel_s.get("qmatmul", 0.0) <= 0:
        return None
    return 100.0 * cap.least_seconds("qmatmul") / t.kernel_s["qmatmul"]
