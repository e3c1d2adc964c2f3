"""kernels.roofline (%): every call of the port's kernels in the profile:
the sum of each call's least time (``benchmark/work/<kernel>.py``: bytes
at the memory's rate or operations at the datapath's peak, whichever is
longer) over the sum of the kernels' device time.  Nothing where a port
kernel ran that no work function covers, or none ran."""


def read(run):
    t, cap = run.trace, run.capture
    if t is None or cap is None:
        return None
    covered = sum(t.kernel_s.values())
    if covered <= 0 or abs(covered - t.port_s) > 1e-9 * max(1.0, t.port_s):
        return None
    least = sum(cap.least_seconds(k) for k in t.kernel_s)
    return 100.0 * least / covered
