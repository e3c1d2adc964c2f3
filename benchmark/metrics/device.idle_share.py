"""device.idle_share (%): 1 - the device's busy time (the union of its
operations' intervals) over the profiled window's wall time."""


def read(run):
    t = run.trace
    return None if t is None or t.window_s <= 0 else 100.0 * (1.0 - t.busy_s / t.window_s)
