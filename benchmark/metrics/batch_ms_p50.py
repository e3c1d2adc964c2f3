"""batch_ms_p50 (ms): the median of the window's batch latencies, each from
the forward's call until its logits are on the host (host clock)."""

import statistics


def read(run):
    lat = run.win["latencies_s"]
    return 1e3 * statistics.median(lat) if lat else None
