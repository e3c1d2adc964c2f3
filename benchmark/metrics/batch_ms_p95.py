"""batch_ms_p95 (ms): the 95th percentile (nearest rank) of the window's
batch latencies, each from the forward's call until its logits are on the
host (host clock)."""

from benchmark.harness import p95


def read(run):
    lat = run.win["latencies_s"]
    return 1e3 * p95(lat) if lat else None
