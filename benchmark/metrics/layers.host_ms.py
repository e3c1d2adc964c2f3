"""layers.host_ms (ms): the host's time to issue one forward onto an idle
device: the device synchronized, then the host clock from the call to its
return; the mean of several forwards, at least 0.3 s in all."""


def read(run):
    s = run.host_issue_s
    return 1e3 * sum(s) / len(s) if s else None
