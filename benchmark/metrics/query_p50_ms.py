"""The median latency of all the window's requests, ms (host clock)."""

from yardstick.measure import percentile


def read(run):
    return percentile(run.latencies_s, 50) * 1e3 if run.latencies_s else None
