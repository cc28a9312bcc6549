"""The 95th percentile latency of all the window's requests, ms (host
clock)."""

from yardstick.measure import percentile


def read(run):
    return percentile(run.latencies_s, 95) * 1e3 if run.latencies_s else None
