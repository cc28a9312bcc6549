"""The host's share of a request, ms: the mean latency less the device's
busy time a request. In a closed loop of one client the card works only
inside requests, so the window's busy time is theirs. Traced run: its
latencies carry the profiler's cost."""


def read(run):
    if run.trace is None or not run.latencies_s:
        return None
    n = len(run.latencies_s)
    return (sum(run.latencies_s) - run.trace.busy_s) / n * 1e3
