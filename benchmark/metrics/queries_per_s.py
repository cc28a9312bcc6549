"""Requests answered over the window's seconds (host clock)."""


def read(run):
    return len(run.latencies_s) / run.window_s if run.window_s > 0 else None
