"""Device idle under the port's span engine.open, ms a request: the
streamed path's files opened and their headers parsed (engine.run_query's
"open" stage, utils/timing.py), the calls nested in it included
(Trace.idle_under). None without a trace, or where no request opened a
file under the span (the resident path)."""

SPAN = "engine.open"


def read(run):
    if run.trace is None or not run.latencies_s:
        return None
    idle = run.trace.idle_under(SPAN)
    return None if idle is None else idle / len(run.latencies_s) * 1e3
