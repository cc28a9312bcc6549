"""Device idle under the port's span engine.scan, ms a request: the
streamed count path's loop (engine._run_count), the main thread waiting on
the decode threads (parallel/pipeline.py), building each step's operands
(host.py), copying them (parallel/comm.py put, span engine.h2d), the
launches and the read-backs, the calls nested in it included
(Trace.idle_under). None without a trace, or where no request scanned
under the span (the resident path)."""

SPAN = "engine.scan"


def read(run):
    if run.trace is None or not run.latencies_s:
        return None
    idle = run.trace.idle_under(SPAN)
    return None if idle is None else idle / len(run.latencies_s) * 1e3
