"""Device idle under the port's span serve.parse, ms a request: the
request dict made into its QueryPlan (serve.handle_request). Idle in a
torch operator or runtime call inside the span keeps that call's name
(trace.py names each instant by the innermost host event). None without a
trace, or where the program has no such span."""

SPAN = "serve.parse"


def read(run):
    if run.trace is None or not run.latencies_s or SPAN not in run.trace.idle_by_host:
        return None
    return run.trace.idle_by_host[SPAN] / len(run.latencies_s) * 1e3
