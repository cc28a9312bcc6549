"""Device idle under the port's span resident.readback, ms a request:
every shard's counts read to the host and summed (ResidentDataset.count).
Idle in a torch operator or runtime call inside the span keeps that
call's name (trace.py names each instant by the innermost host event).
None without a trace, or where the program has no such span."""

SPAN = "resident.readback"


def read(run):
    if run.trace is None or not run.latencies_s or SPAN not in run.trace.idle_by_host:
        return None
    return run.trace.idle_by_host[SPAN] / len(run.latencies_s) * 1e3
