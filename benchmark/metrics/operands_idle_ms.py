"""Device idle under the port's span resident.operands, ms a request:
ResidentDataset._box_table (a box request's header prefilter and every
file's query bounds in one vectorised step, utils/bounds_table.py) and
ResidentDataset._operands (a shard's rows of that table by one gather,
the operand tensors made and copied to the card). Idle in a torch operator
or runtime call inside the span keeps that call's name (trace.py names
each instant by the innermost host event). None without a trace, or where
the program has no such span."""

SPAN = "resident.operands"


def read(run):
    if run.trace is None or not run.latencies_s or SPAN not in run.trace.idle_by_host:
        return None
    return run.trace.idle_by_host[SPAN] / len(run.latencies_s) * 1e3
