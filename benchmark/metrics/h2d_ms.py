"""Device time of the traced window's host-to-device copies (the
profiler's "Memcpy HtoD" events), ms a request: a streamed step's
operands, packed (host.py) or raw, as parallel/comm.py put copies them
from pageable memory. None without a trace, or where the window copied
nothing to the card."""


def read(run):
    if run.trace is None or not run.latencies_s:
        return None
    copies = [e["dur"] for e in run.trace.device
              if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    return sum(copies) / 1e3 / len(run.latencies_s) if copies else None
