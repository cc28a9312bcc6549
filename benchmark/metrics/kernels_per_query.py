"""Kernel events on the device in the traced window, a request: the
launches of the wrappers in ops/predicate.py, ops/density.py and
ops/compact.py, and PyTorch's own (output fills)."""


def read(run):
    if run.trace is None or not run.latencies_s:
        return None
    return len(run.trace.kernels()) / len(run.latencies_s)
