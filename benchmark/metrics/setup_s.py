"""Seconds from the process's start to the first timed request: the
dataset made and written, the program imported, its kernels built or
loaded, the resident load and the warm-up."""


def read(run):
    return run.setup_s
