"""Time of one call on a CUDA card, the one timing loop of chip_smoke.py's
phase 3 and of the A/B tools (packed_bench.py, density_bench.py).

    timer = KernelTimer(torch.device("cuda", 0), runs=25)
    median_ms, least_ms = timer.times(lambda: kernel(*args))
    device_ms, device_least_ms = timer.times(lambda: kernel(*args), device=True)

One warm-up call, then `runs` calls, each between two CUDA events on the
current stream with the card's 50 MB L2 flushed before it (a 256 MiB
buffer zeroed outside the events), so that every run reads its inputs
from device memory as a caller that streams them would. The median and the
least run are returned. Two readings:

  the call (default): the start event is recorded, then the host enqueues
    the call, so the window holds the host's time to enqueue it (a Python
    wrapper's checks, its ctypes call) wherever that is longer than the
    device work before it: the time a caller waits for the call.
  device=True: before the start event the stream is kept busy for about
    2 ms (torch.cuda._sleep, a device spin) while the host enqueues the
    call, so the window holds only the device work the call enqueues (its
    kernels, memsets and the wrapper's device-side allocations and fills).
    A call that waits for the device on the host (a read-back) is timed
    from the spin's end.

This file imports nothing of its package, so that a tool which times
another checkout's kernels (--root) can load it from its own directory.
"""

from __future__ import annotations

import statistics

import torch


# device cycles of the spin ahead of each device-time run: about 2.3 ms at
# 1.755 GHz
AHEAD_CYCLES = 4_000_000


class KernelTimer:
    def __init__(self, device, runs: int = 25):
        if runs < 1:
            raise ValueError(f"runs must be at least 1, got {runs}")
        self.runs = runs
        self._flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def times(self, fn, device: bool = False) -> tuple[float, float]:
        """(median, least) of the runs' times of fn(), in ms: of the call,
        or with device=True of its device work only."""
        fn()
        out = []
        for _ in range(self.runs):
            self._flush.zero_()
            if device:
                torch.cuda._sleep(AHEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out), min(out)
