"""Per-stage wall-clock timers and throughput reporting.

The reference reports only end-to-end `MiB in s (MiB/s)` (query/src/main.rs:309-316).
We keep that line for parity and add per-stage (read / decode / transfer /
kernel / merge) counters so the pipeline can be profiled without jax.profiler.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class StageTimer:
    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t
            self.counts[name] += 1
            self.bytes[name] += nbytes

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def report(self) -> str:
        lines = []
        for name in sorted(self.seconds):
            s = self.seconds[name]
            extra = ""
            if self.bytes[name]:
                extra = f", {self.bytes[name] / 1048576.0 / max(s, 1e-12):.1f} MiB/s"
            # count-less entries (durations accumulated directly into
            # .seconds, e.g. decode_cpu) would print a misleading "x0"
            cnt = f" x{self.counts[name]}" if self.counts[name] else ""
            lines.append(f"  {name}: {s:.3f}s{cnt}{extra}")
        for name in sorted(self.counts):
            if name not in self.seconds:
                lines.append(f"  {name}: {self.counts[name]}")
        return "\n".join(lines)


def throughput_line(total_file_size: int, elapsed_seconds: float) -> str:
    """The reference's closing report line (main.rs:313-316)."""
    mib = total_file_size / 1048576.0
    mibs = mib / max(elapsed_seconds, 1e-12)
    return f"Searched {mib:.2f} MiB in {elapsed_seconds:.2f}s (throughput: {mibs:.2f}MiB/s)"
