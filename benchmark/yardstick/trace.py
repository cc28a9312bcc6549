"""Reading a torch.profiler Chrome trace: the device's busy time, its idle
gaps and what the host did in them, kernel time by name, and whether the
trace holds every kernel that was launched.

Times are in microseconds, as the trace has them. The interval union is
the arithmetic of adhoc_queries_pointclouds_torch/tools/density_profile.py
busy_seconds, copied so that the yardstick does not move with the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from pathlib import Path

# what runs on the device; "gpu_user_annotation" spans mirror host spans
# and are no operation
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW_SPAN = "bench.window"
# the share of the window's launches that may lack their kernel's record
# before the trace counts as short and is not read: CUPTI drops a few
# records of some 160,000 a window now and then (6 in one run, none in
# most; PERF.md), which moves busy_s by less than a thousandth, while a
# profiler session opened late in a process loses most of them
LOST_SHARE = 1e-3


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def merged(spans) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(spans, t0: float, t1: float) -> list[tuple[float, float]]:
    """The parts of [t0, t1] that no interval covers."""
    out, at = [], t0
    for s, e in merged((max(s, t0), min(e, t1)) for s, e in spans if e > t0 and s < t1):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return out


def flatten(events) -> list[tuple[float, float, str]]:
    """Nested host events of one thread -> disjoint (start, end, name)
    segments, each instant named by the innermost event open then."""
    segs: list[tuple[float, float, str]] = []
    stack: list[tuple[float, str]] = []  # (end, name) of the open events
    at = float("-inf")

    def emit_until(t: float) -> None:
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > at:
                segs.append((at, end, name))
                at = end
        if stack and t > at:
            segs.append((at, t, stack[-1][1]))
        at = max(at, t)

    for s, e, name in sorted(events, key=lambda ev: (ev[0], -ev[1])):
        emit_until(s)
        stack.append((e, name))
    emit_until(float("inf"))
    return [seg for seg in segs if seg[1] > seg[0]]


def attribute(gap_spans, segments) -> dict[str, float]:
    """Seconds of the gaps by the name of the host segment over them;
    time in no segment is "host: harness loop, outside any traced span"."""
    starts = [s for s, _, _ in segments]
    out: dict[str, float] = {}
    for g0, g1 in gap_spans:
        covered = 0.0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(segments) and segments[i][0] < g1:
            s, e, name = segments[i]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part / 1e6
                covered += part
            i += 1
        if g1 - g0 - covered > 0:
            key = "host: harness loop, outside any traced span"
            out[key] = out.get(key, 0.0) + (g1 - g0 - covered) / 1e6
    return out


@dataclasses.dataclass
class Trace:
    """The traced window of one run."""

    t0: float
    t1: float
    device: list[dict]  # device events inside the window
    launches: int  # runtime kernel launches inside the window
    unmatched: int  # of those, launches whose kernel the trace lacks
    idle_by_host: dict[str, float]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length((e["ts"], e["ts"] + e["dur"]) for e in self.device) / 1e6

    @property
    def complete(self) -> bool:
        return self.unmatched <= LOST_SHARE * self.launches

    def kernels(self, part: str | None = None) -> list[dict]:
        """Kernel events, those whose name holds part where given."""
        return [e for e in self.device if e["cat"] == "kernel"
                and (part is None or part in e["name"])]

    def kernel_s(self, part: str) -> float:
        return sum(e["dur"] for e in self.kernels(part)) / 1e6

    def by_name(self) -> list[tuple[str, float]]:
        """Device seconds by operation name, largest first."""
        out: dict[str, float] = {}
        for e in self.device:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
        return sorted(out.items(), key=lambda kv: -kv[1])


def _is_launch(e: dict) -> bool:
    return e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", "")


def read(path: Path) -> Trace:
    """The window of a Chrome trace that torch.profiler exported: the
    span named WINDOW_SPAN marks it."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "ts" in e and "dur" in e]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW_SPAN]
    if not spans:
        raise ValueError(f"no {WINDOW_SPAN} span in {path}")
    win = spans[0]
    t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])

    def inside(e):
        return e["ts"] >= t0 and e["ts"] + e["dur"] <= t1

    device = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    # a launch near an edge of the window may run past it: it has its record
    kernel_ids = {e.get("args", {}).get("correlation") for e in events
                  if e.get("cat") == "kernel"}
    launched = [e for e in events if _is_launch(e) and inside(e)]
    unmatched = sum(e.get("args", {}).get("correlation") not in kernel_ids for e in launched)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e.get("tid") == win.get("tid")
            and e.get("pid") == win.get("pid") and e is not win
            and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    idle = attribute(gaps(((e["ts"], e["ts"] + e["dur"]) for e in device), t0, t1),
                     flatten(host))
    return Trace(t0, t1, device, len(launched), unmatched, idle)
