"""Streaming-memory validation of the port at scale (the counterpart of the
root tools/memcheck.py).

Runs a worst-case collect (a box matching EVERY point, write-back + LAS
output) over a dataset far larger than any single block, on the device that
--device names, and reports peak anonymous RSS. The claim under test: host
memory stays O(block + spool cap), never O(hits) — the reference buffers all
hits in RAM (collect_points.rs:14-44), which for the paper's XL query
(~2.6 B points) cannot work.

    python -m adhoc_queries_pointclouds_torch.tools.memcheck [--points N]
        [--files K] [--spool-mb M] [--device cuda|cpu]

--device defaults to cuda; cuda without a card raises before any data is
written. The device is brought up before the baseline reading, so the
CUDA context's host memory is not counted as the query's. Exits 0 and
prints "STREAMING OK" when the peak stays within the budget.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

# The design working set is a CONSTANT w.r.t. hit count:
#   prefetch window (12 blocks x ~24 MiB of columns)
# + in-flight device steps (3 x rows x block x 12 B operands)
# + spool RAM cap + gather chunks + allocator slack  ~= 1.0-1.4 GiB.
# Streaming holds iff the peak stays within that constant budget (and
# therefore below materializing the hits once they exceed it).
BUDGET_MIB = 2048.0


def _kib(line: str) -> int:
    return int(line.split()[1]) * 1024


def anon_bytes() -> int | None:
    """Anonymous resident memory of this process in bytes: RssAnon of
    /proc/self/status, or where a kernel gives no RssAnon line, the sum of
    the "Anonymous:" lines of /proc/self/smaps_rollup (else smaps); None
    where neither exists. Only this part is the engine's: VmRSS also
    counts mmap'd file pages (the dataset itself, reclaimable), which would
    mask or fake a leak."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon:"):
                return _kib(line)
    for name in ("/proc/self/smaps_rollup", "/proc/self/smaps"):
        try:
            with open(name) as f:
                lines = [line for line in f if line.startswith("Anonymous:")]
        except OSError:
            continue
        if lines:
            return sum(_kib(line) for line in lines)
    return None


def vmrss_bytes() -> int:
    """VmRSS of this process in bytes: anonymous and file-backed pages."""
    with open("/proc/self/status") as f:
        return next(_kib(line) for line in f if line.startswith("VmRSS:"))


class RssTracker:
    """Peak anonymous RSS (None where the kernel gives no reading) and peak
    VmRSS, sampled on a thread until stop()."""

    def __init__(self, interval: float = 0.05):
        self.peak_anon, self.peak_total = anon_bytes(), vmrss_bytes()
        self._interval = interval
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _sample(self) -> None:
        if self.peak_anon is not None:
            self.peak_anon = max(self.peak_anon, anon_bytes())
        self.peak_total = max(self.peak_total, vmrss_bytes())

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._sample()

    def stop(self) -> int | None:
        """Stop sampling; the peak anonymous RSS, the last reading included."""
        self._stop.set()
        self._t.join()
        self._sample()
        return self.peak_anon


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="memcheck", description=__doc__.splitlines()[0])
    parser.add_argument("--points", type=int, default=50_000_000)
    parser.add_argument("--files", type=int, default=4)
    parser.add_argument("--spool-mb", type=float, default=128.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    os.environ["AQPC_SPOOL_MB"] = str(args.spool_mb)

    import torch

    from ..engine import run_query
    from ..formats import synth
    from ..formats.las import parse_las_header_file
    from ..models.query import BoundsQuery, QueryPlan
    from ..parallel.comm import require_device
    from ..utils.aabb import AABB

    device = require_device(args.device)
    torch.empty(1, device=device)  # the device's context, before the baseline
    if anon_bytes() is None:
        print("STREAMING NOT MEASURED: this kernel gives no anonymous RSS reading")
        return 1
    mib = 1048576.0
    per_file = args.points // args.files
    with tempfile.TemporaryDirectory(prefix="aqpc_mem_") as tmp:
        root = Path(tmp)
        print(f"writing {args.files} x {per_file / 1e6:.0f}M LAST points...", file=sys.stderr)
        t0 = time.perf_counter()
        synth.write_dataset(root, n_files=args.files, points_per_file=per_file,
                            formats=("last",), seed=0)
        print(f"dataset written in {time.perf_counter() - t0:.0f}s, "
              f"baseline anon RSS {anon_bytes() / mib:.0f} MiB", file=sys.stderr)

        out = root / "out"
        out.mkdir()
        box = AABB((-1e12,) * 3, (1e12,) * 3)  # matches every point
        base = anon_bytes() / mib
        tracker = RssTracker()
        t0 = time.perf_counter()
        res = run_query(root / "last", QueryPlan(bounds=BoundsQuery(box), output_dir=out),
                        device=device, use_index=False)
        dt = time.perf_counter() - t0
        peak = tracker.stop() / mib
        outputs = sorted(out.glob("*.las"))
        written = sum(f.stat().st_size for f in outputs)
        written_points = sum(parse_las_header_file(f).point_count for f in outputs)
    n_points = per_file * args.files
    hits_bytes = res.match_count * 33  # spool record size
    print(
        f"collected {res.match_count / 1e6:.1f}M hits (100% match) in {dt:.1f}s "
        f"({res.match_count / dt / 1e6:.1f} Mpts/s) on {device}; wrote "
        f"{written_points / 1e6:.1f}M points in {written / mib:.0f} MiB of LAS"
    )
    print(
        f"peak anon RSS {peak:.0f} MiB (baseline {base:.0f} MiB; peak VmRSS with the "
        f"dataset's mapped pages {tracker.peak_total / mib:.0f} MiB); "
        f"materializing all hits would need >= {hits_bytes / mib:.0f} MiB"
    )
    ok = res.match_count == written_points == n_points and (peak - base) < BUDGET_MIB
    print(
        "STREAMING OK (bounded working set)" if ok
        else f"STREAMING FAIL ({res.match_count} collected and {written_points} written of "
             f"{n_points} points; working set {peak - base:.0f} MiB, budget "
             f"{BUDGET_MIB:.0f} MiB)"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
