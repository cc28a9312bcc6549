"""The yardstick's arithmetic: percentiles, spreads, the table of peaks and
the bytes a kernel needs for a request.

Bytes follow PERF.md: each input byte counted once, and only what the
query needs. A box count needs the x, y and z of the points of the files
whose header box meets the query (12 B a point), since a plain scan skips
the others; a class count needs every point's class (1 B); a GPS-time
count every point's (hi, lo) int32 encoding of its time (8 B). A
collect's bit mask reads what the count of its predicate reads and writes
one bit a point of those rows (1/8 B); the compaction and the gathers from
the files that follow are not counted here.
"""

from __future__ import annotations

import statistics

import numpy as np

BYTES_A_POINT = {"box": 12, "class": 1, "time": 8}
MASK_BYTES_A_POINT = 1 / 8  # a collect's bit mask: one bit a point written

# device memory bandwidth, bytes/s, from NVIDIA's data sheets (SXM parts,
# at their full power limit; the run prints the card's limit beside it)
PEAK_BYTES_PER_S = {"H100": 3.35e12, "H200": 4.8e12}


def peak_bytes_per_s(kind: str) -> float | None:
    """The data sheet's bandwidth of the card named kind, or None."""
    for part, peak in PEAK_BYTES_PER_S.items():
        if part in kind:
            return peak
    return None


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linearly interpolated."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def meets(bounds, wmin, wmax) -> bool:
    """Whether a closed query box meets a file's closed header box."""
    return all(wmin[a] <= bounds[a + 3] and wmax[a] >= bounds[a] for a in range(3))


def met_points(bounds, dataset) -> int:
    """The points of the files whose header box meets the query box."""
    return sum(n for n, lo, hi in zip(dataset.counts, dataset.wmin, dataset.wmax)
               if meets(bounds, lo, hi))


def box_bytes(bounds, dataset) -> int:
    return BYTES_A_POINT["box"] * met_points(bounds, dataset)


def scan_bytes(kind: str, dataset) -> int:
    return BYTES_A_POINT[kind] * dataset.total_points


def box_mask_bytes(bounds, dataset) -> float:
    """A box collect's mask: x, y, z read and one bit written a point of the
    files the box meets."""
    return (BYTES_A_POINT["box"] + MASK_BYTES_A_POINT) * met_points(bounds, dataset)


def time_mask_bytes(dataset) -> float:
    """A GPS-time collect's mask: every point's time read and its bit
    written."""
    return (BYTES_A_POINT["time"] + MASK_BYTES_A_POINT) * dataset.total_points


def roofline(bytes_needed: int, kernel_s: float, kind: str) -> float | None:
    """The kernels' share of the bandwidth bound, in %, or None when there
    is nothing to read."""
    peak = peak_bytes_per_s(kind)
    if not bytes_needed or kernel_s <= 0 or peak is None:
        return None
    return 100.0 * bytes_needed / peak / kernel_s
