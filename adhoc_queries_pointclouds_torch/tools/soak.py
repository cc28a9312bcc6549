"""Cross-format soak of the port: the paper's core correctness check,
automated (the counterpart of the root tools/soak.py).

The reference validates itself by observing that all four formats return
the same match count for the same query (SURVEY §4). This tool synthesizes
a dataset, runs the full experiment grid (bbox S/L/XL x {full, density},
class {6, 19}, GPS-time range) through the port's engine for every format,
on the device that --device names, and checks:

  - all four formats agree on every cell
  - full bbox cells also match an independent NumPy f64 oracle
  - density cells match the exact reference-math key oracle (GridSpec3D)

    python -m adhoc_queries_pointclouds_torch.tools.soak [--points-per-file N]
        [--files K] [--block-size B] [--device cuda|cpu]

--device defaults to cuda; cuda without a card raises before any data is
written. Exits 0 when every cell passes.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..engine import run_query
from ..formats import open_point_cloud, synth
from ..models.query import BoundsQuery, ClassQuery, DensityConfig, QueryPlan, TimeRangeQuery
from ..ops.density import GridSpec3D
from ..parallel.comm import require_device
from ..utils.aabb import AABB

FORMATS = ("las", "laz", "last", "lazer")


def soak(root: Path, files: int, points_per_file: int, block_size: int, device) -> int:
    """Write the dataset under root, run every cell; the number of failed cells."""
    print(f"synthesizing {files} x {points_per_file} points "
          f"(point format 1: gps) in {root}...", file=sys.stderr)
    written = synth.write_dataset(
        root, n_files=files, points_per_file=points_per_file,
        seed=12345, formats=FORMATS, point_format=1,
    )

    worlds, gps = [], []
    for p in written["las"]:
        r = open_point_cloud(p)
        worlds.append(r.positions_world())
        gps.append(r.column("gps_time").copy())
        r.close()
    total = np.concatenate(worlds)
    tmin, tmax = total.min(axis=0), total.max(axis=0)
    span = tmax - tmin

    boxes = {
        "s": AABB(tuple(tmin + 0.40 * span), tuple(tmin + 0.48 * span)),
        "l": AABB(tuple(tmin + 0.10 * span), tuple(tmin + 0.70 * span)),
        "xl": AABB(tuple(tmin - 0.01 * span), tuple(tmax + 0.01 * span)),
    }
    cell = float(span.max() / 23.0)
    allg = np.concatenate(gps)
    t0q, t1q = float(np.quantile(allg, 0.2)), float(np.quantile(allg, 0.8))

    cells_run = 0
    failures = 0
    t_start = time.perf_counter()

    def run_cell(name, plan, oracle):
        nonlocal cells_run, failures
        counts = {}
        for fmt in FORMATS:
            res = run_query(root / fmt, plan, device=device, block_size=block_size,
                            use_index=False)
            counts[fmt] = res.match_count
        ok = len(set(counts.values())) == 1 and counts["las"] == oracle
        cells_run += 1
        if not ok:
            failures += 1
        print(f"{'OK ' if ok else 'FAIL'} {name}: {counts} oracle={oracle}")

    for size, box in boxes.items():
        oracle = sum(int(np.sum(box.contains_points(w))) for w in worlds)
        run_cell(f"bbox_{size}_full", QueryPlan(bounds=BoundsQuery(box)), oracle)
        grid = GridSpec3D.create(box, cell)
        keys = []
        for w in worlds:
            m = box.contains_points(w)
            if m.any():
                k, _ = grid.exact_keys_d2(w[m])
                keys.append(k)
        density_oracle = len(np.unique(np.concatenate(keys))) if keys else 0
        run_cell(
            f"bbox_{size}_lod",
            QueryPlan(bounds=BoundsQuery(box), density=DensityConfig(cell)),
            density_oracle,
        )
    for cls in (6, 19):
        oracle = 0
        for p in written["las"]:
            r = open_point_cloud(p)
            oracle += int(np.sum(r.column("classification") == cls))
            r.close()
        run_cell(f"class_{cls}", QueryPlan(classification=ClassQuery(cls)), oracle)
    time_oracle = int(np.count_nonzero((allg >= t0q) & (allg < t1q)))
    run_cell("time_range", QueryPlan(time_range=TimeRangeQuery(t0q, t1q)), time_oracle)

    dt = time.perf_counter() - t_start
    print(f"\n{cells_run} cells x {len(FORMATS)} formats in {dt:.1f}s on {device}, "
          f"{failures} failures")
    return failures


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="soak", description=__doc__.splitlines()[0])
    parser.add_argument("--points-per-file", type=int, default=300_000)
    parser.add_argument("--files", type=int, default=3)
    parser.add_argument("--block-size", type=int, default=65_536)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = require_device(args.device)
    with tempfile.TemporaryDirectory(prefix="aqpc_soak_") as root:
        failures = soak(Path(root), args.files, args.points_per_file, args.block_size, device)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
