"""Paper-scale validation run of the port: ~2.2 B points, >2^31 collected
hits (the counterpart of the root tools/paperscale.py).

The reference's protocol tops out at ca13 ≈ 2.6 B points with the XL box
matching the entire dataset (~2.6 B hits, run_query_experiments.rs:140).
The port's engine sums each step's int32 count into Python ints, so counts
past 2^31 are exact by design; this tool shows it:

  1. `generate`: writes a LAST dataset of --files files (default 35 x 64 M
     points -> 2.24 B points, ~45 GB, point format 0), the root tool's bytes,
     one file a worker process at a time.
  2. `oracle`: exact NumPy f64 oracle per file (bbox-XL count, partial-box
     count, class-6 count), summed in Python ints — the full truth, not a
     sample; written to ROOT/oracle.json.
  3. `run`: the engine's bbox-XL count, class-6 count, and force_collect
     bbox-XL and partial-box collects (>2^31 hits through the collect path),
     each checked == oracle, on the device that --device names; peak
     anonymous RSS sampled throughout.

    python -m adhoc_queries_pointclouds_torch.tools.paperscale all --root DIR [--files 35]
    python -m adhoc_queries_pointclouds_torch.tools.paperscale run --root DIR --json OUT.json

--device defaults to cuda; `run` and `all` with cuda and no card raise
before any other work. `run` exits 0 when all four checks equal the oracle.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from ..formats import open_point_cloud, synth
from ..utils.aabb import AABB

# One world slab per file along x (like synth.write_dataset), 1 km² x 100 m
# at mm scale: x/y residuals ~20 bits, z ~17 — representative of the paper's
# datasets, and the XL box below covers every slab.
EXTENT = (1000.0, 1000.0, 100.0)
BASE_OFFSET = (100000.0, 200000.0, 0.0)
CLASS = 6
ORACLE_CHUNK = 16_000_000  # points a file's oracle reads at a time


def xl_box(n_files: int) -> AABB:
    return AABB(
        (BASE_OFFSET[0] - 1.0, BASE_OFFSET[1] - 1.0, BASE_OFFSET[2] - 1.0),
        (BASE_OFFSET[0] + n_files * EXTENT[0] + 1.0,
         BASE_OFFSET[1] + EXTENT[1] + 1.0, BASE_OFFSET[2] + EXTENT[2] + 1.0),
    )


def partial_box(n_files: int) -> AABB:
    """~55% of points: exercises per-block compaction at scale (the XL box
    full-matches every block, which takes the cheap emit_range path)."""
    return AABB(
        (BASE_OFFSET[0], BASE_OFFSET[1], BASE_OFFSET[2]),
        (BASE_OFFSET[0] + n_files * EXTENT[0], BASE_OFFSET[1] + 0.55 * EXTENT[1],
         BASE_OFFSET[2] + EXTENT[2]),
    )


def file_paths(root: Path, n_files: int) -> list[Path]:
    return [root / "last" / f"file_{i}.last" for i in range(n_files)]


def _in_workers(fn, args: list[tuple]):
    """fn(*a) for each a, in spawned worker processes (one a core, at most
    one a task), yielding the results in order."""
    workers = max(1, min(len(args), os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = [pool.submit(fn, *a) for a in args]
        for f in futures:
            yield f.result()


def _generate_file(i: int, path: Path, pts_per_file: int) -> float:
    t0 = time.time()
    cloud = synth.make_cloud(
        pts_per_file, seed=1000 + i, point_format=0,
        offset=(BASE_OFFSET[0] + i * EXTENT[0], BASE_OFFSET[1], BASE_OFFSET[2]),
        extent=EXTENT,
    )
    synth.write_cloud_last(cloud, path)
    return time.time() - t0


def generate(root: Path, n_files: int, pts_per_file: int) -> None:
    """Write the files that do not exist yet (non-empty files are kept)."""
    (root / "last").mkdir(parents=True, exist_ok=True)
    todo = [(i, path, pts_per_file) for i, path in enumerate(file_paths(root, n_files))
            if not (path.exists() and path.stat().st_size > 0)]
    for (_, path, _), seconds in zip(todo, _in_workers(_generate_file, todo)):
        print(f"generated {path.name}: {pts_per_file / 1e6:.0f} Mpts "
              f"in {seconds:.0f}s", flush=True)


def _file_oracle(path: Path, n_files: int) -> dict:
    xlb = xl_box(n_files)
    pb = partial_box(n_files)
    totals = {"points": 0, "xl": 0, "cls": 0, "partial": 0}
    r = open_point_cloud(path)
    n = r.point_count
    for s in range(0, n, ORACLE_CHUNK):
        e = min(s + ORACLE_CHUNK, n)
        w = r.positions_world(s, e)
        totals["xl"] += int(np.sum(xlb.contains_points(w)))
        totals["partial"] += int(np.sum(pb.contains_points(w)))
        totals["cls"] += int(np.sum(r.column("classification", s, e) == CLASS))
        totals["points"] += e - s
    r.close()
    return totals


def oracle(root: Path, n_files: int) -> dict:
    """Exact per-file NumPy f64 oracle, Python-int totals."""
    paths = file_paths(root, n_files)
    totals = {"points": 0, "xl": 0, "cls": 0, "partial": 0}
    for path, one in zip(paths, _in_workers(_file_oracle, [(p, n_files) for p in paths])):
        for k, v in one.items():
            totals[k] += v
        print(f"oracle {path.name}: cumulative {totals}", flush=True)
    return totals


def gib(n: int | None) -> str:
    return "not measured" if n is None else f"{n / 2**30:.3f} GiB"


def run(root: Path, n_files: int, out_json: Path | None, device) -> int:
    import torch

    from ..engine import run_query
    from ..models.query import BoundsQuery, ClassQuery, QueryPlan
    from ..parallel.comm import require_device
    from .memcheck import RssTracker

    device = require_device(device)
    files = [p for p in file_paths(root, n_files) if p.exists()]
    if len(files) != n_files:
        raise FileNotFoundError(f"dataset incomplete: {len(files)}/{n_files} files under {root}")
    ds = root / "last"

    oracle_path = root / "oracle.json"
    if oracle_path.exists():
        truth = json.loads(oracle_path.read_text())
    else:
        truth = oracle(root, n_files)
        oracle_path.write_text(json.dumps(truth))
    print(f"oracle totals: {truth}", flush=True)
    if truth["xl"] != truth["points"]:
        raise ValueError(f"the XL box must cover all points: {truth}")

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rss = RssTracker(interval=0.5)
    report = {"oracle": truth, "n_files": n_files, "format": "last",
              "backend": name, "crossed_2_31_hits": truth["points"] >= 2**31}

    def one(label, plan, expect, **kw):
        t0 = time.time()
        res = run_query(ds, plan, device=device, use_index=False, **kw)
        dt = time.time() - t0
        ok = res.match_count == expect
        mpts = truth["points"] / dt / 1e6
        decode = res.timer.seconds.get("decode_cpu", 0.0)
        scan = res.timer.seconds.get("scan", 0.0)
        print(f"{label}: {res.match_count} (expect {expect}) "
              f"{'OK' if ok else 'MISMATCH'} in {dt:.1f}s = {mpts:.1f} Mpts/s "
              f"(decode {decode:.1f}s of {scan:.1f}s scan; "
              f"peak anon RSS {gib(rss.peak_anon)})", flush=True)
        report[label] = {"count": res.match_count, "expect": expect, "ok": ok,
                         "seconds": round(dt, 3), "mpts": round(mpts, 1),
                         "decode_cpu_s": round(decode, 3),
                         "scan_s": round(scan, 3),
                         "decode_mpts": round(
                             truth["points"] / max(decode, 1e-9) / 1e6, 1)}
        return ok

    ok = True
    ok &= one("count_xl", QueryPlan(bounds=BoundsQuery(xl_box(n_files))), truth["xl"])
    ok &= one("count_class6", QueryPlan(classification=ClassQuery(CLASS)), truth["cls"])
    # >2^31 hits through the collect/emit machinery (count-only emitter)
    ok &= one("collect_xl", QueryPlan(bounds=BoundsQuery(xl_box(n_files))),
              truth["xl"], force_collect=True)
    # partial-match collect at scale: per-block compaction
    ok &= one("collect_partial", QueryPlan(bounds=BoundsQuery(partial_box(n_files))),
              truth["partial"], force_collect=True)
    peak_anon = rss.stop()
    report["peak_anon_rss_gib"] = None if peak_anon is None else round(peak_anon / 2**30, 3)
    report["peak_total_rss_gib"] = round(rss.peak_total / 2**30, 3)
    report["malloc_pin"] = os.environ.get("AQPC_MALLOC_PIN", "1")
    report["pass"] = bool(ok)
    print(("PASS" if ok else "FAIL")
          + f" on {name} — peak anon RSS {gib(peak_anon)}"
          + f" (total incl. page cache {report['peak_total_rss_gib']} GiB)",
          flush=True)
    if out_json:
        out_json.write_text(json.dumps(report, indent=2))
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="paperscale", description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=["generate", "oracle", "run", "all"])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--files", type=int, default=35)
    ap.add_argument("--pts-per-file", type=int, default=64_000_000)
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.cmd in ("run", "all"):
        from ..parallel.comm import require_device

        require_device(args.device)  # cuda without a card raises before any work
    if args.cmd in ("generate", "all"):
        generate(args.root, args.files, args.pts_per_file)
    if args.cmd == "oracle":
        truth = oracle(args.root, args.files)
        (args.root / "oracle.json").write_text(json.dumps(truth))
    if args.cmd in ("run", "all"):
        return run(args.root, args.files, args.json, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
