"""Where a density query's wall time goes on the card, and what pinning
glibc's mmap threshold does to the peak resident set.

    python -m adhoc_queries_pointclouds_torch.tools.density_profile [--data DIR]

Without --data it writes chip_smoke.py's LAST dataset (8 files x 8M points,
point format 3, the same seed) into a temporary directory. It then prints
one JSON object per line:

  {"profile": ...}  per query and transport (AQPC_PACK 1 and 0): a warm-up
    run, then one run_query on the card under torch.profiler: the wall, the
    StageTimer's seconds and counts, the union of the device's busy
    intervals, the idle share (1 - busy / wall), the device time by
    kernel name (the 12 largest), the density kernels' device time with the
    leaders table's clearing (every kernel named density_, and every
    memset: the query makes no other), and the port's kernel launches;
  {"rss": ...}      per query and AQPC_MALLOC_PIN 1 and 0: the peak resident
    set of a fresh process that runs the query once: resource.getrusage's
    ru_maxrss, and VmHWM of /proc/self/status where the kernel gives it.
    Linux carries ru_maxrss over fork and exec, so a reading is never below
    the launching process's own peak: these readings run first, and the
    dataset is written by a process of its own, so that the launcher stays
    small. The switch is read when the engine is imported, so each reading
    needs its own process.

The queries: the bbox count of the large box, and density queries of the
large box at a 25 m and a 0.5 m cell, global scope, no sink but the count.
Every line carries the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from .. import engine
from ..ops import predicate
from ..formats import synth
from ..models.query import BoundsQuery, DensityConfig, QueryPlan
from ..utils.aabb import parse_aabb

SEED = 20261016
BOX = "100500;200250;0;105700;200876;80"
QUERIES = {
    "bbox_count": None,
    "density_25m": 25.0,
    "density_0.5m": 0.5,
}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def plan_of(name: str) -> QueryPlan:
    cell = QUERIES[name]
    return QueryPlan(bounds=BoundsQuery(parse_aabb(BOX)),
                     density=None if cell is None else DensityConfig(cell, "global"))


def run(data: Path, name: str):
    return engine.run_query(data, plan_of(name), device="cuda", use_index=False)


def busy_seconds(events) -> tuple[float, dict]:
    """Union of the device intervals of a profiler trace, and the device
    time by kernel (or copy) name, in ms."""
    spans, by_name = [], {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # microseconds; the attribute was called cuda_time before torch 2.4
            took = getattr(e, "device_time", None)
            took = e.cuda_time if took is None else took
            start = e.time_range.start
            spans.append((start, start + took))
            by_name[e.name] = by_name.get(e.name, 0.0) + took
    spans.sort()
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6, {k: v / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}


def profile(data: Path, name: str, pack: str, smi: str) -> dict:
    os.environ["AQPC_PACK"] = pack
    run(data, name)  # warm: kernels built and loaded, files in the page cache
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    predicate.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run(data, name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = busy_seconds(prof.events())
    density_ms = sum(ms for kernel, ms in by_name.items()
                     if "density_" in kernel or kernel.startswith("Memset"))
    return {"profile": name, "AQPC_PACK": pack, "card": smi, "found": res.match_count,
            "wall_s": wall, "stage_s": dict(res.timer.seconds), "counts": dict(res.timer.counts),
            "h2d_bytes": res.timer.bytes.get("h2d", 0), "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall, "density_device_ms": density_ms,
            "launches": {k: v for k, v in predicate.launches.items() if v},
            "device_ms_by_name": dict(list(by_name.items())[:12])}


def child(data: Path, name: str) -> None:
    res = run(data, name)
    status = Path("/proc/self/status").read_text()
    hwm = next((int(line.split()[1]) for line in status.splitlines()
                if line.startswith("VmHWM:")), None)
    print(json.dumps({"found": res.match_count, "wall_s": res.elapsed_seconds,
                      "vm_hwm_kib": hwm,
                      "ru_maxrss_kib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}))


def spawn(args: list[str], **env) -> str:
    """This tool in a process of its own; its standard output."""
    proc = subprocess.run(
        [sys.executable, "-m", "adhoc_queries_pointclouds_torch.tools.density_profile", *args],
        env=dict(os.environ, **env), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} exited {proc.returncode}:\n{proc.stderr}")
    return proc.stdout


def rss(data: Path, name: str, pin: str, smi: str) -> dict:
    out = spawn(["--data", str(data), "--child", name], AQPC_MALLOC_PIN=pin, AQPC_PACK="1")
    return {"rss": name, "AQPC_MALLOC_PIN": pin, "card": smi,
            "launcher_ru_maxrss_kib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
            **json.loads(out.strip().splitlines()[-1])}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", help="directory of LAST files (default: generate 8 x 8M points)")
    ap.add_argument("--child", choices=sorted(QUERIES), help="run one query and print its RSS")
    ap.add_argument("--make", action="store_true", help="write the dataset under --data and exit")
    args = ap.parse_args(argv)
    if args.child:
        child(Path(args.data), args.child)
        return 0
    if args.make:
        synth.write_dataset(args.data, n_files=8, points_per_file=8_000_000, seed=SEED,
                            formats=("last",), clustered=True, point_format=3)
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("this tool measures on a CUDA device and there is none")
    smi = smi_line()
    with tempfile.TemporaryDirectory(prefix="aqpc_density_profile_") as tmp:
        if args.data:
            data = Path(args.data)
        else:
            spawn(["--data", tmp, "--make"])
            data = Path(tmp) / "last"
        for name in QUERIES:
            for pin in ("1", "0", "1", "0"):
                print(json.dumps(rss(data, name, pin, smi)), flush=True)
        for name in QUERIES:
            for pack in ("1", "0"):
                print(json.dumps(profile(data, name, pack, smi)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
