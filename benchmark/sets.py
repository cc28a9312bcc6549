"""Runs of one cell, one process after another, and the spread of each
metric: how BENCHMARK.json's bounds are measured.

    python3 benchmark/sets.py --workload doc.count --seeds 1,2,3,4,5,6 \
        --seconds 10 [--trace 1] [--out sets.jsonl]

Each run is `python3 benchmark/run.py ...` as the check starts it. One JSON
line a run (its result, exit code, wall seconds and the end of its
standard error), then one line of each metric's median and spread (the
distance between the first and third quartiles over the median,
statistics.quantiles with n=4), over the runs after the first and over
all of them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from yardstick.measure import spread  # noqa: E402


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(BENCH / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=BENCH.parent)
    wall = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": wall, "result": result, "stderr_tail": proc.stderr[-3000:]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/sets.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = one(args.workload, seed, args.seconds, args.trace)
        runs.append(run)
        lines = [json.dumps(run)]
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(lines[0] + "\n")
        print(lines[0] if run["rc"] else json.dumps({k: v for k, v in run.items()
                                                     if k != "stderr_tail"}), flush=True)
    values: dict[str, list[float]] = {}
    for run in runs:
        for name, m in ((run["result"] or {}).get("metrics") or {}).items():
            values.setdefault(name, []).append(m["value"])
    for name, vals in values.items():
        summary = {"metric": name, "values": vals}
        for label, part in (("all", vals), ("after_first", vals[1:])):
            if len(part) >= 2:
                summary[label] = {"median": statistics.median(part), "spread": spread(part)}
        line = json.dumps({"workload": args.workload, **summary})
        print(line, flush=True)
        if args.out is not None:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
