"""The readings a cell's limit is set from (PERF.md, "How correct is
decided"): the program's on many seeds, and the control's on some.

    python3 benchmark/control.py --workload doc.count --seeds 11,12,13 \
        --control-seeds 3 --seconds 3 [--out control.jsonl]

For each seed, in one process: the cell's set-up and a short window of the
program (serve.handle_request, or engine.run_query for a streamed
configuration), exactly as a run makes them (yardstick/harness.py); then
the plain reference in float64 answers the run's sample, and
wrong_replies is the program's reading. On the first
--control-seeds seeds the control is read too: the same reference one
precision below, float32, put in the program's place. Its answers to the
sample become reply lines, and the harness's own comparison
(harness.checks) scores them against the float64 answers and gives its
verdict, which has to be not correct. The control writes no files, so
wrong_files is the program's alone.
One JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]


def control_window(win, picked: list[int], low: dict[int, dict]):
    """The control's replies to the sample, as the window's lines would
    hold them, in a window of their own."""
    from yardstick import harness

    return harness.Window([win.kinds[i] for i in picked], [win.requests[i] for i in picked],
                          [win.latencies_s[i] for i in picked],
                          [json.dumps(low[i]) for i in picked], win.window_s)


def largest_point_gap(low: dict, ans: dict, picked: list[int]) -> float:
    """The widest gap, m, between a coordinate of the control's preview
    points and the reference's (previews of equal length)."""
    gaps = [abs(a - b) for i in picked if "points" in ans[i]
            and len(low[i]["points"]) == len(ans[i]["points"])
            for p, q in zip(low[i]["points"], ans[i]["points"]) for a, b in zip(p[:3], q[:3])]
    return max(gaps, default=0.0)


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    """One seed's readings: the program's checks and, with control, the
    float32 control's, by request kind too."""
    import torch

    from yardstick import harness

    r = harness.Run(cell, seed, seconds, device)
    try:
        r.setup()
        win = r.window()
        r.free_program()
        picked, ans, files = r.check(torch.float64)
        program = harness.checks(win, picked, ans, r.sidecars(), files)
        out = {"seed": seed, "attempted": len(win.replies), "compared": len(picked),
               "program_correct": harness.is_correct(program),
               "program_wrong": program["wrong_replies"]["value"],
               "program_checks": {k: c["value"] for k, c in program.items()}}
        if control:
            _, low, _ = r.check(torch.float32, files=False)
            cwin = control_window(win, picked, low)
            compared = harness.checks(cwin, list(range(len(picked))),
                                      dict(enumerate(ans[i] for i in picked)))
            out["control_correct"] = harness.is_correct(compared)
            out["control_wrong"] = compared["wrong_replies"]["value"]
            out["control_checks"] = {k: c["value"] for k, c in compared.items()}
            off = [i for i in picked if low[i] != ans[i]]
            out["control_wrong_by_kind"] = {
                k: sum(win.kinds[i] == k for i in off) for k in sorted(set(win.kinds))}
            out["control_largest_gap"] = max(
                (abs(low[i]["count"] - ans[i]["count"]) for i in off), default=0)
            out["control_largest_point_gap_m"] = largest_point_gap(low, ans, picked)
        return out
    finally:
        r.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="read the control on the first N seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", type=Path, default=None, help="also append the lines here")
    args = ap.parse_args(argv)

    from yardstick import harness, spec

    cell = spec.cell(args.workload)
    device = harness.require_cards(cell.chips)
    print(f"card: {harness.smi()}", file=sys.stderr)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": cell.name, **readings(
            cell, seed, args.seconds, n < args.control_seeds, device)})
        print(line, flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
