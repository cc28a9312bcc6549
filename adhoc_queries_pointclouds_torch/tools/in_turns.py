"""Two checkouts' kernels timed in turns on one card: the A/B of the bench
tools (packed_bench.py, density_bench.py).

    summary = in_turns(Path(__file__).resolve(), root, against, pairs,
                       ["--runs", "25"], ("kernel", "widths"), ("device_ms", "ms"))

Runs `python script --root TREE *argv` for the trees root and against,
pairs times each, one process a run (each process builds its tree's
kernels), the first of a pair alternating between the trees. Each run's
last line is one JSON object with the card's name ("card") and a list of
rows ("rows"), the same rows in the same order for both trees. For every
row and reading (a row key of a time in ms) it prints and returns each
tree's median of its runs' readings, its least run (the row's key with
"ms" ending "min_ms", where the row has it) and the pairs root won (its
reading below against's); a row without a reading skips it. The last line printed is one JSON object with
those numbers.

This file imports nothing of its package, so that a tool which times
another checkout's kernels (--root) can load it from its own directory.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path


def in_turns(script, root, against, pairs: int, argv, ident, readings) -> dict:
    """The A/B of script over the trees root and against; ident: the row
    keys that name a row (copied into the summary), readings: the row keys
    compared."""
    trees = {"root": str(Path(root).resolve()), "against": str(Path(against).resolve())}
    runs = {"root": [], "against": []}
    for i in range(pairs):
        for name in ("against", "root") if i % 2 == 0 else ("root", "against"):
            out = subprocess.run([sys.executable, str(script), "--root", trees[name], *argv],
                                 check=True, capture_output=True, text=True).stdout
            runs[name].append(json.loads(out.strip().splitlines()[-1]))
            print(f"pair {i + 1}, {name} {trees[name]}: done", flush=True)
    card = runs["root"][0]["card"]
    print(f"card {card}; ms, --against {trees['against']} -> --root {trees['root']}: median of "
          f"{pairs} runs (least run), ratio, --root's wins")
    summary = []
    for at, row in enumerate(runs["root"][0]["rows"]):
        by = {name: [r["rows"][at] for r in rs] for name, rs in runs.items()}
        s = {key: row[key] for key in ident}
        parts = []
        for key in (key for key in readings if key in row):
            least = key[:-2] + "min_ms"
            for name, rows in by.items():
                s[f"{name}_{key}"] = statistics.median(r[key] for r in rows)
                if least in row:
                    s[f"{name}_{least}"] = min(r[least] for r in rows)
            s[f"wins_{key}"] = sum(b[key] < a[key] for a, b in zip(by["against"], by["root"]))
            a, b = s[f"against_{key}"], s[f"root_{key}"]
            mins = (f" ({s[f'against_{least}']:.4f} -> {s[f'root_{least}']:.4f})"
                    if least in row else "")
            parts.append(f"{key} {a:.4f} -> {b:.4f}{mins}, {b / a:.3f}x, wins "
                         f"{s[f'wins_{key}']}/{pairs}")
        summary.append(s)
        what = " ".join(f"{key} {row[key]:.4g}" if isinstance(row[key], float) else str(row[key])
                        for key in ident)
        print(f"  {what}: " + "; ".join(parts))
    result = {"card": card, "trees": trees, "pairs": pairs, "rows": summary}
    print(json.dumps(result))
    return result
