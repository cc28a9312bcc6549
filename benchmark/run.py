"""The benchmark of adhoc_queries_pointclouds_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards. The
cells, their configurations, traffic mixes and metrics are named in
BENCHMARK.json; yardstick/spec.py finds each one's files. The last line of
standard output is the run's result as one JSON object, the checks against
the plain reference the last lines of standard error (yardstick/harness.py).
With --trace 0 the result holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a torch.profiler trace.

Exits 3 without a result when the cards are missing, 4 when JAX or the JAX
package was loaded, and with Python's 1 on any failure.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# every build and kernel cache in the checkout, at fixed paths, so that only
# a checkout's first run builds (the program's own nvcc and g++ builds go
# into its package's directory)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_compute")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from yardstick import harness, spec

    cell = spec.cell(args.workload)
    try:
        return harness.run(cell, args.seed, args.seconds, bool(args.trace))
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3


if __name__ == "__main__":
    raise SystemExit(main())
