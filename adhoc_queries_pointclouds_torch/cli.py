"""Command line of the port: bbox, class and GPS-time counts and collects on
one device.

    python -m adhoc_queries_pointclouds_torch.cli -i DIR --bounds "x0;y0;z0;x1;y1;z1"
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --class 6 -o OUT_DIR
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --time-range "start;end" --print-points

The query flags and output lines are those of adhoc_queries_pointclouds_tpu/
cli.py (cmd_query, cli.py:101-193): "Searching N files...", one "Wrote
OUT_DIR/matching_points_{i}.las" per input file with hits under -o, "Found
N matching points", the closing throughput line, and --stats; --print-points
streams each hit as a "Found point: ..." line. --device (default cuda) names
the device; cuda without a card is an error, never a silent run on the CPU.
Flags of queries the port does not run yet exit with status 2.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .engine import run_query
from .models.query import BoundsQuery, ClassQuery, QueryPlan, TimeRangeQuery
from .utils.aabb import parse_aabb
from .utils.timing import throughput_line

# dest -> flag, for flags whose queries are not ported yet
_NOT_PORTED = {
    "density": "--density",
    "density_scope": "--density-scope",
    "resident": "--resident",
    "repeat": "--repeat",
    "distributed": "--distributed",
    "coordinator": "--coordinator",
    "num_processes": "--num-processes",
    "process_id": "--process-id",
    "profile": "--profile",
    "devices": "--devices",
}


def build_query_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-i", "--input", required=True, help="Input point cloud file or directory")
    parser.add_argument("--bounds", help='Bounding box "minX;minY;minZ;maxX;maxY;maxZ"')
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default) or cpu")
    parser.add_argument("--class", dest="classification", type=int,
                        help="Classification value (0-255)")
    parser.add_argument(
        "--time-range", dest="time_range",
        help='GPS time range "start;end" (half-open: start <= t < end)',
    )
    parser.add_argument("-o", "--output",
                        help="Output directory: one matching_points_{i}.las per input file with hits")
    parser.add_argument("--density", type=float, help="(not yet ported)")
    parser.add_argument("--density-scope", choices=["file", "global"],
                        help="(not yet ported)")
    parser.add_argument("--parallel", action="store_true", help="(parity no-op: always parallel)")
    parser.add_argument("--optimized", action="store_true", help="(parity no-op: always optimized)")
    parser.add_argument("--print-points", action="store_true",
                        help="Print every matching point as it is found")
    parser.add_argument("--parity-quirk", action="store_true",
                        help="Replicate the reference's exact world->local bounds conversion")
    parser.add_argument("--block-size", type=int, default=None, help="Points per device block")
    parser.add_argument("--devices", type=int, default=None, help="(not yet ported)")
    parser.add_argument("--workers", type=int, default=8, help="Host decode threads")
    parser.add_argument("--stats", action="store_true", help="Print per-stage timings")
    parser.add_argument(
        "--keep-going", action="store_true",
        help="Skip unreadable files instead of aborting (reference aborts)",
    )
    parser.add_argument(
        "--no-index", action="store_true",
        help="Ignore block min/max sidecar indexes (pure brute-force scan)",
    )
    parser.add_argument("--profile", metavar="DIR", help="(not yet ported)")
    parser.add_argument("--distributed", action="store_true", help="(not yet ported)")
    parser.add_argument("--coordinator", help="(not yet ported)")
    parser.add_argument("--num-processes", type=int, default=None, help="(not yet ported)")
    parser.add_argument("--process-id", type=int, default=None, help="(not yet ported)")
    parser.add_argument("--resident", action="store_true", help="(not yet ported)")
    parser.add_argument("--repeat", type=int, help="(not yet ported)")


def cmd_query(args: argparse.Namespace) -> int:
    used = [flag for dest, flag in _NOT_PORTED.items() if getattr(args, dest) not in (None, False)]
    if used:
        print(f"not yet ported: {', '.join(used)} (the port runs counts and collects only)",
              file=sys.stderr)
        return 2
    maybe_bounds = parse_aabb(args.bounds) if args.bounds else None
    maybe_class = args.classification
    maybe_time = None
    if args.time_range:
        parts = args.time_range.split(";")
        if len(parts) != 2:
            print('TIME-RANGE must be "start;end"', file=sys.stderr)
            return 1
        maybe_time = TimeRangeQuery(float(parts[0]), float(parts[1]))
    n_predicates = sum(p is not None for p in (maybe_bounds, maybe_class, maybe_time))
    if n_predicates > 1:
        print("Specifying BOUNDS and CLASS at the same time is invalid! "
              "Specify either BOUNDS or CLASS argument!", file=sys.stderr)
        return 1
    if n_predicates == 0:
        print("Found neither BOUNDS nor CLASS argument but exactly one of these "
              "arguments is required!", file=sys.stderr)
        return 1
    plan = QueryPlan(
        bounds=BoundsQuery(maybe_bounds) if maybe_bounds is not None else None,
        classification=ClassQuery(maybe_class) if maybe_class is not None else None,
        time_range=maybe_time,
        output_dir=Path(args.output) if args.output else None,
        print_points=args.print_points,
        parity_quirk=args.parity_quirk,
    )
    kwargs = {}
    if args.block_size:
        kwargs["block_size"] = args.block_size
    result = run_query(
        args.input,
        plan,
        device=args.device,
        workers=args.workers,
        keep_going=args.keep_going,
        use_index=not args.no_index,
        # --print-points streams each hit as it is found; nothing is
        # buffered in RAM
        print_stream=sys.stdout if args.print_points else None,
        **kwargs,
    )
    print(f"Searching {result.files_searched} files...")
    if plan.output_dir is not None:
        for f in result.output_files:
            print(f"Wrote {f}")
    print(f"Found {result.match_count} matching points")
    if args.stats:
        print(result.timer.report())
        print(
            f"  scanned {result.points_scanned} points "
            f"({result.mpts_per_s:.1f} Mpts/s)"
        )
    print(throughput_line(result.total_file_bytes, result.elapsed_seconds))
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # argparse rejects option values that start with '-'; bounding boxes
    # legitimately have negative mins (the reference's clap sets
    # allow_hyphen_values, main.rs:209) — fold them into --opt=value form
    for opt in ("--bounds", "--time-range"):
        for k in range(len(argv) - 1):
            if argv[k] == opt and argv[k + 1].startswith("-"):
                argv[k : k + 2] = [f"{opt}={argv[k + 1]}"]
                break
    if argv and argv[0] == "query":
        argv = argv[1:]
    parser = argparse.ArgumentParser(
        prog="aqpc-torch",
        description="Ad-hoc point cloud queries on a CUDA GPU (LAS/LAZ/LAST/LAZER)",
    )
    build_query_parser(parser)
    return cmd_query(parser.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
