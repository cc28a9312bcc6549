"""Command line of the port: bbox, class and GPS-time counts and collects,
max-density grid sampling, device-resident datasets, the JSON query
service, multi-process queries, and the JAX CLI's other subcommands, on
the local devices of a process.

    python -m adhoc_queries_pointclouds_torch.cli -i DIR --bounds "x0;y0;z0;x1;y1;z1"
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --class 6 -o OUT_DIR
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --time-range "start;end" --print-points
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --bounds B --density 100 -o OUT_DIR
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --bounds B --resident --repeat 20
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --bounds B --devices 2
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --bounds B --profile TRACE_DIR
    python -m adhoc_queries_pointclouds_torch.cli serve -i DIR
    python -m adhoc_queries_pointclouds_torch.cli -i DIR --bounds B --distributed \
        --coordinator HOST:PORT --num-processes N --process-id I [--devices n]
    python -m adhoc_queries_pointclouds_torch.cli convert -i IN.las -o OUT.{last,lazer,laz}
    python -m adhoc_queries_pointclouds_torch.cli index -i DIR
    python -m adhoc_queries_pointclouds_torch.cli count-points -i DIR
    python -m adhoc_queries_pointclouds_torch.cli experiments -i ROOT -e 2
    python -m adhoc_queries_pointclouds_torch.cli postgis --host H --dbname D --user U --pwd P

The surface and output lines are those of adhoc_queries_pointclouds_tpu/
cli.py: the subcommands query (also the bare form, `-i ... --bounds ...`),
convert, count-points and index, with experiments, postgis and serve handed
their own argument lists (main, cli.py:331-403). A query prints
"Searching N files...", one "Wrote OUT_DIR/matching_points_{i}.las" per
input file with hits under -o, "Found N matching points", the closing
throughput line (with the devices the query ran on after it), and --stats; --print-points streams each hit as a "Found
point: ..." line. --density X keeps at most one point per X^3 m^3 grid
cell, per input file (--density-scope file) or over the whole query
(global, the default: one output file). --resident loads the dataset into
device memory once and runs the query there, --repeat times; `serve`
answers JSON requests against a resident dataset (serve.py).
--distributed runs the query in each of P processes over its share of the
files (parallel/distributed.py), each over its own shards: with --device
cuda and --devices n, process I's n shards are the cards (I * n + j) % the
card count, j < n; without --devices, one shard, card I % the card count
(JAX's process takes every local device; here several processes may share
a host's cards), and the last line counts every process's shards.
--profile DIR records the query with torch.profiler (CPU activity, and the
cards' under --device cuda) and writes its trace into DIR; with --resident,
the collect or the --repeat counts after the warm one, whose trace holds
the resident path's spans (README). --devices N shards each step, and a
resident dataset, over the first N devices of
--device (parallel/mesh.py), as the JAX CLI's mesh does; without it,
--device cuda takes every local card and cpu one shard. N of 0, or more
than the cards (in one process), exits 2. --device (default cuda) names
the device; cuda without a card is an error, never a silent run on the
CPU. convert,
index and count-points run on the host alone and write the JAX CLI's
files byte for byte.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import run_query
from .parallel.mesh import local_devices
from .models.query import BoundsQuery, ClassQuery, DensityConfig, QueryPlan, TimeRangeQuery
from .utils.aabb import parse_aabb
from .utils.timing import throughput_line

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
    parser.add_argument("--density", type=float, help="Maximum density: one point per X^3 m^3")
    parser.add_argument(
        "--density-scope",
        choices=["file", "global"],
        default="global",
        help="Dedupe grid per input file (reference --parallel semantics) or globally",
    )
    parser.add_argument("--parallel", action="store_true", help="(parity no-op: always parallel)")
    parser.add_argument("--optimized", action="store_true", help="(parity no-op: always optimized)")
    parser.add_argument("--print-points", action="store_true",
                        help="Print every matching point as it is found")
    parser.add_argument("--parity-quirk", action="store_true",
                        help="Replicate the reference's exact world->local bounds conversion")
    parser.add_argument("--block-size", type=int, default=None, help="Points per device block")
    parser.add_argument(
        "--devices", type=int, default=None,
        help="Devices this process shards each step over: the first N of --device's "
             "(default: every local card; cpu: one shard). Under --distributed, process I's "
             "N shards are cards (I*N + j) %% the card count; the default there is one "
             "shard a process, card I %% the card count, since several processes may share "
             "a host's cards (JAX's process takes every local device)",
    )
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
    parser.add_argument(
        "--profile", metavar="DIR",
        help="Record the query with torch.profiler and write its trace into DIR",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="Run across processes (torch.distributed; every "
             "process reads its shard of the file manifest). Degenerates to "
             "the local engine in a single process.",
    )
    parser.add_argument(
        "--coordinator", help="torch.distributed coordinator address "
        "(host:port); with --num-processes/--process-id brings up the group",
    )
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument(
        "--resident", action="store_true",
        help="Load the dataset into device memory once, then run the query "
             "there (one launch per count query)",
    )
    parser.add_argument(
        "--repeat", type=int, default=1,
        help="Run the query N times (interactive/serving simulation; "
             "pairs with --resident)",
    )


def cmd_query(args: argparse.Namespace) -> int:
    if args.devices is not None and args.devices < 1:
        print(f"--devices {args.devices}: a query needs at least one device", file=sys.stderr)
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
        density=DensityConfig(args.density, args.density_scope) if args.density else None,
        output_dir=Path(args.output) if args.output else None,
        print_points=args.print_points,
        parity_quirk=args.parity_quirk,
    )
    if args.distributed:
        return _run_distributed(args, plan)
    try:
        devices = local_devices(args.device, args.devices)
    except ValueError as e:  # more devices than the machine has
        print(e, file=sys.stderr)
        return 2
    if args.resident:
        return _run_resident(args, plan, devices)
    kwargs = {}
    if args.block_size:
        kwargs["block_size"] = args.block_size

    def execute():
        return run_query(
            args.input,
            plan,
            device=args.device,
            devices=devices,
            workers=args.workers,
            keep_going=args.keep_going,
            use_index=not args.no_index,
            # --print-points streams each hit as it is found; nothing is
            # buffered in RAM
            print_stream=sys.stdout if args.print_points else None,
            **kwargs,
        )

    if args.profile:
        result = profiled(execute, devices, Path(args.profile))
        print(f"Profiler trace written to {args.profile}")
    else:
        result = execute()
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
    print(throughput_line(result.total_file_bytes, result.elapsed_seconds)
          + f" on {devices_line(devices)}")
    return 0


def devices_line(devices) -> str:
    """The devices a query ran on, one a shard: "cuda:0, cuda:1"."""
    return ", ".join(str(d) for d in devices)


PROFILE_TRACE = "trace.json"  # the file --profile writes into its DIR


def profiled(execute, devices, trace_dir: Path):
    """execute() under torch.profiler: CPU activity, and the cards' under
    CUDA devices (a device or a list of them, each checked to exist first,
    so a run asked for on a card never profiles one on the CPU). Every card
    is synchronized before the profiler stops, so every kernel the query
    launched has ended inside the window; the trace goes to
    trace_dir/PROFILE_TRACE (Chrome trace JSON: one "kernel" event a kernel
    the trace holds)."""
    import torch

    from .parallel.comm import require_device

    if not isinstance(devices, (list, tuple)):
        devices = [devices]
    cards = [d for d in dict.fromkeys(require_device(d) for d in devices) if d.type == "cuda"]
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cards:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        result = execute()
        for dev in cards:
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(trace_dir / PROFILE_TRACE))
    return result


def profile_events(trace_dir: Path, category: str) -> list[dict]:
    """The events of one category of the trace that profiled() wrote into
    trace_dir: "kernel" (a kernel on the card), "cuda_runtime" (a runtime
    call on the host, a launch among them), "cpu_op" (an operator)."""
    events = json.loads((Path(trace_dir) / PROFILE_TRACE).read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == category]


def _run_distributed(args: argparse.Namespace, plan: QueryPlan) -> int:
    """The query across processes (parallel/distributed.py), with the JAX CLI's
    output lines (cli.py:196-228). Each process drives the shards of
    process_devices(--device, --devices), and the last line's device count
    is the group's shard total (JAX's len(jax.devices()))."""
    import time

    from .parallel import distributed
    from .parallel.comm import require_device

    require_device(args.device)  # cuda without a card raises before the group forms
    distributed.initialize(args.coordinator, args.num_processes, args.process_id)
    try:
        try:
            devices = distributed.process_devices(args.device, args.devices)
        except ValueError as e:  # several shards on a device that names one card
            print(e, file=sys.stderr)
            return 2
        kwargs = {}
        if args.block_size:
            kwargs["block_size"] = args.block_size
        t0 = time.perf_counter()
        if plan.density is not None:
            count = distributed.distributed_density(args.input, plan, devices=devices, **kwargs)
        elif plan.collects_points:
            count, emitter = distributed.distributed_collect(
                args.input, plan, devices=devices,
                output_dir=plan.output_dir,
                print_stream=sys.stdout if args.print_points else None,
                parity_quirk=plan.parity_quirk, **kwargs,
            )
            for f in emitter.output_files:
                print(f"Wrote {f}")
        else:
            count = distributed.distributed_count(
                args.input, plan, devices=devices, parity_quirk=plan.parity_quirk, **kwargs
            )
        n_devices = distributed.global_device_count(devices)
        print(
            f"Found {count} matching points "
            f"({distributed.process_count()} process(es), {n_devices} devices, "
            f"{time.perf_counter() - t0:.2f}s)"
        )
        return 0
    finally:
        distributed.shutdown()


def _run_resident(args: argparse.Namespace, plan: QueryPlan, devices: list) -> int:
    """The query against the dataset loaded into the devices' memory, one
    shard a device: a collect once, or a count warmed once and then timed
    over --repeat runs, each ending at its read-back (JAX cli.py:231-280,
    its output lines; over several shards, a line of their sizes after the
    first). --profile records the collect, or the timed counts, and prints
    its line and then the counters of what it recorded before "Found": the
    kernels' launches and the box operand tables with the files their
    prefilter kept and dropped."""
    import time

    from .ops import predicate
    from .parallel import resident
    from .parallel.resident import ResidentDataset

    attrs = []
    if plan.bounds is not None or plan.density is not None:
        attrs.append("position")
    if plan.classification is not None:
        attrs.append("classification")
    if plan.time_range is not None:
        attrs.append("gps_time")
    t0 = time.perf_counter()
    ds = ResidentDataset.load(
        args.input,
        devices=devices,
        attrs=tuple(attrs),
        block_size=args.block_size or (1 << 21),
        workers=args.workers,
    )
    load_s = time.perf_counter() - t0
    print(
        f"Resident: {ds.total_points} points, "
        f"{ds.resident_bytes / 1048576.0:.1f} MiB in HBM, loaded in {load_s:.2f}s"
    )
    if len(ds.devices) > 1:
        print("Resident shards: " + ", ".join(
            f"{d} {b / 1048576.0:.1f} MiB" for d, b in zip(ds.devices, ds.per_device_bytes)))

    def timed(execute):
        """(execute(), its seconds), under --profile's profiler if asked."""
        def run():
            t0 = time.perf_counter()
            return execute(), time.perf_counter() - t0

        if not args.profile:
            return run()
        predicate.reset_launches()
        resident.reset_operand_counts()
        got = profiled(run, devices, Path(args.profile))
        print(f"Profiler trace written to {args.profile}")
        launched = ", ".join(f"{k} {n}" for k, n in predicate.launches.items() if n)
        ops = resident.operand_counts
        print(f"Launches: {launched or 'none'}; box operand tables {ops['tables']}, "
              f"files kept {ops['files_kept']}, dropped {ops['files_dropped']}")
        return got

    if plan.collects_points:
        # the collect against the resident columns: one predicate launch and
        # one compaction, attributes gathered from the files for hit rows only
        (count, emitter), dt = timed(lambda: ds.collect(
            plan,
            output_dir=plan.output_dir,
            print_stream=sys.stdout if args.print_points else None,
        ))
        for f in emitter.output_files:
            print(f"Wrote {f}")
        print(f"Found {count} matching points")
        print(f"query in {dt * 1e3:.2f} ms against resident data")
        return 0
    count = ds.count(plan)  # warm (the kernels' first launch builds them)

    def repeat():
        got = count
        for _ in range(args.repeat):
            got = ds.count(plan)
        return got

    count, dt = timed(repeat)
    per_query = dt / max(args.repeat, 1)
    print(f"Found {count} matching points")
    print(
        f"{args.repeat} queries at {per_query * 1e3:.2f} ms/query "
        f"({ds.total_points / max(per_query, 1e-12) / 1e6:.0f} Mpts/s/query)"
    )
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    """LAS to LAST, LAZER or LAZ by the output's suffix (JAX cli.py:283-300)."""
    from .formats import las_to_last, las_to_laz, las_to_lazer

    src = Path(args.input)
    dst = Path(args.output)
    fmt = dst.suffix.lower().lstrip(".")
    if fmt == "last":
        las_to_last(src, dst)
    elif fmt == "lazer":
        las_to_lazer(src, dst, block_size=args.lazer_block_size)
    elif fmt == "laz":
        las_to_laz(src, dst, chunk_size=args.lazer_block_size,
                   strict_interop=args.strict_laz)
    else:
        print(f"Unsupported conversion target .{fmt}", file=sys.stderr)
        return 1
    print(f"Converted {src} -> {dst}")
    return 0


def cmd_index(args: argparse.Namespace) -> int:
    """Exact block min/max sidecar indexes, class bitmaps and GPS ranges
    (JAX cli.py:303-317)."""
    from .engine import discover_files
    from .formats import open_point_cloud
    from .index import build_index, save_index

    for f in discover_files(args.input):
        r = open_point_cloud(f)
        blocks, bitmap, gps_mm = build_index(r)
        p = save_index(f, blocks, bitmap, gps_mm, n_points=r.point_count)
        gps_note = " + gps" if gps_mm is not None else ""
        print(f"Indexed {f} -> {p} ({len(blocks)} blocks{gps_note})")
        r.close()
    return 0


def cmd_count_points(args: argparse.Namespace) -> int:
    """Header-only dataset point count (JAX cli.py:320-328)."""
    from .engine import discover_files
    from .formats.las import parse_las_header_file

    total = 0
    for f in discover_files(args.input):
        total += parse_las_header_file(f).point_count
    print(f"Total number of points: {total}")
    return 0


SUBCOMMANDS = ("query", "convert", "count-points", "experiments", "postgis", "serve", "index")


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
    # the bare reference form: `-i ... --bounds ...` is a query
    if argv and argv[0] not in SUBCOMMANDS + ("-h", "--help"):
        argv = ["query"] + argv
    if argv and argv[0] == "experiments":
        from .experiments import main as exp_main

        return exp_main(argv[1:])
    if argv and argv[0] == "postgis":
        from .postgis import main as pg_main

        return pg_main(argv[1:])
    if argv and argv[0] == "serve":
        from .serve import main as serve_main

        return serve_main(argv[1:])

    parser = argparse.ArgumentParser(
        prog="aqpc-torch",
        description="Ad-hoc point cloud queries on a CUDA GPU (LAS/LAZ/LAST/LAZER)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    qp = sub.add_parser("query", help="Run a bbox/class/time/density query")
    build_query_parser(qp)
    qp.set_defaults(fn=cmd_query)

    cp = sub.add_parser("convert", help="Convert LAS to LAST/LAZER/LAZ")
    cp.add_argument("-i", "--input", required=True)
    cp.add_argument("-o", "--output", required=True)
    cp.add_argument("--lazer-block-size", type=int, default=50_000)
    cp.add_argument(
        "--strict-laz", action="store_true",
        help="LAZ output: refuse anything outside the maximally-conservative "
             "interop subset (formats 0-3, fixed chunks; "
             "docs/LASZIP_INTEROP.md)",
    )
    cp.set_defaults(fn=cmd_convert)

    np_ = sub.add_parser("count-points", help="Header-only total point count")
    np_.add_argument("-i", "--input", required=True)
    np_.set_defaults(fn=cmd_count_points)

    ix = sub.add_parser("index", help="Build block min/max sidecar indexes")
    ix.add_argument("-i", "--input", required=True)
    ix.set_defaults(fn=cmd_index)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
