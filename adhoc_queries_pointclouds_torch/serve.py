"""Interactive / service mode: a device-resident dataset and a JSON query
protocol.

The counterpart of adhoc_queries_pointclouds_tpu/serve.py, with the same
protocol. `serve -i DATASET` loads the dataset's columns into device memory
once (parallel/resident.py), sharded over the devices of --device and
--devices as the CLI's queries are (every local card by default), and then
answers ad-hoc queries from stdin, one JSON object per line, one JSON reply
per line; each count is one kernel launch a device over its resident
blocks and one read-back.

Request lines:
  {"bounds": [minx, miny, minz, maxx, maxy, maxz]}
  {"class": 6}
  {"time_range": [start, end]}          (GPS-time, needs a gps-time format)
  ... any of the above plus:
      "density": X                      (max-density sampling)
      "collect": true, "limit": K       -> up to K hit points in the reply
      "output": "/dir"                  -> write matching points as LAS
  {"cmd": "info"}        -> dataset stats
  {"cmd": "quit"}

Replies:
  {"count": N, "ms": 12.3}
  {"count": N, "ms": ..., "points": [[x,y,z,class], ...], "files": [...]}
  {"error": "..."}
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .models.query import (
    BoundsQuery,
    ClassQuery,
    DensityConfig,
    QueryPlan,
    TimeRangeQuery,
)
from .parallel.mesh import local_devices
from .parallel.resident import ResidentDataset
from .utils.aabb import AABB
from .utils.timing import span


def handle_request(ds: ResidentDataset, req: dict, input_path: str) -> dict:
    if req.get("cmd") == "info":
        return {
            "files": [str(f) for f in ds.files],
            "points": ds.total_points,
            "resident_mib": round(ds.resident_bytes / 1048576.0, 1),
            "blocks": ds.n_blocks,
            "devices": len(ds.devices),
        }
    with span("serve.parse"):
        try:
            density = DensityConfig(float(req["density"])) if "density" in req else None
            if "bounds" in req:
                v = [float(x) for x in req["bounds"]]
                if len(v) != 6:
                    return {"error": "bounds must have 6 numbers"}
                plan = QueryPlan(
                    bounds=BoundsQuery(AABB(tuple(v[:3]), tuple(v[3:]))),
                    density=density,
                )
            elif "class" in req:
                plan = QueryPlan(classification=ClassQuery(int(req["class"])), density=density)
            elif "time_range" in req:
                t = [float(x) for x in req["time_range"]]
                if len(t) != 2:
                    return {"error": "time_range must have 2 numbers"}
                plan = QueryPlan(time_range=TimeRangeQuery(t[0], t[1]), density=density)
            else:
                return {"error": "request needs 'bounds', 'class', 'time_range', or 'cmd'"}
        except (ValueError, TypeError) as e:
            return {"error": str(e)}

    wants_points = bool(req.get("collect"))
    output_dir = req.get("output")
    t0 = time.perf_counter()
    try:
        if wants_points or output_dir:
            count, emitter = ds.collect(
                plan,
                output_dir=Path(output_dir) if output_dir else None,
                keep_hits=wants_points,
                # a preview gathers only the hits it returns; the LAS files
                # of an -o request need every hit
                limit=None if output_dir else int(req.get("limit", 1000)),
            )
            reply = {"count": count, "ms": round((time.perf_counter() - t0) * 1e3, 2)}
            if wants_points:
                limit = int(req.get("limit", 1000))
                pts = []
                for hits in emitter.all_hits:
                    for j in range(hits.count):
                        if len(pts) >= limit:
                            break
                        p = hits.position_world[j]
                        pts.append(
                            [round(p[0], 6), round(p[1], 6), round(p[2], 6),
                             int(hits.classification[j])]
                        )
                    if len(pts) >= limit:
                        break
                reply["points"] = pts
                reply["truncated"] = count > len(pts)
            if output_dir:
                reply["files"] = [str(f) for f in emitter.output_files]
            return reply
        count = ds.count(plan)  # density plans run resident too
        return {"count": count, "ms": round((time.perf_counter() - t0) * 1e3, 2)}
    except NotImplementedError:
        from .engine import run_query

        res = run_query(input_path, plan, device=ds.device, devices=ds.devices)
        return {
            "count": res.match_count,
            "ms": round((time.perf_counter() - t0) * 1e3, 2),
            "path": "streaming",
        }
    except Exception as e:  # the service answers every line; the error is the reply
        return {"error": f"{type(e).__name__}: {e}"}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="aqpc-torch-serve", description="Resident-dataset query service (JSON lines)"
    )
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default) or cpu")
    parser.add_argument("--devices", type=int, default=None,
                        help="Devices to shard the dataset over: the first N of --device's "
                             "(default: every local card; cpu: one)")
    parser.add_argument("--block-size", type=int, default=1 << 21)
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args(argv)
    try:
        devices = local_devices(args.device, args.devices)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    attrs = ["position", "classification"]
    # keep GPS times resident too when every file has them (resident
    # time_range queries; +8 B a point of device memory)
    from .engine import discover_files
    from .formats.las import has_gps_time, parse_las_header_file

    files = discover_files(args.input)
    if files and all(
        has_gps_time(parse_las_header_file(f).point_format) for f in files
    ):
        attrs.append("gps_time")
    ds = ResidentDataset.load(
        args.input,
        devices=devices,
        attrs=tuple(attrs),
        block_size=args.block_size,
        workers=args.workers,
    )
    print(
        json.dumps(
            {
                "ready": True,
                "points": ds.total_points,
                "resident_mib": round(ds.resident_bytes / 1048576.0, 1),
                "load_s": round(time.perf_counter() - t0, 2),
            }
        ),
        flush=True,
    )

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"error": f"bad json: {e}"}), flush=True)
            continue
        if req.get("cmd") == "quit":
            print(json.dumps({"bye": True}), flush=True)
            return 0
        print(json.dumps(handle_request(ds, req, args.input)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
