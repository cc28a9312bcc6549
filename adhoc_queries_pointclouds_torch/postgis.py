"""PostGIS / pgPointcloud baseline driver of the port — the reference
`run_postgis_queries` binary (query/src/bin/run_postgis_queries.rs), a copy
of adhoc_queries_pointclouds_tpu/postgis.py over the port's experiment
constants (experiments.AABBS). It runs no device code.

    python -m adhoc_queries_pointclouds_torch.cli postgis --host H --dbname D --user U --pwd P

Runs the paper's database-side comparison queries against a PostGIS server
with the pgPointcloud extension, tables `navvis`/`doc`/`ca13` with a patch
column `pa` (reference README.md:84-102):

  - patch-level bbox count:   PC_Intersects(pa, ST_MakeEnvelope(...))
    (run_postgis_queries.rs:67-92)
  - exact point-level count:  sum(PC_NumPoints(PC_Intersection(pa, geom)))
    (rs:94-127)
  - class queries:            PC_FilterEquals(pa, 'Classification', c)
    (rs:186-220)

Protocol: 5 iterations per query, report median s +- stddev and Mpts/s as
LaTeX table rows (rs:129-181). Dataset point totals for the Mpts/s figures
are the published sizes (rs:22-24).

Requires a live PostgreSQL and a Python driver (psycopg2/psycopg/pg8000 —
none is a dependency of this package, so this module raises a clear error
unless one is installed where it runs).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

from .experiments import AABBS

# published dataset sizes in Mpts (run_postgis_queries.rs:22-24)
DATASET_MPTS = {"navvis3": 56.2, "doc": 854.0, "ca13": 2608.0}

# the reference's table names drop the navvis suffix digit
TABLE_NAMES = {"navvis3": "navvis", "doc": "doc", "ca13": "ca13"}


def _connect(host: str, dbname: str, user: str, password: str):
    last_err = None
    for mod_name in ("psycopg2", "psycopg", "pg8000.dbapi"):
        try:
            import importlib

            mod = importlib.import_module(mod_name)
            return mod.connect(host=host, dbname=dbname, user=user, password=password)
        except ImportError as e:
            last_err = e
    raise RuntimeError(
        "No PostgreSQL driver available (psycopg2/psycopg/pg8000). "
        f"Install one to run the PostGIS baseline. ({last_err})"
    )


def _envelope(bounds) -> str:
    (minx, miny, _minz), (maxx, maxy, _maxz) = bounds.min, bounds.max
    return f"ST_MakeEnvelope({minx}, {miny}, {maxx}, {maxy})"


def patch_bbox_sql(table: str, bounds) -> str:
    return (
        f"SELECT sum(PC_NumPoints(pa)) FROM {table} "
        f"WHERE PC_Intersects(pa, {_envelope(bounds)});"
    )


def exact_bbox_sql(table: str, bounds) -> str:
    env = _envelope(bounds)
    return (
        f"SELECT sum(PC_NumPoints(PC_Intersection(pa, {env}))) FROM {table} "
        f"WHERE PC_Intersects(pa, {env});"
    )


def class_sql(table: str, classification: int) -> str:
    return (
        f"SELECT sum(PC_NumPoints(PC_FilterEquals(pa, 'Classification', "
        f"{classification}))) FROM {table};"
    )


def run_timed(conn, sql: str, iterations: int = 5) -> tuple[list[float], int]:
    times = []
    result = 0
    for _ in range(iterations):
        cur = conn.cursor()
        t0 = time.perf_counter()
        cur.execute(sql)
        row = cur.fetchone()
        times.append(time.perf_counter() - t0)
        result = int(row[0] or 0)
        cur.close()
    return times, result


def latex_row(name: str, dataset: str, times: list[float]) -> str:
    """median s +- stddev and Mpts/s, LaTeX formatted (rs:145-157)."""
    median = statistics.median(times)
    stddev = statistics.stdev(times) if len(times) > 1 else 0.0
    mpts_per_s = DATASET_MPTS[dataset] / median if median > 0 else 0.0
    return (
        f"{name} & ${median:.2f}s \\pm {stddev:.2f}s$ & "
        f"${mpts_per_s:.2f}$\\,Mpts/s \\\\"
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="aqpc-postgis", description="Run the PostGIS baseline queries"
    )
    parser.add_argument("--host", required=True)
    parser.add_argument("--dbname", required=True)
    parser.add_argument("--user", required=True)
    parser.add_argument("--pwd", required=True)
    parser.add_argument("--iterations", type=int, default=5)
    args = parser.parse_args(argv)

    conn = _connect(args.host, args.dbname, args.user, args.pwd)

    for dataset, boxes in AABBS.items():
        table = TABLE_NAMES[dataset]
        for size in ("s", "l", "xl"):
            for kind, sql_fn in (("patch", patch_bbox_sql), ("exact", exact_bbox_sql)):
                sql = sql_fn(table, boxes[size])
                try:
                    times, count = run_timed(conn, sql, args.iterations)
                except Exception as e:
                    print(f"{dataset}_{size}_{kind}: failed ({e})", file=sys.stderr)
                    conn.rollback()
                    continue
                print(f"% {dataset}_{size}_{kind}: {count} points", file=sys.stderr)
                print(latex_row(f"{dataset}\\_{size}\\_{kind}", dataset, times))
    for dataset in ("doc", "ca13"):
        table = TABLE_NAMES[dataset]
        for class_name, class_value in (("building", 6), ("noclass", 19)):
            sql = class_sql(table, class_value)
            try:
                times, count = run_timed(conn, sql, args.iterations)
            except Exception as e:
                print(f"{dataset}_{class_name}: failed ({e})", file=sys.stderr)
                conn.rollback()
                continue
            print(f"% {dataset}_{class_name}: {count} points", file=sys.stderr)
            print(latex_row(f"{dataset}\\_{class_name}", dataset, times))
    conn.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
