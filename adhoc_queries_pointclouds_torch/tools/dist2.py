"""A real multi-process run of the port's distributed queries.

The counterpart of the JAX package's tools/dist2.py: it spawns worker
processes, joins them in a gloo group over tcp://127.0.0.1 (parallel/
distributed.py initialize), and runs every query kind of that harness
through parallel/distributed.py, on CUDA devices or on the CPU (--device;
--devices n gives each process n shards, parallel/distributed.py
process_devices: with cuda, process i's are the cards (i * n + j) % the
card count, so two processes of one shard, or of two, share a single
card):

  - bbox, class and GPS-time counts, in both transports (AQPC_PACK 1, 0)
  - a bbox collect with -o          (each process writes its own files'
                                     hits under host{i}/)
  - density at file scope, at global scope and with no box (the grid from
    the union of every file's header), each with -o
  - sidecar-index pruning over a clustered, indexed manifest
  - global density over files with exact d2 ties across processes, a
    count over a manifest of one file (the second process's shard is
    empty), and a dictionary class count whose blocks hold the target
    class alone (each process counts them on the host, with no step)
  - the union of the processes' global-scope density winner keys
    (distributed._allgather_keys), whose distinct keys are the global
    winner count

    python -m adhoc_queries_pointclouds_torch.tools.dist2 [--device cuda|cpu] [--procs 2] \
        [--devices n]

writes the datasets from a seed (synth.write_dataset) into a temporary
directory, runs the queries in --procs processes and again in one process,
and exits 0 when every count and every written file agrees: the same
counts, the same multiset of per-file LAS outputs, and for global density
the same winner points.

As a library, run_workers(queries, procs=, device=, devices=) runs a list
of query specs (default_queries gives the one above; chip_smoke.py and the
tests give their own) and returns each worker's report. A worker
(`--worker QUERIES.json --pid I --port P --procs N`) prints one JSON line:
its devices, its per-query count, written files, index-skipped blocks,
wall seconds (from a barrier before the query to its return) and kernel
launches by card ([kernel, card, launches] triples), and its kernel
launches in all.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import _build, index as index_mod, native
from ..engine import discover_files, run_query
from ..formats import open_point_cloud, synth
from ..models.query import BoundsQuery, ClassQuery, DensityConfig, QueryPlan, TimeRangeQuery
from ..ops import predicate
from ..parallel import distributed
from ..utils.aabb import parse_aabb

REPO = Path(__file__).resolve().parents[2]

BOX = "100200;200300;10;102900;200900;70"
TIME_RANGE = (100_000.0, 700_000.0)
CLASS = 6
DENSITY_CELL = 50.0
DENSITY_CELL_NOBOX = 150.0
BLOCK = 1 << 14
# clustered + indexed manifest: a corner box over Morton-ordered files so
# the sidecar index can skip blocks
SMALL_BOX = "100650;200650;0;100980;200980;100"
BLOCK_IDX = 1 << 12


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------- datasets --


def write_datasets(root: Path, *, files: int = 3, points: int = 20_000) -> None:
    """The harness's datasets under root, from fixed seeds:
    data/last (files x points, point format 1), data_idx/last (2 clustered
    files, indexed at BLOCK_IDX), data_ties/last (2 files and a byte copy
    of the second as file_2: every point of file_1 ties with one of
    file_2, which the other process reads), data_cls/last (2 files of
    class CLASS alone)."""
    synth.write_dataset(root / "data", n_files=files, points_per_file=points, seed=97,
                        formats=("last",), point_format=1)
    synth.write_dataset(root / "data_idx", n_files=2, points_per_file=points, seed=98,
                        formats=("last",), clustered=True)
    for f in sorted((root / "data_idx" / "last").glob("*.last")):
        r = open_point_cloud(f)
        # index blocks at the engine block size: the default index block
        # would cover these small files with a single row
        blocks, bmp, gps = index_mod.build_index(r, index_block=BLOCK_IDX)
        index_mod.save_index(f, blocks, bmp, gps, index_block=BLOCK_IDX, n_points=r.point_count)
        r.close()
    ties = root / "data_ties" / "last"
    synth.write_dataset(root / "data_ties", n_files=2, points_per_file=points, seed=99,
                        formats=("last",), point_format=1)
    shutil.copyfile(ties / "file_1.last", ties / "file_2.last")
    synth.write_dataset(root / "data_cls", n_files=2, points_per_file=points, seed=100,
                        formats=("last",), point_format=1, classes=(CLASS,))


def default_queries(root: Path, out: Path) -> list[dict]:
    """The query specs over write_datasets(root); outputs go under out."""
    data = str(root / "data" / "last")
    qs = []
    for pack in ("1", "0"):
        qs += [
            {"name": f"bbox_count_pack{pack}", "data": data, "op": "count", "bounds": BOX,
             "pack": pack},
            {"name": f"class_count_pack{pack}", "data": data, "op": "count", "class": CLASS,
             "pack": pack},
            {"name": f"time_count_pack{pack}", "data": data, "op": "count",
             "time": list(TIME_RANGE), "pack": pack},
        ]
    qs += [
        {"name": "collect", "data": data, "op": "collect", "bounds": BOX,
         "out": str(out / "collect")},
        {"name": "density_file", "data": data, "op": "density", "bounds": BOX,
         "density": [DENSITY_CELL, "file"], "out": str(out / "density_file")},
        {"name": "density_global", "data": data, "op": "density", "bounds": BOX,
         "density": [DENSITY_CELL, "global"], "out": str(out / "density_global")},
        {"name": "density_nobox", "data": data, "op": "density", "class": CLASS,
         "density": [DENSITY_CELL_NOBOX, "global"], "out": str(out / "density_nobox")},
        {"name": "indexed_count", "data": str(root / "data_idx" / "last"), "op": "count",
         "bounds": SMALL_BOX, "block": BLOCK_IDX},
        {"name": "density_ties", "data": str(root / "data_ties" / "last"), "op": "density",
         "bounds": BOX, "density": [DENSITY_CELL, "global"], "out": str(out / "density_ties")},
        {"name": "one_file_count", "data": str(root / "data" / "last" / "file_0.last"),
         "op": "count", "bounds": BOX},
        {"name": "class_single_count", "data": str(root / "data_cls" / "last"), "op": "count",
         "class": CLASS, "pack": "1"},
        {"name": "density_keys", "data": data, "op": "keys", "bounds": BOX,
         "density": [DENSITY_CELL, "global"]},
    ]
    for q in qs:
        q.setdefault("block", BLOCK)
    return qs


# --------------------------------------------------------------- worker --


def query_plan(q: dict) -> QueryPlan:
    """The port's QueryPlan of a query spec."""
    return QueryPlan(
        bounds=BoundsQuery(parse_aabb(q["bounds"])) if "bounds" in q else None,
        classification=ClassQuery(q["class"]) if "class" in q else None,
        time_range=TimeRangeQuery(*q["time"]) if "time" in q else None,
        density=DensityConfig(*q["density"]) if "density" in q else None,
        output_dir=Path(q["out"]) if q.get("out") else None,
    )


def run_one(q: dict, devices: list) -> dict:
    """One query spec through parallel/distributed.py over devices, one a
    shard."""
    os.environ["AQPC_PACK"] = q.get("pack", "1")
    plan = query_plan(q)
    if plan.output_dir is not None:
        plan.output_dir.mkdir(parents=True, exist_ok=True)
    block = q.get("block", distributed.DEFAULT_BLOCK_SIZE)
    if distributed.process_count() > 1:
        dist.barrier()
    before = dict(predicate.device_launches)
    t0 = time.perf_counter()
    files, skipped = [], 0
    if q["op"] == "density":
        count = distributed.distributed_density(q["data"], plan, devices=devices,
                                                block_size=block)
        seconds = time.perf_counter() - t0
        host_out = distributed._host_output_dir(plan)
        if host_out is not None:  # matching_points_{n}.las, in the order of n
            files = [str(p) for p in sorted(host_out.glob("*.las"),
                                            key=lambda p: int(p.stem.rsplit("_", 1)[1]))]
    elif q["op"] == "keys":
        # this process's own global-scope winners, their cell keys gathered
        # from every process: each key has one champion, so the distinct
        # keys are the global winner count
        state: dict = {}
        mine = distributed.shard_manifest(discover_files(q["data"]))
        if mine:
            run_query(mine, plan, device=devices[0], devices=devices, block_size=block,
                      density_state_out=state)
        g = state.get("global")
        keys = distributed._allgather_keys(
            np.empty(0, np.uint64) if g is None else g["key"])
        count = len(np.unique(keys))
        seconds = time.perf_counter() - t0
    elif q["op"] == "collect":
        count, res = distributed.distributed_collect(q["data"], plan, devices=devices,
                                                     block_size=block)
        seconds = time.perf_counter() - t0
        files = [str(p) for p in res.output_files]
    else:
        res = distributed.distributed_query(q["data"], plan, devices=devices, block_size=block,
                                            use_index=q.get("use_index", True))
        seconds = time.perf_counter() - t0
        count = res.match_count
        skipped = int(res.timer.counts.get("index_skipped_blocks", 0))
    card_launches = [[kernel, card, n - before.get((kernel, card), 0)]
                     for (kernel, card), n in sorted(predicate.device_launches.items())
                     if n != before.get((kernel, card), 0)]
    return {"count": count, "files": files, "index_skipped_blocks": skipped, "seconds": seconds,
            "card_launches": card_launches}


def worker_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="dist2 --worker")
    ap.add_argument("queries", type=Path)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--procs", type=int, required=True)
    args = ap.parse_args(argv)
    cfg = json.loads(args.queries.read_text())
    if args.procs > 1:
        distributed.initialize(f"127.0.0.1:{args.port}", args.procs, args.pid,
                               timeout=datetime.timedelta(seconds=cfg["timeout"]))
    devices = distributed.process_devices(cfg["device"], cfg.get("devices"))
    device = devices[0]
    # the host codec, and on a card each card's context and the kernel
    # library, load once before any timed query
    native.load()
    if device.type == "cuda":
        for dev in dict.fromkeys(devices):
            torch.empty(1, device=dev)
        _build.library()
    predicate.reset_launches()
    results = {q["name"]: run_one(q, devices) for q in cfg["queries"]}
    report = {
        "pid": distributed.process_index(), "procs": distributed.process_count(),
        "device": str(device), "devices": [str(d) for d in devices],
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "queries": results,
        "launches": {k: v for k, v in predicate.launches.items() if v},
    }
    print(json.dumps(report), flush=True)
    if args.procs > 1:
        dist.destroy_process_group()
    return 0


# --------------------------------------------------------------- parent --


def run_processes(argvs: list[list[str]], *, timeout: float, env: dict | None = None,
                  cwd=REPO) -> list[tuple[int, str]]:
    """Start one process for each command line at once and wait for all;
    returns each one's (exit code, output). When one exits non-zero (its
    peers would wait for it in a collective) or timeout seconds pass, every
    process still running is stopped (a negative exit code)."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    # every process is on this host: the group talks over the loopback
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    with tempfile.TemporaryDirectory(prefix="aqpc_procs_") as tmp:
        try:
            for i, argv in enumerate(argvs):
                # output to a file, not a pipe: the processes wait on each
                # other in collectives, so draining pipes in turn can
                # deadlock on a full one
                log = open(Path(tmp) / f"process_{i}.log", "w+")
                procs.append((subprocess.Popen(argv, env=env, cwd=str(cwd), stdout=log,
                                               stderr=subprocess.STDOUT, text=True), log))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p, _ in procs):
                if any(p.poll() not in (None, 0) for p, _ in procs):
                    break  # a peer failed: the others would wait in a collective
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        done = []
        for p, log in procs:
            log.seek(0)
            done.append((p.returncode, log.read()))
            log.close()
    return done


def run_workers(queries: list[dict], *, procs: int = 2, device: str = "cuda",
                devices: int | None = None, timeout: float = 600.0,
                command: list[str] | None = None, env: dict | None = None) -> list[dict]:
    """Run the query specs in procs worker processes, each over devices
    shards of device (one without devices); returns their reports by
    process index. A worker that exits non-zero, or a run that outlasts
    timeout seconds, stops every worker and raises. command is the worker's
    command line up to the queries file (default: this module's
    --worker)."""
    command = command or [sys.executable, "-m", "adhoc_queries_pointclouds_torch.tools.dist2",
                          "--worker"]
    with tempfile.TemporaryDirectory(prefix="aqpc_dist2_") as tmp:
        cfg = Path(tmp) / "queries.json"
        cfg.write_text(json.dumps({"device": device, "devices": devices, "timeout": timeout,
                                   "queries": queries}))
        port = free_port()
        done = run_processes([[*command, str(cfg), "--pid", str(pid), "--port", str(port),
                               "--procs", str(procs)] for pid in range(procs)],
                             timeout=timeout, env=env)
    failed = [pid for pid, (rc, _) in enumerate(done) if rc != 0]
    if failed:
        raise RuntimeError(f"dist2: {procs} workers exited {[rc for rc, _ in done]} "
                           f"(a negative code: stopped, after a peer failed or at the "
                           f"{timeout} s timeout):\n" + "\n".join(
                               f"--- worker {pid}:\n{done[pid][1][-6000:]}" for pid in failed))
    reports = []
    for pid, (_, text) in enumerate(done):
        lines = [line for line in text.splitlines() if line.startswith('{"pid": ')]
        if not lines:
            raise RuntimeError(f"dist2 worker {pid} printed no report:\n{text[-6000:]}")
        reports.append(json.loads(lines[-1]))
    return reports


def file_digests(paths) -> list[str]:
    """The sorted sha256 digests of files: a multiset of their bytes."""
    return sorted(hashlib.sha256(Path(p).read_bytes()).hexdigest() for p in paths)


def point_rows(paths) -> list[tuple]:
    """Every point of the LAS files, as sorted (x, y, z, class, intensity,
    r, g, b) tuples: world coordinates to the micrometre, since each file's
    write-back header takes its own points' least corner as its offset."""
    rows = []
    for p in paths:
        r = open_point_cloud(Path(p))
        cols = np.column_stack([np.round(r.positions_world(), 6), r.column("classification"),
                                r.column("intensity"), r.column("color")])
        rows += [tuple(v) for v in cols.tolist()]
        r.close()
    return sorted(rows)


def compare(queries: list[dict], got: list[dict], want: dict) -> None:
    """Hold every worker's report of a multi-process run to the reference
    (name -> {"count", "files"}, one process): each worker's count is the
    reference's; per-file outputs (collect, file-scope density) are the
    same multiset of file bytes; global-scope density outputs hold the same
    points. Raises AssertionError on the first difference."""
    for q in queries:
        name = q["name"]
        counts = [w["queries"][name]["count"] for w in got]
        if any(c != want[name]["count"] for c in counts):
            raise AssertionError(f"{name}: workers counted {counts}, one process "
                                 f"{want[name]['count']}")
        if not q.get("out"):
            continue
        files = [f for w in got for f in w["queries"][name]["files"]]
        if q["op"] == "density" and q["density"][1] == "global":
            same = point_rows(files) == point_rows(want[name]["files"])
        else:
            same = file_digests(files) == file_digests(want[name]["files"])
        if not same:
            raise AssertionError(f"{name}: the workers' {len(files)} files differ from the "
                                 f"one process's {len(want[name]['files'])}")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--worker"]:
        return worker_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m adhoc_queries_pointclouds_torch.tools.dist2")
    ap.add_argument("--device", default="cuda", help="cuda (process i on card i %% n) or cpu")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices", type=int, default=None,
                    help="shards a process (default one): process i's are the cards "
                         "(i * n + j) %% the card count, or n CPU shards")
    ap.add_argument("--files", type=int, default=3)
    ap.add_argument("--points", type=int, default=20_000)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="aqpc_dist2_data_") as td:
        root = Path(td)
        write_datasets(root, files=args.files, points=args.points)
        got = run_workers(default_queries(root, root / "out"), procs=args.procs,
                          device=args.device, devices=args.devices, timeout=args.timeout)
        queries = default_queries(root, root / "out1")
        (one,) = run_workers(queries, procs=1, device=args.device, timeout=args.timeout)
        compare(queries, got, one["queries"])
        if sum(w["queries"]["indexed_count"]["index_skipped_blocks"] for w in got) == 0:
            raise AssertionError("no index pruning through the distributed path")
    shards = ", ".join(f"process {w['pid']} on {' + '.join(w['devices'])}" for w in got)
    print(f"PASS: {args.procs}-process distributed queries ({shards}) equal one "
          f"process's: " + ", ".join(f"{q['name']}={one['queries'][q['name']]['count']}"
                                     for q in queries))
    return 0


if __name__ == "__main__":
    sys.exit(main())
