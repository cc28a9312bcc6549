"""Query engine of the port: bbox, class and GPS-time counts and collects,
and max-density grid sampling, over a set of point-cloud files.

The counterpart of adhoc_queries_pointclouds_tpu/engine.py run_query,
_run_count (engine.py:395-924), _run_collect and _run_collect_mesh
(engine.py:932-1439) and _run_density (engine.py:1441-1849):

  host decode-ahead feeder -> d x K blocks per step -> K blocks a device,
  H2D copy -> one kernel launch a device per step -> int32 totals, read
  back a few steps behind the dispatch -> a Python-int total (count); or
  -> a bit mask and per-block counts a device, read back a few steps
  behind the dispatch -> one compaction launch a device for its blocks
  with some but not all points matching -> hit indices, in device order
  -> hits gathered from the files and emitted in file order (collect: -o
  LAS write-back, --print-points, keep_hits)

The d devices are parallel/mesh.py's (run_query's devices; one by
default): a step's rows are split into d contiguous groups as JAX's
shard_map splits them, and no answer depends on d.

Each predicate has two transports. AQPC_PACK=1, the default, ships bbox
coordinates and the (hi, lo) int32 encoding of GPS times as bit-planar
residuals, and classes as per-block dictionary codes; AQPC_PACK=0 ships raw
int32 columns and the u8 class column (the count path views it as int32
words when the block size is a multiple of 4).

Sidecar-index pruning works as in the JAX engine: bbox and time plans skip
index blocks disjoint from the query, count (or emit) contained ones with no
point IO and pack straddling ones into full multi-range device blocks; class
plans scan only the index blocks whose class bitmap holds the target. A full
bbox scan of an unindexed file writes its sidecar (min/max only: its class
bitmap is all-present and it has no GPS ranges, so it prunes nothing for
class and time plans). The index format is the JAX package's.

A density plan (--density) keeps at most one point per grid cell, the one
closest to the cell's centre, per file or over the whole query: K-block
steps run the predicate and the candidate selection of ops/density.py on
the device, the candidates' indices come back, and the host resolves them
exactly in f64 (GridSpec3D, WinnerAccum) and emits the winners.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
from collections import deque
from pathlib import Path

import numpy as np

from . import host, index as index_mod
from .ops import density as density_ops
from .formats import is_valid_file, open_point_cloud
from .formats.las import has_gps_time
from .parallel import step
from .parallel.comm import LocalStepComm
from .parallel.mesh import step_rows
from .parallel.pipeline import BlockFeeder, BlockTask, task_gidx
from .sinks import FileHits, HitEmitter, concat_hits, empty_hits, gather_hits
from .utils.aabb import AABB, clamp_bounds_to_i32, local_query_bounds
from .utils.timing import StageTimer

DEFAULT_BLOCK_SIZE = 1 << 21  # 2M points: 24 MiB of xyz per block
# Blocks of files smaller than the block size are cut to a multiple of this,
# as the JAX engine does off the TPU, so both engines cut identical blocks.
BLOCK_QUANTUM = 8192

_libc = None


def _init_malloc() -> None:
    """Pin glibc's mmap threshold so multi-MB block buffers never graduate
    into sbrk arenas.

    glibc's M_MMAP_THRESHOLD is DYNAMIC: freeing an mmap'd chunk raises the
    threshold (up to 32 MiB), after which the engine's 4-24 MiB per-block
    column copies are carved from arena heaps whose freed chunks are kept,
    not returned, and anonymous RSS then grows with the bytes scanned.
    Pinning the threshold at 1 MiB keeps every block-sized buffer an mmap
    that free() returns to the OS. AQPC_MALLOC_PIN=0 disables."""
    global _libc
    if os.environ.get("AQPC_MALLOC_PIN", "1") == "0":
        return
    try:
        import ctypes

        _libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        _libc.mallopt(M_MMAP_THRESHOLD, 1 << 20)
    except Exception:
        _libc = None


_init_malloc()


def discover_files(input_path) -> list[Path]:
    """File or flat directory listing with extension filter (main.rs:29-57).
    Also accepts an explicit sequence of file paths."""
    if isinstance(input_path, (list, tuple)):
        files = [Path(f) for f in input_path]
        for f in files:
            if not f.exists():
                raise FileNotFoundError(f"Input path {f} does not exist!")
        return [f for f in files if is_valid_file(f)]
    p = Path(input_path)
    if not p.exists():
        raise FileNotFoundError(f"Input path {p} does not exist!")
    if p.is_file():
        files = [p]
    elif p.is_dir():
        files = sorted(c for c in p.iterdir() if c.is_file())
    else:
        raise ValueError(f"Input path {p} is neither file nor directory!")
    return [f for f in files if is_valid_file(f)]


def get_total_bounds(readers) -> AABB:
    """Union of per-file header bounds (main.rs:94-120)."""
    total = AABB.empty()
    for r in readers:
        total = total.union(r.header.bounds)
    return total


@dataclasses.dataclass
class QueryResult:
    match_count: int
    total_file_bytes: int
    elapsed_seconds: float
    timer: StageTimer
    files_searched: int
    points_scanned: int = 0
    hits: list[FileHits] = dataclasses.field(default_factory=list)  # keep_hits only
    output_files: list[Path] = dataclasses.field(default_factory=list)

    @property
    def throughput_mibs(self) -> float:
        return self.total_file_bytes / 1048576.0 / max(self.elapsed_seconds, 1e-12)

    @property
    def mpts_per_s(self) -> float:
        return self.points_scanned / 1e6 / max(self.elapsed_seconds, 1e-12)


def run_query(
    input_path,
    plan,
    *,
    device,
    devices=None,
    block_size: int = DEFAULT_BLOCK_SIZE,
    workers: int = 8,
    prefetch: int = 12,
    keep_hits: bool = False,
    force_collect: bool = False,
    keep_going: bool = False,
    use_index: bool = True,
    print_stream=None,
    density_grid_bounds: AABB | None = None,
    density_state_out: dict | None = None,
    comm=None,
) -> QueryResult:
    """Count or collect the points of a file or directory that match plan's
    predicate: its closed box, its class, or its half-open GPS-time range;
    with plan.density, keep of them one point per grid cell.

    device: the torch.device (or its name) every step runs on. "cuda" runs
    the hand-written kernels and raises when CUDA is absent; "cpu" runs
    their plain PyTorch versions.
    devices: the devices of a step's shards instead, one a shard
    (parallel/mesh.py local_devices; a device may repeat): each step's
    rows are split over them as JAX's mesh of n_devices splits them.
    keep_hits: also return every hit's attributes, per file (forces the
    collect path; for tests and small queries: it holds all hits in RAM).
    force_collect: run the collect path with no consumer (count only).
    keep_going: skip unreadable files with a warning instead of aborting the
    whole query (the reference aborts on any file error, main.rs:161-163).
    print_stream: stream matching points here as they are found (the
    reference's StdOutCollector, collect_points.rs:46-70). Defaults to
    sys.stdout when plan.print_points is set.
    density_grid_bounds: the density grid's bounds; default the query box,
    else the union of the files' header bounds. Runs that split one query
    over several file lists share one grid this way.
    density_state_out: a dict that receives the winners (WINNER_DTYPE rows)
    of a density plan: under "global", or under "file" a dict by file index.
    comm: the step-communication strategy (parallel/comm.py); default
    LocalStepComm(devices or device), one process. An empty file list raises only for a
    lone participant (comm.is_local): a process of a multi-process run whose
    share of the files is empty still joins the final reductions
    (parallel/distributed.py).
    """
    comm = comm or LocalStepComm(devices or device)
    if print_stream is None and plan.print_points:
        print_stream = sys.stdout
    timer = StageTimer()
    files = discover_files(input_path)
    if not files and comm.is_local:
        raise FileNotFoundError(f"No supported point-cloud files under {input_path}")
    total_bytes = sum(f.stat().st_size for f in files)

    with timer.stage("open"):
        if keep_going:
            readers = []
            kept = []
            for f in files:
                try:
                    readers.append(open_point_cloud(f))
                    kept.append(f)
                except Exception as e:
                    print(f"warning: skipping {f}: {e}", file=sys.stderr)
            files = kept
            if not files and comm.is_local:
                raise FileNotFoundError(f"No readable point-cloud files under {input_path}")
        else:
            readers = [open_point_cloud(f) for f in files]

    # Clamp the block to the largest file: tiny files padded to a huge block
    # would waste device work.
    max_pts = max((r.point_count for r in readers), default=0)
    if max_pts and max_pts < block_size:
        quantum = BLOCK_QUANTUM
        block_size = min(block_size, ((max_pts + quantum - 1) // quantum) * quantum)

    is_bounds = plan.bounds is not None

    if plan.time_range is not None:
        for f, r in zip(files, readers):
            if not has_gps_time(r.header.point_format):
                raise ValueError(f"File {f} does not contain GPS times!")

    # Per-file integer-domain bounds + header prefilter (las.rs:82-99); class
    # and time plans keep every file active.
    file_bounds: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    active = []
    for i, r in enumerate(readers):
        if is_bounds:
            if not r.header.bounds.intersects(plan.bounds.bounds):
                continue
            lo64, hi64 = local_query_bounds(
                plan.bounds.bounds,
                r.header.scale,
                r.header.offset,
                parity_quirk=plan.parity_quirk,
            )
            lo, hi = clamp_bounds_to_i32(lo64, hi64)
            file_bounds[i] = (lo, hi)
        active.append(i)

    grid = None
    if plan.density is not None:
        if density_grid_bounds is not None:
            grid_bounds = density_grid_bounds
        elif is_bounds:
            grid_bounds = plan.bounds.bounds
        else:
            grid_bounds = get_total_bounds(readers)
        grid = density_ops.GridSpec3D.create(grid_bounds, plan.density.cell_size)

    # Optional block min/max sidecar index: exact results are preserved, the
    # index only removes work. A full bbox scan of an unindexed file builds
    # its sidecar on the fly; class and time loaders read no positions, so
    # their collectors would never complete. Density plans skip the
    # auto-build: the grid needs every in-box point, so a sidecar can only
    # prune disjoint blocks for them, and collecting per-block min/max runs
    # on the host's critical path.
    file_indices_meta: dict[int, tuple] = {}
    index_collectors: dict[int, index_mod.IndexCollector] = {}
    if use_index:
        for i in active:
            info = index_mod.load_index(files[i])
            if info is not None:
                file_indices_meta[i] = info
        if (is_bounds and plan.density is None
                and os.environ.get("AQPC_AUTO_INDEX", "1") != "0"):
            for i in active:
                if i not in file_indices_meta:
                    index_collectors[i] = index_mod.IndexCollector(readers[i].point_count)

    if plan.collects_points or keep_hits or force_collect:
        match_count, hits, output_files = _run_collect(
            plan, readers, active, file_bounds, grid,
            block_size=block_size, workers=workers, prefetch=prefetch, timer=timer,
            keep_hits=keep_hits, block_index=file_indices_meta,
            index_collectors=index_collectors, print_stream=print_stream, comm=comm,
            density_state_out=density_state_out,
        )
    else:
        match_count = _run_count(
            plan, readers, active, file_bounds,
            block_size=block_size, workers=workers, prefetch=prefetch, timer=timer,
            block_index=file_indices_meta, index_collectors=index_collectors,
            comm=comm,
        )
        hits, output_files = [], []

    for i, collector in index_collectors.items():
        if collector.save_if_complete(files[i]):
            timer.counts["index_built_files"] += 1

    # points actually scanned = points of files that survived the header
    # prefilter, minus points of blocks the sidecar index pruned (skipped or
    # counted without IO)
    points_scanned = sum(readers[i].point_count for i in active)
    points_scanned -= timer.counts.get("index_pruned_points", 0)
    for r in readers:
        r.close()
    return QueryResult(
        match_count=match_count,
        total_file_bytes=total_bytes,
        elapsed_seconds=timer.elapsed(),
        timer=timer,
        files_searched=len(files),
        points_scanned=points_scanned,
        hits=hits,
        output_files=output_files,
    )


def _plan_tasks(plan, readers, active, file_bounds, block_index, block_size, timer,
                *, ordered: bool):
    """The device blocks of a query after sidecar-index pruning.

    Returns the tasks ((file, block, start, stop), or multi-range ones that
    pack index ranges into full device blocks), the points of index-CONTAINED
    ranges (every point matches, no device pass) and each file's emission
    plan. ordered (collect): scan ranges are packed segment-wise between the
    contained ranges, so every packed task's points lie strictly between its
    neighbouring ("all", s, e) entries and hits still stream out in file
    order; the plan lists ("scan",) per task. Unordered (count): each file's
    scan ranges pack together.
    """
    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None
    emit_queue: dict[int, deque] = {i: deque() for i in active}
    tasks = []
    contained_points = 0
    skipped_blocks = contained_blocks = pruned_points = 0

    def add(i, ranges):
        new_tasks = host._pack_range_tasks(i, ranges, block_size)
        emit_queue[i].extend(("scan",) for _ in new_tasks)
        tasks.extend(new_tasks)

    for i in active:
        n = readers[i].point_count
        idx_info = block_index.get(i)
        if idx_info is not None and not is_bounds and not is_time:
            # class pruning at file scope: index blocks whose bitmap holds
            # the class; skipped ranges hold no hit
            ranges = index_mod.class_present_ranges(
                idx_info[2], idx_info[0], 0, n, plan.classification.classification)
            kept = sum(e - s for s, e in ranges)
            if kept < n:
                skipped_blocks += max((n - kept) // idx_info[0], 1)
                pruned_points += n - kept
            add(i, ranges)
            continue
        if idx_info is not None and (is_bounds or (is_time and idx_info[3] is not None)):
            # bbox / GPS-time pruning at file scope, at the index's 65k
            # granularity: straddling sub-blocks are scanned, fully-inside
            # ones match with zero point IO
            if is_bounds:
                lo, hi = file_bounds[i]
                scan_rs, cont_rs = index_mod.bbox_scan_ranges(
                    idx_info[1], idx_info[0], 0, n, lo, hi)
            else:
                scan_rs, cont_rs = index_mod.time_scan_ranges(
                    idx_info[3], idx_info[0], 0, n,
                    plan.time_range.start, plan.time_range.end)
            cont_pts = sum(e - s for s, e in cont_rs)
            scan_pts = sum(e - s for s, e in scan_rs)
            contained_points += cont_pts
            if cont_pts:
                contained_blocks += max(cont_pts // idx_info[0], 1)
            if n - scan_pts - cont_pts > 0:
                skipped_blocks += max((n - scan_pts - cont_pts) // idx_info[0], 1)
            pruned_points += n - scan_pts
            if not ordered:
                add(i, scan_rs)
                continue
            seg: list[tuple[int, int]] = []
            ci = 0
            for s, e in scan_rs:
                while ci < len(cont_rs) and cont_rs[ci][1] <= s:
                    add(i, seg)
                    seg = []
                    emit_queue[i].append(("all",) + tuple(cont_rs[ci]))
                    ci += 1
                seg.append((s, e))
            add(i, seg)
            emit_queue[i].extend(("all", cs, ce) for cs, ce in cont_rs[ci:])
            continue
        for b in range((n + block_size - 1) // block_size):
            start = b * block_size
            emit_queue[i].append(("scan",))
            tasks.append((i, b, start, min(start + block_size, n)))
    if skipped_blocks or contained_blocks:
        timer.counts["index_skipped_blocks"] += skipped_blocks
        timer.counts["index_contained_blocks"] += contained_blocks
        timer.counts["index_pruned_points"] += pruned_points
    return tasks, contained_points, emit_queue


def _feeder(plan, readers, tasks, file_bounds, index_collectors, *, block_size, pack,
            workers, prefetch) -> BlockFeeder:
    """The host decode-ahead feeder of the plan's predicate. Loaders return
    raw columns and whole-block encodings for the transport run in
    transform: multi-range (index-packed) tasks concatenate several raw
    loads into one block before it is encoded."""
    transform = None
    if plan.time_range is not None:
        # f64 GPS times run on the device as the order-preserving (hi, lo)
        # int32 encoding: exact f64 range semantics with int32 compares
        def load(file_idx, start, stop):
            th, tl = host.encode_f64_sortable(readers[file_idx].column("gps_time", start, stop))
            return {"th": th, "tl": tl}

        if pack:
            def transform(file_idx, cols):
                return host._packed_time_cols(cols["th"], cols["tl"], block_size)
    elif plan.bounds is not None:
        def load(file_idx, start, stop):
            pos = readers[file_idx].column("position", start, stop)
            collector = index_collectors.get(file_idx)
            if collector is not None:
                collector.update(start, pos)
            return {"pos": pos}

        def transform(file_idx, cols):
            pos = cols["pos"]
            if not pack:
                return {
                    "x": np.ascontiguousarray(pos[:, 0]),
                    "y": np.ascontiguousarray(pos[:, 1]),
                    "z": np.ascontiguousarray(pos[:, 2]),
                }
            # packed transport: k-bit residual streams vs per-block base
            # (residualization runs here, in the feeder worker threads; plane
            # extraction happens at stack time, pooled)
            return host._packed_xyz_cols(pos, block_size)
    else:
        target = plan.classification.classification

        def load(file_idx, start, stop):
            return {"cls": np.ascontiguousarray(
                readers[file_idx].column("classification", start, stop))}

        if pack:
            def transform(file_idx, cols):
                return host._packed_class_cols(cols["cls"], target, block_size)

    return BlockFeeder(
        tasks, load, block_size,
        file_bounds=file_bounds, workers=workers, prefetch=prefetch, pad=False,
        transform_fn=transform,
    )


def _packed_bounds(task) -> tuple[np.ndarray, np.ndarray]:
    """Residual-space (lo, hi) of one packed bbox block: the saturating
    i64->i32 clip is exact because sub-32 widths are capped at 28 bits
    (residuals < 2^28 never collide with a saturated bound) and k == 32
    forces base = 0 (bounds pass through unclipped)."""
    i32 = np.iinfo(np.int32)
    lo = np.clip(task.lo.astype(np.int64) - task.columns["base"], i32.min, i32.max)
    hi = np.clip(task.hi.astype(np.int64) - task.columns["base"], i32.min, i32.max)
    return lo.astype(np.int32), hi.astype(np.int32)


def _padded(parts, rows: int, fill) -> np.ndarray:
    """np.stack(parts) and rows - len(parts) rows of fill after them: the
    padding rows of a step (n_valid 0) that its shards divide."""
    return np.stack(list(parts) + [np.asarray(fill, parts[0].dtype)] * (rows - len(parts)))


def _step_operands(plan, *, block_size, pack):
    """The function (batch, rows) -> (kind, arrays, plane_stacks, extra) that
    stacks one step's blocks, one row each, into the numpy operands of its
    step kind (parallel/step.py), padded to rows with rows of n_valid 0
    (JAX's engine.py:803-848; rows is a multiple of the shard count).
    plane_stacks are the point payload among arrays (the h2d bytes); extra
    holds the packed kinds' widths and block size."""
    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None
    if is_time:
        q_enc = np.asarray(
            host.encode_f64_scalar(plan.time_range.start)
            + host.encode_f64_scalar(plan.time_range.end),
            np.int32,
        )

    def widths(batch) -> tuple:
        return tuple(int(k) for k in np.maximum.reduce([t.columns["w"] for t in batch]))

    def operands(batch, rows=None):
        rows = rows or len(batch)
        nvs = _padded([np.int32(t.n_valid) for t in batch], rows, 0)
        if is_bounds and pack:
            kxyz = widths(batch)
            pbounds = [_packed_bounds(t) for t in batch]
            stacks = [host._stack_planes(batch, key, a, rows, kxyz[a], block_size)
                      for a, key in enumerate(("xp", "yp", "zp"))]
            los = _padded([b[0] for b in pbounds], rows, (0, 0, 0))
            his = _padded([b[1] for b in pbounds], rows, (-1, -1, -1))
            return "bbox_packed", (*stacks, los, his, nvs), stacks, (kxyz, block_size)
        if is_bounds:
            stacks = [host._stack_rows(batch, key, rows, block_size, np.int32)
                      for key in ("x", "y", "z")]
            los = _padded([t.lo for t in batch], rows, (0, 0, 0))
            his = _padded([t.hi for t in batch], rows, (-1, -1, -1))
            return "bbox", (*stacks, los, his, nvs), stacks, ()
        if is_time and pack:
            khl = widths(batch)
            q_rows = [host._packed_time_query(q_enc, t.columns["base"]) for t in batch]
            stacks = [host._stack_planes(batch, key, a, rows, khl[a], block_size)
                      for a, key in enumerate(("thp", "tlp"))]
            return ("time_packed", (*stacks, _padded(q_rows, rows, (0, 0, 0, 0)), nvs), stacks,
                    (khl, block_size))
        if is_time:
            stacks = [host._stack_rows(batch, key, rows, block_size, np.int32)
                      for key in ("th", "tl")]
            return "time", (*stacks, np.tile(q_enc, (rows, 1)), nvs), stacks, ()
        if pack:
            (k,) = widths(batch)
            stacks = [host._stack_planes(batch, "clsp", 0, rows, k, block_size)]
            codes = _padded([np.int32(t.columns["t"][0]) for t in batch], rows, 0)
            return "class_dict", (*stacks, codes, nvs), stacks, (k, block_size)
        stacks = [host._stack_rows(batch, "cls", rows, block_size, np.uint8)]
        targets = np.full(rows, plan.classification.classification, np.int32)
        return "class", (*stacks, targets, nvs), stacks, ()

    return operands


def _put(comm, timer, arrays, plane_stacks) -> list[tuple]:
    with timer.stage("h2d", sum(a.nbytes for a in plane_stacks)):
        return comm.put(arrays)


def _run_count(
    plan, readers, active, file_bounds, *, block_size, workers, prefetch, timer,
    block_index, index_collectors, comm,
) -> int:
    # K blocks a device per step amortize the per-step launch and copy
    # overhead; a step is d x K blocks (JAX engine.py:651-656)
    blocks_per_step = int(os.environ.get("AQPC_BLOCKS_PER_STEP", "4"))
    d = len(comm.devices())
    rows_per_step = d * max(1, blocks_per_step)
    tasks, indexed_total, _ = _plan_tasks(
        plan, readers, active, file_bounds, block_index, block_size, timer, ordered=False)
    pack = host._pack_transport_enabled()
    feeder = _feeder(plan, readers, tasks, file_bounds, index_collectors,
                     block_size=block_size, pack=pack, workers=workers, prefetch=prefetch)
    operands = _step_operands(plan, block_size=block_size, pack=pack)

    pending: list = []  # a list of 0-d int32 shard totals a step not yet read back
    device_total = 0
    # blocks resolved with no device work: index-contained ones and the
    # class dictionary's absent-target and single-class blocks
    host_total = indexed_total

    def drain(limit: int):
        nonlocal device_total
        while len(pending) > limit:
            device_total += sum(int(t) for t in pending.pop(0))

    def flush(batch):
        kind, arrays, stacks, extra = operands(batch, step_rows(len(batch), d))
        if kind == "class" and block_size % 4 == 0:
            # words (4 points each) when the rows split into them, else u8
            arrays = (host.pack_class_words(arrays[0]), *arrays[1:])
        pending.append(step.counts(kind, _put(comm, timer, arrays, stacks), extra))
        drain(comm.inflight() - 1)

    # the dictionary's host fast paths resolve some blocks with no step; in a
    # multi-process run too, since each process launches its own steps and
    # the processes meet only in finish_total (parallel/distributed.py)
    is_class_dict = pack and plan.bounds is None and plan.time_range is None
    batch = []
    with timer.stage("scan"):
        for task in feeder:
            if is_class_dict:
                # target class absent: count 0; single-class block holding
                # the target: count n_valid
                npres = int(task.columns["np"][0])
                if int(task.columns["t"][0]) >= npres:
                    continue
                if npres == 1:
                    host_total += task.n_valid
                    continue
            batch.append(task)
            if len(batch) == rows_per_step:
                flush(batch)
                batch = []
        if batch:
            flush(batch)
        drain(0)
    timer.seconds["decode_cpu"] += feeder.decode_seconds

    return comm.finish_total(device_total, host_total)


# ---------------------------------------------------------------------------
# collect path (output, print-points, keep_hits)
# ---------------------------------------------------------------------------


def _run_collect(
    plan, readers, active, file_bounds, grid, *, block_size, workers, prefetch, timer,
    keep_hits, block_index, index_collectors, print_stream, comm, density_state_out,
):
    """Collect-path entry (engine.py:932-972): every hit goes to one
    HitEmitter, which writes one LAS per input file with hits (one file in
    all for a global-scope density plan), prints, or keeps hits, in file
    order. Density plans go to the grid-sampling pipeline."""
    emitter = HitEmitter(
        readers,
        output_dir=plan.output_dir,
        print_stream=print_stream,
        keep_hits=keep_hits,
    )
    if plan.density is not None:
        # density runs host-local: nothing of it crosses participants
        _run_density(
            plan, readers, active, file_bounds, grid, emitter,
            block_size=block_size, workers=workers, prefetch=prefetch, timer=timer,
            block_index=block_index, state_out=density_state_out, comm=comm,
        )
        return emitter.total, emitter.all_hits, emitter.output_files
    _collect_steps(
        plan, readers, active, file_bounds, emitter,
        block_size=block_size, workers=workers, prefetch=prefetch, timer=timer,
        block_index=block_index, index_collectors=index_collectors, comm=comm,
    )
    # hit payloads never cross participants; only the count is reduced
    total = comm.reduce_sum(emitter.total)
    return total, emitter.all_hits, emitter.output_files


def _collect_steps(
    plan, readers, active, file_bounds, emitter, *, block_size, workers, prefetch,
    timer, block_index, index_collectors, comm,
) -> None:
    """Streaming collect (_run_collect_mesh, engine.py:975-1439): the count
    path's K-block steps, each running the predicate into a bit mask with
    exact per-block counts. The counts of step s are read while later steps
    are in flight; the blocks with some but not all points matching then get
    offsets into one exact-size index buffer and one compaction launch fills
    it. Blocks with no hits emit nothing and full blocks emit their rows as
    ranges, with no index fetch. There is no cap and so no retry.

    Hits stream to the emitter in file order: index-contained ranges sit in
    each file's emit queue between the scanned blocks around them, and one
    worker thread emits in order while the main thread owns the device.
    Unlike the count path, absent-target and single-class dictionary blocks
    still ship (at >= 1-bit planes, class_dict_width): resolving them on the
    host would have to thread through the emit queue, and the device
    resolves them for free (miss code / all-match).
    """
    blocks_per_step = int(os.environ.get("AQPC_BLOCKS_PER_STEP", "4"))
    d = len(comm.devices())
    rows_per_step = d * max(1, blocks_per_step)
    tasks, _, emit_queue = _plan_tasks(
        plan, readers, active, file_bounds, block_index, block_size, timer, ordered=True)
    pack = host._pack_transport_enabled()
    # hit attributes are gathered from the readers by index, so the packed
    # transport's raw coordinates never cross the link
    feeder = _feeder(plan, readers, tasks, file_bounds, index_collectors,
                     block_size=block_size, pack=pack, workers=workers, prefetch=prefetch)
    operands = _step_operands(plan, block_size=block_size, pack=pack)

    finalize_order = list(active)
    next_final = 0  # position in finalize_order of the next unfinalized file

    def finalize_through(file_idx_inclusive):
        nonlocal next_final
        while (next_final < len(finalize_order)
               and finalize_order[next_final] <= file_idx_inclusive):
            i = finalize_order[next_final]
            q = emit_queue[i]
            while q:
                item = q.popleft()
                if item[0] == "all":
                    emitter.emit_range(i, item[1], item[2])
            emitter.finalize_file(i)
            next_final += 1

    def emit_scan_result(task, local_idx, full=False):
        i = task.file_idx
        finalize_through(i - 1)
        q = emit_queue[i]
        while q and q[0][0] == "all":
            _, s, e = q.popleft()
            emitter.emit_range(i, s, e)
        if q and q[0][0] == "scan":
            q.popleft()
        if full:
            if task.ranges is None:
                emitter.emit_range(i, task.start, task.start + task.n_valid)
            else:
                for s, e in task.ranges:
                    emitter.emit_range(i, s, e)
        elif local_idx is not None and len(local_idx):
            emitter.emit_indices(i, task_gidx(task, local_idx))

    pending: deque = deque()  # (batch, a BitMask a shard) of steps not yet read back

    def flush(batch):
        kind, arrays, stacks, extra = operands(batch, step_rows(len(batch), d))
        masks = step.collect_masks(kind, _put(comm, timer, arrays, stacks), extra)
        pending.append((batch, masks))
        drain(comm.inflight() - 1)

    # Emission (disk gather of hit attributes, LAS encode, printing) runs on
    # ONE ordered worker thread so that it overlaps the next device steps;
    # the emitter is single-threaded by construction (strict file order).
    emit_q: queue.Queue = queue.Queue(maxsize=8)
    emit_error: list[BaseException] = []

    def emit_worker():
        while True:
            item = emit_q.get()
            if item is None:
                return
            try:
                if not emit_error:
                    with timer.stage("emit"):
                        item()
            except BaseException as e:  # propagate to the main thread
                emit_error.append(e)
            finally:
                emit_q.task_done()

    emit_thread = threading.Thread(target=emit_worker, daemon=True)
    emit_thread.start()

    def submit_emit(fn):
        if emit_error:
            raise emit_error[0]
        emit_q.put(fn)

    def process(batch, masks):
        # offsets for PARTIAL blocks only: empty ones (padding rows among
        # them) emit nothing and full ones emit their rows as ranges
        counts, offsets, idx_np = step.read_hits(
            masks, lambda j, c: 0 < c < batch[j].n_valid, block_size, comm.fetch, timer)
        for j, task in enumerate(batch):
            c = int(counts[j])
            if c == 0:
                submit_emit(lambda t=task: emit_scan_result(t, None))
            elif c == task.n_valid:
                submit_emit(lambda t=task: emit_scan_result(t, None, full=True))
            else:
                local = idx_np[offsets[j] : offsets[j] + c]
                submit_emit(lambda t=task, ix=local: emit_scan_result(t, ix))

    def drain(limit: int):
        while len(pending) > limit:
            process(*pending.popleft())

    with timer.stage("scan"):
        try:
            batch = []
            for task in feeder:
                batch.append(task)
                if len(batch) == rows_per_step:
                    flush(batch)
                    batch = []
            if batch:
                flush(batch)
            drain(0)
            if active:
                submit_emit(lambda: finalize_through(max(active)))
        finally:
            emit_q.put(None)
            emit_thread.join()
        if emit_error:
            raise emit_error[0]
    timer.seconds["decode_cpu"] += feeder.decode_seconds


# ---------------------------------------------------------------------------
# density path (max-density grid sampling)
# ---------------------------------------------------------------------------


def _density_block_tasks(file_idx, n, block_size, idx_info, plan, file_bounds, timer) -> list:
    """Per-engine-block density tasks with sidecar bbox/GPS pruning
    (engine.py:269-299). Only DISJOINT can skip: a CONTAINED block still has
    to flow through the grid (unlike counting, density needs the points
    themselves)."""
    tasks = []
    for b in range((n + block_size - 1) // block_size):
        start = b * block_size
        stop = min(start + block_size, n)
        cls_b = None
        if idx_info is not None and plan.bounds is not None:
            lo, hi = file_bounds[file_idx]
            cls_b = index_mod.classify_block(idx_info[1], idx_info[0], start, stop, lo, hi)
        elif idx_info is not None and plan.time_range is not None and idx_info[3] is not None:
            cls_b = index_mod.classify_time_block(
                idx_info[3], idx_info[0], start, stop,
                plan.time_range.start, plan.time_range.end)
        if cls_b == index_mod.DISJOINT:
            timer.counts["index_skipped_blocks"] += 1
            timer.counts["index_pruned_points"] += stop - start
            continue
        tasks.append((file_idx, b, start, stop))
    return tasks


def _density_feeder(plan, readers, tasks, file_bounds, *, block_size, pack, workers,
                    prefetch) -> BlockFeeder:
    """The density path's feeder (engine.py:1483-1525): every block carries
    its positions, as raw x/y/z columns or (packed transport) as the raw
    columns with per-axis (base, width) for the plane extraction at stack
    time; class and time plans add the raw u8 class column or the encoded
    (hi, lo) GPS-time words."""
    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None

    def load(file_idx, start, stop):
        r = readers[file_idx]
        cols = {"pos": r.column("position", start, stop)}
        if is_time:
            cols["th"], cols["tl"] = host.encode_f64_sortable(r.column("gps_time", start, stop))
        elif not is_bounds:
            cols["cls"] = np.ascontiguousarray(r.column("classification", start, stop))
        return cols

    def transform(file_idx, cols):
        # a whole-block transform, so that multi-range (index-packed) class
        # tasks residualize the concatenated block
        pos = cols.pop("pos")
        if pack:
            out = host._packed_xyz_cols(pos, block_size)
        else:
            out = {key: np.ascontiguousarray(pos[:, a]) for a, key in enumerate("xyz")}
        out.update(cols)  # cls / th, tl ride raw
        return out

    return BlockFeeder(
        tasks, load, block_size,
        file_bounds=file_bounds, workers=workers, prefetch=prefetch, pad=False,
        transform_fn=transform,
    )


def _density_operands(plan, *, block_size, pack):
    """The function (batch, rows) -> (kind, n_pred, arrays, extra, xyz_at,
    widths, stacks) of one density step, padded to rows as _step_operands
    pads. arrays[:n_pred] are the predicate's
    operands as _step_operands stacks them (the bbox predicate in the step's
    transport, class and time raw); arrays[xyz_at:xyz_at + 3] are the x/y/z
    the candidate selection reads: the bbox predicate's own rows or planes,
    else raw rows or planes of their own after the predicate's operands. In
    the packed transport widths are the planes' and the last array is the
    (len(batch), 3) int32 bases; in the raw one widths is None. stacks is the point
    payload (the h2d bytes)."""
    is_bounds = plan.bounds is not None
    predicate_operands = _step_operands(plan, block_size=block_size,
                                        pack=pack and is_bounds)

    def operands(batch, rows=None):
        rows = rows or len(batch)
        kind, arrays, stacks, extra = predicate_operands(batch, rows)
        n_pred = len(arrays)
        widths = None
        if is_bounds:
            xyz_at = 0
            if pack:
                widths = extra[0]
        else:
            xyz_at = n_pred
            if pack:
                widths = tuple(int(k) for k in
                               np.maximum.reduce([t.columns["w"] for t in batch]))
                xyz = [host._stack_planes(batch, key, a, rows, widths[a], block_size)
                       for a, key in enumerate(("xp", "yp", "zp"))]
            else:
                xyz = [host._stack_rows(batch, key, rows, block_size, np.int32)
                       for key in "xyz"]
            arrays = (*arrays, *xyz)
            stacks = [*stacks, *xyz]
        if pack:
            bases = _padded([t.columns["base"].astype(np.int32) for t in batch], rows, (0, 0, 0))
            arrays = (*arrays, bases)
        return kind, n_pred, arrays, extra, xyz_at, widths, stacks

    return operands


def _host_hit_mask(plan, task, xyz_keys, q_enc):
    """The exact host-side predicate mask of one block, or None when no row
    matches (engine.py:1600-1630): it mirrors the device predicate bit for
    bit (closed int32 box, lexicographic half-open encoded time range, u8
    equality). A block with no predicate hit has no density candidate, so it
    skips both the copy to the device and the device step; the hit count of
    the others sizes the leaders table."""
    if plan.bounds is not None:
        m = None
        for a, key in enumerate(xyz_keys):
            col = task.columns[key]
            ma = (col >= task.lo[a]) & (col <= task.hi[a])
            m = ma if m is None else m & ma
            if not m.any():
                return None
        return m
    if plan.time_range is not None:
        th, tl = task.columns["th"], task.columns["tl"]
        ge = (th > q_enc[0]) | ((th == q_enc[0]) & (tl >= q_enc[1]))
        if not ge.any():
            return None
        m = ge & ((th < q_enc[2]) | ((th == q_enc[2]) & (tl < q_enc[3])))
    else:
        m = task.columns["cls"] == plan.classification.classification
    return m if m.any() else None


def _run_density(
    plan, readers, active, file_bounds, grid, emitter, *, block_size, workers, prefetch,
    timer, block_index, state_out, comm,
):
    """Grid-sampling (max-density) collection, f64-exact (engine.py:
    1441-1843).

    Device: one step runs the query predicate and the candidate selection
    of ops/density.py over K blocks of a file (interior cells certified
    against the file's exact integer boundary tables; each cell's leader,
    the points within the f32 error margin of it and the uncertifiable
    points survive). The host reads the per-block candidate counts a few
    steps behind the dispatch, gives each block an offset, and one
    compaction launch returns the candidates' indices in an exact-size
    buffer: there is no cap and no retry. Host: exact f64 reference cell
    keys and d2 of the candidates, merged into the sparse running grid
    state, per file or globally (main.rs:156 vs 129-133).

    Blocks with no predicate hit never leave the host, and blocks with at
    most block_size / 8 hits are gathered on the host and shipped together
    as x/y/z alone, every row a hit, at their true length.
    """
    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None
    scope = plan.density.scope
    blocks_per_step = int(os.environ.get("AQPC_BLOCKS_PER_STEP", "4"))
    devices = comm.devices()
    d = len(devices)
    rows_per_step = d * max(1, blocks_per_step)
    pack = host._pack_transport_enabled()
    # packed loads keep the raw absolute columns under xp/yp/zp (the planes
    # are cut at stack time), so the host reads them directly either way
    xyz_keys = ("xp", "yp", "zp") if pack else ("x", "y", "z")
    q_enc = None
    if is_time:
        q_enc = np.asarray(
            host.encode_f64_scalar(plan.time_range.start)
            + host.encode_f64_scalar(plan.time_range.end),
            np.int32,
        )
    operands = _density_operands(plan, block_size=block_size, pack=pack)
    # deferred-merge accumulators (ops/density.py WinnerAccum): the same
    # fold as a per-block merge_winners_host, O(N log N) in total
    global_acc = density_ops.WinnerAccum()
    sparse_max = block_size // 8

    with timer.stage("scan"):
        for file_seq, file_idx in enumerate(active):
            r = readers[file_idx]
            n = r.point_count
            scale, offset = r.header.scale, r.header.offset
            # the file's tables on every device (JAX replicates them, P())
            tables_np = grid.file_tables(scale, offset)
            tables_on = {dev: density_ops.tables_to_device(tables_np, dev)
                         for dev in dict.fromkeys(devices)}
            tables_dev = tables_on[devices[0]]
            cells = density_ops.grid_cells(tables_dev)  # sizes the leaders table with the hits
            acc = density_ops.WinnerAccum() if scope == "file" else global_acc

            idx_info = block_index.get(file_idx)
            if idx_info is not None and not is_bounds and not is_time:
                # class sub-block pruning at file scope, packed into full
                # multi-range blocks (see _plan_tasks)
                ranges = index_mod.class_present_ranges(
                    idx_info[2], idx_info[0], 0, n, plan.classification.classification)
                kept = sum(e - s for s, e in ranges)
                if kept < n:
                    timer.counts["index_skipped_blocks"] += max((n - kept) // idx_info[0], 1)
                    timer.counts["index_pruned_points"] += n - kept
                tasks = host._pack_range_tasks(file_idx, ranges, block_size)
            else:
                tasks = _density_block_tasks(file_idx, n, block_size, idx_info, plan,
                                             file_bounds, timer)
            feeder = _density_feeder(plan, readers, tasks, file_bounds, block_size=block_size,
                                     pack=pack, workers=workers, prefetch=prefetch)

            def merge_candidates(task, local_idx):
                # exact key and d2 straight from the gathered raw int32
                # columns (no (n, 3) f64 world array)
                with timer.stage("exact"):
                    winners = grid.make_winners_raw(
                        *(task.columns[key][local_idx] for key in xyz_keys),
                        scale, offset, task_gidx(task, local_idx), file_idx)
                with timer.stage("merge"):
                    acc.add(winners, file_seq)

            # (batch, a BitMask a shard, B) of steps not yet read back
            pending: deque = deque()

            def process(batch, masks, step_block):
                counts, offsets, idx_np = step.read_hits(masks, lambda j, c: c > 0, step_block,
                                                         comm.fetch, timer)
                if idx_np is None:
                    return
                for j, task in enumerate(batch):
                    if counts[j]:
                        merge_candidates(task, idx_np[offsets[j] : offsets[j] + int(counts[j])])

            def drain(limit: int):
                while len(pending) > limit:
                    process(*pending.popleft())

            batch: list = []
            batch_hits: list[int] = []

            def flush():
                nonlocal batch, batch_hits
                kind, n_pred, arrays, extra, xyz_at, widths, stacks = operands(
                    batch, step_rows(len(batch), d))
                masks = step.density_masks(
                    kind, _put(comm, timer, arrays, stacks), extra, n_pred, xyz_at, tables_on,
                    block_size, packed=pack, widths=widths,
                    slots=density_ops.table_slots(max(batch_hits), cells))
                pending.append((batch, masks, block_size))
                batch, batch_hits = [], []
                drain(comm.inflight() - 1)

            sparse_cols: list[tuple] = []
            sparse_gidx: list[np.ndarray] = []
            sparse_total = 0

            def flush_sparse():
                nonlocal sparse_cols, sparse_gidx, sparse_total
                if not sparse_total:
                    return
                cols = [np.concatenate([c[a] for c in sparse_cols]) for a in range(3)]
                task = BlockTask(file_idx, -1, 0, sparse_total, dict(zip(xyz_keys, cols)),
                                 gidx_map=np.concatenate(sparse_gidx))
                sparse_cols, sparse_gidx, sparse_total = [], [], 0
                arrays = (*(c[None] for c in cols), np.asarray([task.n_valid], np.int32))
                # one row, on the first device (JAX runs it unsharded too)
                with timer.stage("h2d", sum(a.nbytes for a in arrays[:3])):
                    *xyz_dev, nvs_dev = comm.put_one(arrays)
                mask = step.density_mask_gathered(
                    tuple(xyz_dev), nvs_dev, tables_dev, task.n_valid,
                    slots=density_ops.table_slots(task.n_valid, cells))
                pending.append(([task], [mask], task.n_valid))
                drain(comm.inflight() - 1)

            for task in feeder:
                with timer.stage("prefilter"):
                    m = _host_hit_mask(plan, task, xyz_keys, q_enc)
                    nhits = 0 if m is None else int(np.count_nonzero(m))
                if not nhits:
                    timer.counts["host_prefiltered_blocks"] += 1
                    continue
                if nhits > sparse_max:
                    batch.append(task)
                    batch_hits.append(nhits)
                    if len(batch) == rows_per_step:
                        flush()
                    continue
                idx = np.nonzero(m)[0]
                sparse_cols.append(tuple(task.columns[key][idx] for key in xyz_keys))
                sparse_gidx.append(task_gidx(task, idx))
                sparse_total += nhits
                timer.counts["density_sparse_blocks"] += 1
                if sparse_total >= block_size - sparse_max:
                    flush_sparse()
            flush_sparse()
            if batch:
                flush()
            drain(0)
            timer.seconds["decode_cpu"] += feeder.decode_seconds

            if scope == "file":
                with timer.stage("merge"):
                    file_state = acc.result()
                if state_out is not None:
                    state_out.setdefault("file", {})[file_idx] = file_state
                with timer.stage("emit"):
                    emitter.emit_hits(file_idx, _winners_to_hits(file_state, r, file_idx))
                    emitter.finalize_file(file_idx)

    if scope == "global":
        with timer.stage("merge"):
            global_state = global_acc.result()
        if state_out is not None:
            state_out["global"] = global_state
        with timer.stage("emit"):
            combined: list[FileHits] = []
            for file_idx in np.unique(global_state["file_idx"]):
                sub = global_state[global_state["file_idx"] == file_idx]
                combined.append(_winners_to_hits(sub, readers[file_idx], int(file_idx)))
            emitter.emit_hits(-1, concat_hits(combined))
            emitter.finalize_file(-1)


def _winners_to_hits(state: np.ndarray, reader, file_idx: int) -> FileHits:
    if len(state) == 0:
        return empty_hits(file_idx)
    return gather_hits(reader, np.sort(state["gidx"]), file_idx)
