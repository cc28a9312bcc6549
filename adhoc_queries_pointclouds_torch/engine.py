"""Query engine of the port: bbox, class and GPS-time counts and collects
over a set of point-cloud files.

The counterpart of adhoc_queries_pointclouds_tpu/engine.py run_query,
_run_count (engine.py:395-924), _run_collect and _run_collect_mesh
(engine.py:932-1439):

  host decode-ahead feeder -> K blocks per step -> H2D copy -> one kernel
  launch per step -> int32 step totals, read back a few steps behind the
  dispatch -> a Python-int total (count); or -> a bit mask and per-block
  counts, read back a few steps behind the dispatch -> one compaction
  launch for the blocks with some but not all points matching -> hit
  indices -> hits gathered from the files and emitted in file order
  (collect: -o LAS write-back, --print-points, keep_hits)

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

Density plans are not ported yet and raise.
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
from .formats import is_valid_file, open_point_cloud
from .formats.las import has_gps_time
from .parallel import step
from .parallel.comm import LocalStepComm
from .parallel.pipeline import BlockFeeder, task_gidx
from .sinks import FileHits, HitEmitter
from .utils.aabb import AABB, clamp_bounds_to_i32, local_query_bounds
from .utils.timing import StageTimer

DEFAULT_BLOCK_SIZE = 1 << 21  # 2M points: 24 MiB of xyz per block
# Blocks of files smaller than the block size are cut to a multiple of this,
# as the JAX engine does off the TPU, so both engines cut identical blocks.
BLOCK_QUANTUM = 8192


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


def _require_ported(plan) -> None:
    if plan.density is not None:
        raise NotImplementedError("not yet ported: density plans")


def run_query(
    input_path,
    plan,
    *,
    device,
    block_size: int = DEFAULT_BLOCK_SIZE,
    workers: int = 8,
    prefetch: int = 12,
    keep_hits: bool = False,
    force_collect: bool = False,
    keep_going: bool = False,
    use_index: bool = True,
    print_stream=None,
) -> QueryResult:
    """Count or collect the points of a file or directory that match plan's
    predicate: its closed box, its class, or its half-open GPS-time range.

    device: the torch.device (or its name) every step runs on. "cuda" runs
    the hand-written kernels and raises when CUDA is absent; "cpu" runs
    their plain PyTorch versions.
    keep_hits: also return every hit's attributes, per file (forces the
    collect path; for tests and small queries: it holds all hits in RAM).
    force_collect: run the collect path with no consumer (count only).
    keep_going: skip unreadable files with a warning instead of aborting the
    whole query (the reference aborts on any file error, main.rs:161-163).
    print_stream: stream matching points here as they are found (the
    reference's StdOutCollector, collect_points.rs:46-70). Defaults to
    sys.stdout when plan.print_points is set.
    """
    _require_ported(plan)
    comm = LocalStepComm(device)
    if print_stream is None and plan.print_points:
        print_stream = sys.stdout
    timer = StageTimer()
    files = discover_files(input_path)
    if not files:
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
            if not files:
                raise FileNotFoundError(f"No readable point-cloud files under {input_path}")
        else:
            readers = [open_point_cloud(f) for f in files]

    # Clamp the block to the largest file: tiny files padded to a huge block
    # would waste device work.
    max_pts = max((r.point_count for r in readers), default=0)
    if max_pts and max_pts < block_size:
        quantum = BLOCK_QUANTUM
        block_size = min(block_size, ((max_pts + quantum - 1) // quantum) * quantum)
    block_size = comm.agree_block_size(block_size)

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

    # Optional block min/max sidecar index: exact results are preserved, the
    # index only removes work. A full bbox scan of an unindexed file builds
    # its sidecar on the fly; class and time loaders read no positions, so
    # their collectors would never complete.
    file_indices_meta: dict[int, tuple] = {}
    index_collectors: dict[int, index_mod.IndexCollector] = {}
    if use_index:
        for i in active:
            info = index_mod.load_index(files[i])
            if info is not None:
                file_indices_meta[i] = info
        if is_bounds and os.environ.get("AQPC_AUTO_INDEX", "1") != "0":
            for i in active:
                if i not in file_indices_meta:
                    index_collectors[i] = index_mod.IndexCollector(readers[i].point_count)

    if plan.collects_points or keep_hits or force_collect:
        match_count, hits, output_files = _run_collect(
            plan, readers, active, file_bounds,
            block_size=block_size, workers=workers, prefetch=prefetch, timer=timer,
            keep_hits=keep_hits, block_index=file_indices_meta,
            index_collectors=index_collectors, print_stream=print_stream, comm=comm,
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


def _step_operands(plan, comm, *, block_size, pack):
    """The function (batch, rows) -> (kind, arrays, plane_stacks, extra)
    that stacks one step's blocks into the numpy operands of its step kind
    (parallel/step.py), padded to rows with empty rows (n_valid 0, an empty
    box or range). plane_stacks are the point payload among arrays (the h2d
    bytes); extra holds the packed kinds' widths and block size."""
    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None
    if is_time:
        q_enc = np.asarray(
            host.encode_f64_scalar(plan.time_range.start)
            + host.encode_f64_scalar(plan.time_range.end),
            np.int32,
        )

    def widths(batch, n: int) -> tuple:
        w = comm.agree_widths(
            np.maximum.reduce([t.columns["w"] for t in batch]) if batch else np.zeros(n, np.int64)
        )
        return tuple(int(k) for k in w)

    def operands(batch, rows):
        pad = rows - len(batch)
        nvs = np.asarray([t.n_valid for t in batch] + [0] * pad, np.int32)
        if is_bounds and pack:
            kxyz = widths(batch, 3)
            pbounds = [_packed_bounds(t) for t in batch]
            stacks = [host._stack_planes(batch, key, a, rows, kxyz[a], block_size)
                      for a, key in enumerate(("xp", "yp", "zp"))]
            los = np.stack([b[0] for b in pbounds] + [np.zeros(3, np.int32)] * pad)
            his = np.stack([b[1] for b in pbounds] + [np.full(3, -1, np.int32)] * pad)
            return "bbox_packed", (*stacks, los, his, nvs), stacks, (kxyz, block_size)
        if is_bounds:
            stacks = [host._stack_rows(batch, key, rows, block_size, np.int32)
                      for key in ("x", "y", "z")]
            los = np.stack([t.lo for t in batch] + [np.zeros(3, np.int32)] * pad)
            his = np.stack([t.hi for t in batch] + [np.zeros(3, np.int32)] * pad)
            return "bbox", (*stacks, los, his, nvs), stacks, ()
        if is_time and pack:
            khl = widths(batch, 2)
            q_rows = [host._packed_time_query(q_enc, t.columns["base"]) for t in batch]
            q_rows += [np.zeros(4, np.int32)] * pad
            stacks = [host._stack_planes(batch, key, a, rows, khl[a], block_size)
                      for a, key in enumerate(("thp", "tlp"))]
            return "time_packed", (*stacks, np.stack(q_rows), nvs), stacks, (khl, block_size)
        if is_time:
            stacks = [host._stack_rows(batch, key, rows, block_size, np.int32)
                      for key in ("th", "tl")]
            return "time", (*stacks, np.tile(q_enc, (rows, 1)), nvs), stacks, ()
        if pack:
            (k,) = widths(batch, 1)
            stacks = [host._stack_planes(batch, "clsp", 0, rows, k, block_size)]
            codes = np.asarray([int(t.columns["t"][0]) for t in batch] + [0] * pad, np.int32)
            return "class_dict", (*stacks, codes, nvs), stacks, (k, block_size)
        stacks = [host._stack_rows(batch, "cls", rows, block_size, np.uint8)]
        targets = np.full(rows, plan.classification.classification, np.int32)
        return "class", (*stacks, targets, nvs), stacks, ()

    return operands


def _put(comm, timer, arrays, plane_stacks) -> tuple:
    with timer.stage("h2d", sum(a.nbytes for a in plane_stacks)):
        return comm.put(arrays)


def _run_count(
    plan, readers, active, file_bounds, *, block_size, workers, prefetch, timer,
    block_index, index_collectors, comm,
) -> int:
    # K blocks per step amortize the per-step launch and copy overhead
    blocks_per_step = int(os.environ.get("AQPC_BLOCKS_PER_STEP", "4"))
    rows_per_step = comm.batch_rows(max(1, blocks_per_step))
    tasks, indexed_total, _ = _plan_tasks(
        plan, readers, active, file_bounds, block_index, block_size, timer, ordered=False)
    pack = host._pack_transport_enabled()
    feeder = _feeder(plan, readers, tasks, file_bounds, index_collectors,
                     block_size=block_size, pack=pack, workers=workers, prefetch=prefetch)
    operands = _step_operands(plan, comm, block_size=block_size, pack=pack)

    pending: list = []  # 0-d int32 device totals of steps not yet read back
    device_total = 0
    # blocks resolved with no device work: index-contained ones and the
    # class dictionary's absent-target and single-class blocks
    host_total = indexed_total

    def drain(limit: int):
        nonlocal device_total
        while len(pending) > limit:
            device_total += int(pending.pop(0))

    def flush(batch):
        kind, arrays, stacks, extra = operands(batch, comm.step_rows(len(batch), rows_per_step))
        if kind == "class" and block_size % 4 == 0:
            # words (4 points each) when the rows split into them, else u8
            arrays = (host.pack_class_words(arrays[0]), *arrays[1:])
        pending.append(step.count(kind, _put(comm, timer, arrays, stacks), extra))
        drain(comm.inflight() - 1)

    # the dictionary's host fast paths change the flushed-step count, so
    # they are for a lone participant only
    is_class_dict = (pack and plan.bounds is None and plan.time_range is None
                     and comm.is_local)
    n_steps = comm.agree_steps((len(tasks) + rows_per_step - 1) // rows_per_step)
    batch = []
    with timer.stage("scan"):
        flushed = 0
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
                flushed += 1
                batch = []
        if batch:
            flush(batch)
            flushed += 1
        while flushed < n_steps:  # other participants still have steps
            flush([])
            flushed += 1
        drain(0)
    timer.seconds["decode_cpu"] += feeder.decode_seconds

    return comm.finish_total(device_total, host_total)


# ---------------------------------------------------------------------------
# collect path (output, print-points, keep_hits)
# ---------------------------------------------------------------------------


def _run_collect(
    plan, readers, active, file_bounds, *, block_size, workers, prefetch, timer,
    keep_hits, block_index, index_collectors, print_stream, comm,
):
    """Collect-path entry (engine.py:932-972 without its density branch):
    every hit goes to one HitEmitter, which writes one LAS per input file
    with hits, prints, or keeps hits, in file order."""
    emitter = HitEmitter(
        readers,
        output_dir=plan.output_dir,
        print_stream=print_stream,
        keep_hits=keep_hits,
    )
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
    rows_per_step = comm.batch_rows(max(1, blocks_per_step))
    tasks, _, emit_queue = _plan_tasks(
        plan, readers, active, file_bounds, block_index, block_size, timer, ordered=True)
    pack = host._pack_transport_enabled()
    # hit attributes are gathered from the readers by index, so the packed
    # transport's raw coordinates never cross the link
    feeder = _feeder(plan, readers, tasks, file_bounds, index_collectors,
                     block_size=block_size, pack=pack, workers=workers, prefetch=prefetch)
    operands = _step_operands(plan, comm, block_size=block_size, pack=pack)

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

    pending: deque = deque()  # (batch, BitMask) of steps not yet read back

    def flush(batch):
        kind, arrays, stacks, extra = operands(batch, comm.step_rows(len(batch), rows_per_step))
        mask = step.collect_mask(kind, _put(comm, timer, arrays, stacks), extra)
        pending.append((batch, mask))
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

    def process(batch, mask):
        with timer.stage("d2h", mask.counts.nbytes):
            counts = comm.fetch(mask.counts)
        # offsets for PARTIAL blocks only: empty ones emit nothing and full
        # ones emit their rows as ranges
        offsets = np.full(len(counts), -1, np.int64)
        total = 0
        for j, task in enumerate(batch):
            c = int(counts[j])
            if 0 < c < task.n_valid:
                offsets[j] = total
                total += c
        if total:
            (offsets_dev,) = comm.put((offsets,))
            idx_dev = step.collect_indices(mask, offsets_dev, total, block_size)
            with timer.stage("d2h", 4 * total):
                idx_np = comm.fetch(idx_dev)
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

    n_steps = comm.agree_steps((len(tasks) + rows_per_step - 1) // rows_per_step)
    with timer.stage("scan"):
        try:
            batch = []
            flushed = 0
            for task in feeder:
                batch.append(task)
                if len(batch) == rows_per_step:
                    flush(batch)
                    flushed += 1
                    batch = []
            if batch:
                flush(batch)
                flushed += 1
            while flushed < n_steps:  # other participants still have steps
                flush([])
                flushed += 1
            drain(0)
            if active:
                submit_emit(lambda: finalize_through(max(active)))
        finally:
            emit_q.put(None)
            emit_thread.join()
        if emit_error:
            raise emit_error[0]
    timer.seconds["decode_cpu"] += feeder.decode_seconds
