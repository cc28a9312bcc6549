"""Query engine of the port: bbox, class and GPS-time counts over a set of
point-cloud files.

The counterpart of adhoc_queries_pointclouds_tpu/engine.py run_query and
_run_count (engine.py:395-924) for counting plans:

  host decode-ahead feeder -> K blocks per step -> H2D copy -> one kernel
  launch per step -> int32 step totals, read back a few steps behind the
  dispatch -> a Python-int total

Each predicate has two transports. AQPC_PACK=1, the default, ships bbox
coordinates and the (hi, lo) int32 encoding of GPS times as bit-planar
residuals, and classes as per-block dictionary codes; AQPC_PACK=0 ships raw
int32 columns and the u8 class column (viewed as int32 words when the block
size is a multiple of 4).

Sidecar-index pruning works as in the JAX engine: bbox and time plans skip
index blocks disjoint from the query, count contained ones with no point IO
and pack straddling ones into full multi-range device blocks; class plans
scan only the index blocks whose class bitmap holds the target. A full bbox
scan of an unindexed file writes its sidecar (min/max only: its class bitmap
is all-present and it has no GPS ranges, so it prunes nothing for class and
time plans). The index format is the JAX package's.

Density and collect plans are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

from . import host
from .parallel import step
from .parallel.comm import LocalStepComm
from .parallel.pipeline import BlockFeeder
from .shared import (
    AABB,
    StageTimer,
    clamp_bounds_to_i32,
    has_gps_time,
    index as index_mod,
    is_valid_file,
    local_query_bounds,
    open_point_cloud,
)

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

    @property
    def throughput_mibs(self) -> float:
        return self.total_file_bytes / 1048576.0 / max(self.elapsed_seconds, 1e-12)

    @property
    def mpts_per_s(self) -> float:
        return self.points_scanned / 1e6 / max(self.elapsed_seconds, 1e-12)


def _require_count(plan) -> None:
    if plan.collects_points:
        raise NotImplementedError(
            "not yet ported: density, output and print-points plans (the port counts only)"
        )


def run_query(
    input_path,
    plan,
    *,
    device,
    block_size: int = DEFAULT_BLOCK_SIZE,
    workers: int = 8,
    prefetch: int = 12,
    keep_going: bool = False,
    use_index: bool = True,
) -> QueryResult:
    """Count the points of a file or directory that match plan's predicate:
    its closed box, its class, or its half-open GPS-time range.

    device: the torch.device (or its name) every step runs on. "cuda" runs
    the hand-written kernels and raises when CUDA is absent; "cpu" runs
    their plain PyTorch versions.
    keep_going: skip unreadable files with a warning instead of aborting the
    whole query (the reference aborts on any file error, main.rs:161-163).
    """
    _require_count(plan)
    comm = LocalStepComm(device)
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

    match_count = _run_count(
        plan, readers, active, file_bounds,
        block_size=block_size, workers=workers, prefetch=prefetch, timer=timer,
        block_index=file_indices_meta, index_collectors=index_collectors,
        comm=comm,
    )

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
    )


def _run_count(
    plan, readers, active, file_bounds, *, block_size, workers, prefetch, timer,
    block_index, index_collectors, comm,
) -> int:
    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None
    # K blocks per step amortize the per-step launch and copy overhead
    blocks_per_step = int(os.environ.get("AQPC_BLOCKS_PER_STEP", "4"))
    rows_per_step = comm.batch_rows(max(1, blocks_per_step))

    tasks = []
    indexed_total = 0  # points of CONTAINED index blocks: counted with zero IO
    skipped_blocks = contained_blocks = pruned_points = 0
    for i in active:
        n = readers[i].point_count
        idx_info = block_index.get(i)
        if idx_info is not None and not is_bounds and not is_time:
            # class sub-block pruning at FILE scope: index blocks whose
            # bitmap holds the class, packed into full multi-range blocks
            ranges = index_mod.class_present_ranges(
                idx_info[2], idx_info[0], 0, n, plan.classification.classification)
            kept = sum(e - s for s, e in ranges)
            if kept < n:
                skipped_blocks += max((n - kept) // idx_info[0], 1)
                pruned_points += n - kept
            tasks += host._pack_range_tasks(i, ranges, block_size)
            continue
        if idx_info is not None and (is_bounds or (is_time and idx_info[3] is not None)):
            # bbox / GPS-time sub-block pruning at FILE scope, at the index's
            # 65k granularity: straddling sub-blocks are scanned, packed into
            # full multi-range device blocks; fully-inside ones count with
            # zero point IO
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
            indexed_total += cont_pts
            if cont_pts:
                contained_blocks += max(cont_pts // idx_info[0], 1)
            if n - scan_pts - cont_pts > 0:
                skipped_blocks += max((n - scan_pts - cont_pts) // idx_info[0], 1)
            pruned_points += n - scan_pts
            tasks += host._pack_range_tasks(i, scan_rs, block_size)
            continue
        for b in range((n + block_size - 1) // block_size):
            start = b * block_size
            stop = min(start + block_size, n)
            tasks.append((i, b, start, stop))
    if skipped_blocks or contained_blocks:
        timer.counts["index_skipped_blocks"] += skipped_blocks
        timer.counts["index_contained_blocks"] += contained_blocks
        timer.counts["index_pruned_points"] += pruned_points

    pack = host._pack_transport_enabled()
    transform = None
    # Loaders return raw columns and whole-block encodings run in transform:
    # multi-range (index-packed) tasks concatenate several raw loads into one
    # block before it is encoded.
    if is_time:
        # f64 GPS times run on the device as the order-preserving (hi, lo)
        # int32 encoding: exact f64 range semantics with int32 compares,
        # half-open [start, end) (las.rs:332-339)
        q_enc = np.asarray(
            host.encode_f64_scalar(plan.time_range.start)
            + host.encode_f64_scalar(plan.time_range.end),
            np.int32,
        )

        def load(file_idx, start, stop):
            th, tl = host.encode_f64_sortable(readers[file_idx].column("gps_time", start, stop))
            return {"th": th, "tl": tl}

        if pack:
            def transform(file_idx, cols):
                return host._packed_time_cols(cols["th"], cols["tl"], block_size)
    elif is_bounds:
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

    feeder = BlockFeeder(
        tasks, load, block_size,
        file_bounds=file_bounds, workers=workers, prefetch=prefetch, pad=False,
        transform_fn=transform,
    )

    pending: list = []  # 0-d int32 device totals of steps not yet read back
    device_total = 0
    # blocks resolved with no device work: index-contained ones and the
    # class dictionary's absent-target and single-class blocks
    host_total = indexed_total

    def drain(limit: int):
        nonlocal device_total
        while len(pending) > limit:
            device_total += int(pending.pop(0))

    def widths(batch, n: int) -> tuple:
        w = comm.agree_widths(
            np.maximum.reduce([t.columns["w"] for t in batch]) if batch else np.zeros(n, np.int64)
        )
        return tuple(int(k) for k in w)

    def put(arrays, *plane_stacks):
        with timer.stage("h2d", sum(a.nbytes for a in plane_stacks)):
            return comm.put(arrays)

    def flush(batch):
        rows = comm.step_rows(len(batch), rows_per_step)
        pad = rows - len(batch)
        nvs = np.asarray([t.n_valid for t in batch] + [0] * pad, np.int32)
        if is_bounds and pack:
            i32 = np.iinfo(np.int32)
            kxyz = widths(batch, 3)
            # residual-space bounds: the saturating i64->i32 clip is exact
            # because sub-32 widths are capped at 28 bits (residuals < 2^28
            # never collide with a saturated bound) and k == 32 forces
            # base = 0 (bounds pass through unclipped)
            lo_rows = [
                np.clip(t.lo.astype(np.int64) - t.columns["base"], i32.min, i32.max)
                .astype(np.int32)
                for t in batch
            ] + [np.zeros(3, np.int32)] * pad
            hi_rows = [
                np.clip(t.hi.astype(np.int64) - t.columns["base"], i32.min, i32.max)
                .astype(np.int32)
                for t in batch
            ] + [np.full(3, -1, np.int32)] * pad
            xs = host._stack_planes(batch, "xp", 0, rows, kxyz[0], block_size)
            ys = host._stack_planes(batch, "yp", 1, rows, kxyz[1], block_size)
            zs = host._stack_planes(batch, "zp", 2, rows, kxyz[2], block_size)
            arrays = put((xs, ys, zs, np.stack(lo_rows), np.stack(hi_rows), nvs), xs, ys, zs)
            pending.append(step.bbox_count_packed(*arrays, kxyz, block_size))
        elif is_bounds:
            xs = host._stack_rows(batch, "x", rows, block_size, np.int32)
            ys = host._stack_rows(batch, "y", rows, block_size, np.int32)
            zs = host._stack_rows(batch, "z", rows, block_size, np.int32)
            los = np.stack([t.lo for t in batch] + [np.zeros(3, np.int32)] * pad)
            his = np.stack([t.hi for t in batch] + [np.zeros(3, np.int32)] * pad)
            arrays = put((xs, ys, zs, los, his, nvs), xs, ys, zs)
            pending.append(step.bbox_count(*arrays))
        elif is_time and pack:
            khl = widths(batch, 2)
            q_rows = [host._packed_time_query(q_enc, t.columns["base"]) for t in batch]
            q_rows += [np.zeros(4, np.int32)] * pad
            ths = host._stack_planes(batch, "thp", 0, rows, khl[0], block_size)
            tls = host._stack_planes(batch, "tlp", 1, rows, khl[1], block_size)
            arrays = put((ths, tls, np.stack(q_rows), nvs), ths, tls)
            pending.append(step.time_count_packed(*arrays, khl, block_size))
        elif is_time:
            ths = host._stack_rows(batch, "th", rows, block_size, np.int32)
            tls = host._stack_rows(batch, "tl", rows, block_size, np.int32)
            arrays = put((ths, tls, np.tile(q_enc, (rows, 1)), nvs), ths, tls)
            pending.append(step.time_count(*arrays))
        elif pack:
            (k,) = widths(batch, 1)
            cps = host._stack_planes(batch, "clsp", 0, rows, k, block_size)
            targets = np.asarray([int(t.columns["t"][0]) for t in batch] + [0] * pad, np.int32)
            arrays = put((cps, targets, nvs), cps)
            pending.append(step.class_count_dict(*arrays, k, block_size))
        else:
            clss = host._stack_rows(batch, "cls", rows, block_size, np.uint8)
            # words (4 points each) when the rows split into them, else u8
            if block_size % 4 == 0:
                clss = host.pack_class_words(clss)
            targets = np.full(rows, plan.classification.classification, np.int32)
            arrays = put((clss, targets, nvs), clss)
            pending.append(step.class_count(*arrays))
        drain(comm.inflight() - 1)

    # the dictionary's host fast paths change the flushed-step count, so
    # they are for a lone participant only
    is_class_dict = pack and not is_bounds and not is_time and comm.is_local
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
