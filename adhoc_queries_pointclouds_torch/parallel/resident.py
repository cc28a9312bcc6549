"""Device-resident datasets: repeated ad-hoc queries with no disk, no host
decode and no transfer of points.

The counterpart of adhoc_queries_pointclouds_tpu/parallel/resident.py
ResidentDataset. The files' columns are loaded once into device memory as
(rows, B) tensors, blocks of every file stacked in file order, and sharded
over the dataset's devices as JAX shards them over its mesh (resident.py:
41-42, 82-99): n_blocks is the (file, block) tasks padded to a multiple of
the device count with blocks of file_idx -1 and n_valid 0, and device j
holds the j-th contiguous group of blocks (a ResidentShard). A count is one
launch of the predicate's count entry (ops/predicate.py) a shard and one
read-back of each shard's (rows,) int32 per-block counts, summed on the
host in Python ints, so a dataset of more than 2^31 matches never
overflows. Only the query's per-block bounds or time range cross to the
devices; n_valid stays resident.

Collect and density run the same bit-mask and compaction entries as the
streamed engine (parallel/step.py), shard by shard in block order, with no
cap: the host reads each block's true count first; a collect with a limit
(serve's previews) compacts and gathers only its first limit hits, from
the files they lie in (emit_counts counts the rows). Density gathers its
candidates' x, y and z on the device with the compaction itself
(ops/compact.py compact_bits_gather).

Sizes: x, y and z take 12 B a point, the class 1 B, the GPS time's (hi, lo)
int32 encoding 8 B; 21 B a point with all three, about 3.8 G points in one
H100's 80 GB, and d times that over d cards.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import host
from ..engine import BLOCK_QUANTUM, discover_files
from ..formats import open_point_cloud
from ..models.query import QueryPlan
from ..ops import compact, density as density_ops, predicate
from ..utils.aabb import AABB
from ..utils.bounds_table import HeaderTables, query_bounds_table
from ..utils.timing import span
from . import step
from .comm import indexed, require_device
from .mesh import shard_ranges, step_rows

# predicate kind -> count entry over the kind's raw operands
_COUNTS = {
    "bbox": predicate.bbox_count_multi_kernel,
    "class": predicate.class_count_multi_kernel,
    "time": predicate.time_count_multi_kernel,
}

COLUMNS = ("xs", "ys", "zs", "cls", "ths", "tls")

# box requests' operand tables built (one a request, whatever the shards),
# and the files their header prefilter kept and dropped, since the last
# reset_operand_counts(): the per-file conversions the table stands for
operand_counts = {"tables": 0, "files_kept": 0, "files_dropped": 0}


def reset_operand_counts() -> None:
    for name in operand_counts:
        operand_counts[name] = 0


# collects with a limit (serve's previews) since the last reset_emit_counts():
# their matches, and the rows gathered from the files for them
emit_counts = {"previews": 0, "hits": 0, "gathered": 0}


def reset_emit_counts() -> None:
    for name in emit_counts:
        emit_counts[name] = 0


@dataclasses.dataclass
class ResidentShard:
    """The blocks [lo, hi) of a resident dataset, on one device."""

    device: torch.device
    lo: int
    hi: int
    nvs: torch.Tensor  # (hi - lo,) int32 valid points a block
    xs: torch.Tensor | None = None  # (hi - lo, B) int32
    ys: torch.Tensor | None = None
    zs: torch.Tensor | None = None
    cls: torch.Tensor | None = None  # (hi - lo, B) uint8
    # GPS times as the order-preserving (hi, lo) int32 encoding
    # (host.encode_f64_sortable): exact f64 range tests in int32 compares
    ths: torch.Tensor | None = None
    tls: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (getattr(self, name) for name in COLUMNS) if t is not None)


@dataclasses.dataclass
class ResidentDataset:
    devices: list[torch.device]  # one a shard; a device may repeat
    block_size: int
    n_blocks: int  # the (file, block) tasks in file order, padded to a multiple of the shards
    headers: list
    files: list[Path]
    file_idx: np.ndarray  # (n_blocks,) int32, non-decreasing, then -1 for padding blocks
    nvs: np.ndarray  # (n_blocks,) int32 valid points per block
    block_start: np.ndarray  # (n_blocks,) int64 file-local start
    shards: list[ResidentShard]
    total_points: int = 0
    # kept from the headers and file_idx for the box operands (_box_table):
    # the headers' boxes, scales and offsets as (F, 3) float64, and each
    # block's row of a request's table, file_idx with F for padding blocks
    header_tables: HeaderTables = dataclasses.field(init=False)
    table_rows: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        self.header_tables = HeaderTables.of(self.headers)
        self.table_rows = np.where(self.file_idx >= 0, self.file_idx,
                                   len(self.headers)).astype(np.intp)

    # ------------------------------------------------------------------

    @staticmethod
    def load(
        input_path,
        *,
        device=None,
        devices=None,
        attrs: tuple[str, ...] = ("position", "classification"),
        block_size: int = 1 << 21,
        workers: int = 8,
    ) -> "ResidentDataset":
        """Load the files of input_path (a file or a flat directory) into
        device memory: attrs among position, classification and gps_time.
        device: a torch.device or its name; "cuda" without CUDA raises.
        devices: the shards' devices instead (parallel/mesh.py
        local_devices; a device may repeat)."""
        if devices is None:
            if device is None:
                raise ValueError("ResidentDataset.load needs a device or devices")
            devices = [device]
        devices = [indexed(require_device(d)) for d in devices]
        if not devices:
            raise ValueError("ResidentDataset.load needs at least one device")
        files = discover_files(input_path)
        if not files:
            raise FileNotFoundError(f"No supported point-cloud files under {input_path}")
        readers = [open_point_cloud(f) for f in files]
        try:
            max_pts = max(r.point_count for r in readers)
            if max_pts < block_size:  # shrink to the largest file, rounded up
                q = BLOCK_QUANTUM
                block_size = min(block_size, ((max_pts + q - 1) // q) * q)

            tasks = []
            for i, r in enumerate(readers):
                n = r.point_count
                for b in range((n + block_size - 1) // block_size):
                    start = b * block_size
                    tasks.append((i, start, min(start + block_size, n)))
            n_blocks = step_rows(len(tasks), len(devices))

            file_idx = np.full(n_blocks, -1, np.int32)
            nvs = np.zeros(n_blocks, np.int32)
            block_start = np.zeros(n_blocks, np.int64)
            for j, (i, start, stop) in enumerate(tasks):
                file_idx[j], nvs[j], block_start[j] = i, stop - start, start
            want_pos = "position" in attrs
            want_cls = "classification" in attrs
            want_gps = "gps_time" in attrs
            shape = (n_blocks, block_size)
            cols = {}
            if want_pos:
                cols.update(xs=np.zeros(shape, np.int32), ys=np.zeros(shape, np.int32),
                            zs=np.zeros(shape, np.int32))
            if want_cls:
                cols["cls"] = np.zeros(shape, np.uint8)
            if want_gps:
                cols.update(ths=np.zeros(shape, np.int32), tls=np.zeros(shape, np.int32))

            def fill(j):
                i, start, stop = tasks[j]
                r = readers[i]
                n = stop - start
                if want_pos:
                    p = r.column("position", start, stop)
                    cols["xs"][j, :n] = p[:, 0]
                    cols["ys"][j, :n] = p[:, 1]
                    cols["zs"][j, :n] = p[:, 2]
                if want_cls:
                    cols["cls"][j, :n] = r.column("classification", start, stop)
                if want_gps:
                    th, tl = host.encode_f64_sortable(r.column("gps_time", start, stop))
                    cols["ths"][j, :n] = th
                    cols["tls"][j, :n] = tl

            with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
                list(pool.map(fill, range(len(tasks))))
            headers = [r.header for r in readers]
        finally:
            for r in readers:
                r.close()

        shards = [
            ResidentShard(
                device=dev, lo=lo, hi=hi, nvs=torch.from_numpy(nvs[lo:hi]).to(dev),
                **{name: torch.from_numpy(a[lo:hi]).to(dev) for name, a in cols.items()})
            for dev, (lo, hi) in zip(devices, shard_ranges(n_blocks, len(devices)))
        ]
        return ResidentDataset(
            devices=devices,
            block_size=block_size,
            n_blocks=n_blocks,
            headers=headers,
            files=files,
            file_idx=file_idx,
            nvs=nvs,
            block_start=block_start,
            shards=shards,
            total_points=int(nvs.sum()),
        )

    @property
    def device(self) -> torch.device:
        """The first shard's device."""
        return self.devices[0]

    @property
    def resident_bytes(self) -> int:
        """The columns' bytes on every device together."""
        return sum(self.per_device_bytes)

    @property
    def per_device_bytes(self) -> list[int]:
        """The columns' bytes of each shard, in shard order."""
        return [s.nbytes for s in self.shards]

    def _has(self, name: str) -> bool:
        return getattr(self.shards[0], name) is not None

    # ------------------------------------------------------------------

    def _ranges(self) -> dict[int, tuple[int, int]]:
        """File -> its contiguous row range [lo, hi), for every file with
        blocks (file_idx is non-decreasing up to the padding blocks)."""
        real = self.file_idx[self.file_idx >= 0]
        cuts = np.searchsorted(real, np.arange(len(self.files) + 1))
        return {i: (int(cuts[i]), int(cuts[i + 1])) for i in range(len(self.files))
                if cuts[i] < cuts[i + 1]}

    def _pieces(self, lo: int, hi: int) -> list[tuple[ResidentShard, int, int]]:
        """The rows [lo, hi) cut at the shards' edges: (shard, lo, hi) of
        each shard they reach, in row order."""
        return [(s, max(lo, s.lo), min(hi, s.hi)) for s in self.shards
                if max(lo, s.lo) < min(hi, s.hi)]

    def _box_table(self, plan: QueryPlan) -> tuple:
        """A box plan's integer query bounds of every file at once, after the
        header prefilter (utils/bounds_table.py): (boxes, kept), boxes the
        (2, F + 1, 3) int32 (los, his) a file, F the padding blocks' and the
        dropped files' empty box (0, -1), kept the prefilter's (F,) bool.
        Built once a request, for every shard and density piece; (None,
        None) for other plans."""
        if plan.bounds is None:
            return None, None
        if not self._has("xs"):
            raise ValueError("dataset loaded without position columns")
        with span("resident.operands"):
            table, kept = query_bounds_table(plan.bounds.bounds, self.header_tables,
                                             parity_quirk=plan.parity_quirk)
            n_kept = int(np.count_nonzero(kept))
            operand_counts["tables"] += 1
            operand_counts["files_kept"] += n_kept
            operand_counts["files_dropped"] += len(kept) - n_kept
            return table.transpose(1, 0, 2), kept

    def _operands(self, plan: QueryPlan, shard: ResidentShard, lo: int, hi: int,
                  boxes: np.ndarray | None) -> tuple[str, tuple]:
        """(kind, operands) of plan's predicate over the resident rows [lo,
        hi) of shard, on its device, in the raw layout of parallel/step.py:
        bbox (xs, ys, zs, los, his, nvs), class (cls, targets, nvs), time
        (ths, tls, qs, nvs). A box plan's rows take their file's bounds
        from boxes (_box_table's) by one gather: a file the header
        prefilter drops, and a padding block, get the empty box (0, -1)."""
        with span("resident.operands"):
            rows = hi - lo
            at = slice(lo - shard.lo, hi - shard.lo)
            nvs = shard.nvs[at]
            if plan.bounds is not None:
                # (los, his) of the rows: one copy to the device
                bounds = np.take(boxes, self.table_rows[lo:hi], axis=1)
                b = torch.from_numpy(bounds).to(shard.device)
                return "bbox", (shard.xs[at], shard.ys[at], shard.zs[at], b[0], b[1], nvs)
            if plan.time_range is not None:
                if shard.ths is None:
                    raise ValueError("dataset loaded without gps_time columns")
                # (hi, lo) of the start, then of the end: both in one encode
                th, tl = host.encode_f64_sortable(
                    np.array([plan.time_range.start, plan.time_range.end], np.float64))
                q = np.stack([th, tl], axis=1).ravel()
                qs = torch.from_numpy(np.tile(q, (rows, 1))).to(shard.device)
                return "time", (shard.ths[at], shard.tls[at], qs, nvs)
            if shard.cls is None:
                raise ValueError("dataset loaded without classification column")
            targets = torch.full((rows,), plan.classification.classification, dtype=torch.int32,
                                 device=shard.device)
            return "class", (shard.cls[at], targets, nvs)

    def collect(
        self,
        plan: QueryPlan,
        *,
        output_dir=None,
        print_stream=None,
        keep_hits: bool = False,
        limit: int | None = None,
    ):
        """Collect matching points: one predicate launch a shard over its
        resident blocks into a bit mask, one read of each shard's per-block
        counts, one compaction a shard of its partial blocks' hits into an
        exact-size buffer; hit attributes are gathered from the source
        files for hit rows only, in block (so file) order. With limit, only
        the first limit hits (none for limit <= 0) are compacted and
        gathered, and only their files opened; the count is still every
        match's and every file is still finalized (density plans ignore
        limit). Returns (count, HitEmitter)."""
        from ..sinks import HitEmitter

        if plan.density is not None:
            return self.density_collect(
                plan, output_dir=output_dir, print_stream=print_stream,
                keep_hits=keep_hits,
            )
        boxes, _ = self._box_table(plan)
        masks = [step.collect_mask(*self._operands(plan, s, s.lo, s.hi, boxes))
                 for s in self.shards]
        # full blocks are emitted as ranges; partial ones get an offset, while
        # the hits of the rows before them (read_hits asks in row order) are
        # fewer than limit
        before = 0

        def picked(b, c):
            nonlocal before
            take = 0 < c < self.nvs[b] and (limit is None or before < limit)
            before += c
            return take

        counts, offsets, idx_np = step.read_hits(masks, picked, self.block_size)
        count = int(counts.sum(dtype=np.int64))
        # (row, hits emitted from it) in row order, the first `want` hits
        want = count if limit is None else min(max(limit, 0), count)
        emits = []
        for b in np.flatnonzero(counts).tolist():
            n = min(int(counts[b]), want)
            if n <= 0:
                break
            emits.append((b, n))
            want -= n

        readers = {}
        try:
            for i in sorted({int(self.file_idx[b]) for b, _ in emits}):
                readers[i] = open_point_cloud(self.files[i])
            emitter = HitEmitter(
                readers, output_dir=output_dir, print_stream=print_stream,
                keep_hits=keep_hits,
            )
            for b, n in emits:
                i = int(self.file_idx[b])
                start = int(self.block_start[b])
                if offsets[b] < 0:
                    emitter.emit_range(i, start, start + n)
                else:
                    local = idx_np[offsets[b] : offsets[b] + n]
                    emitter.emit_indices(i, local.astype(np.int64) + start)
            for i in range(len(self.files)):
                emitter.finalize_file(i)
        finally:
            for r in readers.values():
                r.close()
        if limit is not None:
            emit_counts["previews"] += 1
            emit_counts["hits"] += count
            emit_counts["gathered"] += emitter.total
        return count, emitter

    def density_states(self, plan: QueryPlan):
        """Run the density query against the resident blocks; returns
        (per-file states dict, global state): exactly one is populated.

        Per file, over its contiguous rows on each shard they reach, in
        block order: the predicate's bit mask, one read of its counts (they
        size the leaders table), the candidates (ops/density.py), one read
        of their counts, then one compaction that also gathers the
        candidates' x, y and z; the host resolves them exactly in f64
        (GridSpec3D, WinnerAccum)."""
        if plan.density is None:
            raise ValueError("density_states needs a density plan")
        if plan.time_range is not None and not self._has("ths"):
            raise ValueError("dataset loaded without gps_time columns")
        if not self._has("xs"):
            raise ValueError("dataset loaded without position columns")
        if plan.bounds is not None:
            grid_bounds = plan.bounds.bounds
        else:
            grid_bounds = AABB.empty()
            for h in self.headers:
                grid_bounds = grid_bounds.union(h.bounds)
        grid = density_ops.GridSpec3D.create(grid_bounds, plan.density.cell_size)
        boxes, kept = self._box_table(plan)

        accs: dict[int, density_ops.WinnerAccum] = {}
        global_acc = density_ops.WinnerAccum()
        per_file_scope = plan.density.scope == "file"
        # file_seq counts every file with blocks, those the prefilter drops
        # too, as the JAX package's does: it orders winners tied on d2
        for file_seq, (i, (blo, bhi)) in enumerate(sorted(self._ranges().items())):
            if kept is not None and not kept[i]:
                continue
            h = self.headers[i]
            tables_np = grid.file_tables(h.scale, h.offset)
            for shard, plo, phi in self._pieces(blo, bhi):
                self._density_piece(plan, grid, shard, plo, phi, boxes, tables_np, h, i,
                                    file_seq, accs.setdefault(i, density_ops.WinnerAccum())
                                    if per_file_scope else global_acc)
        return (
            {i: a.result() for i, a in accs.items()},
            global_acc.result() if not per_file_scope else None,
        )

    def _density_piece(self, plan, grid, shard, lo, hi, boxes, tables_np, header, i,
                       file_seq, acc) -> None:
        """The density candidates of file i's rows [lo, hi) on one shard,
        resolved and merged into acc (density_states; boxes the request's
        _box_table)."""
        kind, arrays = self._operands(plan, shard, lo, hi, boxes)
        mask = step.collect_mask(kind, arrays)
        most = int(mask.counts.max())
        if not most:
            return
        tables = density_ops.tables_to_device(tables_np, shard.device)
        at = slice(lo - shard.lo, hi - shard.lo)
        xyz = (shard.xs[at], shard.ys[at], shard.zs[at])
        cands = density_ops.density_candidates_bits(
            xyz, mask, arrays[-1], tables, self.block_size,
            slots=density_ops.table_slots(most, density_ops.grid_cells(tables)))
        counts = cands.counts.cpu().numpy()
        offsets = np.full(hi - lo, -1, np.int64)
        total = 0
        for j in range(hi - lo):
            if counts[j]:
                offsets[j] = total
                total += int(counts[j])
        if not total:
            return
        offsets_dev = torch.from_numpy(offsets).to(shard.device)
        idx, gx, gy, gz = (t.cpu().numpy() for t in compact.compact_bits_gather(
            cands.bits, cands.chunks, offsets_dev, total, self.block_size, *xyz))
        for j in range(hi - lo):
            c = int(counts[j])
            if c == 0:
                continue
            at = slice(offsets[j], offsets[j] + c)
            with span("resident.density.exact"):
                winners = grid.make_winners_raw(
                    gx[at], gy[at], gz[at], header.scale, header.offset,
                    idx[at].astype(np.int64) + int(self.block_start[lo + j]), i,
                )
            with span("resident.density.merge"):
                acc.add(winners, file_seq)

    def density_count(self, plan: QueryPlan) -> int:
        """Max-density sampled count against the resident blocks."""
        states, global_state = self.density_states(plan)
        if plan.density.scope == "file":
            return sum(len(s) for s in states.values() if s is not None)
        return 0 if global_state is None else len(global_state)

    def density_collect(
        self, plan: QueryPlan, *, output_dir=None, print_stream=None,
        keep_hits: bool = False,
    ):
        """Density-sampled collection: winner attributes gathered from the
        source files. Returns (count, HitEmitter)."""
        from ..sinks import HitEmitter, concat_hits, empty_hits, gather_hits

        states, global_state = self.density_states(plan)
        readers = [open_point_cloud(f) for f in self.files]
        emitter = HitEmitter(
            readers, output_dir=output_dir, print_stream=print_stream,
            keep_hits=keep_hits,
        )

        def to_hits(state, i):
            if state is None or len(state) == 0:
                return empty_hits(i)
            return gather_hits(readers[i], np.sort(state["gidx"]), i)

        try:
            if plan.density.scope == "file":
                for i in range(len(self.files)):
                    emitter.emit_hits(i, to_hits(states.get(i), i))
                    emitter.finalize_file(i)
            else:
                combined = []
                if global_state is not None and len(global_state):
                    for i in np.unique(global_state["file_idx"]):
                        sub = global_state[global_state["file_idx"] == i]
                        combined.append(to_hits(sub, int(i)))
                emitter.emit_hits(-1, concat_hits(combined))
                emitter.finalize_file(-1)
        finally:
            for r in readers:
                r.close()
        return emitter.total, emitter

    def count(self, plan: QueryPlan) -> int:
        """One resident ad-hoc count: one launch of the predicate's count
        entry a shard over its blocks, then one read-back of each shard's
        per-block counts, summed in Python ints (density plans: per file,
        as density_states)."""
        if plan.density is not None:
            return self.density_count(plan)
        if plan.collects_points:
            raise NotImplementedError(
                "use ResidentDataset.collect() for point materialization"
            )
        boxes, _ = self._box_table(plan)
        per_shard = []
        for s in self.shards:
            kind, arrays = self._operands(plan, s, s.lo, s.hi, boxes)
            if kind == "class" and self.block_size % 4 == 0:
                # the u8 column viewed as int32 words, 4 points a word
                per_shard.append(predicate.class_count_words_kernel(
                    arrays[0].view(torch.int32), *arrays[1:]))
            else:
                per_shard.append(_COUNTS[kind](*arrays))
        with span("resident.readback"):
            return sum(int(c.cpu().numpy().sum(dtype=np.int64)) for c in per_shard)
