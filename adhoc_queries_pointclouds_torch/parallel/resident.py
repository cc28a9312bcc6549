"""Device-resident datasets: repeated ad-hoc queries with no disk, no host
decode and no transfer of points.

The counterpart of adhoc_queries_pointclouds_tpu/parallel/resident.py
ResidentDataset. The file's columns are loaded once into device memory as
(n_blocks, B) tensors, blocks of every file stacked in file order; a count
is then one launch of the predicate's count entry (ops/predicate.py) over
every block and one read-back of the (n_blocks,) int32 per-block counts,
summed on the host in Python ints, so a dataset of more than 2^31 matches
never overflows. Only the query's per-block bounds or time range cross to
the device; n_valid stays resident.

One device, so there is no mesh and no padding: n_blocks is the number of
(file, block) tasks and every row belongs to a file. Collect and density
run the same bit-mask and compaction entries as the streamed engine
(parallel/step.py), with no cap: the host reads each block's true count
first. Density gathers its candidates' x, y and z on the device with the
compaction itself (ops/compact.py compact_bits_gather).

Sizes: x, y and z take 12 B a point, the class 1 B, the GPS time's (hi, lo)
int32 encoding 8 B; 21 B a point with all three, about 3.8 G points in an
H100's 80 GB.
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
from ..utils.aabb import AABB, clamp_bounds_to_i32, local_query_bounds
from . import step
from .comm import require_device

# predicate kind -> count entry over the kind's raw operands
_COUNTS = {
    "bbox": predicate.bbox_count_multi_kernel,
    "class": predicate.class_count_multi_kernel,
    "time": predicate.time_count_multi_kernel,
}


@dataclasses.dataclass
class ResidentDataset:
    device: torch.device
    block_size: int
    n_blocks: int  # the (file, block) tasks, in file order
    headers: list
    files: list[Path]
    file_idx: np.ndarray  # (n_blocks,) int32, non-decreasing
    nvs: np.ndarray  # (n_blocks,) int32 valid points per block
    block_start: np.ndarray  # (n_blocks,) int64 file-local start
    nvs_dev: torch.Tensor  # nvs on the device
    xs: torch.Tensor | None = None  # (n_blocks, B) int32
    ys: torch.Tensor | None = None
    zs: torch.Tensor | None = None
    cls: torch.Tensor | None = None  # (n_blocks, B) uint8
    # GPS times as the order-preserving (hi, lo) int32 encoding
    # (host.encode_f64_sortable): exact f64 range tests in int32 compares
    ths: torch.Tensor | None = None
    tls: torch.Tensor | None = None
    total_points: int = 0

    # ------------------------------------------------------------------

    @staticmethod
    def load(
        input_path,
        *,
        device,
        attrs: tuple[str, ...] = ("position", "classification"),
        block_size: int = 1 << 21,
        workers: int = 8,
    ) -> "ResidentDataset":
        """Load the files of input_path (a file or a flat directory) into
        device memory: attrs among position, classification and gps_time.
        device: a torch.device or its name; "cuda" without CUDA raises."""
        device = require_device(device)
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
            n_blocks = len(tasks)

            file_idx = np.asarray([t[0] for t in tasks], np.int32)
            nvs = np.asarray([t[2] - t[1] for t in tasks], np.int32)
            block_start = np.asarray([t[1] for t in tasks], np.int64)
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
                list(pool.map(fill, range(n_blocks)))
            headers = [r.header for r in readers]
        finally:
            for r in readers:
                r.close()

        def put(a):
            return torch.from_numpy(a).to(device)

        return ResidentDataset(
            device=device,
            block_size=block_size,
            n_blocks=n_blocks,
            headers=headers,
            files=files,
            file_idx=file_idx,
            nvs=nvs,
            block_start=block_start,
            nvs_dev=put(nvs),
            total_points=int(nvs.sum()),
            **{name: put(a) for name, a in cols.items()},
        )

    @property
    def resident_bytes(self) -> int:
        total = 0
        for t in (self.xs, self.ys, self.zs, self.cls, self.ths, self.tls):
            if t is not None:
                total += t.numel() * t.element_size()
        return total

    # ------------------------------------------------------------------

    def _ranges(self) -> dict[int, tuple[int, int]]:
        """File -> its contiguous row range [lo, hi), for every file with
        blocks (file_idx is non-decreasing)."""
        cuts = np.searchsorted(self.file_idx, np.arange(len(self.files) + 1))
        return {i: (int(cuts[i]), int(cuts[i + 1])) for i in range(len(self.files))
                if cuts[i] < cuts[i + 1]}

    def _file_bounds(self, plan: QueryPlan) -> dict:
        """Per-file integer query bounds after the header prefilter: files
        whose header box misses the query's have none."""
        out = {}
        for i, h in enumerate(self.headers):
            if not h.bounds.intersects(plan.bounds.bounds):
                continue
            lo64, hi64 = local_query_bounds(
                plan.bounds.bounds, h.scale, h.offset, parity_quirk=plan.parity_quirk
            )
            out[i] = clamp_bounds_to_i32(lo64, hi64)
        return out

    def _operands(self, plan: QueryPlan, lo: int, hi: int) -> tuple[str, tuple]:
        """(kind, operands) of plan's predicate over resident rows [lo, hi),
        in the raw layout of parallel/step.py: bbox (xs, ys, zs, los, his,
        nvs), class (cls, targets, nvs), time (ths, tls, qs, nvs). A file
        the header prefilter drops gets the empty box (0, -1)."""
        rows = hi - lo
        nvs = self.nvs_dev[lo:hi]
        if plan.bounds is not None:
            if self.xs is None:
                raise ValueError("dataset loaded without position columns")
            bounds = np.zeros((2, rows, 3), np.int32)  # (los, his): one copy to the device
            bounds[1] = -1
            ranges = self._ranges()
            for i, (blo, bhi) in self._file_bounds(plan).items():
                flo, fhi = ranges.get(i, (0, 0))
                flo, fhi = max(flo, lo) - lo, min(fhi, hi) - lo
                if flo < fhi:
                    bounds[0, flo:fhi] = blo
                    bounds[1, flo:fhi] = bhi
            b = torch.from_numpy(bounds).to(self.device)
            return "bbox", (self.xs[lo:hi], self.ys[lo:hi], self.zs[lo:hi], b[0], b[1], nvs)
        if plan.time_range is not None:
            if self.ths is None:
                raise ValueError("dataset loaded without gps_time columns")
            q = np.asarray(
                host.encode_f64_scalar(plan.time_range.start)
                + host.encode_f64_scalar(plan.time_range.end),
                np.int32,
            )
            qs = torch.from_numpy(np.tile(q, (rows, 1))).to(self.device)
            return "time", (self.ths[lo:hi], self.tls[lo:hi], qs, nvs)
        if self.cls is None:
            raise ValueError("dataset loaded without classification column")
        targets = torch.full((rows,), plan.classification.classification, dtype=torch.int32,
                             device=self.device)
        return "class", (self.cls[lo:hi], targets, nvs)

    def collect(
        self,
        plan: QueryPlan,
        *,
        output_dir=None,
        print_stream=None,
        keep_hits: bool = False,
    ):
        """Collect matching points: one predicate launch over every resident
        block into a bit mask, one read of the per-block counts, one
        compaction of the partial blocks' hits into an exact-size buffer;
        hit attributes are gathered from the source files for hit rows
        only, in block (so file) order. Returns (count, HitEmitter)."""
        from ..sinks import HitEmitter

        if plan.density is not None:
            return self.density_collect(
                plan, output_dir=output_dir, print_stream=print_stream,
                keep_hits=keep_hits,
            )
        kind, arrays = self._operands(plan, 0, self.n_blocks)
        mask = step.collect_mask(kind, arrays)
        counts = mask.counts.cpu().numpy()
        # full blocks are emitted as ranges; partial ones get an offset
        offsets = np.full(self.n_blocks, -1, np.int64)
        total = 0
        for b in range(self.n_blocks):
            if 0 < counts[b] < self.nvs[b]:
                offsets[b] = total
                total += int(counts[b])
        idx_np = None
        if total:
            offsets_dev = torch.from_numpy(offsets).to(self.device)
            idx_np = step.collect_indices(mask, offsets_dev, total, self.block_size).cpu().numpy()

        readers = [open_point_cloud(f) for f in self.files]
        emitter = HitEmitter(
            readers, output_dir=output_dir, print_stream=print_stream,
            keep_hits=keep_hits,
        )
        try:
            for b in range(self.n_blocks):
                c = int(counts[b])
                if c == 0:
                    continue
                i = int(self.file_idx[b])
                start = int(self.block_start[b])
                if offsets[b] < 0:
                    emitter.emit_range(i, start, start + int(self.nvs[b]))
                else:
                    local = idx_np[offsets[b] : offsets[b] + c]
                    emitter.emit_indices(i, local.astype(np.int64) + start)
            for i in range(len(self.files)):
                emitter.finalize_file(i)
        finally:
            for r in readers:
                r.close()
        return emitter.total, emitter

    def density_states(self, plan: QueryPlan):
        """Run the density query against the resident blocks; returns
        (per-file states dict, global state): exactly one is populated.

        Per file, over its contiguous rows: the predicate's bit mask, one
        read of its counts (they size the leaders table), the candidates
        (ops/density.py), one read of their counts, then one compaction that
        also gathers the candidates' x, y and z; the host resolves them
        exactly in f64 (GridSpec3D, WinnerAccum)."""
        if plan.density is None:
            raise ValueError("density_states needs a density plan")
        if plan.time_range is not None and self.ths is None:
            raise ValueError("dataset loaded without gps_time columns")
        if self.xs is None:
            raise ValueError("dataset loaded without position columns")
        if plan.bounds is not None:
            grid_bounds = plan.bounds.bounds
        else:
            grid_bounds = AABB.empty()
            for h in self.headers:
                grid_bounds = grid_bounds.union(h.bounds)
        grid = density_ops.GridSpec3D.create(grid_bounds, plan.density.cell_size)
        file_bounds = self._file_bounds(plan) if plan.bounds is not None else None

        accs: dict[int, density_ops.WinnerAccum] = {}
        global_acc = density_ops.WinnerAccum()
        per_file_scope = plan.density.scope == "file"
        # file_seq counts every file with blocks, those the prefilter drops
        # too, as the JAX package's does: it orders winners tied on d2
        for file_seq, (i, (blo, bhi)) in enumerate(sorted(self._ranges().items())):
            if file_bounds is not None and i not in file_bounds:
                continue
            kind, arrays = self._operands(plan, blo, bhi)
            mask = step.collect_mask(kind, arrays)
            most = int(mask.counts.max())
            if not most:
                continue
            h = self.headers[i]
            tables = density_ops.tables_to_device(grid.file_tables(h.scale, h.offset),
                                                  self.device)
            xyz = (self.xs[blo:bhi], self.ys[blo:bhi], self.zs[blo:bhi])
            cands = density_ops.density_candidates_bits(
                xyz, mask, arrays[-1], tables, self.block_size,
                slots=density_ops.table_slots(most, density_ops.grid_cells(tables)))
            counts = cands.counts.cpu().numpy()
            offsets = np.full(bhi - blo, -1, np.int64)
            total = 0
            for j in range(bhi - blo):
                if counts[j]:
                    offsets[j] = total
                    total += int(counts[j])
            if not total:
                continue
            offsets_dev = torch.from_numpy(offsets).to(self.device)
            idx, gx, gy, gz = (t.cpu().numpy() for t in compact.compact_bits_gather(
                cands.bits, cands.chunks, offsets_dev, total, self.block_size, *xyz))
            acc = accs.setdefault(i, density_ops.WinnerAccum()) if per_file_scope else global_acc
            for j in range(bhi - blo):
                c = int(counts[j])
                if c == 0:
                    continue
                at = slice(offsets[j], offsets[j] + c)
                winners = grid.make_winners_raw(
                    gx[at], gy[at], gz[at], h.scale, h.offset,
                    idx[at].astype(np.int64) + int(self.block_start[blo + j]), i,
                )
                acc.add(winners, file_seq)
        return (
            {i: a.result() for i, a in accs.items()},
            global_acc.result() if not per_file_scope else None,
        )

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
        entry over every block, one read-back of the per-block counts,
        summed in Python ints (density plans: per file, as density_states)."""
        if plan.density is not None:
            return self.density_count(plan)
        if plan.collects_points:
            raise NotImplementedError(
                "use ResidentDataset.collect() for point materialization"
            )
        kind, arrays = self._operands(plan, 0, self.n_blocks)
        if kind == "class" and self.block_size % 4 == 0:
            # the u8 column viewed as int32 words, 4 points a word
            counts = predicate.class_count_words_kernel(arrays[0].view(torch.int32), *arrays[1:])
        else:
            counts = _COUNTS[kind](*arrays)
        return int(counts.cpu().numpy().sum(dtype=np.int64))
