"""Streaming hit emission: bounded-memory collection, print, and writeback.

The reference has two collector behaviors worth preserving without its RAM
cost: StdOutCollector streams each hit as it is found
(query/src/collect_points.rs:46-70) while BufferCollector + FileDumper
buffer every hit of a file before writing (collect_points.rs:14-44,
dump_points.rs:73-106). The paper's XL queries match ~2.6 B points — far
beyond host RAM — so here every consumer is streaming:

  - hits are gathered from the source file in bounded chunks as soon as a
    block's compacted indices arrive from the device;
  - --print-points writes each chunk straight to the stream;
  - LAS write-back spools chunks (RAM up to AQPC_SPOOL_MB, then a temp
    file) because the reference's header math needs the min corner and
    extent of ALL hits before the first record can be encoded
    (dump_points.rs:73-89); peak RSS stays O(chunk), spill is sequential IO.

keep_hits (test/API convenience) retains everything in RAM and is the only
non-streaming consumer — never enabled by the CLI for unbounded queries.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path

import numpy as np

HIT_ATTRS = ("position", "classification", "color", "intensity")

SPOOL_DTYPE = np.dtype(
    [
        ("pos", "<f8", (3,)),
        ("cls", "u1"),
        ("rgb", "<u2", (3,)),
        ("intensity", "<u2"),
    ]
)


@dataclasses.dataclass
class FileHits:
    """Materialized matching points of one input file."""

    file_idx: int
    position_world: np.ndarray  # (n, 3) f64
    classification: np.ndarray  # (n,) u8
    color: np.ndarray  # (n, 3) u16
    intensity: np.ndarray  # (n,) u16

    @property
    def count(self) -> int:
        return len(self.position_world)


def empty_hits(file_idx: int) -> FileHits:
    return FileHits(
        file_idx,
        np.empty((0, 3), np.float64),
        np.empty(0, np.uint8),
        np.empty((0, 3), np.uint16),
        np.empty(0, np.uint16),
    )


def gather_hits(reader, indices: np.ndarray, file_idx: int) -> FileHits:
    """Random-access gather of hit rows — the columnar analog of the
    reference's lazy per-hit attribute reads (search/last.rs:137-153)."""
    attrs = reader.take(indices, HIT_ATTRS)
    pos_world = attrs["position"].astype(np.float64) * np.asarray(
        reader.header.scale
    ) + np.asarray(reader.header.offset)
    return FileHits(
        file_idx=file_idx,
        position_world=pos_world,
        classification=np.asarray(attrs["classification"], np.uint8),
        color=np.asarray(attrs["color"], np.uint16).reshape(-1, 3),
        intensity=np.asarray(attrs["intensity"], np.uint16),
    )


def concat_hits(parts: list[FileHits], file_idx: int = -1) -> FileHits:
    if not parts:
        return empty_hits(file_idx)
    return FileHits(
        file_idx=file_idx,
        position_world=np.concatenate([p.position_world for p in parts]),
        classification=np.concatenate([p.classification for p in parts]),
        color=np.concatenate([p.color for p in parts]),
        intensity=np.concatenate([p.intensity for p in parts]),
    )


class HitSpool:
    """Append-only spool of hit attributes with a RAM cap and disk spill.

    Tracks running count / min / max so the LAS write-back header can be
    derived before re-reading the spool (write order is preserved)."""

    def __init__(self, mem_limit_bytes: int, spool_dir: Path | None = None):
        self._mem_limit = mem_limit_bytes
        self._chunks: list[np.ndarray] = []
        self._mem_bytes = 0
        self._spill = None
        self._spool_dir = spool_dir
        self.count = 0
        self.pmin = np.full(3, np.inf)
        self.pmax = np.full(3, -np.inf)

    def append(self, hits: FileHits) -> None:
        if hits.count == 0:
            return
        rec = np.empty(hits.count, SPOOL_DTYPE)
        rec["pos"] = hits.position_world
        rec["cls"] = hits.classification
        rec["rgb"] = hits.color
        rec["intensity"] = hits.intensity
        self.count += hits.count
        np.minimum(self.pmin, hits.position_world.min(axis=0), out=self.pmin)
        np.maximum(self.pmax, hits.position_world.max(axis=0), out=self.pmax)
        if self._spill is not None:
            self._spill.write(rec.tobytes())
            return
        self._chunks.append(rec)
        self._mem_bytes += rec.nbytes
        if self._mem_bytes > self._mem_limit:
            self._spill = tempfile.TemporaryFile(
                prefix="aqpc_spool_", dir=self._spool_dir
            )
            for c in self._chunks:
                self._spill.write(c.tobytes())
            self._chunks = []
            self._mem_bytes = 0

    def chunks(self, chunk_points: int = 1 << 20):
        """Yield (positions, classification, color, intensity) in order."""
        if self._spill is None:
            for rec in self._chunks:
                yield rec["pos"], rec["cls"], rec["rgb"], rec["intensity"]
            return
        self._spill.seek(0)
        itemsize = SPOOL_DTYPE.itemsize
        remaining = self.count
        while remaining > 0:
            take = min(chunk_points, remaining)
            buf = self._spill.read(take * itemsize)
            rec = np.frombuffer(buf, dtype=SPOOL_DTYPE)
            yield rec["pos"], rec["cls"], rec["rgb"], rec["intensity"]
            remaining -= take

    def close(self) -> None:
        self._chunks = []
        if self._spill is not None:
            self._spill.close()
            self._spill = None


class HitEmitter:
    """Routes per-block hit indices to all configured consumers, streaming.

    emit_* must be called in file order, ascending indices per file (the
    engine's batched dispatch guarantees this), then finalize_file once per
    file; finalize_file order determines output numbering, matching the
    reference's one-LAS-per-input-file naming (README.md:66)."""

    def __init__(
        self,
        readers,
        *,
        output_dir: Path | None = None,
        print_stream=None,
        keep_hits: bool = False,
        gather_chunk: int = 1 << 20,
    ):
        self.readers = readers
        self.output_dir = Path(output_dir) if output_dir is not None else None
        if self.output_dir is not None:
            if not self.output_dir.exists():
                raise FileNotFoundError(f"Path {self.output_dir} does not exist!")
            if not self.output_dir.is_dir():
                raise NotADirectoryError(f"Path {self.output_dir} is no directory!")
        self.print_stream = print_stream
        self.keep_hits = keep_hits
        self.gather_chunk = gather_chunk
        spool_mb = float(os.environ.get("AQPC_SPOOL_MB", "256"))
        self._spool_limit = int(spool_mb * 1048576)
        self.total = 0
        self.output_files: list[Path] = []
        self._spools: dict[int, HitSpool] = {}
        self._kept: dict[int, list[FileHits]] = {}
        self.all_hits: list[FileHits] = []

    # -- emission ----------------------------------------------------------

    def emit_indices(self, file_idx: int, gidx: np.ndarray) -> None:
        """gidx: ascending int64 point ordinals within file file_idx."""
        for s in range(0, len(gidx), self.gather_chunk):
            chunk = gidx[s : s + self.gather_chunk]
            self._consume(file_idx, gather_hits(self.readers[file_idx], chunk, file_idx))

    def emit_range(self, file_idx: int, start: int, stop: int) -> None:
        """Every point of [start, stop) matches (index-contained block)."""
        for s in range(start, stop, self.gather_chunk):
            idx = np.arange(s, min(s + self.gather_chunk, stop), dtype=np.int64)
            self._consume(file_idx, gather_hits(self.readers[file_idx], idx, file_idx))

    def emit_hits(self, file_idx: int, hits: FileHits) -> None:
        """Pre-materialized hits (density winners)."""
        self._consume(file_idx, hits)

    def _consume(self, file_idx: int, hits: FileHits) -> None:
        self.total += hits.count
        if self.print_stream is not None and hits.count:
            # Batch-format the whole chunk: native snprintf loop when the
            # C library is present (~50x the per-point Python f-string the
            # reference's one-point-per-iteration StdOutCollector implies,
            # collect_points.rs:46-70), byte-identical Python join fallback.
            from . import native

            text = native.format_points(
                hits.position_world, hits.color, hits.classification, hits.intensity
            )
            if text is None:
                p = hits.position_world.tolist()
                c = hits.color.tolist()
                cl = hits.classification.tolist()
                it = hits.intensity.tolist()
                text = "".join(
                    f"Found point: ({x:.3f}, {y:.3f}, {z:.3f}) "
                    f"class={k} rgb=({r}, {g}, {b}) intensity={n}\n"
                    for (x, y, z), (r, g, b), k, n in zip(p, c, cl, it)
                )
            self.print_stream.write(text)
        if self.output_dir is not None and hits.count:
            spool = self._spools.get(file_idx)
            if spool is None:
                spool = self._spools[file_idx] = HitSpool(self._spool_limit)
            spool.append(hits)
        if self.keep_hits:
            self._kept.setdefault(file_idx, []).append(hits)

    # -- finalization ------------------------------------------------------

    def finalize_file(self, file_idx: int) -> None:
        from .formats.las import write_las_chunked

        spool = self._spools.pop(file_idx, None)
        if spool is not None and spool.count:
            path = self.output_dir / f"matching_points_{len(self.output_files)}.las"
            write_las_chunked(
                path, spool.chunks(), spool.count, spool.pmin, spool.pmax,
                point_format=2,
            )
            spool.close()
            self.output_files.append(path)
        if self.keep_hits:
            parts = self._kept.pop(file_idx, [])
            self.all_hits.append(concat_hits(parts, file_idx))
