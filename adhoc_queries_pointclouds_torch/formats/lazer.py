"""LAZER codec: block-wise LZ4-compressed columnar point cloud.

Container layout (reverse-engineered from readers/src/lazer_reader.rs:57-125,
136-265): a standard LAS header; at `offset_to_point_data`:

    u64 block_size                      # points per block
    u64 block_offset[num_blocks]        # file-absolute, num_blocks = ceil(N/bs)

Each block:

    u64 blob_offset[number_of_attributes]   # file-absolute
    <one LZ4 *frame* per attribute, back to back>

number_of_attributes = 8 base + has_color + has_gps_time + has_waveform +
has_nir (lazer_reader.rs:92-105). Blob index semantics the reference relies
on: 0 = positions (3 x i32), 1 = intensity (u16), 3 = classification (u8),
8 = color (3 x u16) (lazer_reader.rs:176,202,221,240). Indices 2,4,5,6 carry
the remaining LAS record fields (flags, scan angle, user data, point source);
index 7 is reserved/empty. The last block may hold fewer than block_size
points.

The block table is the natural pipeline granularity: the host decodes only
the attribute blobs a query needs (positions for bbox, classification for
class — 1 compressed byte-stream per point for the latter), while the device
scans the previous block.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .. import native
from . import lz4py
from .las import (
    LasHeader,
    has_color,
    has_gps_time,
    has_nir,
    has_waveform,
    is_extended_format,
    parse_las_header,
    write_las_header,
)

DEFAULT_BLOCK_SIZE = 50_000
_WAVE_BYTES = 29  # wave packet descriptor + offset + size + location + dx/dy/dz


def attribute_layout(fmt: int) -> list[tuple[str, np.dtype, int]]:
    """(name, dtype, components) per blob index, in blob order."""
    ext = is_extended_format(fmt)
    attrs: list[tuple[str, str, int]] = [
        ("position", "<i4", 3),
        ("intensity", "<u2", 1),
        ("flags", "<u2" if ext else "u1", 1),
        ("classification", "u1", 1),
        ("scan_angle", "<i2" if ext else "i1", 1),
        ("user_data", "u1", 1),
        ("point_source", "<u2", 1),
        ("_reserved", "u1", 0),
    ]
    if has_color(fmt):
        attrs.append(("color", "<u2", 3))
    if has_gps_time(fmt):
        attrs.append(("gps_time", "<f8", 1))
    if has_waveform(fmt):
        attrs.append(("waveform", "u1", _WAVE_BYTES))
    if has_nir(fmt):
        attrs.append(("nir", "<u2", 1))
    return [(n, np.dtype(d), c) for n, d, c in attrs]


def _decompress_frame(blob: memoryview | np.ndarray, dst_cap: int) -> np.ndarray:
    if native.available():
        return native.lz4_frame_decompress(blob, dst_cap)
    payload, _ = lz4py.frame_decompress(bytes(blob))
    return np.frombuffer(payload, dtype=np.uint8)


def _compress_frame(data: bytes) -> bytes:
    if native.available():
        return native.lz4_frame_compress(data)
    return lz4py.frame_compress_stored(data)


class LazerFile:
    """Block-wise reader for .lazer files."""

    extension = "lazer"

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        self.header = parse_las_header(self._mm[:512].tobytes())
        h = self.header
        off = h.offset_to_point_data
        (self.block_size,) = struct.unpack_from("<Q", self._mm, off)
        if self.block_size == 0:
            raise ValueError(f"{self.path}: zero LAZER block size")
        self.num_blocks = (h.point_count + self.block_size - 1) // self.block_size
        self.block_offsets = np.frombuffer(
            self._mm, dtype="<u8", count=self.num_blocks, offset=off + 8
        ).astype(np.int64)
        ends = np.empty(self.num_blocks, dtype=np.int64)
        ends[:-1] = self.block_offsets[1:]
        if self.num_blocks:
            ends[-1] = self._mm.size
        self.block_ends = ends
        self._attrs = attribute_layout(h.point_format)
        self._attr_index = {name: i for i, (name, _, _) in enumerate(self._attrs)}
        self.num_attributes = len(self._attrs)
        # Tiny decode cache: engine blocks don't align with LAZER blocks, so
        # a boundary LAZER block would otherwise be decoded twice. Readers
        # are called from the engine's feeder threads, so cache mutation is
        # lock-guarded; one shared pool serves multi-block column reads.
        import threading

        self._cache: dict[tuple[int, str], np.ndarray] = {}
        self._cache_order: list[tuple[int, str]] = []
        self._cache_lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()

    @property
    def point_count(self) -> int:
        return self.header.point_count

    @property
    def file_size(self) -> int:
        return int(self._mm.size)

    def points_in_block(self, block_idx: int) -> int:
        if block_idx < self.num_blocks - 1:
            return self.block_size
        return self.point_count - block_idx * self.block_size

    def _blob_table(self, block_idx: int) -> np.ndarray:
        start = int(self.block_offsets[block_idx])
        offs = np.frombuffer(
            self._mm, dtype="<u8", count=self.num_attributes, offset=start
        ).astype(np.int64)
        return offs

    def read_block(self, block_idx: int, attrs: tuple[str, ...]) -> dict[str, np.ndarray]:
        """Decode the requested attribute columns of one block (small LRU)."""
        n = self.points_in_block(block_idx)
        out: dict[str, np.ndarray] = {}
        missing = []
        with self._cache_lock:
            for name in attrs:
                cached = self._cache.get((block_idx, name))
                if cached is not None:
                    out[name] = cached
                else:
                    missing.append(name)
        if not missing:
            return out
        offs = self._blob_table(block_idx)
        block_end = int(self.block_ends[block_idx])
        for name in missing:
            idx = self._attr_index[name]
            dtype, comps = self._attrs[idx][1], self._attrs[idx][2]
            blob_start = int(offs[idx])
            blob_end = int(offs[idx + 1]) if idx + 1 < self.num_attributes else block_end
            expect = n * comps * dtype.itemsize
            raw = _decompress_frame(self._mm[blob_start:blob_end], expect)
            if raw.nbytes != expect:
                raise ValueError(
                    f"{self.path} block {block_idx} attr {name}: "
                    f"decoded {raw.nbytes} bytes, expected {expect}"
                )
            arr = raw.view(dtype)
            if comps > 1:
                arr = arr.reshape(n, comps)
            out[name] = arr
            key = (block_idx, name)
            with self._cache_lock:
                if key not in self._cache:
                    self._cache[key] = arr
                    self._cache_order.append(key)
                    while len(self._cache_order) > 8:
                        self._cache.pop(self._cache_order.pop(0), None)
        return out

    def take(self, indices: np.ndarray, attrs: tuple[str, ...]) -> dict[str, np.ndarray]:
        """Gather hit rows: decodes only the LAZER blocks that contain hits,
        only for the requested attributes (compressed-format analog of the
        reference's hit-only reads)."""
        indices = np.asarray(indices, dtype=np.int64)
        if "color" in attrs and "color" not in self._attr_index:
            attrs = tuple(a for a in attrs if a != "color")
            zero_color = True
        else:
            zero_color = False
        parts: dict[str, list[np.ndarray]] = {a: [] for a in attrs}
        order = np.argsort(indices, kind="stable")
        sorted_idx = indices[order]
        blocks = sorted_idx // self.block_size
        result_chunks: dict[str, np.ndarray] = {}
        for b in np.unique(blocks):
            sel = blocks == b
            local = (sorted_idx[sel] - b * self.block_size).astype(np.int64)
            cols = self.read_block(int(b), attrs)
            for a in attrs:
                parts[a].append(cols[a][local])
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        for a in attrs:
            cat = (
                np.concatenate(parts[a], axis=0)
                if parts[a]
                else np.empty((0,), dtype=np.uint8)
            )
            result_chunks[a] = cat[inv]
        if zero_color:
            result_chunks["color"] = np.zeros((len(indices), 3), dtype=np.uint16)
        return result_chunks

    def column(self, name: str, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Materialize an attribute column; covering blocks decode in
        PARALLEL across host threads (the C LZ4 calls release the GIL) —
        the reference decodes LAZER strictly serially (lazer.rs:59-75)."""
        stop = self.point_count if stop is None else stop
        if name == "color" and "color" not in self._attr_index:
            return np.zeros((stop - start, 3), dtype=np.uint16)
        if stop <= start:
            shape = (0, 3) if name in ("position", "color") else (0,)
            dtype = self._attrs[self._attr_index[name]][1]
            return np.empty(shape, dtype=dtype)
        first = start // self.block_size
        last = (stop - 1) // self.block_size

        def piece(b: int) -> np.ndarray:
            col = self.read_block(b, (name,))[name]
            b0 = b * self.block_size
            lo = max(start - b0, 0)
            hi = min(stop - b0, self.points_in_block(b))
            return col[lo:hi]

        blocks = range(first, last + 1)
        if last - first >= 2 and native.available():
            with self._pool_lock:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(max_workers=8)
            parts = list(self._pool.map(piece, blocks))
        else:
            parts = [piece(b) for b in blocks]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def positions_world(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        raw = self.column("position", start, stop).astype(np.float64)
        return raw * np.asarray(self.header.scale) + np.asarray(self.header.offset)

    def close(self):
        self._mm = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self._cache.clear()


def write_lazer(
    path: str | Path,
    header: LasHeader,
    columns: dict[str, np.ndarray],
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    compress_workers: int = 0,
) -> None:
    """Write a .lazer file from SoA columns. Missing attributes zero-fill."""
    n = header.point_count
    attrs = attribute_layout(header.point_format)
    num_blocks = (n + block_size - 1) // block_size

    def col_for(name: str, dtype: np.dtype, comps: int) -> np.ndarray:
        col = columns.get(name)
        if col is None:
            shape = (n, comps) if comps > 1 else (n,)
            return np.zeros(shape, dtype=dtype)
        col = np.asarray(col, dtype=dtype)
        return col.reshape(n, comps) if comps > 1 else col.reshape(n)

    mats = [(name, col_for(name, dtype, comps)) for name, dtype, comps in attrs]

    def encode_block(b: int) -> list[bytes]:
        lo, hi = b * block_size, min((b + 1) * block_size, n)
        return [_compress_frame(np.ascontiguousarray(col[lo:hi]).tobytes()) for _, col in mats]

    if compress_workers > 1 and num_blocks > 1:
        with ThreadPoolExecutor(max_workers=compress_workers) as pool:
            all_blobs = list(pool.map(encode_block, range(num_blocks)))
    else:
        all_blobs = [encode_block(b) for b in range(num_blocks)]

    with open(path, "wb") as f:
        hdr = write_las_header(header)
        pad = header.offset_to_point_data - len(hdr)
        f.write(hdr)
        if pad > 0:
            f.write(b"\x00" * pad)
        table_pos = header.offset_to_point_data
        f.write(struct.pack("<Q", block_size))
        block_offset_pos = table_pos + 8
        cursor = block_offset_pos + 8 * num_blocks
        block_offsets = []
        for blobs in all_blobs:
            block_offsets.append(cursor)
            cursor += 8 * len(blobs) + sum(len(x) for x in blobs)
        f.write(struct.pack(f"<{num_blocks}Q", *block_offsets) if num_blocks else b"")
        for b, blobs in enumerate(all_blobs):
            blob_cursor = block_offsets[b] + 8 * len(blobs)
            blob_offsets = []
            for x in blobs:
                blob_offsets.append(blob_cursor)
                blob_cursor += len(x)
            f.write(struct.pack(f"<{len(blobs)}Q", *blob_offsets))
            for x in blobs:
                f.write(x)


def las_to_lazer(
    las_path: str | Path,
    lazer_path: str | Path,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    compress_workers: int = 8,
) -> None:
    """Convert uncompressed .las to .lazer (built-in format converter)."""
    from .las import LasFile

    src = LasFile(las_path)
    names = [name for name, _, comps in attribute_layout(src.header.point_format) if comps]
    cols = {name: src.column(name) for name in names}
    write_lazer(
        lazer_path, src.header, cols, block_size=block_size, compress_workers=compress_workers
    )
    src.close()
