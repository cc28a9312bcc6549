"""LAZ (LASzip-compressed LAS) codec: point formats 0-5 (v2) and 6-10 (v3).

The reference engine gets LAZ decode from laz-rs inside pasture and notes
that no byte-level query shortcut exists on LAZ — every query fully
decompresses (query/src/search/laz.rs:27-31). Here decode is our own native
LASzip implementation (native/laszip.cpp): chunked container, adaptive
arithmetic coder, POINT10/GPSTIME11/RGB12/BYTE v2 items for formats 0-3 and
the layered POINT14/RGB14/RGBNIR14/BYTE14 v3 items for LAS 1.4 formats 6-8
— and chunks decode IN PARALLEL across host threads straight into SoA
columns, which the reference's serial record-wise path cannot do.

Container layout (open LAZ specification):
  - LAS header with bit 7 of the point format byte set
  - a "laszip encoded" VLR (record id 22204) describing compressor/items
  - at offset_to_point_data: i64 absolute chunk-table offset, then chunks;
    a table offset of -1 means the writer streamed and the real offset is
    in the LAST 8 bytes of the file (recovered here)
  - chunk table: u32 version, u32 count, arithmetic-coded chunk byte sizes;
    variable-size chunking (chunk_size == u32::MAX in the VLR) stores
    (point count, byte size) pairs per chunk

Interop: self-roundtrip is exact (tested); third-party LAZ decoding is
spec-faithful best effort until validated against external files (no
independent LAZ encoder exists in this environment). Wave packets (formats
4/5/9/10) use a spec-shaped self-consistent item codec (INTEROP RISK noted
in native/laszip.cpp).
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

from .. import native
from .las import (
    LasHeader, has_color, has_gps_time, has_nir, has_waveform,
    parse_las_header, write_las_header,
)

LASZIP_USER_ID = b"laszip encoded\x00\x00"
LASZIP_RECORD_ID = 22204
DEFAULT_CHUNK_SIZE = 50_000
VARIABLE_CHUNK_SIZE = 0xFFFFFFFF

# VLR description written by this codec — used to tell our own files apart
# from foreign (third-party-encoded) LAZ, whose decode is spec-faithful best
# effort but externally unvalidated (docs/LASZIP_INTEROP.md).
AQPC_VLR_DESCRIPTION = b"aqpc-tpu laszip"


class LazInteropWarning(UserWarning):
    """Raised once per process per situation when a LAZ file crosses the
    self-written boundary: reading a foreign file, or writing a file whose
    items include documented-uncertain codec paths. Decode/encode proceeds —
    the point is to fail LOUDLY instead of silently producing valid-looking
    garbage if one of the uncertain constants differs from upstream LASzip."""


_warned_keys: set = set()


def _warn_interop_once(key: str, msg: str) -> None:
    import warnings

    if key in _warned_keys:
        return
    _warned_keys.add(key)
    warnings.warn(msg, LazInteropWarning, stacklevel=3)


def _uncertain_items(is14: bool, has_wave: bool) -> list[str]:
    """Codec paths whose constants are documented-uncertain vs upstream
    LASzip (docs/LASZIP_INTEROP.md) — named in interop warnings."""
    out = []
    if is14:
        out.append(
            "v3 layered items (16x16 number-return context tables, layer "
            "context formulas, per-context RGB14/NIR model copies)"
        )
    if has_wave:
        out.append("wave-packet items (self-consistent Wave29 scheme)")
    return out

ITEM_BYTE = 0
ITEM_POINT10 = 6
ITEM_GPSTIME11 = 7
ITEM_RGB12 = 8
ITEM_WAVEPACKET13 = 9
ITEM_POINT14 = 10
ITEM_RGB14 = 11
ITEM_RGBNIR14 = 12
ITEM_WAVEPACKET14 = 13
ITEM_BYTE14 = 14

_STANDARD_RECORD_LENGTH = {0: 20, 1: 28, 2: 26, 3: 34, 4: 57, 5: 63,
                           6: 30, 7: 36, 8: 38, 9: 59, 10: 67}


def _default_threads() -> int:
    return min(os.cpu_count() or 1, 16)


class LazFile:
    """Chunk-parallel reader for .laz files (point formats 0-3 and 6-8)."""

    extension = "laz"

    def __init__(self, path: str | Path, *, threads: int | None = None):
        if not native.available():
            raise RuntimeError("LAZ support requires the native codec (g++ build failed?)")
        self.path = Path(path)
        self._threads = threads or _default_threads()
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        self.header = parse_las_header(self._mm[:512].tobytes())
        h = self.header
        if h.point_format not in _STANDARD_RECORD_LENGTH:
            raise NotImplementedError(
                f"LAZ point format {h.point_format} not supported"
            )
        self.is14 = h.point_format >= 6
        self._parse_vlrs()
        self._parse_chunk_table()
        self._cache: dict[int, dict[str, np.ndarray]] = {}
        self._cache_order: list[int] = []
        import threading

        self._cache_lock = threading.Lock()

    # -- container parsing ---------------------------------------------------

    def _parse_vlrs(self):
        h = self.header
        pos = h.header_size
        payload = None
        buf = self._mm
        for _ in range(h.num_vlrs):
            if pos + 54 > h.offset_to_point_data:
                break
            user_id = bytes(buf[pos + 2 : pos + 18])
            (record_id,) = struct.unpack_from("<H", buf, pos + 18)
            (rec_len,) = struct.unpack_from("<H", buf, pos + 20)
            body = pos + 54
            if user_id == LASZIP_USER_ID and record_id == LASZIP_RECORD_ID:
                payload = bytes(buf[body : body + rec_len])
                self.vlr_description = bytes(buf[pos + 22 : pos + 54]).rstrip(b"\x00")
            pos = body + rec_len
        if payload is None:
            raise ValueError(f"{self.path}: no laszip VLR found — not a LAZ file?")
        (compressor, coder, vmaj, vmin, vrev, options, chunk_size) = struct.unpack_from(
            "<HHBBHII", payload, 0
        )
        (num_items,) = struct.unpack_from("<H", payload, 32)
        items = [struct.unpack_from("<HHH", payload, 34 + 6 * i) for i in range(num_items)]
        want_compressor = 3 if self.is14 else 2
        if compressor != want_compressor:
            raise NotImplementedError(
                f"LAZ compressor {compressor} unsupported for point format "
                f"{self.header.point_format} (expected {want_compressor})"
            )
        if coder != 0:
            raise NotImplementedError(f"LAZ coder {coder} not supported")
        self.variable_chunks = chunk_size == VARIABLE_CHUNK_SIZE
        self.chunk_size = (
            DEFAULT_CHUNK_SIZE if chunk_size in (0, VARIABLE_CHUNK_SIZE) else chunk_size
        )
        self.has_gps = False
        self.has_rgb = False
        self.has_nir_ch = False
        self.has_wave = False
        self.extra_size = 0
        for t, size, version in items:
            if self.is14:
                if version != 3:
                    raise NotImplementedError(
                        f"LAZ item type {t} version {version} (need v3 for formats 6-10)"
                    )
                if t == ITEM_POINT14:
                    self.has_gps = True  # gps_time is part of POINT14
                elif t == ITEM_RGB14:
                    self.has_rgb = True
                elif t == ITEM_RGBNIR14:
                    self.has_rgb = True
                    self.has_nir_ch = True
                elif t == ITEM_BYTE14:
                    self.extra_size = size
                elif t == ITEM_WAVEPACKET14:
                    self.has_wave = True
                else:
                    raise NotImplementedError(f"LAZ item type {t} not supported")
            else:
                if version != 2 and t not in (ITEM_BYTE, ITEM_WAVEPACKET13):
                    raise NotImplementedError(f"LAZ item type {t} version {version} (need v2)")
                if t == ITEM_POINT10:
                    pass
                elif t == ITEM_GPSTIME11:
                    self.has_gps = True
                elif t == ITEM_RGB12:
                    self.has_rgb = True
                elif t == ITEM_WAVEPACKET13:
                    self.has_wave = True
                elif t == ITEM_BYTE:
                    if version != 2:
                        raise NotImplementedError("LAZ BYTE item version != 2")
                    self.extra_size = size
                else:
                    raise NotImplementedError(f"LAZ item type {t} not supported")
        self.is_foreign = (
            getattr(self, "vlr_description", b"") != AQPC_VLR_DESCRIPTION
        )
        if self.is_foreign:
            risky = _uncertain_items(self.is14, self.has_wave)
            what = (
                "; uncertain codec paths in play: " + "; ".join(risky)
                if risky
                else " (v2 core items: spec-faithful, externally unvalidated)"
            )
            _warn_interop_once(
                f"read:{self.is14}:{self.has_wave}",
                f"{self.path}: LAZ file was not written by this codec "
                f"(VLR description {getattr(self, 'vlr_description', b'')!r}); "
                f"third-party LASzip interop is unvalidated in this build — a "
                f"mis-decode would be silent{what}. See docs/LASZIP_INTEROP.md; "
                f"drop externally-encoded fixtures into tests/fixtures/laz/ to "
                f"activate the conformance harness.",
            )

    def _parse_chunk_table(self):
        h = self.header
        lib = native.load()
        (table_off,) = struct.unpack_from("<q", self._mm, h.offset_to_point_data)
        if table_off == -1:
            # streaming writer: the real table offset is in the file's last
            # 8 bytes (LASzip recovery convention)
            (table_off,) = struct.unpack_from("<q", self._mm, self._mm.size - 8)
        if not (h.offset_to_point_data + 8 <= table_off <= self._mm.size):
            raise ValueError(f"{self.path}: chunk table offset {table_off} out of range")
        n = h.point_count
        table = np.ascontiguousarray(self._mm[table_off:])
        first = h.offset_to_point_data + 8
        if self.variable_chunks:
            if n:
                (num,) = struct.unpack_from("<I", table, 4)
                counts = np.zeros(max(num, 1), np.int64)
                sizes = np.zeros(max(num, 1), np.uint64)
                got = lib.aqpc_laz_read_chunk_table_var(
                    table.ctypes.data, table.nbytes,
                    counts.ctypes.data, sizes.ctypes.data, num,
                )
                if got != num:
                    raise ValueError(f"{self.path}: variable chunk table decode failed")
                if int(counts.sum()) != n:
                    raise ValueError(
                        f"{self.path}: chunk point counts sum {int(counts.sum())} != "
                        f"header count {n}"
                    )
                self.num_chunks = int(num)
                self.chunk_counts = counts[: self.num_chunks]
                self.chunk_byte_sizes = sizes[: self.num_chunks]
            else:
                self.num_chunks = 0
                self.chunk_counts = np.zeros(0, np.int64)
                self.chunk_byte_sizes = np.zeros(0, np.uint64)
        else:
            self.num_chunks = (n + self.chunk_size - 1) // self.chunk_size if n else 0
            sizes = np.zeros(max(self.num_chunks, 1), np.uint64)
            if self.num_chunks:
                got = lib.aqpc_laz_read_chunk_table(
                    table.ctypes.data, table.nbytes, sizes.ctypes.data, self.num_chunks
                )
                if got != self.num_chunks:
                    raise ValueError(
                        f"{self.path}: chunk table decode failed ({got} != {self.num_chunks})"
                    )
            counts = np.full(max(self.num_chunks, 1), self.chunk_size, np.int64)
            if self.num_chunks:
                counts[self.num_chunks - 1] = n - (self.num_chunks - 1) * self.chunk_size
            self.chunk_counts = counts[: self.num_chunks]
            self.chunk_byte_sizes = sizes[: self.num_chunks]
        # absolute file offsets and point-ordinal starts per chunk
        offsets = np.zeros(self.num_chunks + 1, np.uint64)
        offsets[0] = first
        np.cumsum(self.chunk_byte_sizes, out=offsets[1:])
        offsets[1:] += first
        self.chunk_offsets = offsets[: self.num_chunks]
        starts = np.zeros(self.num_chunks + 1, np.int64)
        np.cumsum(self.chunk_counts, out=starts[1:])
        self.chunk_starts = starts  # len num_chunks + 1

    # -- columnar access -----------------------------------------------------

    @property
    def point_count(self) -> int:
        return self.header.point_count

    @property
    def file_size(self) -> int:
        return int(self._mm.size)

    def points_in_chunk(self, i: int) -> int:
        return int(self.chunk_starts[i + 1] - self.chunk_starts[i])

    def _chunk_of(self, point_ordinal: int) -> int:
        return int(np.searchsorted(self.chunk_starts, point_ordinal, "right") - 1)

    def _decode_chunks(self, first: int, count: int) -> dict[str, np.ndarray]:
        """Decode chunks [first, first+count) into SoA columns (parallel)."""
        lib = native.load()
        n_pts = int(self.chunk_starts[first + count] - self.chunk_starts[first])
        out_offsets = np.ascontiguousarray(
            self.chunk_starts[first : first + count] - self.chunk_starts[first]
        )
        counts = np.ascontiguousarray(self.chunk_counts[first : first + count])
        offs = np.ascontiguousarray(self.chunk_offsets[first : first + count])
        szs = np.ascontiguousarray(self.chunk_byte_sizes[first : first + count])
        alloc = max(n_pts, 1)
        if self.is14:
            cols = {
                "x": np.empty(alloc, np.int32),
                "y": np.empty(alloc, np.int32),
                "z": np.empty(alloc, np.int32),
                "intensity": np.zeros(alloc, np.uint16),
                "_returns": np.zeros(alloc, np.uint8),
                "_flags15": np.zeros(alloc, np.uint8),
                "classification": np.zeros(alloc, np.uint8),
                "user_data": np.zeros(alloc, np.uint8),
                "scan_angle": np.zeros(alloc, np.int16),
                "point_source": np.zeros(alloc, np.uint16),
                "gps_time": np.zeros(alloc, np.float64),
            }
            rgb = np.zeros((alloc, 3), np.uint16) if self.has_rgb else np.zeros((1, 3), np.uint16)
            nir = np.zeros(alloc, np.uint16) if self.has_nir_ch else np.zeros(1, np.uint16)
            wave = (
                np.zeros((alloc, 29), np.uint8) if self.has_wave
                else np.zeros((1, 29), np.uint8)
            )
            extra = (
                np.zeros((alloc, self.extra_size), np.uint8)
                if self.extra_size
                else np.zeros((1, 1), np.uint8)
            )
            rc = lib.aqpc_laz14_decode_chunks(
                self._mm.ctypes.data, self._mm.size,
                offs.ctypes.data, szs.ctypes.data, counts.ctypes.data,
                out_offsets.ctypes.data, count,
                cols["x"].ctypes.data, cols["y"].ctypes.data, cols["z"].ctypes.data,
                cols["intensity"].ctypes.data, cols["_returns"].ctypes.data,
                cols["_flags15"].ctypes.data, cols["classification"].ctypes.data,
                cols["user_data"].ctypes.data, cols["scan_angle"].ctypes.data,
                cols["point_source"].ctypes.data, cols["gps_time"].ctypes.data,
                rgb.ctypes.data, nir.ctypes.data, wave.ctypes.data,
                extra.ctypes.data,
                self.extra_size, int(self.has_rgb), int(self.has_nir_ch),
                int(self.has_wave), self._threads,
            )
            if rc != 0:
                raise ValueError(f"{self.path}: LAZ chunk {first + rc - 1} failed to decode")
            # extended "flags" field = record bytes 14|15<<8 (LastFile layout)
            cols["flags"] = (
                cols.pop("_returns").astype(np.uint16)
                | (cols.pop("_flags15").astype(np.uint16) << 8)
            )
            if self.has_rgb:
                cols["color"] = rgb
            if self.has_nir_ch:
                cols["nir"] = nir
            if self.has_wave:
                cols["waveform"] = wave
            if self.extra_size:
                cols["extra"] = extra
        else:
            cols = {
                "x": np.empty(alloc, np.int32),
                "y": np.empty(alloc, np.int32),
                "z": np.empty(alloc, np.int32),
                "intensity": np.zeros(alloc, np.uint16),
                "flags": np.zeros(alloc, np.uint8),
                "classification": np.zeros(alloc, np.uint8),
                "scan_angle": np.zeros(alloc, np.int8),
                "user_data": np.zeros(alloc, np.uint8),
                "point_source": np.zeros(alloc, np.uint16),
            }
            gps = np.zeros(alloc, np.float64) if self.has_gps else np.zeros(1, np.float64)
            rgb = np.zeros((alloc, 3), np.uint16) if self.has_rgb else np.zeros((1, 3), np.uint16)
            wave = (
                np.zeros((alloc, 29), np.uint8) if self.has_wave
                else np.zeros((1, 29), np.uint8)
            )
            extra = (
                np.zeros((alloc, self.extra_size), np.uint8)
                if self.extra_size
                else np.zeros((1, 1), np.uint8)
            )
            rc = lib.aqpc_laz_decode_chunks(
                self._mm.ctypes.data, self._mm.size,
                offs.ctypes.data, szs.ctypes.data, counts.ctypes.data,
                out_offsets.ctypes.data, count,
                cols["x"].ctypes.data, cols["y"].ctypes.data, cols["z"].ctypes.data,
                cols["intensity"].ctypes.data, cols["flags"].ctypes.data,
                cols["classification"].ctypes.data, cols["scan_angle"].ctypes.data,
                cols["user_data"].ctypes.data, cols["point_source"].ctypes.data,
                gps.ctypes.data, rgb.ctypes.data, wave.ctypes.data,
                extra.ctypes.data,
                self.extra_size, int(self.has_gps), int(self.has_rgb),
                int(self.has_wave), self._threads,
            )
            if rc != 0:
                raise ValueError(f"{self.path}: LAZ chunk {first + rc - 1} failed to decode")
            if self.has_gps:
                cols["gps_time"] = gps
            if self.has_rgb:
                cols["color"] = rgb
            if self.has_wave:
                cols["waveform"] = wave
            if self.extra_size:
                cols["extra"] = extra
        return cols

    def read_chunk(self, i: int) -> dict[str, np.ndarray]:
        # Lock guards the cache structures only (the engine's feeder calls
        # readers from multiple threads); decode itself runs unlocked.
        with self._cache_lock:
            cached = self._cache.get(i)
        if cached is not None:
            return cached
        cols = self._decode_chunks(i, 1)
        with self._cache_lock:
            if i not in self._cache:
                self._cache[i] = cols
                self._cache_order.append(i)
                while len(self._cache_order) > 32:
                    self._cache.pop(self._cache_order.pop(0), None)
        return cols

    def column(self, name: str, start: int = 0, stop: int | None = None) -> np.ndarray:
        stop = self.point_count if stop is None else stop
        if name == "color" and not self.has_rgb:
            return np.zeros((stop - start, 3), dtype=np.uint16)
        if stop <= start:
            shape = (0, 3) if name in ("position", "color") else (0,)
            return np.empty(shape, dtype=np.int32)
        first = self._chunk_of(start)
        last = self._chunk_of(stop - 1)
        if last > first:
            # one native call decodes the whole chunk run with its internal
            # thread pool (chunks are independent coder streams)
            cols = self._decode_chunks(first, last - first + 1)
        else:
            cols = self.read_chunk(first)
        if name == "position":
            col = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        else:
            col = cols[name]
        b0 = int(self.chunk_starts[first])
        return col[start - b0 : stop - b0]

    def positions_world(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        raw = self.column("position", start, stop).astype(np.float64)
        return raw * np.asarray(self.header.scale) + np.asarray(self.header.offset)

    def take(self, indices: np.ndarray, attrs: tuple[str, ...]) -> dict[str, np.ndarray]:
        """Gather hit rows, decoding only the chunks that contain hits."""
        indices = np.asarray(indices, dtype=np.int64)
        order = np.argsort(indices, kind="stable")
        sorted_idx = indices[order]
        chunks = np.searchsorted(self.chunk_starts, sorted_idx, "right") - 1
        parts: dict[str, list[np.ndarray]] = {a: [] for a in attrs}
        for c in np.unique(chunks):
            sel = chunks == c
            local = (sorted_idx[sel] - int(self.chunk_starts[c])).astype(np.int64)
            cols = self.read_chunk(int(c))
            for a in attrs:
                if a == "position":
                    parts[a].append(
                        np.stack(
                            [cols["x"][local], cols["y"][local], cols["z"][local]], axis=1
                        )
                    )
                elif a == "color" and not self.has_rgb:
                    parts[a].append(np.zeros((len(local), 3), np.uint16))
                else:
                    parts[a].append(cols[a][local])
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        out = {}
        for a in attrs:
            if parts[a]:
                out[a] = np.concatenate(parts[a], axis=0)[inv]
            else:
                shape = (0, 3) if a in ("position", "color") else (0,)
                out[a] = np.empty(shape, np.int32)
        return out

    def close(self):
        self._mm = None
        self._cache.clear()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _laszip_vlr(point_format: int, chunk_size: int, extra_size: int) -> bytes:
    if point_format >= 6:
        compressor = 3
        items = [(ITEM_POINT14, 30, 3)]
        if has_nir(point_format):
            items.append((ITEM_RGBNIR14, 8, 3))
        elif has_color(point_format):
            items.append((ITEM_RGB14, 6, 3))
        if has_waveform(point_format):
            items.append((ITEM_WAVEPACKET14, 29, 3))
        if extra_size:
            items.append((ITEM_BYTE14, extra_size, 3))
    else:
        compressor = 2
        items = [(ITEM_POINT10, 20, 2)]
        if has_gps_time(point_format):
            items.append((ITEM_GPSTIME11, 8, 2))
        if has_color(point_format):
            items.append((ITEM_RGB12, 6, 2))
        if has_waveform(point_format):
            items.append((ITEM_WAVEPACKET13, 29, 1))
        if extra_size:
            items.append((ITEM_BYTE, extra_size, 2))
    payload = struct.pack(
        "<HHBBHIIqqH", compressor, 0, 3, 4, 0, 0, chunk_size, -1, -1, len(items)
    )
    for t, size, version in items:
        payload += struct.pack("<HHH", t, size, version)
    vlr = struct.pack("<H", 0) + LASZIP_USER_ID + struct.pack(
        "<HH", LASZIP_RECORD_ID, len(payload)
    )
    vlr += b"aqpc-tpu laszip".ljust(32, b"\x00")
    return vlr + payload


def write_laz(
    path: str | Path,
    header: LasHeader,
    columns: dict[str, np.ndarray],
    *,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    threads: int | None = None,
    variable_chunk_counts: list[int] | None = None,
    defer_chunk_table: bool = False,
    strict_interop: bool = False,
) -> None:
    """Write a .laz file (formats 0-3 as v2, 6-8 as v3) from SoA columns.

    variable_chunk_counts: write a variable-size-chunk container (VLR
    chunk_size = u32::MAX, (count, size) pairs in the table) with the given
    per-chunk point counts. defer_chunk_table: write -1 as the chunk-table
    offset and append the real offset in the file's last 8 bytes (the
    streaming-writer layout this reader recovers from).

    strict_interop: refuse (ValueError) any feature outside the
    maximally-conservative subset believed byte-interoperable with upstream
    LASzip — point formats 0-3 (v2 items POINT10/GPSTIME11/RGB12/BYTE
    only), fixed-size chunks, chunk table at its canonical position. Every
    constant group exercised by this subset is in docs/LASZIP_INTEROP.md's
    "Certain" list; none of the UNCERTAIN groups can appear in the output.
    Use for files destined for external consumers and for generating
    external-validation fixtures (recipe in docs/LASZIP_INTEROP.md)."""
    if not native.available():
        raise RuntimeError("LAZ support requires the native codec")
    if header.point_format not in _STANDARD_RECORD_LENGTH:
        raise NotImplementedError("LAZ write supports point formats 0-10")
    if strict_interop:
        problems = []
        if header.point_format > 3:
            problems.append(
                f"point format {header.point_format} (strict subset is 0-3: "
                "v3 layered / waveform items carry uncertain constants)"
            )
        if variable_chunk_counts is not None:
            problems.append("variable-size chunking")
        if defer_chunk_table:
            problems.append("deferred chunk table")
        if problems:
            raise ValueError(
                "strict_interop refuses: " + "; ".join(problems)
                + ". See docs/LASZIP_INTEROP.md."
            )
    risky = _uncertain_items(
        header.point_format >= 6, has_waveform(header.point_format)
    )
    if risky:
        _warn_interop_once(
            f"write:{header.point_format >= 6}:{has_waveform(header.point_format)}",
            f"writing LAZ point format {header.point_format}: the laszip VLR "
            f"claims standard LASzip, but these items are only guaranteed "
            f"self-consistent (this codec round-trips them exactly; upstream "
            f"readers may mis-decode): {'; '.join(risky)}. Files are tagged "
            f"via VLR description {AQPC_VLR_DESCRIPTION!r}; prefer formats "
            f"0-3 for external consumers. See docs/LASZIP_INTEROP.md.",
        )
    lib = native.load()
    n = header.point_count
    threads = threads or _default_threads()
    is14 = header.point_format >= 6
    extra_size = max(
        header.point_record_length - _STANDARD_RECORD_LENGTH[header.point_format], 0
    )

    pos = np.ascontiguousarray(np.asarray(columns["position"], np.int32)).reshape(n, 3)
    x = np.ascontiguousarray(pos[:, 0])
    y = np.ascontiguousarray(pos[:, 1])
    z = np.ascontiguousarray(pos[:, 2])

    def col(name, dtype, shape=None):
        v = columns.get(name)
        if v is None:
            return np.zeros(shape or n, dtype)
        return np.ascontiguousarray(np.asarray(v, dtype).reshape(shape or n))

    intensity = col("intensity", np.uint16)
    classification = col("classification", np.uint8)
    user_data = col("user_data", np.uint8)
    point_source = col("point_source", np.uint16)
    hr = has_color(header.point_format)
    rgb = col("color", np.uint16, (n, 3)) if hr else np.zeros((1, 3), np.uint16)
    extra = (
        col("extra", np.uint8, (n, extra_size))
        if extra_size
        else np.zeros((1, 1), np.uint8)
    )

    if variable_chunk_counts is not None:
        chunk_counts = np.asarray(variable_chunk_counts, np.int64)
        if int(chunk_counts.sum()) != n or (chunk_counts <= 0).any():
            raise ValueError("variable_chunk_counts must be positive and sum to n")
    else:
        num = (n + chunk_size - 1) // chunk_size
        chunk_counts = np.full(max(num, 1), chunk_size, np.int64)
        if num:
            chunk_counts[num - 1] = n - (num - 1) * chunk_size
        chunk_counts = chunk_counts[:num]
    num_chunks = len(chunk_counts)

    # All operand arrays must be NAMED (kept alive) through the native
    # calls: passing a temporary's .ctypes.data hands the C code a pointer
    # to freed memory.
    hw = has_waveform(header.point_format)
    wave_all = col("waveform", np.uint8, (n, 29)) if hw else np.zeros((1, 29), np.uint8)
    if is14:
        flags16 = col("flags", np.uint16)
        rb_all = np.ascontiguousarray((flags16 & 0xFF).astype(np.uint8))
        fb_all = np.ascontiguousarray((flags16 >> 8).astype(np.uint8))
        ang_all = np.ascontiguousarray(col("scan_angle", np.int16))
        gps_all = np.ascontiguousarray(col("gps_time", np.float64))
        hn = has_nir(header.point_format)
        nir_all = col("nir", np.uint16) if hn else np.zeros(1, np.uint16)
    else:
        flags8_all = col("flags", np.uint8)
        ang8_all = col("scan_angle", np.int8)
        hg = has_gps_time(header.point_format)
        gps_all = col("gps_time", np.float64) if hg else np.zeros(1, np.float64)

    def encode_range(start: int, count: int, out: np.ndarray, sizes_out: np.ndarray):
        """Encode points [start, start+count) as one chunk of `count` points."""
        sl = slice(start, start + count)

        def c_(a, whole=False):
            arr = np.ascontiguousarray(a if whole else a[sl])
            keep.append(arr)  # keep alive until the native call returns
            return arr.ctypes.data

        keep: list[np.ndarray] = []
        if is14:
            total = lib.aqpc_laz14_encode_chunks(
                c_(x), c_(y), c_(z), c_(intensity), c_(rb_all), c_(fb_all),
                c_(classification), c_(user_data), c_(ang_all),
                c_(point_source), c_(gps_all),
                c_(rgb) if hr else c_(rgb, whole=True),
                c_(nir_all) if hn else c_(nir_all, whole=True),
                c_(wave_all) if hw else c_(wave_all, whole=True),
                c_(extra) if extra_size else c_(extra, whole=True),
                extra_size, int(hr), int(hn), int(hw), count, count,
                out.ctypes.data, out.nbytes, sizes_out.ctypes.data, threads,
            )
        else:
            total = lib.aqpc_laz_encode_chunks(
                c_(x), c_(y), c_(z), c_(intensity), c_(flags8_all),
                c_(classification), c_(ang8_all), c_(user_data),
                c_(point_source),
                c_(gps_all) if hg else c_(gps_all, whole=True),
                c_(rgb) if hr else c_(rgb, whole=True),
                c_(wave_all) if hw else c_(wave_all, whole=True),
                c_(extra) if extra_size else c_(extra, whole=True),
                extra_size, int(hg), int(hr), int(hw), count, count,
                out.ctypes.data, out.nbytes, sizes_out.ctypes.data, threads,
            )
        del keep
        if total < 0:
            raise RuntimeError("LAZ encode overflow")
        return int(total)

    raw_pt = header.point_record_length + 8
    if variable_chunk_counts is not None:
        # encode chunk by chunk (arbitrary sizes)
        blobs = []
        sizes = np.zeros(num_chunks, np.uint64)
        start = 0
        for i, cnt in enumerate(chunk_counts):
            out = np.empty(int(cnt) * raw_pt + 65536, np.uint8)
            s1 = np.zeros(1, np.uint64)
            total = encode_range(start, int(cnt), out, s1)
            blobs.append(out[:total].tobytes())
            sizes[i] = total
            start += int(cnt)
        payload = b"".join(blobs)
        total = len(payload)
    else:
        cap = n * raw_pt + num_chunks * 1024 + 65536
        out = np.empty(cap, np.uint8)
        sizes = np.zeros(max(num_chunks, 1), np.uint64)
        if is14:
            total = lib.aqpc_laz14_encode_chunks(
                x.ctypes.data, y.ctypes.data, z.ctypes.data,
                intensity.ctypes.data, rb_all.ctypes.data, fb_all.ctypes.data,
                classification.ctypes.data, user_data.ctypes.data,
                ang_all.ctypes.data, point_source.ctypes.data,
                gps_all.ctypes.data, rgb.ctypes.data, nir_all.ctypes.data,
                wave_all.ctypes.data, extra.ctypes.data,
                extra_size, int(hr), int(hn), int(hw), n, chunk_size,
                out.ctypes.data, cap, sizes.ctypes.data, threads,
            )
        else:
            total = lib.aqpc_laz_encode_chunks(
                x.ctypes.data, y.ctypes.data, z.ctypes.data,
                intensity.ctypes.data, flags8_all.ctypes.data,
                classification.ctypes.data, ang8_all.ctypes.data,
                user_data.ctypes.data, point_source.ctypes.data,
                gps_all.ctypes.data, rgb.ctypes.data, wave_all.ctypes.data,
                extra.ctypes.data,
                extra_size, int(hg), int(hr), int(hw), n, chunk_size,
                out.ctypes.data, cap, sizes.ctypes.data, threads,
            )
        if total < 0:
            raise RuntimeError("LAZ encode overflow")
        total = int(total)
        payload = out[:total].tobytes()

    table_cap = 16 + 16 * max(num_chunks, 1) + 1024
    table = np.empty(table_cap, np.uint8)
    if variable_chunk_counts is not None:
        table_len = lib.aqpc_laz_write_chunk_table_var(
            chunk_counts.ctypes.data, sizes.ctypes.data, num_chunks,
            table.ctypes.data, table_cap,
        )
    else:
        table_len = lib.aqpc_laz_write_chunk_table(
            sizes.ctypes.data, num_chunks, table.ctypes.data, table_cap
        )
    if table_len < 0:
        raise RuntimeError("LAZ chunk table encode overflow")

    vlr_chunk_size = VARIABLE_CHUNK_SIZE if variable_chunk_counts is not None else chunk_size
    vlr = _laszip_vlr(header.point_format, vlr_chunk_size, extra_size)
    import dataclasses

    hdr_size = 227 if header.version[1] <= 2 else (235 if header.version[1] == 3 else 375)
    offset_to_point_data = hdr_size + len(vlr)
    laz_header = dataclasses.replace(
        header,
        offset_to_point_data=offset_to_point_data,
        num_vlrs=1,
    )
    hdr = bytearray(write_las_header(laz_header))
    hdr[104] |= 0x80  # compression bit
    struct.pack_into("<I", hdr, 100, 1)  # number of VLRs

    chunk_table_offset = offset_to_point_data + 8 + total
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(vlr)
        f.write(struct.pack("<q", -1 if defer_chunk_table else chunk_table_offset))
        f.write(payload)
        f.write(table[:table_len].tobytes())
        if defer_chunk_table:
            f.write(struct.pack("<q", chunk_table_offset))


def las_to_laz(
    las_path: str | Path,
    laz_path: str | Path,
    *,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    strict_interop: bool = False,
) -> None:
    """Convert uncompressed .las (formats 0-3, 6-8) to .laz."""
    from .las import LasFile

    src = LasFile(las_path)
    h = src.header
    cols = {
        "position": src.column("position"),
        "intensity": src.column("intensity"),
        "flags": src.column("flags"),
        "classification": src.column("classification"),
        "scan_angle": src.column("scan_angle"),
        "user_data": src.column("user_data"),
        "point_source": src.column("point_source"),
    }
    if has_gps_time(h.point_format):
        cols["gps_time"] = src.column("gps_time")
    if has_color(h.point_format):
        cols["color"] = src.column("color")
    if has_nir(h.point_format):
        cols["nir"] = src.column("nir")
    if has_waveform(h.point_format):
        cols["waveform"] = src.column("waveform")
    if h.point_record_length > _STANDARD_RECORD_LENGTH[h.point_format]:
        cols["extra"] = src.column("extra")
    write_laz(laz_path, h, cols, chunk_size=chunk_size,
              strict_interop=strict_interop)
    src.close()
