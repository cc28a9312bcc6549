"""LAST ("LAS-Transposed") codec: columnar LAS, the TPU-friendliest format.

Container layout (reverse-engineered from readers/src/last_reader.rs:73-154):
a standard LAS header, then the point data transposed *by record field* — all
N x/y/z int32 triples first, then all N intensities, then all N flag bytes,
and so on in LAS record order. Hence the block for a field that lives at byte
offset F inside a single LAS record starts at

    offset_to_point_data + F * N

and the whole point-data section is exactly record_length * N bytes, same as
the LAS it was transposed from. The positions block is 12 B/point, the
classification block 1 B/point at F=15 (formats 0-5) or 16 (6-10), the color
block 6 B/point at F in {2:20, 3:28, 5:28, 7:30, 8:30, 10:30}
(last_reader.rs:90-144).

This is already the device SoA layout: reading a column is one contiguous
mmap slice + reinterpret, no de-interleave pass at all.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import las as las_mod
from .las import (
    COLOR_OFFSET,
    GPS_TIME_OFFSET,
    WAVE_BYTES,
    WAVE_OFFSET,
    LasHeader,
    has_nir,
    has_waveform,
    is_extended_format,
    parse_las_header,
    write_las_header,
)

# (field name, numpy dtype, byte offset inside a non-extended record)
_FIELDS_BASE = [("position", "<i4", 0), ("intensity", "<u2", 12)]


def field_layout(fmt: int) -> list[tuple[str, np.dtype, int, int]]:
    """(name, dtype, record_offset, components) per field, in record order."""
    ext = is_extended_format(fmt)
    fields: list[tuple[str, str, int, int]] = [
        ("position", "<i4", 0, 3),
        ("intensity", "<u2", 12, 1),
    ]
    if ext:
        fields += [
            ("flags", "<u2", 14, 1),
            ("classification", "u1", 16, 1),
            ("user_data", "u1", 17, 1),
            ("scan_angle", "<i2", 18, 1),
            ("point_source", "<u2", 20, 1),
        ]
    else:
        fields += [
            ("flags", "u1", 14, 1),
            ("classification", "u1", 15, 1),
            ("scan_angle", "i1", 16, 1),
            ("user_data", "u1", 17, 1),
            ("point_source", "<u2", 18, 1),
        ]
    if fmt in GPS_TIME_OFFSET:
        fields.append(("gps_time", "<f8", GPS_TIME_OFFSET[fmt], 1))
    if fmt in COLOR_OFFSET:
        fields.append(("color", "<u2", COLOR_OFFSET[fmt], 3))
    if has_nir(fmt):
        fields.append(("nir", "<u2", 36, 1))
    if has_waveform(fmt):
        # the 29-byte wave packet is one record field -> one contiguous
        # point-major block of n x 29 bytes (parse with las.parse_waveform)
        fields.append(("waveform", "u1", WAVE_OFFSET[fmt], WAVE_BYTES))
    return [(n, np.dtype(d), off, c) for n, d, off, c in fields]


class LastFile:
    """Zero-copy columnar view over a .last file."""

    extension = "last"

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        self.header = parse_las_header(self._mm[:512].tobytes())
        h = self.header
        end = h.offset_to_point_data + h.point_count * h.point_record_length
        if end > self._mm.size:
            raise ValueError(
                f"{self.path}: header claims {h.point_count} points "
                f"({end} bytes) but file has {self._mm.size}"
            )
        self._layout = {
            name: (dtype, off, comps)
            for name, dtype, off, comps in field_layout(self.header.point_format)
        }
        covered = sum(dt.itemsize * c for dt, _, c in self._layout.values())
        if h.point_record_length > covered:
            # trailing extra bytes: one transposed tail block (point-major)
            self._layout["extra"] = (
                np.dtype("u1"), covered, h.point_record_length - covered
            )

    @property
    def point_count(self) -> int:
        return self.header.point_count

    @property
    def file_size(self) -> int:
        return int(self._mm.size)

    def column(self, name: str, start: int = 0, stop: int | None = None) -> np.ndarray:
        n = self.point_count
        stop = n if stop is None else stop
        if name == "color" and "color" not in self._layout:
            return np.zeros((stop - start, 3), dtype=np.uint16)
        dtype, record_off, comps = self._layout[name]
        block_start = self.header.offset_to_point_data + record_off * n
        itemsize = dtype.itemsize * comps
        lo = block_start + start * itemsize
        hi = block_start + stop * itemsize
        arr = np.frombuffer(self._mm[lo:hi], dtype=dtype)
        if arr.size != (stop - start) * comps:
            raise ValueError(
                f"{self.path}: column {name!r} [{start}:{stop}] truncated "
                f"({arr.size} of {(stop - start) * comps} values)"
            )
        if comps > 1:
            arr = arr.reshape(-1, comps)
        return arr

    def positions_world(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        raw = self.column("position", start, stop).astype(np.float64)
        return raw * np.asarray(self.header.scale) + np.asarray(self.header.offset)

    def take(self, indices: np.ndarray, attrs: tuple[str, ...]) -> dict[str, np.ndarray]:
        """Random-access gather: fancy-index zero-copy column views — the
        columnar analog of last.rs:137-153 (random class/color byte reads)."""
        n = self.point_count
        out: dict[str, np.ndarray] = {}
        for name in attrs:
            if name == "color" and "color" not in self._layout:
                out[name] = np.zeros((len(indices), 3), dtype=np.uint16)
                continue
            dtype, record_off, comps = self._layout[name]
            block_start = self.header.offset_to_point_data + record_off * n
            view = np.frombuffer(
                self._mm, dtype=dtype, count=n * comps, offset=block_start
            )
            if comps > 1:
                view = view.reshape(n, comps)
            out[name] = view[indices]
        return out

    def close(self):
        self._mm = None


def las_to_last(las_path: str | Path, last_path: str | Path) -> None:
    """Transpose an uncompressed .las file into .last (format converter).

    The reference relies on the external igd-geo/pointcloud-format-conversions
    project for this step (README.md:29); here it is a built-in.
    """
    src = las_mod.LasFile(las_path)
    h = src.header
    n = h.point_count
    layout = field_layout(h.point_format)
    covered = sum(dt.itemsize * comps for _, dt, _, comps in layout)
    with open(last_path, "wb") as f:
        hdr = write_las_header(h)
        pad = h.offset_to_point_data - len(hdr)
        f.write(hdr)
        if pad > 0:
            f.write(b"\x00" * pad)
        for name, dtype, record_off, comps in layout:
            f.write(np.ascontiguousarray(src.column(name)).tobytes())
        # Record bytes not covered by named fields (extra-bytes payloads)
        # are one more record field -> one contiguous point-major tail block
        # (total size stays record_length * N; LastFile exposes it as the
        # "extra" column)
        if covered < h.point_record_length:
            raw = np.frombuffer(
                src._mm,
                dtype=np.uint8,
                count=n * h.point_record_length,
                offset=h.offset_to_point_data,
            ).reshape(n, h.point_record_length)
            f.write(np.ascontiguousarray(raw[:, covered:]).tobytes())
    src.close()


def write_last(
    path: str | Path,
    header: LasHeader,
    columns: dict[str, np.ndarray],
) -> None:
    """Write a .last file directly from SoA columns.

    `columns` must contain every field of `field_layout(header.point_format)`;
    missing ones are zero-filled.
    """
    n = header.point_count
    layout = field_layout(header.point_format)
    covered = sum(dt.itemsize * comps for _, dt, _, comps in layout)
    if header.point_record_length > covered:
        layout = layout + [
            ("extra", np.dtype("u1"), covered, header.point_record_length - covered)
        ]
        covered = header.point_record_length
    if covered != header.point_record_length:
        raise ValueError(
            f"point format {header.point_format}: fields cover {covered} bytes "
            f"but record length is {header.point_record_length}"
        )
    with open(path, "wb") as f:
        hdr = write_las_header(header)
        pad = header.offset_to_point_data - len(hdr)
        f.write(hdr)
        if pad > 0:
            f.write(b"\x00" * pad)
        for name, dtype, _off, comps in layout:
            col = columns.get(name)
            if col is None:
                col = np.zeros((n, comps) if comps > 1 else n, dtype=dtype)
            col = np.ascontiguousarray(np.asarray(col, dtype=dtype))
            expect = n * comps
            if col.size != expect:
                raise ValueError(f"column {name}: expected {expect} values, got {col.size}")
            f.write(col.tobytes())
