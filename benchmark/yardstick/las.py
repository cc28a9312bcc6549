"""A small reader of the LAS files that an `-o` request writes: the LAS 1.2
public header and point format 2 records, in numpy.

It imports numpy only: nothing of the program. The layout is the LAS 1.2
specification's; the writer's choices that the checks rely on are its
header math (the offset the hits' min corner, one scale of at least 0.001
m for all three axes) and the one file per input file that has hits,
numbered in input order as matching_points_<k>.las.

  header   "LASF", version 1.2, its size at 94, the offset to the points
           at 96, point format at 104, record length at 105, the point
           count at 107, scale x/y/z at 131, offset x/y/z at 155
  format 2 x, y, z int32 at 0, 4, 8; intensity at 12; the classification
           byte at 15; red, green, blue at 20; 26 B a record
"""

from __future__ import annotations

import dataclasses
import re
import struct
from pathlib import Path

import numpy as np

SIGNATURE = b"LASF"
HEADER_SIZE = 227  # the LAS 1.2 public header
FORMAT = 2
RECORD_LENGTH = 26
RECORD = np.dtype({"names": ["xyz", "classification"], "formats": [("<i4", 3), "u1"],
                   "offsets": [0, 15], "itemsize": RECORD_LENGTH})
NAME = re.compile(r"matching_points_(0|[1-9][0-9]*)\.las")


@dataclasses.dataclass
class Header:
    n: int
    offset_to_points: int
    scale: np.ndarray  # (3,) float64
    offset: np.ndarray  # (3,) float64


def read_header(path: Path) -> Header:
    """The header of a LAS 1.2 file of point format 2; ValueError where the
    file is not one, or its size is not the header's points."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
    if len(head) < HEADER_SIZE or head[:4] != SIGNATURE or tuple(head[24:26]) != (1, 2):
        raise ValueError(f"{path.name}: not a LAS 1.2 file")
    (size,) = struct.unpack_from("<H", head, 94)
    (to_points,) = struct.unpack_from("<I", head, 96)
    fmt = head[104]
    (length,) = struct.unpack_from("<H", head, 105)
    (n,) = struct.unpack_from("<I", head, 107)
    if size < HEADER_SIZE or fmt != FORMAT or length != RECORD_LENGTH:
        raise ValueError(f"{path.name}: header size {size}, point format {fmt}, record "
                         f"length {length}")
    if path.stat().st_size != to_points + n * RECORD_LENGTH:
        raise ValueError(f"{path.name}: {path.stat().st_size} B for {n} points from "
                         f"{to_points}")
    return Header(n, to_points, np.array(struct.unpack_from("<3d", head, 131)),
                  np.array(struct.unpack_from("<3d", head, 155)))


def read_points(path: Path) -> tuple[np.ndarray, np.ndarray, Header]:
    """The file's points: (n, 3) float64 world coordinates (raw x scale +
    offset, each file with its own), (n,) uint8 classification bytes, and
    its header."""
    h = read_header(path)
    recs = np.fromfile(path, RECORD, h.n, offset=h.offset_to_points)
    return recs["xyz"].astype(np.float64) * h.scale + h.offset, recs["classification"], h


def numbered(directory: Path) -> list[Path] | None:
    """The directory's files in their numbering order, or None where it
    holds anything but matching_points_0.las ... matching_points_<n-1>.las."""
    found = {}
    for p in Path(directory).iterdir():
        m = NAME.fullmatch(p.name)
        if m is None or not p.is_file():
            return None
        found[int(m.group(1))] = p
    if sorted(found) != list(range(len(found))):
        return None
    return [found[k] for k in range(len(found))]
