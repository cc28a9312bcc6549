"""Host-side file-format layer: LAS / LAST / LAZER / LAZ codecs.

Every reader exposes the same columnar interface:
  .header         parsed LasHeader (all four formats reuse the LAS header)
  .point_count    number of points
  .file_size      bytes on disk (for MiB/s reporting, main.rs:227-231)
  .column(name, start, stop)        -> numpy SoA column (raw int32 positions)
  .positions_world(start, stop)     -> f64 world coords (hits only, normally)

This is the layer the reference delegates to pasture/las-rs/laz-rs for
(SURVEY §2.4); here it is owned, and it feeds int32 SoA blocks straight to
the device.
"""

from __future__ import annotations

from pathlib import Path

from .las import LasFile, LasHeader, parse_las_header, write_las  # noqa: F401
from .last import LastFile, las_to_last  # noqa: F401
from .laz import LazFile, las_to_laz  # noqa: F401
from .lazer import LazerFile, las_to_lazer  # noqa: F401

SUPPORTED_EXTENSIONS = ("las", "laz", "last", "lazer")


def open_point_cloud(path: str | Path):
    """Extension-dispatched reader factory (reference searcher.rs:50-89)."""
    path = Path(path)
    ext = path.suffix.lower().lstrip(".")
    if ext == "las":
        return LasFile(path)
    if ext == "last":
        return LastFile(path)
    if ext == "lazer":
        return LazerFile(path)
    if ext == "laz":
        return LazFile(path)
    raise ValueError(f"Unsupported file extension in file {path}")


def is_valid_file(path: Path) -> bool:
    """Extension filter (reference main.rs:185-189)."""
    return path.suffix.lower().lstrip(".") in SUPPORTED_EXTENSIONS
