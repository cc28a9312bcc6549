"""The benchmark's datasets: a frozen copy of the clustered generator and of
the LAST writer, made on the device from the seed.

The generator is adhoc_queries_pointclouds_torch/formats/synth.py's
make_cloud_clustered, frozen here so that later changes to the program
cannot move the yardstick, and written in torch so that a tile is made on
the card with a torch.Generator in a few large calls:

  - cluster_frac of the points fall in Gaussian clusters (sigma =
    sigma_frac x the larger xy extent, truncated at 2.5 sigma) around
    n_clusters centres, each cluster with its own height band and class;
    the rest form a ground sheet of classes[0] hugging z = 0
    (z = extent_z x Beta(1.2, 12), drawn as a ratio of two Gamma draws);
  - the points are sorted by their 2-D Morton code on a 10-bit lattice, so
    a block of a file covers a compact region, as in tiled airborne scans;
  - GPS times (point formats that have them) rise along that order at
    time_rate points a second from time_start, with a jitter below half a
    point's spacing, so no time lies on a multiple of 1 / time_rate plus
    three quarters of it (traffic.py puts the windows' edges there).

Tile i of a dataset lies at x offset i x tile_extent[0], as
formats/synth.py write_dataset lays its files out, and its GPS times
continue those of tile i - 1. Only the columns a resident query reads are
written (positions, classes and GPS times); the LAST file's other columns
are left as holes, which read as zeros. Intensity and colour are not drawn.
The host keeps its copy of the columns for the reference, so the files can
go as soon as the program has loaded them: their pages are then dropped
before the system writes them back, and no writeback runs beside the
measured window.

The same seed gives the same tiles on the same device; the CPU tests pin
the CPU stream to a committed digest.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np
import torch

# the LAS 1.2 public header: its size, and the record length and GPS-time
# offset of point formats 0 and 1 (the LAS specification)
HEADER_SIZE = 227
RECORD_LENGTH = {0: 20, 1: 28}
CLASS_OFFSET = 15
GPS_OFFSET = 20


def has_gps(point_format: int) -> bool:
    return point_format == 1


@dataclasses.dataclass
class Tile:
    """One generated tile, on the device it was made on."""

    raw: torch.Tensor  # (n, 3) int32 local coordinates
    cls: torch.Tensor  # (n,) uint8
    gps: torch.Tensor | None  # (n,) float64, or None
    offset: tuple[float, float, float]
    scale: tuple[float, float, float]
    wmin: tuple[float, float, float]  # world bounds as the header holds them
    wmax: tuple[float, float, float]


@dataclasses.dataclass
class Dataset:
    """What the benchmark wrote: its files, their geometry and the host's
    copy of their columns (read_columns' keys)."""

    files: list[Path]
    columns: list[dict[str, np.ndarray]]
    counts: list[int]
    offsets: list[tuple[float, float, float]]
    scale: tuple[float, float, float]
    wmin: list[tuple[float, float, float]]
    wmax: list[tuple[float, float, float]]
    point_format: int
    time_rate: float

    @property
    def total_points(self) -> int:
        return sum(self.counts)

    @property
    def extent_min(self) -> tuple[float, ...]:
        return tuple(min(b[a] for b in self.wmin) for a in range(3))

    @property
    def extent_max(self) -> tuple[float, ...]:
        return tuple(max(b[a] for b in self.wmax) for a in range(3))


def tile_seed(seed: int, config: str, tile: int) -> int:
    """A 64-bit seed for one tile, drawn from the run's seed, the
    configuration's name and the tile's index."""
    words = [seed & 0xFFFFFFFFFFFFFFFF, tile] + list(config.encode())
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit values with zero bits (int64)."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def make_tile(n: int, *, seed: int, device, point_format: int,
              scale=(0.001, 0.001, 0.001), offset=(100000.0, 200000.0, 0.0),
              extent=(1000.0, 1000.0, 100.0), classes=(2, 3, 5, 6),
              n_clusters: int = 48, cluster_frac: float = 0.7, sigma_frac: float = 0.015,
              time_start: float = 0.0, time_rate: float = 200_000.0) -> Tile:
    """One clustered tile of n points (see the module's docstring)."""
    f64 = torch.float64
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, dtype=f64, device=device)

    ext = torch.tensor(extent, dtype=f64, device=device)
    n_c = int(n * cluster_frac)
    n_b = n - n_c
    k = max(n_clusters, 1)

    centers = (0.08 + 0.84 * rand(k, 2)) * ext[:2]
    heights = (0.15 + 0.6 * rand(k)) * ext[2]
    table = torch.tensor(classes, dtype=torch.uint8, device=device)
    cluster_cls = table[torch.randint(0, len(classes), (k,), generator=g, device=device)]
    assign = torch.randint(0, k, (n_c,), generator=g, device=device)
    sigma = sigma_frac * float(max(extent[0], extent[1]))
    dev = torch.randn(n_c, 2, generator=g, dtype=f64, device=device) * sigma
    xy_c = centers[assign] + dev.clamp(-2.5 * sigma, 2.5 * sigma)
    z_c = heights[assign] * rand(n_c)
    cls_c = cluster_cls[assign]
    del dev

    xy_b = rand(n_b, 2) * ext[:2]
    ga = torch._standard_gamma(torch.full((n_b,), 1.2, dtype=f64, device=device), generator=g)
    gb = torch._standard_gamma(torch.full((n_b,), 12.0, dtype=f64, device=device), generator=g)
    z_b = ext[2] * (ga / (ga + gb))
    del ga, gb
    cls_b = torch.full((n_b,), classes[0], dtype=torch.uint8, device=device)

    xy = torch.minimum(torch.cat([xy_c, xy_b]).clamp_min(0.0), ext[:2])
    z = torch.cat([z_c, z_b]).clamp(0.0, float(extent[2]))
    cls = torch.cat([cls_c, cls_b])
    del xy_c, xy_b, z_c, z_b, cls_c, cls_b

    q = (xy / ext[:2] * 1023.0).clamp(0, 1023).to(torch.int64)
    order = torch.argsort(_part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << 1), stable=True)
    del q
    local = torch.cat([xy[order], z[order, None]], dim=1)
    cls = cls[order]
    del xy, z, order

    sc = torch.tensor(scale, dtype=f64, device=device)
    max_raw = torch.tensor([int(e / s) for e, s in zip(extent, scale)], device=device)
    raw = torch.minimum(torch.round(local / sc).to(torch.int64), max_raw).to(torch.int32)
    del local
    world = raw.to(f64) * sc + torch.tensor(offset, dtype=f64, device=device)
    wmin = tuple(float(v) for v in world.amin(dim=0).tolist())
    wmax = tuple(float(v) for v in world.amax(dim=0).tolist())
    del world

    gps = None
    if has_gps(point_format):
        gps = time_start + torch.arange(n, dtype=f64, device=device) / time_rate
        gps += rand(n) * (0.5 / time_rate)
    return Tile(raw.contiguous(), cls.contiguous(), gps, tuple(offset), tuple(scale),
                wmin, wmax)


def las_header(point_format: int, n: int, scale, offset, wmin, wmax) -> bytes:
    """A LAS 1.2 public header block with no VLRs (formats/las.py
    write_las_header for versions 1.0-1.2)."""
    buf = bytearray(HEADER_SIZE)
    buf[0:4] = b"LASF"
    struct.pack_into("<HH", buf, 4, 0, 0)
    buf[24], buf[25] = 1, 2
    sysid = b"benchmark"
    buf[26:26 + len(sysid)] = sysid
    struct.pack_into("<HH", buf, 90, 1, 2026)
    struct.pack_into("<HII", buf, 94, HEADER_SIZE, HEADER_SIZE, 0)
    buf[104] = point_format
    struct.pack_into("<H", buf, 105, RECORD_LENGTH[point_format])
    struct.pack_into("<I", buf, 107, min(n, 2**32 - 1))
    struct.pack_into("<6d", buf, 131, *scale, *offset)
    struct.pack_into("<6d", buf, 179, wmax[0], wmin[0], wmax[1], wmin[1], wmax[2], wmin[2])
    return bytes(buf)


def host_columns(tile: Tile) -> dict[str, np.ndarray]:
    cols = {"raw": tile.raw.cpu().numpy(), "cls": tile.cls.cpu().numpy()}
    if tile.gps is not None:
        cols["gps"] = tile.gps.cpu().numpy()
    return cols


def write_last(path: Path, tile: Tile, cols: dict[str, np.ndarray], point_format: int) -> None:
    """The tile as a LAST file: the header, then each record field's column
    at offset_to_point_data + field offset x n (formats/last.py). Only the
    position, class and GPS-time columns are written; the rest are holes."""
    n = cols["raw"].shape[0]
    with open(path, "wb") as f:
        f.write(las_header(point_format, n, tile.scale, tile.offset, tile.wmin, tile.wmax))
        f.write(memoryview(np.ascontiguousarray(cols["raw"])).cast("B"))
        f.seek(HEADER_SIZE + CLASS_OFFSET * n)
        f.write(memoryview(cols["cls"]).cast("B"))
        if "gps" in cols:
            f.seek(HEADER_SIZE + GPS_OFFSET * n)
            f.write(memoryview(cols["gps"]).cast("B"))
        f.truncate(HEADER_SIZE + RECORD_LENGTH[point_format] * n)


def read_columns(path: Path, point_format: int) -> dict[str, np.ndarray]:
    """A written file's columns back (read-only views): raw (n, 3) int32,
    cls (n,) uint8 and, where the format has it, gps (n,) float64."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    (n,) = struct.unpack_from("<I", mm[:HEADER_SIZE].tobytes(), 107)
    cols = {
        "raw": np.frombuffer(mm, np.int32, 3 * n, HEADER_SIZE).reshape(n, 3),
        "cls": np.frombuffer(mm, np.uint8, n, HEADER_SIZE + CLASS_OFFSET * n),
    }
    if has_gps(point_format):
        cols["gps"] = np.frombuffer(mm, np.float64, n, HEADER_SIZE + GPS_OFFSET * n)
    return cols


def tile_counts(config: dict) -> list[int]:
    """Points a tile: the total split evenly, the last tile taking the rest."""
    total, tiles = int(config["points"]), int(config["tiles"])
    each = total // tiles
    return [each] * (tiles - 1) + [total - each * (tiles - 1)]


def make_dataset(config: dict, seed: int, root: Path, device) -> Dataset:
    """Every tile of config, made on device from seed and written to root
    as tile_<i>.last; the device's copies are freed tile by tile."""
    gen = config["generator"]
    fmt = int(config["point_format"])
    scale = tuple(float(s) for s in config["scale"])
    base = tuple(float(o) for o in config["offset"])
    extent = tuple(float(e) for e in config["tile_extent_m"])
    rate = float(gen.get("time_rate", 200_000.0))
    files, columns, counts, offsets, wmin, wmax = [], [], [], [], [], []
    start = 0
    for i, n in enumerate(tile_counts(config)):
        offset = (base[0] + i * extent[0], base[1], base[2])
        tile = make_tile(n, seed=tile_seed(seed, config["name"], i), device=device,
                         point_format=fmt, scale=scale, offset=offset, extent=extent,
                         classes=tuple(config["classes"]), n_clusters=int(gen["n_clusters"]),
                         cluster_frac=float(gen["cluster_frac"]),
                         sigma_frac=float(gen["sigma_frac"]),
                         time_start=start / rate, time_rate=rate)
        path = root / f"tile_{i:03d}.last"
        cols = host_columns(tile)
        write_last(path, tile, cols, fmt)
        files.append(path)
        columns.append(cols)
        counts.append(n)
        offsets.append(offset)
        wmin.append(tile.wmin)
        wmax.append(tile.wmax)
        start += n
        del tile
    return Dataset(files, columns, counts, offsets, scale, wmin, wmax, fmt, rate)
