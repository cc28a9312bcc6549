"""Synthetic point-cloud fixture generation.

The reference ships no test fixtures at all (its integration tests hard-code
absolute paths on the author's machine, readers/src/last_reader.rs:406-407).
This module generates deterministic datasets in every supported format so the
whole test suite and benchmark harness are self-contained.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .las import LasHeader, RECORD_LENGTH, has_color, record_dtype, write_las_header
from .last import write_last


@dataclasses.dataclass
class SynthCloud:
    """In-memory SoA point cloud plus its LAS header parameters."""

    header: LasHeader
    position_raw: np.ndarray  # (N, 3) int32 local coords
    intensity: np.ndarray  # (N,) uint16
    classification: np.ndarray  # (N,) uint8
    color: np.ndarray  # (N, 3) uint16 (zeros if format has no color)
    gps_time: np.ndarray | None = None
    waveform: np.ndarray | None = None  # (N, 29) uint8 wave packets

    @property
    def positions_world(self) -> np.ndarray:
        return self.position_raw.astype(np.float64) * np.asarray(
            self.header.scale
        ) + np.asarray(self.header.offset)

    def columns(self) -> dict[str, np.ndarray]:
        cols = {
            "position": self.position_raw,
            "intensity": self.intensity,
            "classification": self.classification,
        }
        if has_color(self.header.point_format):
            cols["color"] = self.color
        if self.gps_time is not None:
            cols["gps_time"] = self.gps_time
        if self.waveform is not None:
            cols["waveform"] = self.waveform
        return cols


def make_cloud(
    n: int,
    *,
    seed: int = 0,
    point_format: int = 2,
    scale: tuple[float, float, float] = (0.001, 0.001, 0.001),
    offset: tuple[float, float, float] = (100000.0, 200000.0, 0.0),
    extent: tuple[float, float, float] = (1000.0, 1000.0, 100.0),
    classes: tuple[int, ...] = (1, 2, 3, 4, 5, 6),
) -> SynthCloud:
    """Deterministic uniform cloud over [offset, offset+extent] in world space."""
    rng = np.random.default_rng(seed)
    max_raw = [int(e / s) for e, s in zip(extent, scale)]
    raw = np.stack(
        [rng.integers(0, m + 1, size=n, dtype=np.int64).astype(np.int32) for m in max_raw],
        axis=1,
    )
    intensity = rng.integers(0, 2**16, size=n, dtype=np.int64).astype(np.uint16)
    classification = rng.choice(np.asarray(classes, dtype=np.uint8), size=n)
    color = rng.integers(0, 2**16, size=(n, 3), dtype=np.int64).astype(np.uint16)
    world = raw.astype(np.float64) * np.asarray(scale) + np.asarray(offset)
    header = LasHeader(
        version=(1, 2) if point_format < 6 else (1, 4),
        point_format=point_format,
        point_record_length=RECORD_LENGTH[point_format],
        point_count=n,
        offset_to_point_data=227 if point_format < 6 else 375,
        scale=scale,
        offset=offset,
        min=tuple(world.min(axis=0)) if n else offset,
        max=tuple(world.max(axis=0)) if n else offset,
    )
    gps = None
    from .las import has_gps_time, has_waveform

    if has_gps_time(point_format):
        gps = rng.uniform(0.0, 1e6, size=n)
    wave = None
    if has_waveform(point_format):
        wave = rng.integers(0, 256, size=(n, 29), dtype=np.int64).astype(np.uint8)
    return SynthCloud(header, raw, intensity, classification, color,
                      gps_time=gps, waveform=wave)


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Interleave 16-bit values with zero bits (Morton x-coordinate part)."""
    x = x.astype(np.uint32)
    x = (x | (x << 8)) & np.uint32(0x00FF00FF)
    x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & np.uint32(0x33333333)
    x = (x | (x << 1)) & np.uint32(0x55555555)
    return x


def make_cloud_clustered(
    n: int,
    *,
    seed: int = 0,
    point_format: int = 2,
    scale: tuple[float, float, float] = (0.001, 0.001, 0.001),
    offset: tuple[float, float, float] = (100000.0, 200000.0, 0.0),
    extent: tuple[float, float, float] = (1000.0, 1000.0, 100.0),
    classes: tuple[int, ...] = (2, 3, 5, 6),
    n_clusters: int = 48,
    cluster_frac: float = 0.7,
    sigma_frac: float = 0.015,
    time_start: float = 0.0,
    time_rate: float = 200_000.0,
) -> SynthCloud:
    """Spatially-coherent cloud: Gaussian clusters over a uniform ground
    sheet, Morton-ordered like real tiled airborne lidar.

    Uniform-random fixtures (make_cloud) make every engine block span the
    whole file extent, so block min/max indexes and per-block residual
    packing have nothing to bite on — unlike the paper's real datasets
    (56 M-2.6 B pts of scan-ordered flight lines, reference
    run_query_experiments.rs:106-380 / run_postgis_queries.rs:22-24). Here:

      - cluster_frac of points Gaussian-cluster in xy around n_clusters
        centers (sigma = sigma_frac x max extent, truncated at 2.5 sigma so
        each cluster's support is a bounded tile) with per-cluster height
        bands; the rest form a low-z ground sheet
      - classes are per-cluster (ground points take classes[0]) and the
        truncation keeps them spatially bounded — a given non-ground class
        exists only in the tiles its clusters cover, like real lidar where
        buildings live in built-up blocks. Class-presence bitmaps can
        therefore prune blocks for a *present* class (untruncated tails
        sprinkled every class into every block, reducing the bitmap to an
        absent-class-only device)
      - all points are sorted by 2-D Morton code (10-bit lattice), so
        engine blocks cover compact regions: header/index pruning, packed
        -transport widths, and LZ4/LASzip ratios behave like production data
      - gps_time increases monotonically along the Morton order at
        time_rate pts/s from time_start (narrow per-block time ranges, the
        flight-line shape the packed time transport exploits)
    """
    rng = np.random.default_rng(seed)
    ext = np.asarray(extent, np.float64)
    n_c = int(n * cluster_frac)
    n_b = n - n_c

    centers = rng.uniform(0.08, 0.92, (max(n_clusters, 1), 2)) * ext[:2]
    heights = rng.uniform(0.15, 0.75, max(n_clusters, 1)) * ext[2]
    cluster_cls = rng.choice(np.asarray(classes, np.uint8), size=max(n_clusters, 1))
    assign = rng.integers(0, max(n_clusters, 1), n_c)
    sigma = sigma_frac * float(ext[:2].max())
    dev = np.clip(rng.normal(0.0, sigma, (n_c, 2)), -2.5 * sigma, 2.5 * sigma)
    xy_c = centers[assign] + dev
    z_c = heights[assign] * rng.random(n_c)
    cls_c = cluster_cls[assign]

    xy_b = rng.uniform(0.0, 1.0, (n_b, 2)) * ext[:2]
    z_b = ext[2] * rng.beta(1.2, 12.0, n_b)  # ground sheet hugs z = 0
    cls_b = np.full(n_b, classes[0], np.uint8)

    xy = np.clip(np.concatenate([xy_c, xy_b]), 0.0, ext[:2])
    z = np.clip(np.concatenate([z_c, z_b]), 0.0, ext[2])
    classification = np.concatenate([cls_c, cls_b])

    # Morton order on a 10-bit lattice: engine blocks become compact tiles
    q = np.clip((xy / np.maximum(ext[:2], 1e-300) * 1023.0), 0, 1023).astype(np.uint32)
    order = np.argsort(_part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << np.uint32(1)),
                       kind="stable")
    xy, z, classification = xy[order], z[order], classification[order]

    local = np.concatenate([xy, z[:, None]], axis=1)
    max_raw = np.asarray([int(e / s) for e, s in zip(extent, scale)], np.int64)
    raw = np.minimum(
        np.round(local / np.asarray(scale)).astype(np.int64), max_raw
    ).astype(np.int32)

    intensity = rng.integers(0, 2**16, size=n, dtype=np.int64).astype(np.uint16)
    color = rng.integers(0, 2**16, size=(n, 3), dtype=np.int64).astype(np.uint16)
    world = raw.astype(np.float64) * np.asarray(scale) + np.asarray(offset)
    header = LasHeader(
        version=(1, 2) if point_format < 6 else (1, 4),
        point_format=point_format,
        point_record_length=RECORD_LENGTH[point_format],
        point_count=n,
        offset_to_point_data=227 if point_format < 6 else 375,
        scale=scale,
        offset=offset,
        min=tuple(world.min(axis=0)) if n else offset,
        max=tuple(world.max(axis=0)) if n else offset,
    )
    from .las import has_gps_time, has_waveform

    gps = None
    if has_gps_time(point_format):
        gps = time_start + np.arange(n, dtype=np.float64) / time_rate
        gps += rng.uniform(0.0, 0.5 / time_rate, n)  # intra-pulse jitter
    wave = None
    if has_waveform(point_format):
        wave = rng.integers(0, 256, size=(n, 29), dtype=np.int64).astype(np.uint8)
    return SynthCloud(header, raw, intensity, classification, color,
                      gps_time=gps, waveform=wave)


def write_cloud_las(cloud: SynthCloud, path: str | Path) -> None:
    h = cloud.header
    recs = np.zeros(h.point_count, dtype=record_dtype(h.point_format, h.point_record_length))
    recs["x"] = cloud.position_raw[:, 0]
    recs["y"] = cloud.position_raw[:, 1]
    recs["z"] = cloud.position_raw[:, 2]
    recs["intensity"] = cloud.intensity
    recs["classification"] = cloud.classification
    if has_color(h.point_format):
        recs["red"] = cloud.color[:, 0]
        recs["green"] = cloud.color[:, 1]
        recs["blue"] = cloud.color[:, 2]
    if cloud.gps_time is not None:
        recs["gps_time"] = cloud.gps_time
    if cloud.waveform is not None:
        recs["waveform"] = cloud.waveform
    with open(path, "wb") as f:
        hdr = write_las_header(h)
        pad = h.offset_to_point_data - len(hdr)
        f.write(hdr)
        if pad > 0:
            f.write(b"\x00" * pad)
        f.write(recs.tobytes())


def write_cloud_last(cloud: SynthCloud, path: str | Path) -> None:
    write_last(path, cloud.header, cloud.columns())


def write_cloud_lazer(cloud: SynthCloud, path: str | Path, block_size: int = 50_000) -> None:
    from .lazer import write_lazer

    write_lazer(path, cloud.header, cloud.columns(), block_size=block_size)


def write_cloud_laz(cloud: SynthCloud, path: str | Path, chunk_size: int = 50_000) -> None:
    from .laz import write_laz

    write_laz(path, cloud.header, cloud.columns(), chunk_size=chunk_size)


def write_dataset(
    root: str | Path,
    *,
    n_files: int = 4,
    points_per_file: int = 100_000,
    formats: tuple[str, ...] = ("las", "last", "lazer"),
    seed: int = 0,
    point_format: int = 2,
    clustered: bool = False,
    **cloud_kwargs,
) -> dict[str, list[Path]]:
    """Generate a multi-file dataset laid out like the paper's experiment data:
    root/<fmt>/file_<i>.<fmt> (reference README.md:31-47). Each file covers a
    different sub-slab of the world extent so header prefilters have bite.
    clustered=True uses the spatially-coherent generator (Morton-ordered
    Gaussian clusters + monotone gps — see make_cloud_clustered).
    """
    root = Path(root)
    out: dict[str, list[Path]] = {f: [] for f in formats}
    base_offset = cloud_kwargs.pop("offset", (100000.0, 200000.0, 0.0))
    extent = cloud_kwargs.pop("extent", (1000.0, 1000.0, 100.0))
    for i in range(n_files):
        file_offset = (
            base_offset[0] + i * extent[0],
            base_offset[1],
            base_offset[2],
        )
        make = make_cloud_clustered if clustered else make_cloud
        extra = dict(cloud_kwargs)
        if clustered:
            from .las import has_gps_time

            if has_gps_time(point_format):
                # files continue one global flight line
                rate = extra.get("time_rate", 200_000.0)
                extra.setdefault("time_start", i * points_per_file / rate)
        cloud = make(
            points_per_file,
            seed=seed + i,
            point_format=point_format,
            offset=file_offset,
            extent=extent,
            **extra,
        )
        for fmt in formats:
            d = root / fmt
            d.mkdir(parents=True, exist_ok=True)
            p = d / f"file_{i}.{fmt}"
            if fmt == "las":
                write_cloud_las(cloud, p)
            elif fmt == "last":
                write_cloud_last(cloud, p)
            elif fmt == "lazer":
                write_cloud_lazer(cloud, p)
            elif fmt == "laz":
                write_cloud_laz(cloud, p)
            else:
                raise ValueError(f"unsupported synth format {fmt}")
            out[fmt].append(p)
    return out


def formats_available(*formats: str) -> tuple[str, ...]:
    """Drop 'laz' when the native codec is unavailable (AQPC_DISABLE_NATIVE
    or a failed g++ build): the pure-python fallback covers LZ4/LAZER but
    not LASzip. Fixture generators degrade rather than error."""
    from .. import native

    if native.available():
        return tuple(formats)
    return tuple(f for f in formats if f != "laz")
