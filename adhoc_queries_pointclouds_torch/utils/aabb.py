"""Axis-aligned bounding boxes and world->integer-local coordinate conversion.

Replaces the reference's `pasture_core::math::AABB` usage and the
world-to-local query-bounds conversion of query/src/search/las.rs:86-99.
All world-space math stays on the host in float64; the device only ever sees
int32 local coordinates and int32 query bounds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

I32_MIN = -(2**31)
I32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class AABB:
    """Closed axis-aligned box: contains p iff min <= p <= max on all axes.

    Matches the inclusivity of the reference's integer test
    (`< min || > max` -> continue, query/src/search/las.rs:107-118).
    """

    min: tuple[float, float, float]
    max: tuple[float, float, float]

    def __post_init__(self):
        object.__setattr__(self, "min", tuple(float(v) for v in self.min))
        object.__setattr__(self, "max", tuple(float(v) for v in self.max))

    @staticmethod
    def empty() -> "AABB":
        inf = math.inf
        return AABB((inf, inf, inf), (-inf, -inf, -inf))

    def is_empty(self) -> bool:
        return any(lo > hi for lo, hi in zip(self.min, self.max))

    def union(self, other: "AABB") -> "AABB":
        return AABB(
            tuple(min(a, b) for a, b in zip(self.min, other.min)),
            tuple(max(a, b) for a, b in zip(self.max, other.max)),
        )

    def intersects(self, other: "AABB") -> bool:
        return all(
            self.min[i] <= other.max[i] and self.max[i] >= other.min[i]
            for i in range(3)
        )

    def contains_points(self, xyz: np.ndarray) -> np.ndarray:
        """Vectorized closed-box containment test for an (N, 3) float array."""
        lo = np.asarray(self.min)
        hi = np.asarray(self.max)
        return np.all((xyz >= lo) & (xyz <= hi), axis=1)

    @property
    def extent(self) -> tuple[float, float, float]:
        return tuple(hi - lo for lo, hi in zip(self.min, self.max))


def parse_aabb(text: str) -> AABB:
    """Parse 'minx;miny;minz;maxx;maxy;maxz' (reference main.rs:59-92)."""
    parts = text.split(";")
    if len(parts) != 6:
        raise ValueError(f'Could not parse AABB from string "{text}"')
    try:
        vals = [float(p) for p in parts]
    except ValueError as e:
        raise ValueError(f'Could not parse AABB from string "{text}": {e}') from e
    return AABB(tuple(vals[:3]), tuple(vals[3:]))


def _trunc(v: float) -> int:
    """C-style cast-to-integer: truncation toward zero (Rust `as i64`)."""
    return math.trunc(v)


def local_query_bounds(
    bounds: AABB,
    scale: tuple[float, float, float],
    offset: tuple[float, float, float],
    *,
    parity_quirk: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Convert a world-space query AABB into the file's integer coordinate space.

    Returns (lo, hi) int64 arrays of shape (3,). A point with raw integer
    coordinates q matches iff lo <= q <= hi componentwise — the integer-domain
    equivalent of a closed f64 box test, done once per file so the per-point
    hot loop is pure int compares (reference query/src/search/las.rs:86-118).

    The correct conversion for a *closed* world box [wmin, wmax] is
        lo = ceil((wmin - offset) / scale),  hi = floor((wmax - offset) / scale)
    because integer coordinate q maps to world offset + scale*q.

    With ``parity_quirk=True`` we instead replicate the reference bit-for-bit:
    truncation-toward-zero casts on both corners, and the min corner dividing
    y and z by the *x* scale factor (las.rs:91-92 and last.rs:101-102 use
    `x_scale_factor` for all three axes of the min corner — a latent bug when
    per-axis scales differ). Use for parity runs against the Rust engine only.
    """
    sx, sy, sz = (float(s) for s in scale)
    ox, oy, oz = (float(o) for o in offset)
    wmin, wmax = bounds.min, bounds.max

    if parity_quirk:
        lo = np.array(
            [
                _trunc((wmin[0] - ox) / sx),
                _trunc((wmin[1] - oy) / sx),
                _trunc((wmin[2] - oz) / sx),
            ],
            dtype=np.int64,
        )
        hi = np.array(
            [
                _trunc((wmax[0] - ox) / sx),
                _trunc((wmax[1] - oy) / sy),
                _trunc((wmax[2] - oz) / sz),
            ],
            dtype=np.int64,
        )
        return lo, hi

    def exact_lo(w: float, s: float, o: float) -> int:
        """Smallest integer q with o + s*q >= w under exact f64 semantics.

        ceil((w-o)/s) can be off by one ulp either way because the division
        is inexact; refine against the f64 predicate the oracle (and any
        f64 reader) actually evaluates: world(q) = o + s*q.
        """
        q = math.ceil((w - o) / s)
        while o + s * q < w:  # q still below the box: move up
            q += 1
        while o + s * (q - 1) >= w:  # q-1 already inside: move down
            q -= 1
        return q

    def exact_hi(w: float, s: float, o: float) -> int:
        """Largest integer q with o + s*q <= w under exact f64 semantics."""
        q = math.floor((w - o) / s)
        while o + s * q > w:
            q -= 1
        while o + s * (q + 1) <= w:
            q += 1
        return q

    lo = np.array(
        [exact_lo(wmin[i], s, o) for i, (s, o) in enumerate(((sx, ox), (sy, oy), (sz, oz)))],
        dtype=np.int64,
    )
    hi = np.array(
        [exact_hi(wmax[i], s, o) for i, (s, o) in enumerate(((sx, ox), (sy, oy), (sz, oz)))],
        dtype=np.int64,
    )
    return lo, hi


def clamp_bounds_to_i32(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Clamp int64 local bounds into int32 range for the device kernels.

    Raw LAS coordinates are int32, so clamping the query bounds to int32 range
    never changes which stored points match.
    """
    lo32 = np.clip(lo, I32_MIN, I32_MAX).astype(np.int32)
    hi32 = np.clip(hi, I32_MIN, I32_MAX).astype(np.int32)
    # A box entirely outside int32 range matches nothing; encode as inverted box.
    empty = (hi < I32_MIN) | (lo > I32_MAX)
    lo32 = np.where(empty, np.int32(I32_MAX), lo32)
    hi32 = np.where(empty, np.int32(I32_MIN), hi32)
    return lo32, hi32
