"""Every file's integer query bounds in one vectorised step.

The resident request path's counterpart of aabb.py's per-file conversion:
the header prefilter (AABB.intersects), local_query_bounds and
clamp_bounds_to_i32, applied to all F files of a dataset at once from (F, 3)
float64 tables of their headers' boxes, scales and offsets. Every quotient,
product, sum and compare is the same float64 operation as the scalar
path's, so the bounds are bit-identical. Only a corner whose quotient is
past 2^52 differs: the scalar path raises past int64 there, or steps for
ever, where the table holds the clamp's bound, far outside int32 on the
same side. local_query_bounds stays the streamed path's and the tests'
oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .aabb import AABB, I32_MAX, I32_MIN

# Below this magnitude a quotient's ceil or floor, and each +-1 step of the
# refinement, is an integer that float64 holds exactly, as the scalar path's
# Python ints are. Past it the bound is far outside int32 on the quotient's
# side, where the clamp makes every refinement moot, so it is not refined
# (the scalar path steps there one integer at a time, for as long as it
# takes, and raises past int64).
_EXACT = 2.0**52
# +1 for the min corner (ceil, step up while below the box), -1 for the max
# corner (floor, step down while above it): negation is exact in float64, so
# d * v < d * w is v < w for the min corner and v > w for the max corner, and
# d * ceil(d * x) is ceil(x) for the one and floor(x) for the other.
_SIDE = np.array([1.0, -1.0]).reshape(1, 2, 1)
# the three candidates c - d, c, c + d around a corner's ceil or floor c
_STEPS = np.array([-1.0, 0.0, 1.0]).reshape(3, 1, 1, 1) * _SIDE
# the clamp's inverted box, for a corner past int32 on the wrong side
_INVERTED = np.array([I32_MAX, I32_MIN], np.int32).reshape(2, 1)
_EMPTY = np.array([[0, 0, 0], [-1, -1, -1]], np.int32)


class HeaderTables(NamedTuple):
    """(F, 3) float64 tables of F files' header boxes, scales and offsets."""

    box_min: np.ndarray
    box_max: np.ndarray
    scale: np.ndarray
    offset: np.ndarray

    @staticmethod
    def of(headers) -> "HeaderTables":
        """The tables of LasHeader-like headers: the floats of .bounds,
        .scale and .offset."""
        rows = {"box_min": [h.bounds.min for h in headers],
                "box_max": [h.bounds.max for h in headers],
                "scale": [h.scale for h in headers], "offset": [h.offset for h in headers]}
        return HeaderTables(**{k: np.array(v, np.float64).reshape(-1, 3) for k, v in rows.items()})


def query_bounds_table(
    bounds: AABB, tables: HeaderTables, *, parity_quirk: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """(table, kept): table is (F + 1, 2, 3) int32, row i file i's (lo, hi)
    as clamp_bounds_to_i32(*local_query_bounds(bounds, scale_i, offset_i))
    gives them, row F and every file the header prefilter drops the empty
    box (0, -1); kept is the prefilter's (F,) bool.

    In a kept file, a zero scale or a non-finite quotient raises what the
    scalar path raises first (its division's ZeroDivisionError, math.ceil's
    OverflowError or ValueError), and, without the quirk, a negative scale
    ValueError (the scalar refinement never ends there)."""
    w = np.array([bounds.min, bounds.max], np.float64)  # (2, 3): the corners
    kept = np.all((tables.box_min <= w[1]) & (tables.box_max >= w[0]), axis=1)
    s, o = tables.scale[:, None, :], tables.offset[:, None, :]  # (F, 1, 3)
    with np.errstate(all="ignore"):  # dropped files are not read
        if parity_quirk:  # truncation toward zero; the min corner divides by the x scale
            div = np.concatenate([np.broadcast_to(s[..., :1], s.shape), s], axis=1)
            x = (w - o) / div
            _raise_as_scalar(kept, div, x, parity_quirk)
            q = np.trunc(x)
        else:
            q = _refined(kept, w, s, o)
    # clamp_bounds_to_i32 on the exact integers held in float64
    if np.abs(q).max(initial=0.0) <= I32_MAX:
        clamped = q.astype(np.int32)
    else:
        q = np.where(np.isfinite(q), q, 0.0)
        empty = ((q[:, 1] < I32_MIN) | (q[:, 0] > I32_MAX))[:, None, :]
        clamped = np.where(empty, _INVERTED, np.clip(q, I32_MIN, I32_MAX).astype(np.int32))
    return np.concatenate([np.where(kept[:, None, None], clamped, _EMPTY), _EMPTY[None]]), kept


def _refined(kept, w, s, o) -> np.ndarray:
    """(F, 2, 3) float64: local_query_bounds' exact_lo of the min corner and
    exact_hi of the max corner, file by file. Both are the end of a
    monotone f64 predicate (o + s * q >= w rises with q for s > 0, o + s * q
    <= w falls), so where it changes between the candidates c - d, c and
    c + d the answer is c or c + d, as the scalar path's loops end; a corner
    where it does not takes those loops."""
    x = (w - o) / s
    c = _SIDE * np.ceil(_SIDE * x)
    dw = _SIDE * w
    inside = _SIDE * (o + s * (c + _STEPS)) >= dw  # (3, F, 2, 3)
    settled = inside[2] > inside[0]
    q = np.where(inside[1], c, c + _SIDE)
    if settled.all():
        return q
    _raise_as_scalar(kept, np.broadcast_to(s, x.shape), x, False)
    refine = (np.abs(c) < _EXACT) & (s > 0) & ~settled
    q = np.where(settled, q, c)
    while True:  # the corner still outside the box: step in
        out = refine & (_SIDE * (o + s * q) < dw)
        if not out.any():
            break
        q = q + _SIDE * out
    while True:  # the next step out still inside: step out
        step = refine & (_SIDE * (o + s * (q - _SIDE)) >= dw)
        if not step.any():
            break
        q = q - _SIDE * step
    return q


def _raise_as_scalar(kept, div, x, parity_quirk: bool) -> None:
    """Raise for the first corner quotient of a kept file, in the scalar
    path's order (file, then min corner before max, then axis), that it
    cannot turn into an integer."""
    bad = ~np.isfinite(x)  # a zero divisor among them
    if not parity_quirk:
        bad |= div < 0
    bad &= kept[:, None, None]
    if not bad.any():
        return
    at = tuple(np.argwhere(bad)[0])
    if div[at] < 0:
        raise ValueError("query bounds need positive scale factors")
    if div[at] == 0:
        raise ZeroDivisionError("float division by zero")
    if np.isnan(x[at]):
        raise ValueError("cannot convert float NaN to integer")
    raise OverflowError("cannot convert float infinity to integer")
