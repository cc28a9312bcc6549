"""utils/bounds_table.py against the scalar path it replaces, bit for bit.

query_bounds_table gives every file's int32 query bounds at once; the
oracle is the per-file path the resident dataset ran before it and the
streamed engine still runs: AABB.intersects as the header prefilter, then
clamp_bounds_to_i32(*local_query_bounds(...)). Every kept row must be equal,
every dropped row and the extra row F the empty box (0, -1), and an input
the scalar path raises for must raise the same exception with the same
message. Where the scalar path cannot finish (a quotient past int64 raises
in its conversion, one near 1e300 steps for ever), the table must hold what
it gives for the same box with those coordinates pulled in to 1e12, still
far past int32 on the same side. Random cases come from hypothesis
(derandomized, no example database), the adversarial ones from a seeded
list.
"""

import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from adhoc_queries_pointclouds_torch.formats.las import LasHeader
from adhoc_queries_pointclouds_torch.utils.aabb import (
    AABB,
    I32_MAX,
    clamp_bounds_to_i32,
    local_query_bounds,
)
from adhoc_queries_pointclouds_torch.utils.bounds_table import HeaderTables, query_bounds_table

EMPTY = [[0, 0, 0], [-1, -1, -1]]


def header(lo, hi, scale, offset) -> LasHeader:
    return LasHeader(scale=tuple(scale), offset=tuple(offset), min=tuple(lo), max=tuple(hi))


def oracle(bounds: AABB, headers, quirk: bool) -> np.ndarray:
    """The scalar path, file by file: (F + 1, 2, 3) int32."""
    out = np.array([EMPTY] * (len(headers) + 1), np.int32)
    for i, h in enumerate(headers):
        if h.bounds.intersects(bounds):
            out[i] = clamp_bounds_to_i32(*local_query_bounds(bounds, h.scale, h.offset,
                                                              parity_quirk=quirk))
    return out


def outcome(fn):
    """fn()'s result, or the type and message of what it raised."""
    try:
        return fn()
    except (OverflowError, ValueError, ZeroDivisionError) as e:
        return type(e), str(e)


def tame(bounds: AABB, far: float) -> AABB:
    """bounds with every finite coordinate clipped to [-far, far]."""
    def pull(v):
        return tuple(float(np.clip(c, -far, far)) if math.isfinite(c) else c for c in v)
    return AABB(pull(bounds.min), pull(bounds.max))


def check(bounds: AABB, headers, quirk: bool, far: float | None = None):
    """The table against the oracle (on the box tamed to far, if given);
    returns the table, or None if both raised alike."""
    want = outcome(lambda: oracle(bounds if far is None else tame(bounds, far), headers, quirk))
    got = outcome(lambda: query_bounds_table(bounds, HeaderTables.of(headers),
                                             parity_quirk=quirk))
    if isinstance(want, tuple):
        assert got == want
        return None
    table, kept = got
    assert table.dtype == np.int32 and table.shape == (len(headers) + 1, 2, 3)
    assert kept.tolist() == [h.bounds.intersects(bounds) for h in headers]
    np.testing.assert_array_equal(table, want)
    assert table[-1].tolist() == EMPTY
    return table


def test_tables_hold_the_headers_floats():
    hs = [header((1.5, -2.0, 3.0), (4.0, 5.0, 6.25), (0.001, 0.01, 0.1), (-1e6, 2e5, 0.0)),
          header((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (1 / 3, 0.25, 7e-4), (9.0, 8.0, 7.0))]
    t = HeaderTables.of(hs)
    for name, attr in (("box_min", lambda h: h.bounds.min), ("box_max", lambda h: h.bounds.max),
                       ("scale", lambda h: h.scale), ("offset", lambda h: h.offset)):
        a = getattr(t, name)
        assert a.dtype == np.float64 and a.shape == (2, 3)
        assert a.tolist() == [list(attr(h)) for h in hs]


# ---------------------------------------------------------------------------
# the seeded adversarial list
# ---------------------------------------------------------------------------

SCALES = [(0.001, 0.001, 0.001), (0.01, 0.001, 0.1), (1 / 3, 0.25, 7.3e-4), (1e-7, 0.5, 2.0)]
OFFSETS = [(0.0, 0.0, 0.0), (-1e9, -5e8, -1e4), (389400.0, 124200.0, -94.88),
           (-23.108, -21.261, -10.029), (1e12, -1e12, 3e11)]


def grid_headers(rng, n=5):
    """n files, each its own scale and offset, with header boxes that hold
    their grid points q in [-2e6, 2e6] (or nearly: a box's face may cut
    the corners of a query near its edge)."""
    out = []
    for j in range(n):
        s = np.array(SCALES[j % len(SCALES)])
        o = np.array(OFFSETS[rng.integers(len(OFFSETS))])
        lo = o - s * rng.integers(10**6, 2 * 10**6, 3)
        out.append(header(lo, o + s * rng.integers(10**6, 2 * 10**6, 3), s, o))
    return out


def near(v: float, ulps: int) -> float:
    """v moved by ulps units in the last place (either sign)."""
    toward = math.inf if ulps > 0 else -math.inf
    for _ in range(abs(ulps)):
        v = float(np.nextafter(v, toward))
    return v


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("ulps", [-2, -1, 0, 1, 2])
def test_corners_on_and_beside_grid_points(quirk, ulps):
    """Each corner at o + s*q of some file, or one or two ulps either side,
    where the quotient's ceil and floor are off by one and the refinement
    decides."""
    rng = np.random.default_rng(1000 + ulps)
    for _ in range(40):
        hs = grid_headers(rng)
        i = rng.integers(len(hs))
        s, o = np.array(hs[i].scale), np.array(hs[i].offset)
        lo_q = rng.integers(-10**6, 10**6, 3)
        hi_q = lo_q + rng.integers(0, 10**5, 3)
        lo = [near(float(o[k] + s[k] * lo_q[k]), ulps) for k in range(3)]
        hi = [near(float(o[k] + s[k] * hi_q[k]), -ulps) for k in range(3)]
        table = check(AABB(lo, hi), hs, quirk)
        assert table[i].tolist() != EMPTY  # file i is kept


@pytest.mark.parametrize("quirk", [False, True])
def test_per_axis_scales_and_far_offsets(quirk):
    """Scales that differ a file and an axis (where the quirk's min corner
    divides by the x scale), negative and far offsets."""
    rng = np.random.default_rng(7)
    for _ in range(200):
        hs = grid_headers(rng, n=int(rng.integers(1, 9)))
        c = np.array(hs[rng.integers(len(hs))].offset) + rng.normal(0, 1e4, 3)
        check(AABB(c - rng.uniform(0, 1e4, 3), c + rng.uniform(0, 1e4, 3)), hs, quirk)


@pytest.mark.parametrize("quirk", [False, True])
def test_fine_scales_on_far_offsets(quirk):
    """A scale far finer than the float64 spacing at its offset: hundreds of
    integers map to one world coordinate, and the refinement walks that
    many steps from the quotient's ceil or floor."""
    rng = np.random.default_rng(11)
    o, s = (1e12, -1e12, 3e11), (1e-7, 1e-6, 2e-5)
    hs = [header(np.array(o) - 1.0, np.array(o) + 1.0, s, o)]
    walked = 0
    for _ in range(200):
        lo = np.array(o) + rng.uniform(-0.5, 0.5, 3)
        hi = lo + rng.uniform(0.0, 0.4, 3)
        table = check(AABB(lo, hi), hs, quirk)
        x = (lo[0] - o[0]) / s[0]
        walked = max(walked, abs(int(table[0, 0, 0]) - math.ceil(x)))
    assert quirk or walked > 100


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("axes", [(0,), (1,), (2,), (0, 1, 2)])
@pytest.mark.parametrize("side", ["below", "above", "across"])
def test_boxes_beyond_int32(quirk, axes, side):
    """A box past int32 on one axis or on all: below it, above it, or
    across the whole range (clamped, or encoded as the inverted box)."""
    s, o = (0.001, 0.01, 0.1), (0.0, -1e6, 50.0)
    hs = [header((-1e12,) * 3, (1e12,) * 3, s, o),
          header((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (0.25, 0.5, 1.0), (0.0, 0.0, 0.0))]
    lo, hi = [0.0, -1e6, 50.0], [1.0, -1e6 + 10.0, 60.0]
    for k in axes:
        far = 4.0 * I32_MAX * s[k]
        lo[k], hi[k] = {"below": (o[k] - 2 * far, o[k] - far),
                        "above": (o[k] + far, o[k] + 2 * far),
                        "across": (o[k] - far, o[k] + far)}[side]
    table = check(AABB(lo, hi), hs, quirk)
    if side != "across" and not quirk:
        for k in axes:  # the inverted box on that axis
            assert table[0, :, k].tolist() == [I32_MAX, -I32_MAX - 1]


@pytest.mark.parametrize("quirk", [False, True])
def test_boxes_touching_or_missing_a_header_face(quirk):
    """The prefilter is inclusive: a query face on a header face keeps the
    file, one ulp off it drops the file."""
    h = header((10.0, 20.0, 30.0), (11.0, 21.0, 31.0), (0.001, 0.01, 0.1), (10.0, 20.0, 0.0))
    other = header((0.0, 0.0, 0.0), (100.0, 100.0, 100.0), (0.01, 0.01, 0.01), (0.0, 0.0, 0.0))
    for k in range(3):
        for face, off in (("min", -1), ("max", 1)):
            edge = (h.min if face == "min" else h.max)[k]
            for ulps, kept in ((0, True), (off, False)):
                lo, hi = list(h.min), list(h.max)
                v = near(edge, ulps)
                if face == "min":
                    lo[k], hi[k] = v - 5.0, v
                else:
                    lo[k], hi[k] = v, v + 5.0
                check(AABB(lo, hi), [h, other], quirk)
                got = query_bounds_table(AABB(lo, hi), HeaderTables.of([h]), parity_quirk=quirk)
                assert got[1].tolist() == [kept]


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("bad", [math.inf, math.nan, 1e300, 9.3e18, 2.0**62, 5e15, 1e14])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("corner", [0, 1])
def test_non_finite_and_huge_corners(quirk, bad, sign, corner):
    """A non-finite or huge coordinate: in a file the prefilter keeps, the
    scalar path's exception (math.ceil's), or its bounds; past what it can
    finish, its bounds at 1e12 (a quotient past 2^52 and int32 on the same
    side); NaN drops every file, as intersects does; a file the prefilter
    drops for another axis never raises."""
    hs = [header((0.0, 0.0, 0.0), (100.0, 100.0, 100.0), (0.01, 0.001, 0.1), (5.0, 5.0, 5.0)),
          header((200.0, 0.0, 0.0), (300.0, 100.0, 100.0), (0.01, 0.01, 0.01), (0.0, 0.0, 0.0))]
    lo, hi = [1.0, 1.0, 1.0], [50.0, 50.0, 50.0]
    (lo if corner == 0 else hi)[1] = sign * bad
    lo[1], hi[1] = min(lo[1], hi[1]), max(lo[1], hi[1])
    table = check(AABB(lo, hi), hs, quirk, far=1e12)
    if math.isfinite(bad):  # file 0 is kept; the far corner clamps
        far_corner = int(hi[1] == sign * bad)
        assert table is not None and table[0, far_corner, 1] in (2**31 - 1, -(2**31))
    # x misses both files: nothing is kept, nothing raises
    lo[0], hi[0] = 400.0, 500.0
    table = check(AABB(lo, hi), hs, quirk, far=1e12)
    assert table.tolist() == [EMPTY] * 3


def test_a_quotient_past_2_52_is_not_refined_but_clamped():
    """Quotients from 2^52 to 2^62, where the scalar path finishes and fits
    int64: its bounds, unclipped."""
    h = header((-1e30,) * 3, (1e30,) * 3, (1.0, 1.0, 1.0), (0.5, -0.5, 0.0))
    for e in range(52, 63):
        for v in (2.0**e, float(np.nextafter(2.0**e, 0)), 3 * 2.0 ** (e - 2)):
            for quirk in (False, True):
                check(AABB((-v, 1.0, -v), (v, 2.0, -1.0)), [h], quirk)


def test_a_non_finite_corner_raises_as_math_ceil():
    h = header((0.0, 0.0, 0.0), (100.0, 100.0, 100.0), (0.01, 0.01, 0.01), (0.0, 0.0, 0.0))
    with pytest.raises(OverflowError, match="cannot convert float infinity to integer"):
        query_bounds_table(AABB((-math.inf, 0.0, 0.0), (1.0, 1.0, 1.0)), HeaderTables.of([h]))


def test_a_negative_scale_raises_only_where_kept():
    """The scalar refinement never ends on a negative scale: the table
    raises for a kept file, and not for a dropped one; the quirk, with no
    refinement, gives the scalar path's truncations."""
    neg = header((0.0, 0.0, 0.0), (10.0, 10.0, 10.0), (0.01, -0.01, 0.01), (0.0, 0.0, 0.0))
    ok = header((20.0, 0.0, 0.0), (30.0, 10.0, 10.0), (0.01, 0.01, 0.01), (0.0, 0.0, 0.0))
    inside = AABB((1.0, 1.0, 1.0), (2.0, 2.0, 2.0))
    with pytest.raises(ValueError, match="positive scale"):
        query_bounds_table(inside, HeaderTables.of([neg, ok]))
    check(AABB((21.0, 1.0, 1.0), (22.0, 2.0, 2.0)), [neg, ok], False)
    check(inside, [neg, ok], True)


def test_a_zero_scale_raises_only_where_kept():
    z = header((0.0, 0.0, 0.0), (10.0, 10.0, 10.0), (0.0, 0.01, 0.01), (0.0, 0.0, 0.0))
    ok = header((20.0, 0.0, 0.0), (30.0, 10.0, 10.0), (0.01, 0.01, 0.01), (0.0, 0.0, 0.0))
    for quirk in (False, True):
        assert check(AABB((1.0, 1.0, 1.0), (2.0, 2.0, 2.0)), [z, ok], quirk) is None
        check(AABB((21.0, 1.0, 1.0), (22.0, 2.0, 2.0)), [z, ok], quirk)


# ---------------------------------------------------------------------------
# hypothesis
# ---------------------------------------------------------------------------

# coordinates and offsets to 1e9 and scales from 1e-4 keep the quotients of
# "free", "grid" and "face" coordinates under 2^52, where the refinement
# runs; "far" ones (1e11 and beyond) are compared at 1e12
finite = st.floats(-1e9, 1e9, allow_nan=False, allow_infinity=False)
scales = st.one_of(st.sampled_from([0.001, 0.01, 0.1, 1 / 3, 7.3e-4, 1e-4, 2.0]),
                   st.floats(1e-4, 10.0))


@st.composite
def headers(draw):
    n = draw(st.integers(1, 6))
    out = []
    for _ in range(n):
        s = [draw(scales) for _ in range(3)]
        o = [draw(st.one_of(st.just(0.0), finite)) for _ in range(3)]
        lo = [draw(finite) for _ in range(3)]
        hi = [v + draw(st.floats(0.0, 1e8)) for v in lo]
        out.append(header(lo, hi, s, o))
    return out


@st.composite
def coordinate(draw, hs, k):
    """An axis-k coordinate: anywhere, a grid point of a file moved by a
    few ulps, a header face moved by a few ulps, or far out."""
    h = hs[draw(st.integers(0, len(hs) - 1))]
    kind = draw(st.sampled_from(["free", "grid", "face", "far"]))
    if kind == "free":
        return draw(finite)
    if kind == "grid":  # near or inside the header box
        q0 = round((h.min[k] - h.offset[k]) / h.scale[k])
        span = int(min(2**30, (h.max[k] - h.min[k]) / h.scale[k]))
        v = h.offset[k] + h.scale[k] * (q0 + draw(st.integers(-3, span + 3)))
    elif kind == "face":
        v = draw(st.sampled_from([h.min[k], h.max[k]]))
    else:
        v = draw(st.sampled_from([-1.0, 1.0])) * draw(st.floats(1e11, 1e300))
    return near(v, draw(st.integers(-2, 2)))


@st.composite
def cases(draw):
    hs = draw(headers())
    a = [draw(coordinate(hs, k)) for k in range(3)]
    b = [draw(coordinate(hs, k)) for k in range(3)]
    lo = [min(x, y) for x, y in zip(a, b)]
    hi = [max(x, y) for x, y in zip(a, b)]
    return AABB(lo, hi), hs, draw(st.booleans())


@settings(max_examples=600, deadline=None, derandomize=True, database=None)
@given(cases())
def test_random_cases_equal_the_scalar_path(case):
    check(*case, far=1e12)
