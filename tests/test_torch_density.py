"""The port's ops/density.py against the JAX package's, on the CPU.

Host half (GridSpec3D, WinnerAccum, merge_winners_host): the port's copy
must give byte-identical output on the same numpy inputs, made from a seed.

Device half: the same blocks go through the JAX package's jitted
block_density_candidates / density_candidates_multi (on the CPU, as
tests/test_ops.py runs them) and through the port's
density_candidates_bits on CPU tensors (its plain version), whose BitMask
ops/compact.py compact_bits turns into indices. Three things are held, all
at tolerance 0 (they are sets of integers and exact f64 values):

  (i)   the winners after the host's exact merge are identical;
  (ii)  the port's candidates contain every f64 winner of the block;
  (iii) the port's candidate set equals the JAX function's.

(iii) could differ in the last bit of an f32 d2 if XLA's CPU code fused a
multiply with an add; over every case below it does not, so (iii) is held
everywhere too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_tpu import native as jax_native
from adhoc_queries_pointclouds_tpu.ops import density as jd
from adhoc_queries_pointclouds_tpu.ops import predicate as jax_predicate
from adhoc_queries_pointclouds_tpu.utils.aabb import AABB as JaxAABB
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch import native as torch_native
from adhoc_queries_pointclouds_torch.ops import compact as tc
from adhoc_queries_pointclouds_torch.ops import density as td
from adhoc_queries_pointclouds_torch.ops import predicate as tp
from adhoc_queries_pointclouds_torch.utils.aabb import AABB

I32 = np.iinfo(np.int32)

# (bounds min, bounds max, cell size, scale, offset)
GRIDS = {
    "unit": ((0.0, 0.0, 0.0), (10.0, 10.0, 10.0), 1.0, (0.001,) * 3, (0.0,) * 3),
    "offset": ((100.0, -50.0, 3.0), (107.3, -42.7, 9.1), 0.7300000000000001,
               (0.001, 0.002, 0.0005), (100.0, -50.0, 3.0)),
    "pow2": ((0.0, 0.0, 0.0), (8.0, 8.0, 8.0), 1.0, (0.001,) * 3, (0.0,) * 3),
    "fine": ((0.0, 0.0, 0.0), (10.0, 10.0, 10.0), 0.001, (0.001,) * 3, (0.0,) * 3),
    "wide": ((100.0, -50.0, 0.0), (2100.0, 1950.0, 123.7), 3.3,
             (0.001, 0.01, 0.0025), (90.0, -60.0, -5.0)),
    "degenerate_z": ((0.0, 0.0, 5.0), (10.0, 10.0, 5.0), 1.0, (0.01,) * 3, (0.0,) * 3),
    "far_offset": ((5e5, 4e6, -10.0), (5e5 + 300.0, 4e6 + 200.0, 90.0), 2.5,
                   (0.01, 0.01, 0.01), (5e5, 4e6, 0.0)),
    "tiny_scale": ((0.0, 0.0, 0.0), (10.0, 10.0, 10.0), 1.0, (1e-7,) * 3, (0.0,) * 3),
    "huge_cells": ((-3e6, -3e6, -3e6), (3e6, 3e6, 3e6), 2.9e6, (0.001,) * 3, (0.0,) * 3),
}


def grids(name):
    bmin, bmax, cell, scale, offset = GRIDS[name]
    return (jd.GridSpec3D.create(JaxAABB(bmin, bmax), cell),
            td.GridSpec3D.create(AABB(bmin, bmax), cell), scale, offset)


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ------------------------------------------------------------------ host half


def test_constants_match():
    assert td.EPS_REL == jd.EPS_REL and td.WINNER_DTYPE == jd.WINNER_DTYPE
    assert (td.I32_MAX, td.I32_MIN) == (jd.I32_MAX, jd.I32_MIN)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_create_matches(name):
    ref, got, _, _ = grids(name)
    assert (got.dims, got.bits, got.masks, got.cell_size) == (ref.dims, ref.bits, ref.masks,
                                                              ref.cell_size)


@pytest.mark.parametrize("bmax,cell,match", [
    ((1e6, 1e6, 1e6), 1e-2, "Too many cells"),
    ((1e6, 10.0, 10.0), 0.1, "too large for device tables"),
])
def test_grid_create_refuses_as_jax(bmax, cell, match):
    with pytest.raises(ValueError, match=match) as want:
        jd.GridSpec3D.create(JaxAABB((0.0,) * 3, bmax), cell)
    with pytest.raises(ValueError) as got:
        td.GridSpec3D.create(AABB((0.0,) * 3, bmax), cell)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_file_tables_byte_identical(name):
    ref, got, scale, offset = grids(name)
    a = ref._file_tables_impl(scale, offset)
    b = got._file_tables_impl(scale, offset)
    assert sorted(a) == sorted(b) == sorted(td.TABLE_KEYS) and len(a) == 15
    for key in a:
        assert same_bytes(a[key], b[key]), key
    assert got.file_tables(scale, offset) is got.file_tables(scale, offset)  # cached


def test_file_tables_refuse_non_positive_scale():
    _, got, _, offset = grids("unit")
    with pytest.raises(ValueError, match="non-positive LAS scale"):
        got._file_tables_impl((0.001, 0.0, 0.001), offset)


def raw_points(rng, n, scale, offset, bmin, bmax):
    """(n, 3) int32: most inside the grid, some beyond it, some at the int32
    extremes."""
    lo = (np.asarray(bmin) - np.asarray(offset)) / np.asarray(scale)
    hi = (np.asarray(bmax) - np.asarray(offset)) / np.asarray(scale)
    span = np.maximum(hi - lo, 1.0)
    raw = lo + rng.random((n, 3)) * span
    far = rng.random(n) < 0.1
    raw[far] += (rng.random((int(far.sum()), 3)) - 0.3) * 3 * span
    raw = np.clip(np.round(raw), I32.min, I32.max).astype(np.int64)
    raw[:4, 0] = [I32.min, I32.max, 0, -1]
    raw[4:8, 2] = [I32.min, I32.max, I32.min + 1, I32.max - 1]
    return raw.astype(np.int32)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_exact_keys_d2_byte_identical(name, monkeypatch):
    ref, got, scale, offset = grids(name)
    rng = np.random.default_rng(31)
    bmin, bmax = GRIDS[name][0], GRIDS[name][1]
    raw = raw_points(rng, 3000, scale, offset, bmin, bmax)
    world = raw.astype(np.float64) * np.asarray(scale) + np.asarray(offset)
    world[8] = [np.nan, 1e300, -1e300]
    for a, b in zip(ref.exact_keys_d2(world), got.exact_keys_d2(world)):
        assert same_bytes(a, b)
    assert same_bytes(ref.exact_cells(world), got.exact_cells(world))
    cols = (raw[:, 0], raw[:, 1], raw[:, 2], scale, offset)
    native_out = got.exact_keys_d2_raw(*cols)
    for a, b in zip(ref.exact_keys_d2_raw(*cols), native_out):
        assert same_bytes(a, b)
    gidx = rng.permutation(len(raw)).astype(np.int64)
    assert same_bytes(ref.make_winners_raw(*cols, gidx, 3), got.make_winners_raw(*cols, gidx, 3))
    assert same_bytes(ref.make_winners(world, gidx, 2), got.make_winners(world, gidx, 2))
    # the numpy fallback of the fused native pass
    monkeypatch.setattr(torch_native, "density_exact", lambda *a, **k: None)
    for a, b in zip(native_out, got.exact_keys_d2_raw(*cols)):
        assert same_bytes(a, b)


def winner_batches(rng, n_batches, n_keys):
    gidx = 0
    out = []
    for _ in range(n_batches):
        n = int(rng.integers(0, 300))
        b = np.zeros(n, dtype=td.WINNER_DTYPE)
        b["key"] = rng.integers(0, n_keys, n)
        b["d2"] = rng.integers(0, 5, n) * 0.25  # quantized: exact ties are common
        b["file_idx"] = rng.integers(0, 3, n)
        b["gidx"] = np.arange(gidx, gidx + n)
        gidx += n
        out.append(b)
    return out


@pytest.mark.parametrize("fallback", [False, True], ids=["native", "numpy"])
@pytest.mark.parametrize("floor", [64, 1 << 19])
def test_winner_accum_byte_identical(monkeypatch, floor, fallback):
    if fallback:
        for mod in (jax_native, torch_native):
            monkeypatch.setattr(mod, "winner_dedupe", lambda *a, **k: None)
            monkeypatch.setattr(mod, "winner_merge", lambda *a, **k: None)
    batches = winner_batches(np.random.default_rng(7), 41, 60)
    ref, got = jd.WinnerAccum(floor=floor), td.WinnerAccum(floor=floor)
    for s, b in enumerate(batches):
        ref.add(b, s % 5)  # file_seq decides ties before gidx
        got.add(b, s % 5)
    assert same_bytes(ref.result(), got.result()) and len(got.result()) > 0
    assert same_bytes(td.WinnerAccum().result(), jd.WinnerAccum().result())


def test_winner_accum_file_seq_orders_ties():
    a = np.zeros(1, dtype=td.WINNER_DTYPE)
    a[0] = (3, 1.0, 0, 900)  # file seq 0, huge gidx
    b = np.zeros(1, dtype=td.WINNER_DTYPE)
    b[0] = (3, 1.0, 1, 2)  # file seq 1, tiny gidx, same key and d2
    acc = td.WinnerAccum()
    acc.add(a, 0)
    acc.add(b, 1)
    got = acc.result()
    assert len(got) == 1 and got["gidx"][0] == 900


def test_merge_winners_host_byte_identical():
    batches = winner_batches(np.random.default_rng(11), 23, 40)
    ref = got = None
    for b in batches:
        ref = jd.merge_winners_host(ref, b)
        got = td.merge_winners_host(got, b)
        assert same_bytes(ref, got)
    assert same_bytes(td.merge_winners_host(None, batches[0][:0]),
                      jd.merge_winners_host(None, batches[0][:0]))
    soa = [tuple(np.ascontiguousarray(b[f]) for f in ("key", "d2", "file_idx", "gidx", "file_idx"))
           for b in (ref[:20], ref[10:])]
    for x, y in zip(jd._merge_soa_py(*soa), td._merge_soa_py(*soa)):
        assert same_bytes(x, y)


# ---------------------------------------------------------------- device half


def boundary_points(grid, scale, offset):
    tables = grid.file_tables(scale, offset)
    pts = []
    for ax, name in enumerate("xyz"):
        b = tables[f"b{name}"].astype(np.int64)
        interior = b[(b > I32.min) & (b < I32.max)]
        for t in interior[1:-1]:
            for delta in (-1, 0, 1):
                p = [5000, 5000, 5000]
                p[ax] = int(np.clip(t + delta, I32.min + 1, I32.max - 2))
                pts.append(p)
    return np.asarray(pts, np.int32)


def block_cases():
    """name -> (grid name, raw (n, 3) int32, mask or None, n_valid or None):
    the cases of tests/test_ops.py TestDensity, and seeded random blocks."""
    rng = np.random.default_rng(7)
    c = 5_000_000
    vals = [0, 999, 1000, 1001, 4999, 5000, 5001, 9999, 10000]
    random_unit = rng.integers(0, 10_001, (5000, 3)).astype(np.int32)
    random_unit[:, 2] //= 2
    cases = {
        "single_point": ("unit", np.array([[450, 460, 470]], np.int32), None, None),
        "same_cell": ("unit", np.array([[480, 460, 470], [450, 440, 460]], np.int32), None, None),
        "different_cells": ("unit", np.array([[450, 460, 470], [1350, 450, 440]], np.int32),
                            None, None),
        "masked": ("unit", np.array([[1000, 1000, 1000], [2000, 2000, 2000], [3000, 3000, 3000]],
                                    np.int32), np.array([False, True, False]), None),
        "oracle_random": ("unit", random_unit, None, None),
        "boundary_epsilon": ("offset", boundary_points(grids("offset")[1], *GRIDS["offset"][3:]),
                             None, None),
        "exact_integer_boundaries": (
            "unit", np.asarray([[a, b, d] for a in vals for b in vals for d in vals], np.int32),
            None, None),
        "max_face_pow2_wrap": ("pow2", np.array([[100, 100, 100], [8000, 100, 100]], np.int32),
                               None, None),
        "near_tie": ("tiny_scale", np.array([[c + 1000, c, c], [c - 1001, c, c],
                                             [c, c + 1000, c]], np.int32), None, None),
        "exact_tie": ("unit", np.array([[600, 500, 500], [400, 500, 500], [500, 600, 500],
                                        [500, 500, 400], [500, 500, 500 + 101]], np.int32),
                      None, None),
        "one_point_per_cell": ("fine", rng.integers(0, 10000, (512, 3)).astype(np.int32),
                               None, None),
    }
    for name in sorted(GRIDS):
        bmin, bmax, _, scale, offset = GRIDS[name]
        for trial, n in enumerate((777, 4096)):
            raw = raw_points(rng, n, scale, offset, bmin, bmax)
            mask = rng.random(n) < (0.6, 1.0)[trial]
            cases[f"random_{name}_{n}"] = (name, raw, mask, n - (5, 0)[trial])
    return cases


CASES = block_cases()


def jax_tables(grid, scale, offset):
    return {k: jnp.asarray(v) for k, v in grid.file_tables(scale, offset).items()}


def port_candidates(xyz, mask_rows, nvs, tables, block_size, **packed):
    """The port's candidate indices per block through the public entry and
    the collect path's compaction, as the engine takes them."""
    t = td.tables_to_device(tables, "cpu")
    mask = tp.pack_mask_bits(torch.from_numpy(mask_rows))
    nvs_t = torch.from_numpy(np.asarray(nvs, np.int32))
    out = td.density_candidates_bits(tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in xyz),
                                     mask, nvs_t, t, block_size, **packed)
    counts = out.counts.numpy()
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    idx = tc.compact_bits(out.bits, out.chunks, torch.from_numpy(offsets), int(counts.sum()),
                          block_size).numpy()
    assert np.array_equal(out.chunks.sum(1).numpy(), counts)
    return [idx[o : o + c].astype(np.int64) for o, c in zip(offsets, counts)]


def exact_winners(grid, raw, idx, scale, offset):
    idx = np.asarray(idx, np.int64)
    rows = grid.make_winners_raw(raw[idx, 0], raw[idx, 1], raw[idx, 2], scale, offset, idx, 0)
    return td.merge_winners_host(None, rows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_candidates_match_jax(case):
    name, raw, mask, n_valid = CASES[case]
    ref_grid, grid, scale, offset = grids(name)
    n = len(raw)
    mask = np.ones(n, bool) if mask is None else mask
    n_valid = n if n_valid is None else n_valid
    cnt, idx = jd.block_density_candidates(
        jnp.asarray(raw[:, 0]), jnp.asarray(raw[:, 1]), jnp.asarray(raw[:, 2]),
        jnp.asarray(mask), n_valid, jax_tables(ref_grid, scale, offset), cap=n)
    ref = np.asarray(idx[: int(cnt)], np.int64)
    (got,) = port_candidates([raw[None, :, a] for a in range(3)], mask[None], [n_valid],
                             grid.file_tables(scale, offset), n)
    assert np.all(np.diff(got) > 0)  # ascending
    valid = np.nonzero(mask & (np.arange(n) < n_valid))[0]
    assert set(got) <= set(valid)
    # (i) winners identical after the host's exact merge
    want = exact_winners(grid, raw, ref, scale, offset)
    assert same_bytes(exact_winners(grid, raw, got, scale, offset), want)
    # (ii) every f64 winner of the block is a candidate
    truth = exact_winners(grid, raw, valid, scale, offset)
    assert set(truth["gidx"]) <= set(got)
    assert same_bytes(truth, want)
    # (iii) the same candidate set
    assert np.array_equal(got, ref)
    if case == "exact_tie":
        assert list(got) == [0, 1, 2, 3]  # all four ties survive, the farther point does not
    if case.startswith("random_degenerate_z"):
        assert len(got) > 0


def test_flagged_points_survive_wholesale():
    """Beyond the max face, at the int32 extremes, and every point of a grid
    with a zero-extent axis whose coordinate is not the face itself."""
    _, grid, scale, offset = grids("unit")
    raw = np.array([[500, 500, 500], [520, 500, 500], [10_000, 500, 500], [20_000, 1, 1],
                    [I32.max, 5, 5], [I32.min, 5, 5], [5, 5, I32.max]], np.int32)
    (got,) = port_candidates([raw[None, :, a] for a in range(3)], np.ones((1, 7), bool), [7],
                             grid.file_tables(scale, offset), 7)
    assert list(got) == [0, 2, 3, 4, 5, 6]


MULTI_WIDTHS = [(0, 4, 12), (20, 28, 32), (8, 16, 24), (32, 32, 32), (3, 7, 13)]


def multi_blocks(rng, widths, k_blocks, block_size):
    """K blocks whose axis a spans 2^widths[a] values above a per-block base,
    with a grid over part of the data."""
    raw = np.empty((k_blocks, block_size, 3), np.int32)
    bases = np.zeros((k_blocks, 3), np.int64)
    for a, w in enumerate(widths):
        if w == 32:
            raw[:, :, a] = rng.integers(I32.min, I32.max + 1, (k_blocks, block_size))
        else:
            bases[:, a] = rng.integers(-1000, 1000, k_blocks) * (1 << max(w - 3, 0))
            raw[:, :, a] = bases[:, a, None] + rng.integers(0, 1 << w, (k_blocks, block_size))
    lo = raw.reshape(-1, 3).min(0).astype(np.float64)
    hi = raw.reshape(-1, 3).max(0).astype(np.float64)
    scale, offset = (0.01, 0.01, 0.01), (0.0, 0.0, 0.0)
    bmin = (lo + 0.1 * (hi - lo)) * 0.01
    bmax = np.maximum((lo + 0.8 * (hi - lo)) * 0.01, bmin + 1.0)
    cell = float((bmax - bmin).max() / 40)
    return raw, bases, tuple(bmin), tuple(bmax), cell, scale, offset


@pytest.mark.parametrize("widths", MULTI_WIDTHS, ids=str)
@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_multi_block_candidates_match_jax(widths, packed):
    k_blocks, block_size = 3, 2048
    rng = np.random.default_rng(sum(widths) + packed)
    raw, bases, bmin, bmax, cell, scale, offset = multi_blocks(rng, widths, k_blocks, block_size)
    ref_grid = jd.GridSpec3D.create(JaxAABB(bmin, bmax), cell)
    grid = td.GridSpec3D.create(AABB(bmin, bmax), cell)
    masks = rng.random((k_blocks, block_size)) < np.array([[1.0], [0.5], [0.02]])
    nvs = np.array([block_size, block_size - 3, 900], np.int32)
    tables = grid.file_tables(scale, offset)
    cols = [np.ascontiguousarray(raw[:, :, a]) for a in range(3)]
    if packed:
        planes = []
        for a, w in enumerate(widths):
            out = np.zeros((k_blocks, host.packed_row_width(w, block_size)), np.uint8)
            for k in range(k_blocks):
                host.pack_bits_into(out[k], cols[a][k], w, int(bases[k, a]), block_size)
            planes.append(out)
        bases32 = bases.astype(np.int32)
        jcols = [jax_predicate.unpack_bits_jnp(jnp.asarray(planes[a]), widths[a], block_size)
                 + jnp.asarray(bases32[:, a : a + 1]) for a in range(3)]
        got = port_candidates(planes, masks, nvs, tables, block_size,
                              bases=torch.from_numpy(bases32), widths=widths)
    else:
        jcols = [jnp.asarray(c) for c in cols]
        got = port_candidates(cols, masks, nvs, tables, block_size)
    multi = jax.jit(jd.density_candidates_multi, static_argnames="cap")
    cnts, idx = multi(*jcols, jnp.asarray(masks & (np.arange(block_size) < nvs[:, None])),
                      jnp.asarray(nvs), jax_tables(ref_grid, scale, offset), cap=block_size)
    assert sum(len(g) for g in got) > 0
    for k in range(k_blocks):
        ref = np.asarray(idx[k, : int(cnts[k])], np.int64)
        assert np.array_equal(got[k], ref)
        valid = np.nonzero(masks[k] & (np.arange(block_size) < nvs[k]))[0]
        truth = exact_winners(grid, raw[k], valid, scale, offset)
        assert set(truth["gidx"]) <= set(got[k])
        assert same_bytes(exact_winners(grid, raw[k], got[k], scale, offset), truth)


def test_leaders_plain_matches_the_candidates_margin():
    """density_leaders_plain: one (key, least d2) per occupied cell, and the
    candidates are exactly the points within the margin of their leader."""
    _, grid, scale, offset = grids("unit")
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 10_001, (2, 3000, 3)).astype(np.int32)
    t = td.tables_to_device(grid.file_tables(scale, offset), "cpu")
    xyz = [torch.from_numpy(np.ascontiguousarray(raw[:, :, a])) for a in range(3)]
    rows = torch.ones((2, 3000), dtype=torch.bool)
    nvs = torch.tensor([3000, 2000], dtype=torch.int32)
    leaders = td.density_leaders_plain(*xyz, rows, nvs, t)
    cand = td.density_candidates_plain(*xyz, rows, nvs, t)
    for k, (keys, lead) in enumerate(leaders):
        assert torch.all(keys[1:] > keys[:-1]) and len(keys) == len(lead) <= 1000
        assert int(cand[k].sum()) >= len(keys)
        assert not cand[k, int(nvs[k]):].any()


def test_table_slots_and_wrapper_checks():
    assert td.table_slots(0) == 64 and td.table_slots(33) == 128 and td.table_slots(64) == 128
    assert td.table_slots(1 << 21) == 1 << 22
    _, grid, scale, offset = grids("unit")
    t = td.tables_to_device(grid.file_tables(scale, offset), "cpu")
    assert t["eps_abs"].shape == (1,) and t["bx"].dtype == torch.int32
    assert td._check_tables(t, torch.device("cpu")) == (10, 10, 10)
    bad = dict(t, crx=t["crx"][:-1])
    with pytest.raises(ValueError, match="bx"):
        td._check_tables(bad, torch.device("cpu"))
    step = ((torch.zeros((1, 8), dtype=torch.int32),) * 3, torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), t, 8)
    with pytest.raises(ValueError, match="power of two"):
        td.density_leaders(*step, slots=48)
    with pytest.raises(ValueError, match="take CUDA tensors"):  # the passes are kernels only
        td.density_leaders(*step, slots=64)
