"""The port's resident datasets against the JAX package's, on the CPU.

The same files are loaded by adhoc_queries_pointclouds_tpu's ResidentDataset
(on the 8-device CPU mesh, so its blocks are padded to a multiple of 8) and
by the port's (device="cpu", no padding). Counts, collects (hit attributes
and written LAS bytes) and density winners (key, d2, file, gidx) must be
equal, and each count must equal the port's streamed run_query. Everything
compared is an integer, bytes or an f64 computed by the same host code from
the same indices: the tolerance is 0.

The dataset mirrors tests/test_resident.py (3 files x 25,000 points, seed
17, blocks of 2^14), in point format 3 so that GPS-time queries run too.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_tpu.models import query as jax_query
from adhoc_queries_pointclouds_tpu.parallel.resident import ResidentDataset as JaxResident
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch.formats import open_point_cloud, synth
from adhoc_queries_pointclouds_torch.models import query as torch_query
from adhoc_queries_pointclouds_torch.parallel import resident, step
from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset
from adhoc_queries_pointclouds_torch.utils.aabb import (
    clamp_bounds_to_i32,
    local_query_bounds,
    parse_aabb,
)
from adhoc_queries_pointclouds_torch.utils.timing import StageTimer
from test_torch_engine import make_plan

BLOCK = 1 << 14
ATTRS = ("position", "classification", "gps_time")
BOX = "100200;200300;10;100700;200800;60"
# query name -> make_plan arguments
QUERIES = {
    "box": dict(box=BOX),
    "box_all": dict(box="-1e9;-1e9;-1e9;1e9;1e9;1e9"),
    # about half of every block's points: partial blocks with many hits
    "box_half": dict(box="-1e9;-1e9;-1e9;1e9;1e9;50"),
    "box_disjoint": dict(box="0;0;0;10;10;10"),
    # every file, in a box a density grid can cover
    "box_files": dict(box="99000;199000;-10;104000;202000;200"),
    "class6": dict(cls=6),
    "class19": dict(cls=19),
    "time": dict(time=(200_000.0, 800_000.0)),
    "time_none": dict(time=(2e6, 3e6)),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_resident")
    synth.write_dataset(root, n_files=3, points_per_file=25_000, seed=17, formats=("last",),
                        point_format=3)
    return root / "last"


@pytest.fixture(scope="module")
def both(data):
    """(the JAX package's resident dataset, the port's), all three attrs."""
    return (JaxResident.load(data, block_size=BLOCK, attrs=ATTRS),
            ResidentDataset.load(data, device="cpu", block_size=BLOCK, attrs=ATTRS))


def plans(density=None, scope="global", **fields):
    """The JAX package's plan and the port's from the same arguments."""
    out = []
    for eng, q in ((jax_engine, jax_query), (torch_engine, torch_query)):
        plan = make_plan(eng, **fields)
        if density is not None:
            plan = dataclasses.replace(plan, density=q.DensityConfig(density, scope))
        out.append(plan)
    return out


def test_layout_has_no_padding(data, both):
    """One device: a block for each (file, block) task, every row a file's."""
    ref, got = both
    assert got.device == torch.device("cpu") and got.devices == [got.device]
    assert got.n_blocks == 6 and ref.n_blocks == 8  # JAX pads to the 8-device mesh
    assert got.file_idx.tolist() == [0, 0, 1, 1, 2, 2]
    assert got.nvs.tolist() == [BLOCK, 25_000 - BLOCK] * 3
    assert got.block_start.tolist() == [0, BLOCK] * 3
    (shard,) = got.shards
    assert (shard.lo, shard.hi) == (0, 6)
    assert torch.equal(shard.nvs, torch.from_numpy(got.nvs))
    assert got.total_points == ref.total_points == 75_000
    assert got.resident_bytes == 6 * BLOCK * 21 == got.per_device_bytes[0]
    for name in ("xs", "ys", "zs", "cls", "ths", "tls"):
        t = getattr(shard, name)
        assert t.is_contiguous() and t.shape == (6, BLOCK)
        assert np.array_equal(t.numpy(), np.asarray(getattr(ref, name))[ref.file_idx >= 0])
    assert shard.cls.dtype == torch.uint8


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_count_matches_jax_and_streaming(data, both, name):
    ref, got = both
    jax_plan, torch_plan = plans(**QUERIES[name])
    want = ref.count(jax_plan)
    assert got.count(torch_plan) == want
    streamed = torch_engine.run_query(data, torch_plan, device="cpu", block_size=BLOCK,
                                      use_index=False)
    assert streamed.match_count == want
    assert (want == 0) == name.endswith(("disjoint", "19", "none"))


def test_repeated_distinct_boxes_match_the_oracle(data, both):
    """Distinct boxes give distinct, oracle-correct counts (nothing cached)."""
    _, got = both
    worlds = []
    for f in sorted(data.iterdir()):
        r = open_point_cloud(f)
        worlds.append(r.positions_world())
        r.close()
    for dx in (100.0, 300.0, 500.0):
        box = parse_aabb(f"100200;200300;10;{100200 + dx};200800;60")
        want = sum(int(np.sum(box.contains_points(w))) for w in worlds)
        assert got.count(torch_query.QueryPlan(bounds=torch_query.BoundsQuery(box))) == want > 0


def _hits_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.file_idx == y.file_idx
        for field in ("position_world", "classification", "color", "intensity"):
            assert np.array_equal(getattr(x, field), getattr(y, field)), field


@pytest.mark.parametrize("name", ["box", "box_half", "box_all", "class6", "time", "box_disjoint"])
def test_collect_matches_jax(both, tmp_path, name):
    """Collect with -o and keep_hits: the JAX package's hits and LAS bytes."""
    ref, got = both
    outs = []
    for ds, plan, sub in ((ref, plans(**QUERIES[name])[0], "jax"),
                          (got, plans(**QUERIES[name])[1], "torch")):
        out = tmp_path / sub
        out.mkdir()
        count, emitter = ds.collect(plan, output_dir=out, keep_hits=True)
        outs.append((count, emitter, {f.name: f.read_bytes() for f in out.iterdir()}))
    (want, ref_emitter, ref_files), (count, emitter, files) = outs
    assert count == want == sum(h.count for h in emitter.all_hits)
    _hits_equal(emitter.all_hits, ref_emitter.all_hits)
    assert files == ref_files
    assert bool(files) == (want > 0)


def test_collect_returns_every_point_with_no_cap(both):
    """Many matches in every block: the JAX package retries past its cap
    (cap=8), the port reads each block's true count and compacts exactly
    that many; both return every point of the half box, and every point of
    the whole dataset."""
    ref, got = both
    jax_plan, torch_plan = plans(**QUERIES["box_half"])
    want, ref_emitter = ref.collect(jax_plan, cap=8, keep_hits=True)
    count, emitter = got.collect(torch_plan, keep_hits=True)
    assert count == want > 20_000
    _hits_equal(emitter.all_hits, ref_emitter.all_hits)
    jax_plan, torch_plan = plans(**QUERIES["box_all"])
    count, emitter = got.collect(torch_plan, keep_hits=True)
    assert count == got.total_points == ref.collect(jax_plan, cap=8)[0]
    assert [h.count for h in emitter.all_hits] == [25_000] * 3


def block_counts(ds, plan) -> np.ndarray:
    """The hits of every row of ds, from the collect's own masks."""
    boxes, _ = ds._box_table(plan)
    return np.concatenate([step.collect_mask(*ds._operands(plan, s, s.lo, s.hi, boxes))
                           .counts.numpy() for s in ds.shards])


def head_of(all_hits, k: int) -> list:
    """The first k hits of a collect's all_hits, files in order, one entry
    a file as finalize_file leaves them."""
    out = []
    for h in all_hits:
        n = min(h.count, max(k, 0))
        k -= n
        out.append(dataclasses.replace(h, **{f: getattr(h, f)[:n] for f in (
            "position_world", "classification", "color", "intensity")}))
    return out


def limited_against_full(ds, plan, limit: int, monkeypatch) -> tuple[int, set]:
    """A collect with limit against the full gather on the same dataset: the
    same count, the full gather's first limit hits, one entry a file, and
    emit_counts moved by this preview alone (the full gather moves it not).
    Returns (count, indices of the files the limited collect opened)."""
    resident.reset_emit_counts()
    want, full = ds.collect(plan, keep_hits=True)
    assert resident.emit_counts == {"previews": 0, "hits": 0, "gathered": 0}
    opened = []
    real_open = resident.open_point_cloud
    monkeypatch.setattr(resident, "open_point_cloud",
                        lambda f: opened.append(ds.files.index(f)) or real_open(f))
    count, emitter = ds.collect(plan, keep_hits=True, limit=limit)
    assert count == want
    _hits_equal(emitter.all_hits, head_of(full.all_hits, limit))
    gathered = min(max(limit, 0), count)
    assert emitter.total == sum(h.count for h in emitter.all_hits) == gathered
    assert resident.emit_counts == {"previews": 1, "hits": count, "gathered": gathered}
    assert opened == sorted(set(opened))
    assert set(opened) == {i for i, h in enumerate(emitter.all_hits) if h.count}
    return count, set(opened)


# case -> (query, the limit from the rows' hits c, what the case must show
# about c and the limit)
LIMITS = {
    "zero": ("box_half", lambda c: 0, lambda c, k: c[0] > 0),
    "negative": ("box_half", lambda c: -3, lambda c, k: c[0] > 0),
    "one": ("box_half", lambda c: 1, lambda c, k: c[0] > 1),
    "inside_a_partial_block": ("box_half", lambda c: int(c[0]) // 2,
                               lambda c, k: 1 < k < c[0] < BLOCK),
    "across_a_block": ("box_half", lambda c: int(c[0]) + 7,
                       lambda c, k: c[0] < k < c[0] + c[1] and c[1] < 25_000 - BLOCK),
    "across_a_file": ("box_half", lambda c: int(c[:2].sum()) + 7,
                      lambda c, k: c[:2].sum() < k < c[:3].sum()),
    "full_block_clipped": ("box_all", lambda c: 100, lambda c, k: k < c[0] == BLOCK),
    "across_full_blocks": ("box_all", lambda c: BLOCK + 9,
                           lambda c, k: BLOCK < k < 25_000 and c[1] == 25_000 - BLOCK),
    "the_count": ("box_half", lambda c: int(c.sum()), lambda c, k: k > BLOCK),
    "above_the_count": ("box", lambda c: int(c.sum()) + 1, lambda c, k: k - 1 > 0),
    "far_above_the_count": ("class6", lambda c: 10**9, lambda c, k: c.sum() > 0),
    "no_hits": ("box_disjoint", lambda c: 10, lambda c, k: c.sum() == 0),
    "time_window": ("time", lambda c: int(c.sum()) // 3, lambda c, k: 0 < k),
}


@pytest.mark.parametrize("case", sorted(LIMITS))
def test_limited_collect_is_the_full_gathers_head(both, monkeypatch, case):
    """A collect with a limit: the count of every match, the first limit
    hits of the full gather and only their files opened."""
    _, ds = both
    name, limit_of, shows = LIMITS[case]
    plan = plans(**QUERIES[name])[1]
    c = block_counts(ds, plan)
    limit = limit_of(c)
    assert shows(c, limit)
    count, opened = limited_against_full(ds, plan, limit, monkeypatch)
    assert count == int(c.sum())
    if case == "across_a_file":
        assert opened == {0, 1}


def _winners_equal(a, b):
    assert a.dtype == b.dtype and len(a) == len(b)
    for field in ("key", "d2", "file_idx", "gidx"):
        assert np.array_equal(a[field], b[field]), field


@pytest.mark.parametrize("scope", ["global", "file"])
@pytest.mark.parametrize("name, cell", [("box", 5.0), ("box_files", 40.0), ("class6", 20.0),
                                        ("time", 30.0)])
def test_density_winners_match_jax(both, name, cell, scope):
    ref, got = both
    jax_plan, torch_plan = plans(density=cell, scope=scope, **QUERIES[name])
    want_files, want_global = ref.density_states(jax_plan)
    files, global_state = got.density_states(torch_plan)
    if scope == "global":
        assert files == {} and want_files == {}
        _winners_equal(global_state, want_global)
        assert len(global_state) > 0
    else:
        assert global_state is None and want_global is None
        assert sorted(files) == sorted(want_files) != []
        for i in files:
            _winners_equal(files[i], want_files[i])
    assert got.count(torch_plan) == ref.count(jax_plan)


@pytest.mark.parametrize("scope", ["global", "file"])
def test_density_collect_matches_jax(both, tmp_path, scope):
    """Density with -o and keep_hits: the winners' attributes and the LAS
    bytes of the JAX package's resident density collect."""
    ref, got = both
    outs = []
    for ds, plan, sub in ((ref, plans(density=5.0, scope=scope, **QUERIES["box"])[0], "jax"),
                          (got, plans(density=5.0, scope=scope, **QUERIES["box"])[1], "torch")):
        out = tmp_path / sub
        out.mkdir()
        count, emitter = ds.collect(plan, output_dir=out, keep_hits=True)
        outs.append((count, emitter, {f.name: f.read_bytes() for f in out.iterdir()}))
    (want, ref_emitter, ref_files), (count, emitter, files) = outs
    assert count == want > 0
    _hits_equal(emitter.all_hits, ref_emitter.all_hits)
    assert files == ref_files != {}


def test_density_file_seq_counts_pruned_files(both):
    """A box over file 1 only: the header prefilter drops files 0 and 2, and
    the winners are the JAX package's (file_seq counts dropped files too)."""
    ref, got = both
    jax_plan, torch_plan = plans(density=2.0, box="101100;200000;0;101900;201000;100")
    _winners_equal(got.density_states(torch_plan)[1], ref.density_states(jax_plan)[1])
    assert set(got.density_states(torch_plan)[1]["file_idx"].tolist()) == {1}


def _profiled_events(fn, tmp_path) -> list[dict]:
    """The complete events of a CPU torch.profiler trace of fn()."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def test_a_profiled_stage_is_an_engine_span(tmp_path):
    """StageTimer.stage("scan") under a profiler is the span engine.scan,
    and its seconds, count and bytes are kept as before."""
    timer = StageTimer()

    def scan():
        with timer.stage("scan", 1024):
            torch.ones(8).sum()

    events = _profiled_events(scan, tmp_path)
    (ev,) = [e for e in events if e["name"] == "engine.scan"]
    assert any(e["name"].startswith("aten::") and ev["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= ev["ts"] + ev["dur"] for e in events)
    assert timer.counts["scan"] == 1 and timer.bytes["scan"] == 1024
    assert 0 < timer.seconds["scan"] and "scan:" in timer.report()


def test_a_profiled_streamed_query_has_its_stages(data, tmp_path):
    """run_query's stages appear in a profiler trace as engine.<stage>."""
    _, plan = plans(box=BOX)
    events = _profiled_events(lambda: torch_engine.run_query(
        data, plan, device="cpu", block_size=BLOCK), tmp_path)
    names = {e["name"] for e in events}
    assert {"engine.open", "engine.scan"} <= names


def test_density_host_work_is_two_spans_a_block(both, tmp_path):
    """A resident density count under a profiler: resident.density.exact
    and resident.density.merge once for each block with candidates, each
    exact before its merge, the count the JAX package's."""
    jax_ds, ds = both
    jplan, tplan = plans(box=BOX, density=5.0)
    got = []
    events = _profiled_events(lambda: got.append(ds.count(tplan)), tmp_path)
    assert got == [jax_ds.count(jplan)] and got[0] > 0
    exact = sorted(e["ts"] for e in events if e["name"] == "resident.density.exact")
    merge = sorted(e["ts"] for e in events if e["name"] == "resident.density.merge")
    assert exact and len(exact) == len(merge)
    assert all(x < m for x, m in zip(exact, merge))
    assert all(m < x for m, x in zip(merge, exact[1:]))
    assert len([e for e in events if e["name"] == "resident.operands"]) >= 1


def test_count_rejects_a_collect_plan(both, tmp_path):
    for ds, plan in zip(both, plans(box=BOX, output_dir=tmp_path)):
        with pytest.raises(NotImplementedError, match="collect"):
            ds.count(plan)


@pytest.mark.parametrize("attrs, query, missing", [
    (("position", "classification"), "time", "gps_time"),
    (("classification",), "box", "position"),
    (("position",), "class6", "classification"),
])
def test_missing_columns_raise_as_jax(data, attrs, query, missing):
    """A query over a column the dataset was loaded without raises
    ValueError naming it, in count and collect, as the JAX package's does."""
    ref = JaxResident.load(data, block_size=BLOCK, attrs=attrs)
    got = ResidentDataset.load(data, device="cpu", block_size=BLOCK, attrs=attrs)
    jax_plan, torch_plan = plans(**QUERIES[query])
    for ds, plan in ((ref, jax_plan), (got, torch_plan)):
        with pytest.raises(ValueError, match=missing):
            ds.count(plan)
        with pytest.raises(ValueError, match=missing):
            ds.collect(plan)
    if missing != "classification":  # the JAX package's density fails otherwise there
        for ds, plan in zip((ref, got), plans(density=10.0, **QUERIES[query])):
            with pytest.raises(ValueError, match=missing):
                ds.count(plan)


def test_cuda_without_cuda_raises(data, monkeypatch):
    """A dataset asked for on CUDA is never loaded on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidentDataset.load(data, device="cuda", block_size=BLOCK)


# ---------------------------------------------------------------------------
# the box operands: one table of every file's bounds a request, rows by one
# gather (utils/bounds_table.py), against the per-file assembly it replaced
# ---------------------------------------------------------------------------

# files of 2, 2, 2 and 4 blocks: 2 shards cut file 2 (rows 4 | 5), 3 shards
# file 3 (rows 6-7 | 8-9) and pad two rows
UNEVEN_SHARDS = [1, 2, 3]


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_resident_uneven")
    synth.write_dataset(root / "a", n_files=3, points_per_file=25_000, seed=17,
                        formats=("last",), point_format=3)
    synth.write_dataset(root / "b", n_files=1, points_per_file=50_000, seed=23,
                        formats=("last",), point_format=3, offset=(102500.0, 200000.0, 0.0))
    files = sorted((root / "a" / "last").iterdir()) + [root / "b" / "last" / "file_0.last"]
    jax = JaxResident.load(files, block_size=BLOCK, attrs=ATTRS)
    return files, jax, {d: ResidentDataset.load(files, devices=["cpu"] * d, block_size=BLOCK,
                                                attrs=ATTRS) for d in UNEVEN_SHARDS}


def seeded_boxes(seed: int, n: int) -> list[str]:
    """n boxes over the uneven dataset's files (x 100000-104500), some past
    its ends, some cutting every file, some missing all."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.uniform([99_800, 199_900, -5], [103_600, 200_950, 95])
        b = a + rng.uniform(0, 1, 3) * rng.choice([10.0, 500.0, 3000.0]) * [1, 0.5, 0.05]
        out.append(";".join(repr(float(v)) for v in (*a, *b)))
    return out


def per_file_assembly(ds, plan, lo: int, hi: int) -> np.ndarray:
    """The (2, hi - lo, 3) bounds of rows [lo, hi) as _operands built them
    before the table: the header prefilter and local_query_bounds a file,
    a files == i mask a file met."""
    bounds = np.zeros((2, hi - lo, 3), np.int32)
    bounds[1] = -1
    files = ds.file_idx[lo:hi]
    for i, h in enumerate(ds.headers):
        if h.bounds.intersects(plan.bounds.bounds):
            blo, bhi = clamp_bounds_to_i32(*local_query_bounds(
                plan.bounds.bounds, h.scale, h.offset, parity_quirk=plan.parity_quirk))
            bounds[0, files == i] = blo
            bounds[1, files == i] = bhi
    return bounds


def operand_bounds(ds, plan, shard, lo, hi, boxes) -> np.ndarray:
    kind, arrays = ds._operands(plan, shard, lo, hi, boxes)
    assert kind == "bbox"
    return np.stack([arrays[3].numpy(), arrays[4].numpy()])


@pytest.mark.parametrize("shards", UNEVEN_SHARDS)
@pytest.mark.parametrize("quirk", [False, True])
def test_operand_rows_are_the_per_file_assembly(uneven, shards, quirk):
    """Every shard's rows, and every density piece (a file's rows on one
    shard), take the bounds the per-file assembly gave them; padding rows
    the empty box."""
    _, _, by_shards = uneven
    ds = by_shards[shards]
    assert ds.n_blocks == {1: 10, 2: 10, 3: 12}[shards]
    ranges = ds._ranges()
    for box in seeded_boxes(31 + shards, 40) + [BOX, "-1e9;-1e9;-1e9;1e9;1e9;1e9"]:
        plan = dataclasses.replace(plans(box=box)[1], parity_quirk=quirk)
        boxes, kept = ds._box_table(plan)
        assert kept.tolist() == [h.bounds.intersects(plan.bounds.bounds) for h in ds.headers]
        for s in ds.shards:
            got = operand_bounds(ds, plan, s, s.lo, s.hi, boxes)
            np.testing.assert_array_equal(got, per_file_assembly(ds, plan, s.lo, s.hi))
            pad = ds.file_idx[s.lo:s.hi] < 0
            assert (got[0, pad] == 0).all() and (got[1, pad] == -1).all()
        for blo, bhi in ranges.values():
            for s, plo, phi in ds._pieces(blo, bhi):
                np.testing.assert_array_equal(operand_bounds(ds, plan, s, plo, phi, boxes),
                                              per_file_assembly(ds, plan, plo, phi))
    if shards > 1:  # the edges cut a file mid-way
        assert any(len(ds._pieces(blo, bhi)) > 1 for blo, bhi in ranges.values())
    assert (ds.file_idx < 0).sum() == (2 if shards == 3 else 0)


@pytest.mark.parametrize("shards", UNEVEN_SHARDS)
def test_resident_replies_equal_jax_on_seeded_boxes(uneven, shards):
    """Counts, collects and density winners of seeded boxes over 1, 2 and
    3 shards: the JAX package's resident dataset's (the per-file path)."""
    _, ref, by_shards = uneven
    ds = by_shards[shards]
    boxes = seeded_boxes(7, 12)
    for box in boxes:
        jax_plan, torch_plan = plans(box=box)
        assert ds.count(torch_plan) == ref.count(jax_plan)
    for box in boxes[:3]:
        jax_plan, torch_plan = plans(box=box)
        want, ref_emitter = ref.collect(jax_plan, keep_hits=True)
        count, emitter = ds.collect(torch_plan, keep_hits=True)
        assert count == want
        _hits_equal(emitter.all_hits, ref_emitter.all_hits)
    for box, scope in ((boxes[0], "global"), (boxes[1], "file"), (QUERIES["box_files"]["box"],
                                                                   "file")):
        jax_plan, torch_plan = plans(density=25.0, scope=scope, box=box)
        (want_files, want_global), (files, global_state) = (
            ref.density_states(jax_plan), ds.density_states(torch_plan))
        if scope == "global":
            _winners_equal(global_state, want_global)
        else:  # a state for each file the prefilter keeps, with winners or not
            kept = [i for i, h in enumerate(ds.headers)
                    if h.bounds.intersects(torch_plan.bounds.bounds)]
            assert sorted(files) == kept
            assert {i for i in files if len(files[i])} == {i for i in want_files
                                                          if len(want_files[i])}
            for i in want_files:
                _winners_equal(files[i], want_files[i])


@pytest.mark.parametrize("shards", UNEVEN_SHARDS)
def test_one_operand_table_a_request(uneven, shards):
    """operand_counts: one table a box request, whatever the shard count,
    in count, collect and density; its kept and dropped files add up to
    the files; class and time requests build none."""
    _, _, by_shards = uneven
    ds = by_shards[shards]
    n_files = len(ds.files)
    box = "101500;200000;0;102600;201000;100"  # files 1 and 3 (header boxes overlap)
    _, plan = plans(box=box)
    kept = [h.bounds.intersects(plan.bounds.bounds) for h in ds.headers]
    assert 0 < sum(kept) < n_files
    calls = [lambda: ds.count(plan), lambda: ds.collect(plan),
             lambda: ds.count(plans(density=25.0, box=box)[1])]
    for call in calls:
        resident.reset_operand_counts()
        call()
        assert resident.operand_counts == {"tables": 1, "files_kept": sum(kept),
                                           "files_dropped": n_files - sum(kept)}
    resident.reset_operand_counts()
    for name in ("class6", "time"):
        ds.count(plans(**QUERIES[name])[1])
    assert resident.operand_counts == {"tables": 0, "files_kept": 0, "files_dropped": 0}


@pytest.mark.parametrize("shards", UNEVEN_SHARDS)
@pytest.mark.parametrize("side", [-5, 5])
def test_limited_collect_across_shards(uneven, monkeypatch, shards, side):
    """Limits that end 5 hits before and after the first shard's last row,
    over 1, 2 and 3 shards (2 and 3 cut a file there): the full gather's
    head, only its files opened."""
    _, _, by_shards = uneven
    ds = by_shards[shards]
    plan = plans(**QUERIES["box_half"])[1]
    c = block_counts(ds, plan)
    edge = ds.shards[0].hi
    assert c[edge - 1] > 5 and (shards == 1 or c[edge] > 5)
    limited_against_full(ds, plan, int(c[:edge].sum()) + side, monkeypatch)


@pytest.mark.parametrize("window", [(200_000.0, 800_000.0), (-0.0, 5e-324), (-1e300, -0.0)])
def test_time_operand_rows_are_the_scalar_encoding(both, window):
    """A time plan's (rows, 4) operand: every row the (hi, lo) encodings of
    the start and of the end, as encode_f64_scalar gives each."""
    _, ds = both
    _, plan = plans(time=window)
    (shard,) = ds.shards
    kind, arrays = ds._operands(plan, shard, 1, 5, None)
    want = [*host.encode_f64_scalar(window[0]), *host.encode_f64_scalar(window[1])]
    assert kind == "time" and arrays[2].dtype == torch.int32
    assert arrays[2].tolist() == [want] * 4
