"""The port's collect path end to end against the JAX engine, on the CPU.

The same point-format-3 dataset and query go through
adhoc_queries_pointclouds_tpu's run_query and the port's
run_query(device="cpu") with an output directory and keep_hits: the match
counts, the hits of each file (every attribute, in file order) and the
written matching_points_{i}.las files (byte for byte) must be equal, over
every format, both transports (AQPC_PACK 0/1), bbox, class and GPS-time
predicates, with the sidecar index off, exact, and (bbox) auto-built. The
printed text of --print-points must be identical too. Everything compared
is integers, bytes or f64 values computed by the same host code from the
same hit indices: the tolerance is 0.

The JAX engine compacts into a capped buffer and retries overflowing
blocks; the port has no cap. A JAX run with a tiny AQPC_COLLECT_CAP takes
the retry path, and the port must still match it.
"""

import filecmp
import io
import shutil

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_tpu.formats.las import write_las
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch.ops import predicate as TP
from adhoc_queries_pointclouds_torch.shared import (
    BoundsQuery,
    ClassQuery,
    QueryPlan,
    TimeRangeQuery,
    index as index_mod,
    open_point_cloud,
    parse_aabb,
    synth,
)

FORMATS = synth.formats_available("las", "last", "lazer", "laz")
BLOCK = 1 << 14
# 2 files x 200k points (4 index blocks of 65k each) at x offsets 100000 and
# 101000, GPS times at 200k points/s: file 0 spans [0, 1) s, file 1 [1, 2) s
QUERIES = {
    # z <= 60: in file 0 it contains index blocks 1 and 3 and straddles 0
    # and 2, so the scan ranges are split by a contained block
    "bbox": dict(bounds=BoundsQuery(parse_aabb("99999;199999;-1;102001;201001;60"))),
    # in some clusters' blocks only (seed 8, 8 clusters)
    "class": dict(classification=ClassQuery(6)),
    # straddles the file boundary
    "time": dict(time_range=TimeRangeQuery(0.3, 1.4)),
}


def _exact_index(data_dir):
    for f in sorted(data_dir.iterdir()):
        r = open_point_cloud(f)
        mm, bitmap, gps = index_mod.build_index(r)
        index_mod.save_index(f, mm, bitmap, gps, n_points=r.point_count)
        r.close()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine_collect")
    synth.write_dataset(root / "data", n_files=2, points_per_file=200_000, seed=8,
                        formats=FORMATS, clustered=True, point_format=3, n_clusters=8)
    for fmt in FORMATS:
        shutil.copytree(root / "data" / fmt, root / f"idx_{fmt}")
        _exact_index(root / f"idx_{fmt}")
    return root


def _collect(eng, data, query, out, **kw):
    """One collect run of either engine into a fresh directory out."""
    out.mkdir(parents=True)
    plan = QueryPlan(output_dir=out, **query)
    if eng is torch_engine:
        kw.setdefault("device", "cpu")
    kw.setdefault("block_size", BLOCK)
    return eng.run_query(data, plan, keep_hits=True, **kw)


def _same(got, ref, count_positive=True):
    """Equal counts, equal hits per file in file order, byte-identical LAS."""
    assert got.match_count == ref.match_count
    if count_positive:
        assert got.match_count > 0
    assert got.files_searched == ref.files_searched
    assert got.points_scanned == ref.points_scanned
    assert [h.file_idx for h in got.hits] == [h.file_idx for h in ref.hits]
    for a, b in zip(got.hits, ref.hits):
        np.testing.assert_array_equal(a.position_world, b.position_world)
        np.testing.assert_array_equal(a.classification, b.classification)
        np.testing.assert_array_equal(a.color, b.color)
        np.testing.assert_array_equal(a.intensity, b.intensity)
    assert [f.name for f in got.output_files] == [f.name for f in ref.output_files]
    for a, b in zip(got.output_files, ref.output_files):
        assert filecmp.cmp(a, b, shallow=False), (a, b)
    assert sum(h.count for h in got.hits) == got.match_count


@pytest.mark.parametrize("pred", sorted(QUERIES))
@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("use_index", [False, True], ids=["noindex", "exact"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_collect_matches_jax_engine(dataset, tmp_path, monkeypatch, fmt, use_index, pack, pred):
    monkeypatch.setenv("AQPC_PACK", pack)
    data = dataset / (f"idx_{fmt}" if use_index else f"data/{fmt}")
    ref = _collect(jax_engine, data, QUERIES[pred], tmp_path / "jax", use_index=use_index)
    got = _collect(torch_engine, data, QUERIES[pred], tmp_path / "torch", use_index=use_index)
    _same(got, ref)
    assert 0 < got.match_count < 400_000
    if use_index:
        assert got.timer.counts["index_pruned_points"] > 0
    if use_index and pred != "class":
        assert got.timer.counts["index_contained_blocks"] > 0


@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_bbox_collect_with_auto_built_index(dataset, tmp_path, monkeypatch, fmt, pack):
    """The first collect of each engine builds its own sidecars as it scans;
    the second reads them. Both runs must match."""
    monkeypatch.setenv("AQPC_PACK", pack)
    dirs = []
    for name in ("jax", "torch"):
        d = tmp_path / f"{name}_data"
        shutil.copytree(dataset / "data" / fmt, d)
        dirs.append(d)
    for run in range(2):
        ref = _collect(jax_engine, dirs[0], QUERIES["bbox"], tmp_path / f"jax{run}")
        got = _collect(torch_engine, dirs[1], QUERIES["bbox"], tmp_path / f"torch{run}")
        _same(got, ref)
        if run == 0:
            assert got.timer.counts["index_built_files"] == 2
        else:
            assert got.timer.counts["index_pruned_points"] > 0
    for d in dirs:
        assert len(list(d.glob("*.aqpc-idx"))) == 2


@pytest.mark.parametrize("pred", sorted(QUERIES))
@pytest.mark.parametrize("pack", ["1", "0"])
def test_print_points_text_matches_jax(dataset, monkeypatch, pack, pred):
    monkeypatch.setenv("AQPC_PACK", pack)
    data = dataset / "idx_last"
    texts = []
    for eng, kw in ((jax_engine, {}), (torch_engine, {"device": "cpu"})):
        buf = io.StringIO()
        res = eng.run_query(data, QueryPlan(print_points=True, **QUERIES[pred]),
                            block_size=BLOCK, print_stream=buf, **kw)
        texts.append((res.match_count, buf.getvalue()))
    (n_ref, ref), (n_got, got) = texts
    assert n_got == n_ref > 0 and got == ref
    assert got.count("\n") == n_got and got.startswith("Found point: (")


@pytest.mark.parametrize("pack", ["1", "0"])
def test_collect_block_size_not_multiple_of_8(dataset, tmp_path, monkeypatch, pack):
    """B % 8 != 0: packed transports take byte planes only, and the bit
    masks end in a partial word."""
    monkeypatch.setenv("AQPC_PACK", pack)
    for pred, query in QUERIES.items():
        for sub, use_index in (("data/last", False), ("idx_last", True)):
            kw = dict(block_size=10_003, use_index=use_index)
            ref = _collect(jax_engine, dataset / sub, query, tmp_path / f"j_{pred}_{use_index}", **kw)
            got = _collect(torch_engine, dataset / sub, query, tmp_path / f"t_{pred}_{use_index}",
                           **kw)
            _same(got, ref)


@pytest.mark.parametrize("pack", ["1", "0"])
def test_collect_multi_range_blocks(dataset, tmp_path, monkeypatch, pack):
    """A block size that does not divide the 65k index block packs index
    ranges into multi-range device blocks: hits map back through task_gidx."""
    monkeypatch.setenv("AQPC_PACK", pack)
    for pred, query in QUERIES.items():
        ref = _collect(jax_engine, dataset / "idx_las", query, tmp_path / f"j_{pred}",
                       block_size=40_000)
        got = _collect(torch_engine, dataset / "idx_las", query, tmp_path / f"t_{pred}",
                       block_size=40_000)
        _same(got, ref)


@pytest.mark.parametrize("pack", ["1", "0"])
def test_full_match_streams_with_spool_spill(dataset, tmp_path, monkeypatch, pack):
    """Every point matches (full blocks emit ranges with no index fetch) and
    the spool spills to disk: the LAS files are still byte-identical."""
    monkeypatch.setenv("AQPC_PACK", pack)
    monkeypatch.setenv("AQPC_SPOOL_MB", "0.25")
    query = dict(bounds=BoundsQuery(parse_aabb("-1e9;-1e9;-1e9;1e9;1e9;1e9")))
    kw = dict(use_index=False)
    ref = _collect(jax_engine, dataset / "data" / "lazer", query, tmp_path / "jax", **kw)
    got = _collect(torch_engine, dataset / "data" / "lazer", query, tmp_path / "torch", **kw)
    _same(got, ref)
    assert got.match_count == 400_000


@pytest.mark.parametrize("pred", sorted(QUERIES))
def test_jax_cap_retry_path_matches_uncapped_port(dataset, tmp_path, monkeypatch, pred):
    """A tiny AQPC_COLLECT_CAP sends the JAX engine through its overflow
    retry; the port, which reads each count first, ignores the variable."""
    monkeypatch.setenv("AQPC_COLLECT_CAP", "8")
    for pack in ("1", "0"):
        monkeypatch.setenv("AQPC_PACK", pack)
        ref = _collect(jax_engine, dataset / "data" / "last", QUERIES[pred], tmp_path / f"j{pack}",
                       use_index=False)
        got = _collect(torch_engine, dataset / "data" / "last", QUERIES[pred],
                       tmp_path / f"t{pack}", use_index=False)
        _same(got, ref)


@pytest.mark.parametrize("pack", ["1", "0"])
def test_class_collect_single_class_and_absent_blocks(tmp_path, monkeypatch, pack):
    """Blocks of one class, and blocks without the target, ship to the card
    in the collect path (>= 1-bit planes): the count path's host fast paths
    do not apply, and every class still collects as the JAX engine does."""
    monkeypatch.setenv("AQPC_PACK", pack)
    rng = np.random.default_rng(3)
    n = 50_000
    pos = rng.uniform((100000.0, 200000.0, 0.0), (100100.0, 200100.0, 10.0), (n, 3))
    cls = rng.choice(np.array([1, 2, 6], np.uint8), n)
    cls[: 3 * 8192] = 2  # three single-class blocks
    cls[3 * 8192 : 4 * 8192] = 1  # one block without classes 2 and 6
    color = rng.integers(0, 65536, (n, 3)).astype(np.uint16)
    data = tmp_path / "data"
    data.mkdir()
    write_las(data / "one.las", pos, cls, color, rng.integers(0, 65536, n).astype(np.uint16),
              scale=(0.001, 0.001, 0.001), offset=(100000.0, 200000.0, 0.0))
    for target in (2, 1, 6, 9):
        query = dict(classification=ClassQuery(target))
        ref = _collect(jax_engine, data, query, tmp_path / f"j{target}", block_size=8192)
        TP.reset_launches()
        got = _collect(torch_engine, data, query, tmp_path / f"t{target}", block_size=8192)
        _same(got, ref, count_positive=target != 9)
        assert got.match_count == int(np.count_nonzero(cls == target))


@pytest.mark.parametrize("pred", sorted(QUERIES))
@pytest.mark.parametrize("pack", ["1", "0"])
def test_force_collect_matches_jax_engine(dataset, monkeypatch, pack, pred):
    """force_collect runs the collect path with a count-only emitter: the
    count equals the JAX engine's force_collect run and the port's own count
    path, and nothing is kept or written."""
    monkeypatch.setenv("AQPC_PACK", pack)
    data = dataset / "idx_last"
    plan = QueryPlan(**QUERIES[pred])
    ref = jax_engine.run_query(data, plan, block_size=BLOCK, force_collect=True)
    got = torch_engine.run_query(data, plan, device="cpu", block_size=BLOCK, force_collect=True)
    counted = torch_engine.run_query(data, plan, device="cpu", block_size=BLOCK)
    assert got.match_count == ref.match_count == counted.match_count > 0
    assert got.points_scanned == ref.points_scanned
    assert got.hits == [] and got.output_files == []
    assert got.timer.counts["index_pruned_points"] > 0
