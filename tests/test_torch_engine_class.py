"""The port's class count end to end against the JAX engine, on the CPU.

The same point-format-3 dataset and class go through
adhoc_queries_pointclouds_tpu's run_query and the port's
run_query(device="cpu"); match counts must be equal over every format, in
both transports (AQPC_PACK 0/1), with the sidecar index off and with an
exact index. Counts are integers: the tolerance is 0.

An index auto-built by a bbox scan has an all-present class bitmap and
prunes nothing for a class plan, so the index cases read sidecars built by
index.build_index + save_index (what the JAX CLI's index command writes),
on a copy of the data.
"""

import shutil

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch.shared import (
    BoundsQuery,
    ClassQuery,
    QueryPlan,
    index as index_mod,
    open_point_cloud,
    parse_aabb,
    synth,
)

FORMATS = synth.formats_available("las", "last", "lazer", "laz")
BLOCK = 1 << 14
# clustered data: class 2 is the ground sheet (in every block), 6 is in some
# clusters' blocks only (with 8 clusters and seed 8, in two of file 0's four
# index blocks), 4 is in none
CLASSES = [2, 6, 4]


def write_data(root, seed):
    synth.write_dataset(root, n_files=2, points_per_file=200_000, seed=seed,
                        formats=FORMATS, clustered=True, point_format=3, n_clusters=8)


def exact_index_copy(src, dst):
    """A copy of src whose files carry exact sidecars (class bitmaps and
    GPS min/max)."""
    shutil.copytree(src, dst)
    for f in sorted(dst.iterdir()):
        r = open_point_cloud(f)
        mm, bitmap, gps = index_mod.build_index(r)
        index_mod.save_index(f, mm, bitmap, gps, n_points=r.point_count)
        r.close()
    return dst


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine_class")
    write_data(root / "data", seed=8)
    for fmt in FORMATS:
        exact_index_copy(root / "data" / fmt, root / f"idx_{fmt}")
    return root


def _oracle(data_dir, target: int) -> int:
    total = 0
    for f in sorted(data_dir.iterdir()):
        if f.suffix == ".aqpc-idx":
            continue
        r = open_point_cloud(f)
        total += int(np.count_nonzero(r.column("classification") == target))
        r.close()
    return total


@pytest.mark.parametrize("target", CLASSES)
@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("use_index", [False, True], ids=["noindex", "index"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_class_count_matches_jax_engine(dataset, monkeypatch, fmt, use_index, pack, target):
    monkeypatch.setenv("AQPC_PACK", pack)
    plan = QueryPlan(classification=ClassQuery(target))
    data = dataset / (f"idx_{fmt}" if use_index else f"data/{fmt}")
    ref = jax_engine.run_query(data, plan, block_size=BLOCK, use_index=use_index)
    got = torch_engine.run_query(data, plan, device="cpu", block_size=BLOCK, use_index=use_index)
    assert got.match_count == ref.match_count
    assert got.files_searched == ref.files_searched == 2
    assert got.points_scanned == ref.points_scanned
    if target == 2:
        assert 0 < got.match_count < 400_000
    if target == 6:
        assert 0 < got.match_count < _oracle(dataset / "data" / fmt, 2)
    if target == 4:
        assert got.match_count == 0
    if use_index and target != 2:
        assert got.timer.counts["index_pruned_points"] > 0
    if use_index and target == 4:
        assert got.points_scanned == 0


@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("block", [40_002, 16_383])  # B % 4 == 2 and 3: u8 rows, byte planes
def test_class_count_block_size_not_multiple_of_4(dataset, monkeypatch, pack, block):
    monkeypatch.setenv("AQPC_PACK", pack)
    for target in (6, 2):
        plan = QueryPlan(classification=ClassQuery(target))
        for data, use_index in ((dataset / "data" / "last", False), (dataset / "idx_last", True)):
            ref = jax_engine.run_query(data, plan, block_size=block, use_index=use_index)
            got = torch_engine.run_query(data, plan, device="cpu", block_size=block,
                                         use_index=use_index)
            assert got.match_count == ref.match_count == _oracle(dataset / "data" / "last", target)


def test_class_and_time_plans_build_no_index(tmp_path, monkeypatch):
    """Index auto-build is for bbox scans only: a class or time run on an
    unindexed copy writes no sidecar, and a sidecar auto-built by a bbox scan
    (conservative class bitmap, no GPS ranges) leaves the counts exact."""
    from adhoc_queries_pointclouds_torch.shared import TimeRangeQuery

    monkeypatch.setenv("AQPC_PACK", "1")
    write_data(tmp_path, seed=12)
    data = tmp_path / "last"
    plans = [QueryPlan(classification=ClassQuery(6)),
             QueryPlan(time_range=TimeRangeQuery(0.3, 1.4))]
    want = [torch_engine.run_query(data, p, device="cpu", block_size=BLOCK, use_index=False)
            .match_count for p in plans]
    for p, n in zip(plans, want):
        got = torch_engine.run_query(data, p, device="cpu", block_size=BLOCK)
        assert got.match_count == n > 0
        assert "index_built_files" not in got.timer.counts
    assert not list(data.glob("*.aqpc-idx"))
    bbox = QueryPlan(bounds=BoundsQuery(parse_aabb("-1e9;-1e9;-1e9;1e9;1e9;1e9")))
    torch_engine.run_query(data, bbox, device="cpu", block_size=BLOCK)
    assert len(list(data.glob("*.aqpc-idx"))) == 2
    for p, n in zip(plans, want):
        got = torch_engine.run_query(data, p, device="cpu", block_size=BLOCK)
        ref = jax_engine.run_query(data, p, block_size=BLOCK)
        assert got.match_count == ref.match_count == n
        assert got.timer.counts.get("index_pruned_points", 0) == 0
