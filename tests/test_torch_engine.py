"""The port's bbox count end to end against the JAX engine, on the CPU.

The same dataset and box go through adhoc_queries_pointclouds_tpu's
run_query and the port's run_query(device="cpu"); match counts must be equal
over every format, with the sidecar index off and on, in both transports
(AQPC_PACK 0/1). Counts are integers: the tolerance is 0.

Index auto-build writes a sidecar next to each data file, so each engine's
index cases run on its own copy of the dataset: otherwise the second engine
would silently read the first one's index. The cross cases read the other
engine's index.
"""

import shutil

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_tpu.formats import open_point_cloud as jax_open_point_cloud
from adhoc_queries_pointclouds_tpu.models import query as jax_query
from adhoc_queries_pointclouds_tpu.parallel.comm import LocalStepComm as JaxLocalStepComm
from adhoc_queries_pointclouds_tpu.utils.aabb import parse_aabb as jax_parse_aabb
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch import host
from adhoc_queries_pointclouds_torch import index as index_mod
from adhoc_queries_pointclouds_torch.formats import open_point_cloud, synth
from adhoc_queries_pointclouds_torch.models import query as torch_query
from adhoc_queries_pointclouds_torch.parallel.comm import LocalStepComm as TorchLocalStepComm
from adhoc_queries_pointclouds_torch.utils.aabb import (
    clamp_bounds_to_i32,
    local_query_bounds,
    parse_aabb,
)

FORMATS = synth.formats_available("las", "last", "lazer", "laz")
BLOCK = 1 << 14
# Files are 2 x 200k points (4 index blocks of 65k each) laid out at x
# offsets 100000 and 101000 with a 1000 x 1000 x 100 extent.
BOXES = {
    # straddles file 0; in file 1 it contains the second index block and
    # straddles the others, so the scan ranges are split by a contained one
    "partial": "100100;200250;0;102000;200876;80",
    "disjoint": "0;0;0;10;10;10",
    "everything": "99000;199000;-10;103000;202000;200",
    "full_range": "-1e12;-1e12;-1e12;1e12;1e12;1e12",
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine")
    synth.write_dataset(root / "data", n_files=2, points_per_file=200_000, seed=5,
                        formats=FORMATS, clustered=True)
    return root


@pytest.fixture(scope="module")
def indexed(dataset):
    """fmt -> (dir indexed by the JAX engine, dir indexed by the port), each
    built by that engine's own auto-build during a full scan; both builds
    must count the same."""
    spec = dict(box=BOXES["full_range"])
    out = {}
    for fmt in FORMATS:
        jax_dir = dataset / f"jax_idx_{fmt}"
        torch_dir = dataset / f"torch_idx_{fmt}"
        shutil.copytree(dataset / "data" / fmt, jax_dir)
        shutil.copytree(dataset / "data" / fmt, torch_dir)
        ref = run(jax_engine, jax_dir, spec, block_size=BLOCK, use_index=True)
        got = run(torch_engine, torch_dir, spec, block_size=BLOCK, use_index=True)
        assert got.match_count == ref.match_count == 400_000
        for d in (jax_dir, torch_dir):
            assert len(list(d.glob("*.aqpc-idx"))) == 2
        out[fmt] = (jax_dir, torch_dir)
    return out


def make_plan(eng, *, box=None, cls=None, time=None, density=None, **fields):
    """The QueryPlan of engine eng (jax_engine or torch_engine) from that
    engine's own package's classes: box is a --bounds string, cls a class
    value, time a (start, end) pair, density a cell size; fields are
    QueryPlan's other fields (output_dir, print_points)."""
    q, parse = (torch_query, parse_aabb) if eng is torch_engine else (jax_query, jax_parse_aabb)
    return q.QueryPlan(
        bounds=None if box is None else q.BoundsQuery(parse(box)),
        classification=None if cls is None else q.ClassQuery(cls),
        time_range=None if time is None else q.TimeRangeQuery(*time),
        density=None if density is None else q.DensityConfig(density),
        **fields,
    )


def run(eng, data, spec: dict, **kw):
    """run_query of either engine over data with the plan make_plan(eng,
    **spec); the port runs on the CPU."""
    if eng is torch_engine:
        kw.setdefault("device", "cpu")
    return eng.run_query(data, make_plan(eng, **spec), **kw)


def _oracle(data_dir, box: str) -> int:
    aabb = parse_aabb(box)
    total = 0
    for f in sorted(data_dir.iterdir()):
        r = open_point_cloud(f)
        total += int(np.sum(aabb.contains_points(r.positions_world())))
        r.close()
    return total


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("use_index", [False, True], ids=["noindex", "index"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_count_matches_jax_engine(dataset, indexed, monkeypatch, fmt, use_index, pack, box):
    monkeypatch.setenv("AQPC_PACK", pack)
    spec = dict(box=BOXES[box])
    if use_index:
        jax_dir, torch_dir = indexed[fmt]
    else:
        jax_dir = torch_dir = dataset / "data" / fmt
    ref = run(jax_engine, jax_dir, spec, block_size=BLOCK, use_index=use_index)
    got = run(torch_engine, torch_dir, spec, block_size=BLOCK, use_index=use_index)
    assert got.match_count == ref.match_count
    assert got.files_searched == ref.files_searched
    assert got.points_scanned == ref.points_scanned
    if box == "partial":
        assert 0 < got.match_count < 400_000
        if use_index:
            assert got.timer.counts["index_pruned_points"] > 0


@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_index_built_by_either_engine_serves_the_other(dataset, indexed, monkeypatch,
                                                       fmt, pack):
    monkeypatch.setenv("AQPC_PACK", pack)
    jax_dir, torch_dir = indexed[fmt]
    for name in ("file_0", "file_1"):
        a = index_mod.load_index(jax_dir / f"{name}.{fmt}")
        b = index_mod.load_index(torch_dir / f"{name}.{fmt}")
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    spec = dict(box=BOXES["partial"])
    want = _oracle(dataset / "data" / fmt, BOXES["partial"])
    got = run(torch_engine, jax_dir, spec, block_size=BLOCK)
    ref = run(jax_engine, torch_dir, spec, block_size=BLOCK)
    assert got.match_count == ref.match_count == want
    assert got.timer.counts["index_pruned_points"] > 0


@pytest.mark.parametrize("pack", ["1", "0"])
def test_multi_range_blocks(dataset, indexed, monkeypatch, pack):
    """A block size that does not divide the index block packs straddling
    index-block ranges of one file into shared multi-range device blocks."""
    monkeypatch.setenv("AQPC_PACK", pack)
    fmt = "last"
    jax_dir, torch_dir = indexed[fmt]
    block = 40_000
    box = BOXES["partial"]
    multi = 0
    for i, f in enumerate(sorted(torch_dir.glob(f"*.{fmt}"))):
        r = open_point_cloud(f)
        lo, hi = clamp_bounds_to_i32(*local_query_bounds(parse_aabb(box), r.header.scale,
                                                         r.header.offset))
        info = index_mod.load_index(f)
        scan, _ = index_mod.bbox_scan_ranges(info[1], info[0], 0, r.point_count, lo, hi)
        multi += sum(len(t) == 3 for t in host._pack_range_tasks(i, scan, block))
        r.close()
    assert multi > 0
    ref = run(jax_engine, jax_dir, dict(box=box), block_size=block)
    got = run(torch_engine, torch_dir, dict(box=box), block_size=block)
    assert got.match_count == ref.match_count == _oracle(dataset / "data" / fmt, box)


@pytest.mark.parametrize("fmt", FORMATS)
def test_discover_files_and_total_bounds_match_jax_engine(dataset, fmt):
    data = dataset / "data" / fmt
    files = torch_engine.discover_files(data)
    assert files == jax_engine.discover_files(data) and len(files) == 2
    readers = [open_point_cloud(f) for f in files]
    jax_readers = [jax_open_point_cloud(f) for f in files]
    box = torch_engine.get_total_bounds(readers)
    ref = jax_engine.get_total_bounds(jax_readers)
    assert (box.min, box.max) == (ref.min, ref.max)
    assert box.min[0] < box.max[0]
    for r in readers + jax_readers:
        r.close()


def test_non_bbox_plans_are_not_ported(dataset, tmp_path):
    """Every plan kind runs now: a class count, a density plan and the
    collecting plans (-o, --print-points). The class, time, collect and
    density parity grids are in test_torch_engine_class.py,
    test_torch_engine_time.py, test_torch_engine_collect.py and
    test_torch_engine_density.py."""
    import io

    data = dataset / "data" / "last"
    got = run(torch_engine, data, dict(cls=6), block_size=BLOCK)
    assert got.match_count == run(jax_engine, data, dict(cls=6), block_size=BLOCK).match_count > 0
    box = BOXES["partial"]
    dense = run(torch_engine, data, dict(box=box, density=1.0), block_size=BLOCK)
    ref = run(jax_engine, data, dict(box=box, density=1.0), block_size=BLOCK)
    assert 0 < dense.match_count == ref.match_count < _oracle(data, box)
    outs = []
    for name, eng in (("jax", jax_engine), ("torch", torch_engine)):
        buf = io.StringIO()
        (tmp_path / name).mkdir()
        printed = run(eng, data, dict(box=box, print_points=True), block_size=BLOCK,
                      print_stream=buf)
        written = run(eng, data, dict(box=box, output_dir=tmp_path / name), block_size=BLOCK)
        outs.append((printed.match_count, buf.getvalue(), written.match_count,
                     [f.read_bytes() for f in written.output_files]))
    assert outs[0] == outs[1]
    assert outs[1][0] == outs[1][2] == outs[1][1].count("\n") > 0 and outs[1][3]


class _JaxNotLocal(JaxLocalStepComm):
    """A participant of a multi-process run, as far as the engine asks."""

    is_local = False


class _TorchNotLocal(TorchLocalStepComm):
    is_local = False


@pytest.mark.parametrize("keep_going", [False, True])
@pytest.mark.parametrize("collect", [False, True], ids=["count", "collect"])
@pytest.mark.parametrize("spec", [dict(box=BOXES["partial"]), dict(cls=6), dict(time=(1.0, 2.0))],
                         ids=["box", "class", "time"])
def test_empty_file_list_raises_only_for_a_lone_participant(tmp_path, spec, collect,
                                                            keep_going):
    """run_query(comm=...): over a directory with no point-cloud file, a
    strategy that is not local (a process whose share of a multi-process
    run's files is empty) gets a 0 count from both engines, each with its
    own package's LocalStepComm made not local; the default, local
    strategy raises FileNotFoundError in both."""
    kw = dict(block_size=BLOCK, keep_going=keep_going, keep_hits=collect)
    ref = run(jax_engine, tmp_path, spec, comm=_JaxNotLocal(), **kw)
    got = run(torch_engine, tmp_path, spec, comm=_TorchNotLocal("cpu"), **kw)
    assert got.match_count == ref.match_count == 0
    assert got.files_searched == ref.files_searched == 0
    assert got.points_scanned == ref.points_scanned == 0
    for eng in (jax_engine, torch_engine):
        with pytest.raises(FileNotFoundError):
            run(eng, tmp_path, spec, **kw)
