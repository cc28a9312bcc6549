"""The port's density path end to end against the JAX engine, on the CPU.

The same dataset and plan go through adhoc_queries_pointclouds_tpu's
run_query and the port's run_query(device="cpu"), each with a plan of its
own package's classes: the match count, the winners (density_state_out,
field by field), the kept hits' attributes, the written LAS files (byte for
byte) and the --print-points text must be equal; tolerance 0 throughout
(integers, exact f64 values and bytes). One run of each engine feeds all of
them: -o, the print stream and keep_hits are consumers of one emitter.

Density plans never auto-build a sidecar, so both engines read the same
exact index from one copy of the dataset.
"""

import io
import shutil

import numpy as np
import pytest
from test_torch_engine import make_plan

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_tpu.utils.aabb import parse_aabb as jax_parse_aabb
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch import index as index_mod
from adhoc_queries_pointclouds_torch.formats import open_point_cloud, synth
from adhoc_queries_pointclouds_torch.ops import density as density_ops
from adhoc_queries_pointclouds_torch.utils.aabb import parse_aabb

FORMATS = synth.formats_available("las", "last", "lazer", "laz")
BLOCK = 1 << 13
N_FILES, N_POINTS = 2, 80_000
# Files are 1000 x 1000 x 100 m at x offsets 100000 and 101000; 80k points
# at 200k points/s span 0.4 s each, and the last index block of a file holds
# 18 % of it (the index prunes a class only above 10 %).
BOX = "100400;200250;20;101300;200600;45"
SPECS = {
    "box": dict(box=BOX, density=7.0),
    "class": dict(cls=6, density=40.0),
    "time": dict(time=(0.1, 0.55), density=25.0),
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """root/data/<fmt>: the files; root/indexed/<fmt>: copies with exact
    sidecars (class bitmaps and GPS ranges) as the index command builds."""
    root = tmp_path_factory.mktemp("torch_engine_density")
    synth.write_dataset(root / "data", n_files=N_FILES, points_per_file=N_POINTS, seed=9,
                        formats=FORMATS, clustered=True, point_format=3)
    for fmt in ("las", "last"):
        shutil.copytree(root / "data" / fmt, root / "indexed" / fmt)
        for f in sorted((root / "indexed" / fmt).iterdir()):
            r = open_point_cloud(f)
            blocks, bitmap, gps = index_mod.build_index(r)
            index_mod.save_index(f, blocks, bitmap, gps, n_points=r.point_count)
            r.close()
    return root


@pytest.fixture(scope="module")
def prunable_class(dataset):
    """A class that some index block of the dataset lacks and another holds,
    so that the exact index prunes part of a class plan."""
    present = []
    for f in sorted((dataset / "data" / "last").glob("*.last")):
        r = open_point_cloud(f)
        cls = r.column("classification")
        present += [set(cls[s : s + 65536].tolist()) for s in range(0, len(cls), 65536)]
        r.close()
    partial = sorted(c for c in set.union(*present) if not all(c in p for p in present))
    assert partial, present
    return partial[-1]


def run_both(data, spec, tmp_path, *, scope="global", use_index=False, block=BLOCK, **kw):
    """Both engines over data with the density plan of spec; returns
    [(result, state, printed text, written bytes)] for (jax, torch)."""
    outs = []
    for name, eng in (("jax", jax_engine), ("torch", torch_engine)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        plan = make_plan(eng, **spec, output_dir=out_dir, print_points=True)
        plan = type(plan)(**{**plan.__dict__,
                             "density": type(plan.density)(plan.density.cell_size, scope)})
        state, buf = {}, io.StringIO()
        extra = dict(device="cpu") if eng is torch_engine else {}
        if "density_grid_bounds" in kw:
            parse = parse_aabb if eng is torch_engine else jax_parse_aabb
            extra["density_grid_bounds"] = parse(kw["density_grid_bounds"])
        res = eng.run_query(data, plan, block_size=block, use_index=use_index, keep_hits=True,
                            print_stream=buf, density_state_out=state, **extra)
        outs.append((res, state, buf.getvalue(), [f.read_bytes() for f in res.output_files]))
    return outs


def assert_same(ref, got, scope):
    (r_res, r_state, r_text, r_files), (g_res, g_state, g_text, g_files) = ref, got
    assert g_res.match_count == r_res.match_count > 0
    assert g_res.files_searched == r_res.files_searched
    assert g_res.points_scanned == r_res.points_scanned
    if scope == "global":
        states = [(r_state["global"], g_state["global"])]
        assert sorted(g_state) == sorted(r_state) == ["global"]
    else:
        assert sorted(g_state["file"]) == sorted(r_state["file"])
        states = [(r_state["file"][i], g_state["file"][i]) for i in sorted(r_state["file"])]
    n_winners = 0
    for a, b in states:
        assert b.dtype == a.dtype == density_ops.WINNER_DTYPE
        for field in ("key", "d2", "file_idx", "gidx"):
            assert np.array_equal(a[field], b[field]), field
        n_winners += len(b)
    assert n_winners == g_res.match_count
    assert len(g_res.hits) == len(r_res.hits)
    for a, b in zip(r_res.hits, g_res.hits):
        assert a.file_idx == b.file_idx
        for field in ("position_world", "classification", "color", "intensity"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field
    assert g_text == r_text and g_text.count("\n") == g_res.match_count
    assert [f.name for f in g_res.output_files] == [f.name for f in r_res.output_files]
    assert g_files == r_files and g_files
    assert len(g_files) == (1 if scope == "global" else len(states))


@pytest.mark.parametrize("use_index", [False, True], ids=["noindex", "exactindex"])
@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("scope", ["file", "global"])
@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("fmt", ["last", "las"])
def test_density_matches_jax_engine(dataset, prunable_class, tmp_path, monkeypatch, fmt, kind,
                                    scope, pack, use_index):
    monkeypatch.setenv("AQPC_PACK", pack)
    data = dataset / ("indexed" if use_index else "data") / fmt
    spec = dict(SPECS[kind], cls=prunable_class) if kind == "class" else SPECS[kind]
    ref, got = run_both(data, spec, tmp_path, scope=scope, use_index=use_index)
    assert_same(ref, got, scope)
    counts = got[0].timer.counts
    for name in ("host_prefiltered_blocks", "density_sparse_blocks", "index_skipped_blocks",
                 "index_pruned_points"):
        assert counts.get(name, 0) == ref[0].timer.counts.get(name, 0), name
    if use_index:
        assert counts["index_pruned_points"] > 0
    if kind == "box" and not use_index:
        # blocks wholly outside the box never leave the host, and the
        # blocks at its edge go through the sparse gather
        assert counts["host_prefiltered_blocks"] > 0 and counts["density_sparse_blocks"] > 0


@pytest.mark.parametrize("fmt", [f for f in FORMATS if f in ("laz", "lazer")])
def test_density_over_compressed_formats(dataset, tmp_path, fmt):
    ref, got = run_both(dataset / "data" / fmt, SPECS["box"], tmp_path)
    assert_same(ref, got, "global")


def test_density_grid_bounds_given(dataset, tmp_path):
    """An explicit grid moves the lattice: other winners than the box's own
    grid gives, and the same ones in both engines."""
    data = dataset / "data" / "last"
    for sub in "ab":
        (tmp_path / sub).mkdir()
    ref, got = run_both(data, SPECS["box"], tmp_path / "a",
                        density_grid_bounds="100003;200001;-2;102000;201000;100")
    assert_same(ref, got, "global")
    _, own = run_both(data, SPECS["box"], tmp_path / "b")
    assert not np.array_equal(own[1]["global"]["key"], got[1]["global"]["key"])


def test_density_without_a_box_uses_the_total_bounds(dataset):
    """A class plan's grid spans the union of the files' header bounds: the
    winners are those of the exact f64 reference over that grid."""
    data = dataset / "data" / "last"
    state = {}
    plan = make_plan(torch_engine, cls=6, density=40.0)
    res = torch_engine.run_query(data, plan, device="cpu", block_size=BLOCK,
                                 density_state_out=state)
    readers = [open_point_cloud(f) for f in torch_engine.discover_files(data)]
    grid = density_ops.GridSpec3D.create(torch_engine.get_total_bounds(readers), 40.0)
    acc = density_ops.WinnerAccum()
    for i, r in enumerate(readers):
        rows = np.nonzero(r.column("classification") == 6)[0]
        acc.add(grid.make_winners(r.positions_world()[rows], rows, i), i)
        r.close()
    want = acc.result()
    assert res.match_count == len(want) > 0
    assert np.array_equal(state["global"], want)


@pytest.mark.parametrize("pack", ["1", "0"])
def test_density_dense_steps_and_odd_block_size(dataset, tmp_path, monkeypatch, pack):
    """A box over everything sends every block through the K-block steps (no
    prefilter, no sparse gather), at a block size off every alignment."""
    monkeypatch.setenv("AQPC_PACK", pack)
    spec = dict(box="99000;199000;-10;103000;202000;200", density=15.0)
    ref, got = run_both(dataset / "data" / "last", spec, tmp_path, block=8192 + 24)
    assert_same(ref, got, "global")
    counts = got[0].timer.counts
    assert counts.get("host_prefiltered_blocks", 0) == counts.get("density_sparse_blocks", 0) == 0


def test_init_malloc_honours_the_switch(monkeypatch):
    """_init_malloc pins glibc's mmap threshold through mallopt unless
    AQPC_MALLOC_PIN=0."""
    import ctypes

    calls = []

    class Libc:
        def mallopt(self, param, value):
            calls.append((param, value))
            return 1

    monkeypatch.setattr(ctypes, "CDLL", lambda *a, **k: Libc())
    monkeypatch.setattr(torch_engine, "_libc", None)
    monkeypatch.setenv("AQPC_MALLOC_PIN", "0")
    torch_engine._init_malloc()
    assert calls == [] and torch_engine._libc is None
    monkeypatch.setenv("AQPC_MALLOC_PIN", "1")
    torch_engine._init_malloc()
    assert calls == [(-3, 1 << 20)] and torch_engine._libc is not None
    monkeypatch.delenv("AQPC_MALLOC_PIN")
    torch_engine._init_malloc()
    assert calls == [(-3, 1 << 20)] * 2
