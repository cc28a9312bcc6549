"""Several devices in one process against the JAX package's mesh, on the CPU.

The JAX engine runs each step under shard_map over a mesh of n_devices of
the 8 virtual host devices of tests/conftest.py; the port splits the same
steps over devices=local_devices("cpu", d), one shard a device
(parallel/mesh.py). For d in 1, 2, 4 and 8 the same files and plans go
through both: counts (bbox in both transports, class, GPS time), collects
(hits and written LAS bytes), density winners (key, d2, file, gidx) at file
and global scope, resident datasets (their padded layout, counts, collects
and density) and serve's "info". The tolerance is 0 throughout: integers,
exact f64 values and bytes.
"""

import numpy as np
import pytest
from test_torch_engine import make_plan

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_tpu import serve as jax_serve
from adhoc_queries_pointclouds_tpu.parallel import mesh as jax_mesh
from adhoc_queries_pointclouds_tpu.parallel.resident import ResidentDataset as JaxResident
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch import serve as torch_serve
from adhoc_queries_pointclouds_torch.formats import synth
from adhoc_queries_pointclouds_torch.ops import density as density_ops
from adhoc_queries_pointclouds_torch.parallel import mesh
from adhoc_queries_pointclouds_torch.parallel.comm import LocalStepComm
from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset

DEVICES = [1, 2, 4, 8]
BLOCK = 1 << 13
ATTRS = ("position", "classification", "gps_time")
# three files of 40k points (5 blocks each) at x offsets 100000, 101000 and
# 102000, 1000 x 1000 x 100 m each: the box cuts all three
BOX = "100200;200300;10;102500;200800;60"
SPECS = {
    "box": dict(box=BOX),
    "class": dict(cls=6),
    "time": dict(time=(0.1, 0.6)),
}
DENSITY = {"box": dict(box=BOX, density=9.0), "class": dict(cls=6, density=40.0)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_devices")
    synth.write_dataset(root, n_files=3, points_per_file=40_000, seed=16, formats=("last",),
                        clustered=True, point_format=3)
    return root / "last"


def run_both(data, spec, d, **kw):
    """(the JAX engine's result at n_devices=d, the port's over d CPU shards)."""
    ref = jax_engine.run_query(data, make_plan(jax_engine, **spec), n_devices=d,
                               block_size=BLOCK, use_index=False, **kw)
    got = torch_engine.run_query(data, make_plan(torch_engine, **spec), device="cpu",
                                 devices=mesh.local_devices("cpu", d), block_size=BLOCK,
                                 use_index=False, **kw)
    return ref, got


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("pack", ["1", "0"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_count_matches_jax_mesh(data, monkeypatch, kind, pack, d):
    monkeypatch.setenv("AQPC_PACK", pack)
    ref, got = run_both(data, SPECS[kind], d)
    assert got.match_count == ref.match_count > 0
    assert got.points_scanned == ref.points_scanned


@pytest.mark.parametrize("d", DEVICES)
def test_steps_split_into_d_contiguous_groups(data, monkeypatch, d):
    """Every step is d x K rows (the last one padded to a multiple of d),
    one group of rows a shard, and the groups run on the shards' devices."""
    monkeypatch.setenv("AQPC_BLOCKS_PER_STEP", "2")
    shapes = []
    put = LocalStepComm.put

    def spy(self, arrays):
        shards = put(self, arrays)
        shapes.append([tuple(a.shape[0] for a in group) for group in shards])
        return shards

    monkeypatch.setattr(LocalStepComm, "put", spy)
    ref, got = run_both(data, SPECS["box"], d)
    assert got.match_count == ref.match_count
    assert all(len(step) == d and len({*step}) == 1 for step in shapes)
    for step in shapes:
        assert all(len(set(group)) == 1 for group in step)  # every operand: the same rows
    # 15 blocks (3 files of 5): full steps of 2 blocks a shard, then the
    # rest padded to a multiple of d
    full, rest = divmod(15, 2 * d)
    want = [2] * full + ([mesh.step_rows(rest, d) // d] if rest else [])
    assert [step[0][0] for step in shapes] == want


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_collect_writes_jax_bytes(data, tmp_path, kind, d):
    outs = []
    for name, eng in (("jax", jax_engine), ("torch", torch_engine)):
        out = tmp_path / name
        out.mkdir()
        kw = (dict(n_devices=d) if eng is jax_engine
              else dict(device="cpu", devices=mesh.local_devices("cpu", d)))
        res = eng.run_query(data, make_plan(eng, **SPECS[kind], output_dir=out),
                            block_size=BLOCK, use_index=False, keep_hits=True, **kw)
        outs.append((res.match_count, [f.name for f in res.output_files],
                     [f.read_bytes() for f in res.output_files],
                     [h.position_world for h in res.hits]))
    (count, names, files, pos), (want, want_names, want_files, want_pos) = outs[1], outs[0]
    assert count == want > 0
    assert names == want_names and files == want_files and len(files) == 3
    assert all(np.array_equal(a, b) for a, b in zip(pos, want_pos))


def _same_winners(ref_state, got_state, scope) -> int:
    if scope == "global":
        pairs = [(ref_state["global"], got_state["global"])]
    else:
        assert sorted(got_state["file"]) == sorted(ref_state["file"])
        pairs = [(ref_state["file"][i], got_state["file"][i]) for i in sorted(ref_state["file"])]
    n = 0
    for a, b in pairs:
        assert b.dtype == density_ops.WINNER_DTYPE
        for field in ("key", "d2", "file_idx", "gidx"):
            assert np.array_equal(a[field], b[field]), field
        n += len(b)
    return n


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("scope", ["file", "global"])
@pytest.mark.parametrize("kind", sorted(DENSITY))
def test_density_winners_match_jax_mesh(data, kind, scope, d):
    states = []
    for eng in (jax_engine, torch_engine):
        plan = make_plan(eng, **DENSITY[kind])
        plan = type(plan)(**{**plan.__dict__,
                             "density": type(plan.density)(plan.density.cell_size, scope)})
        kw = (dict(n_devices=d) if eng is jax_engine
              else dict(device="cpu", devices=mesh.local_devices("cpu", d)))
        state = {}
        res = eng.run_query(data, plan, block_size=BLOCK, use_index=False,
                            force_collect=True, density_state_out=state, **kw)
        states.append((res.match_count, state))
    (want, ref_state), (count, got_state) = states
    assert count == want == _same_winners(ref_state, got_state, scope) > 0


@pytest.fixture(scope="module")
def residents(data):
    """d -> (the JAX resident dataset on a mesh of d, the port's over d CPU
    shards)."""
    return {d: (JaxResident.load(data, mesh=jax_mesh.make_mesh(d), block_size=BLOCK,
                                 attrs=ATTRS),
                ResidentDataset.load(data, devices=mesh.local_devices("cpu", d),
                                     block_size=BLOCK, attrs=ATTRS))
            for d in DEVICES}


def _plans(spec):
    return make_plan(jax_engine, **spec), make_plan(torch_engine, **spec)


@pytest.mark.parametrize("d", DEVICES)
def test_resident_layout_matches_jax_mesh(residents, d):
    """n_blocks padded to a multiple of d as JAX pads it, with padding
    blocks of file -1 and n_valid 0, and the j-th contiguous group of
    blocks on shard j."""
    ref, got = residents[d]
    assert got.n_blocks == ref.n_blocks and got.n_blocks % d == 0
    assert np.array_equal(got.file_idx, ref.file_idx)
    assert np.array_equal(got.nvs, ref.nvs)
    assert np.array_equal(got.block_start, ref.block_start)
    assert got.total_points == ref.total_points == 120_000
    assert got.resident_bytes == ref.resident_bytes == sum(got.per_device_bytes)
    assert [(s.lo, s.hi) for s in got.shards] == mesh.shard_ranges(got.n_blocks, d)
    for s in got.shards:
        for name in ("xs", "ys", "zs", "cls", "ths", "tls"):
            assert np.array_equal(getattr(s, name).numpy(),
                                  np.asarray(getattr(ref, name))[s.lo : s.hi])


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_resident_count_and_collect_match_jax_mesh(residents, tmp_path, kind, d):
    ref, got = residents[d]
    jax_plan, torch_plan = _plans(SPECS[kind])
    assert got.count(torch_plan) == ref.count(jax_plan) > 0
    outs = []
    for ds, plan, sub in ((ref, jax_plan, "jax"), (got, torch_plan, "torch")):
        out = tmp_path / sub
        out.mkdir()
        count, emitter = ds.collect(plan, output_dir=out, keep_hits=True)
        outs.append((count, {f.name: f.read_bytes() for f in out.iterdir()}))
    assert outs[1] == outs[0] and outs[1][0] > 0 and len(outs[1][1]) == 3


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("scope", ["file", "global"])
@pytest.mark.parametrize("kind", sorted(DENSITY))
def test_resident_density_matches_jax_mesh(residents, kind, scope, d):
    ref, got = residents[d]
    plans = []
    for plan in _plans(DENSITY[kind]):
        plans.append(type(plan)(**{**plan.__dict__,
                                   "density": type(plan.density)(plan.density.cell_size,
                                                                 scope)}))
    ref_files, ref_global = ref.density_states(plans[0])
    got_files, got_global = got.density_states(plans[1])
    n = _same_winners({"file": ref_files, "global": ref_global},
                      {"file": got_files, "global": got_global}, scope)
    assert got.count(plans[1]) == ref.count(plans[0]) == n > 0


@pytest.mark.parametrize("d", DEVICES)
def test_serve_info_reports_the_shards(data, residents, d):
    ref, got = residents[d]
    want = jax_serve.handle_request(ref, {"cmd": "info"}, str(data))
    reply = torch_serve.handle_request(got, {"cmd": "info"}, str(data))
    assert reply == want and reply["devices"] == d
