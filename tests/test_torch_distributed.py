"""The port's parallel/distributed.py in one process, where no group is
initialized, against the JAX package's parallel/distributed.py at process
count 1, on the CPU: one counterpart a test of tests/test_distributed.py,
and the wire helpers byte for byte.

Here each call runs on one device (device=, one shard). The counterpart
of tests/test_distributed.py::test_global_mesh_spans_all_devices, and a
process over several shards (process_devices, global_device_count,
devices=) against JAX's global mesh, are in
tests/test_torch_distributed_devices.py. The real two-process runs are
tests/test_torch_dist2.py (one shard a process) and
tests/test_torch_dist2_devices.py (two).
"""

import dataclasses

import jax
import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_tpu.parallel import distributed as jax_distributed
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch.formats import synth
from adhoc_queries_pointclouds_torch.ops.density import WINNER_DTYPE
from adhoc_queries_pointclouds_torch.parallel import distributed

from test_torch_engine import make_plan

BOX = "100200;200300;10;100900;200900;70"
# a box over all three files of a dataset: one output file each
BOX_ALL = "100200;200300;10;102900;200900;70"
BLOCK = 1 << 14


def _data(tmp_path, n_files, seed, **kw):
    synth.write_dataset(tmp_path, n_files=n_files, points_per_file=kw.pop("points", 20_000),
                        seed=seed, formats=("last",), **kw)
    return tmp_path / "last"


def _counts(data, spec):
    """(the JAX engine's count, JAX distributed_count's, the port's
    distributed_count's) of the plan make_plan(**spec)."""
    ref = jax_engine.run_query(data, make_plan(jax_engine, **spec), block_size=BLOCK).match_count
    jax_got = jax_distributed.distributed_count(data, make_plan(jax_engine, **spec),
                                                block_size=BLOCK)
    got = distributed.distributed_count(data, make_plan(torch_engine, **spec), device="cpu",
                                        block_size=BLOCK)
    return ref, jax_got, got


@pytest.mark.parametrize("pack", ["1", "0"])
def test_distributed_count_matches_engine(tmp_path, monkeypatch, pack):
    monkeypatch.setenv("AQPC_PACK", pack)
    data = _data(tmp_path, 3, 31)
    ref, jax_got, _ = _counts(data, dict(box=BOX))
    got = distributed.distributed_bbox_count(data, make_plan(torch_engine, box=BOX),
                                             device="cpu", block_size=BLOCK)
    assert got == jax_got == ref > 0


def test_shard_manifest_single_process(tmp_path):
    files = [tmp_path / f"{i}.las" for i in range(5)]
    assert distributed.shard_manifest(files) == files  # process_count == 1
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)


@pytest.mark.parametrize("pid, n", [(0, 1), (0, 2), (1, 2), (0, 3), (2, 3), (3, 4), (5, 7)])
def test_shard_manifest_is_jax_round_robin(tmp_path, monkeypatch, pid, n):
    files = [tmp_path / f"file_{i}.last" for i in range(11)]
    monkeypatch.setattr(jax, "process_index", lambda: pid)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(distributed, "process_index", lambda: pid)
    monkeypatch.setattr(distributed, "process_count", lambda: n)
    got = distributed.shard_manifest(files)
    assert got == jax_distributed.shard_manifest(files) == files[pid::n]


@pytest.mark.parametrize("pack", ["1", "0"])
def test_distributed_class_count_matches_engine(tmp_path, monkeypatch, pack):
    monkeypatch.setenv("AQPC_PACK", pack)
    ref, jax_got, got = _counts(_data(tmp_path, 3, 32), dict(cls=6))
    assert got == jax_got == ref > 0


@pytest.mark.parametrize("pack", ["1", "0"])
def test_distributed_time_count_matches_engine(tmp_path, monkeypatch, pack):
    monkeypatch.setenv("AQPC_PACK", pack)
    ref, jax_got, got = _counts(_data(tmp_path, 2, 33, point_format=1),
                                dict(time=(100_000.0, 700_000.0)))
    assert got == jax_got == ref > 0


def test_distributed_collect_matches_engine(tmp_path):
    """-o: the same count as the JAX engine, and the same LAS files, byte
    for byte, as JAX distributed_collect writes."""
    data = _data(tmp_path, 3, 34)
    outs = []
    for name, eng, collect, kw in (
            ("jax", jax_engine, jax_distributed.distributed_collect, {}),
            ("torch", torch_engine, distributed.distributed_collect, {"device": "cpu"})):
        out = tmp_path / name
        out.mkdir()
        plan = make_plan(eng, box=BOX_ALL, output_dir=out)
        total, res = collect(data, plan, block_size=BLOCK, output_dir=out, keep_hits=True, **kw)
        outs.append((total, [f.name for f in res.output_files],
                     [f.read_bytes() for f in res.output_files]))
    ref = jax_engine.run_query(data, make_plan(jax_engine, box=BOX_ALL), block_size=BLOCK)
    assert outs[1] == outs[0]
    assert outs[1][0] == ref.match_count > 0 and len(outs[1][2]) == 3


def test_distributed_collect_print_points_matches_engine(tmp_path, monkeypatch):
    """The counterpart of the JAX collect overflow retry: the JAX run under
    a collect cap of 8 retries its blocks; the port has no cap (the
    compaction writes an exact-size buffer), so the same query simply
    collects. Both keep the same hits."""
    data = _data(tmp_path, 2, 35, points=10_000)
    ref = jax_engine.run_query(data, make_plan(jax_engine, box=BOX), block_size=BLOCK)
    monkeypatch.setenv("AQPC_COLLECT_CAP", "8")
    total_j, res_j = jax_distributed.distributed_collect(
        data, make_plan(jax_engine, box=BOX, print_points=True), block_size=BLOCK,
        keep_hits=True, print_stream=open("/dev/null", "w"))
    monkeypatch.delenv("AQPC_COLLECT_CAP")
    total, res = distributed.distributed_collect(
        data, make_plan(torch_engine, box=BOX, print_points=True), device="cpu",
        block_size=BLOCK, keep_hits=True, print_stream=open("/dev/null", "w"))
    assert total == total_j == ref.match_count > 0
    assert [h.count for h in res.hits] == [h.count for h in res_j.hits]
    for a, b in zip(res.hits, res_j.hits):
        np.testing.assert_array_equal(a.position_world, b.position_world)


@pytest.mark.parametrize("spec", [
    dict(box=BOX_ALL, density=("global",)), dict(box=BOX_ALL, density=("file",)),
    dict(cls=6, density=("global",)),  # no box: the grid is the files' header union
], ids=["global", "file", "nobox"])
def test_distributed_density_matches_engine(tmp_path, spec):
    """Counts equal to the JAX engine's and JAX distributed_density's, and
    with -o the same LAS bytes."""
    from adhoc_queries_pointclouds_tpu.models.query import DensityConfig as JaxDensity
    from adhoc_queries_pointclouds_torch.models.query import DensityConfig

    data = _data(tmp_path, 3, 36)
    scope = spec["density"][0]
    cell = 150.0 if "cls" in spec else 50.0
    query = {k: v for k, v in spec.items() if k != "density"}
    outs = []
    for name, eng, fn, cfg, kw in (
            ("jax", jax_engine, jax_distributed.distributed_density, JaxDensity, {}),
            ("torch", torch_engine, distributed.distributed_density, DensityConfig,
             {"device": "cpu"})):
        out = tmp_path / name
        out.mkdir()
        plan = make_plan(eng, **query, output_dir=out)
        plan = dataclasses.replace(plan, density=cfg(cell, scope))
        count = fn(data, plan, block_size=BLOCK, **kw)
        outs.append((count, [f.read_bytes() for f in sorted(out.glob("*.las"))]))
    plan = make_plan(jax_engine, **query)
    ref = jax_engine.run_query(data, dataclasses.replace(plan, density=JaxDensity(cell, scope)),
                               block_size=BLOCK)
    assert outs[1] == outs[0]
    assert outs[1][0] == ref.match_count > 0
    assert len(outs[1][1]) == (3 if scope == "file" else 1)


@pytest.mark.parametrize("scope", ["global", "file"])
def test_distributed_query_delegates_density(tmp_path, scope):
    """distributed_query with a density plan returns distributed_density's
    count, with global files_searched, as the JAX function does."""
    from adhoc_queries_pointclouds_tpu.models.query import DensityConfig as JaxDensity
    from adhoc_queries_pointclouds_torch.models.query import DensityConfig

    data = _data(tmp_path, 2, 37)
    jplan = dataclasses.replace(make_plan(jax_engine, box=BOX), density=JaxDensity(50.0, scope))
    plan = dataclasses.replace(make_plan(torch_engine, box=BOX), density=DensityConfig(50.0, scope))
    expected = jax_engine.run_query(data, jplan, block_size=BLOCK).match_count
    ref = jax_distributed.distributed_query(data, jplan, block_size=BLOCK)
    res = distributed.distributed_query(data, plan, device="cpu", block_size=BLOCK)
    assert res.match_count == ref.match_count == expected > 0
    assert res.files_searched == ref.files_searched == 2
    assert res.total_file_bytes == ref.total_file_bytes > 0
    assert res.hits == [] and res.output_files == []


def _winner_state(rng, n):
    state = np.empty(n, WINNER_DTYPE)
    state["key"] = rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    state["d2"] = rng.random(n) * 10.0 ** rng.integers(-300, 300, n)
    state["d2"][: n // 4] = 0.0
    state["file_idx"] = rng.integers(0, 1000, n)
    state["gidx"] = rng.integers(0, 2**40, n)
    return state


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
@pytest.mark.parametrize("nproc, pid", [(1, 0), (2, 1), (5, 3)])
def test_winner_rows_i32_bytes_match_jax(n, nproc, pid):
    """The 7-word wire rows of a random winner state, with the round-robin
    rank map, are JAX's byte for byte (and None gives no rows)."""
    state = _winner_state(np.random.default_rng(n * 31 + nproc), n)
    to_global = lambda j: j * nproc + pid  # noqa: E731
    got = distributed._winner_rows_i32(state, to_global)
    want = jax_distributed._winner_rows_i32(state, to_global)
    assert got.dtype == want.dtype == np.int32 and got.shape == (n, 7)
    assert got.tobytes() == want.tobytes()
    assert distributed._winner_rows_i32(None, to_global).shape == (0, 7)


def test_allgather_rows_and_keys_are_identities_at_one_process(monkeypatch):
    monkeypatch.setenv("AQPC_ALLGATHER_SLAB_KB", "1")
    rows = np.random.default_rng(3).integers(-2**31, 2**31, (50, 7), dtype=np.int64)
    rows = rows.astype(np.int32)
    keys = np.random.default_rng(4).integers(0, 2**64, 40, dtype=np.uint64)
    assert distributed._allgather_i32_rows(rows) is rows
    assert distributed._allgather_keys(keys) is keys
    assert distributed._allgather_slab_bytes() == 1024
    assert distributed._allreduce_sum(17) == distributed._allreduce_max(17) == 17


def test_dist_step_comm_at_one_process():
    """The strategy has no lockstep hook (each process launches its own
    steps), an empty shard is not an error (is_local False), and the count
    reduces both totals."""
    comm = distributed.DistStepComm("cpu")
    assert not comm.is_local and comm.device().type == "cpu"
    for hook in ("agree_block_size", "agree_steps", "step_rows", "batch_rows", "agree_widths"):
        assert not hasattr(comm, hook)
    assert comm.finish_total(5, 7) == 12 and comm.reduce_sum(3) == 3
    assert distributed.process_device("cpu").type == "cpu"
    distributed.initialize(None)  # no coordinator: stays one process
    assert distributed.process_count() == 1
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed.initialize("127.0.0.1:1")
