"""A process of a --distributed group over several shards, on the CPU: the
port's parallel/distributed.py over process_devices("cpu", d) against the
JAX package's distributed functions, which run on the global mesh of the 8
virtual host devices of tests/conftest.py, and against JAX's
engine.run_query.

The counterpart of tests/test_distributed.py::test_global_mesh_spans_all_devices
(global_device_count over a process's shards), the layout rule of the
cards a process drives (card_layout: no card needed), and for d in 1, 2,
3 and 8 shards (3 pads a step's rows; 8 is JAX's whole virtual mesh):
counts (bbox and GPS time in both transports, class raw and dictionary),
collects (-o LAS bytes, file for file) and density at file and global
scope (the winners' key, d2, file and gidx, and the LAS bytes). The
tolerance is 0 throughout: integers, exact f64 values and bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_engine import make_plan

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_tpu.models.query import DensityConfig as JaxDensity
from adhoc_queries_pointclouds_tpu.parallel import distributed as jax_distributed
from adhoc_queries_pointclouds_torch import engine as torch_engine
from adhoc_queries_pointclouds_torch.formats import synth
from adhoc_queries_pointclouds_torch.models.query import DensityConfig
from adhoc_queries_pointclouds_torch.parallel import distributed

DEVICES = [1, 2, 3, 8]
BLOCK = 1 << 13
# three files of 40k points (5 blocks each) at x offsets 100000, 101000 and
# 102000: the box cuts all three
BOX = "100200;200300;10;102500;200800;60"
COUNTS = {
    "box_pack1": (dict(box=BOX), "1"),
    "box_pack0": (dict(box=BOX), "0"),
    "class_raw": (dict(cls=6), "0"),
    "class_dict": (dict(cls=6), "1"),
    "time_pack1": (dict(time=(0.1, 0.6)), "1"),
    "time_pack0": (dict(time=(0.1, 0.6)), "0"),
}
COLLECTS = {"box": dict(box=BOX), "class": dict(cls=6), "time": dict(time=(0.1, 0.6))}
# no box: the grid is the union of the files' headers
DENSITY = {"box": (dict(box=BOX), 9.0), "class": (dict(cls=6), 40.0)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_distributed_devices")
    synth.write_dataset(root, n_files=3, points_per_file=40_000, seed=17, formats=("last",),
                        clustered=True, point_format=3)
    return root / "last"


@pytest.fixture(scope="module")
def jax_results():
    """name -> the JAX package's result, which no shard count changes:
    computed at its first use and kept for every d."""
    return {}


def _kept(cache, key, make):
    if key not in cache:
        cache[key] = make()
    return cache[key]


# ------------------------------------------------------------------ layout


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_global_device_count_spans_every_shard(n):
    """The counterpart of test_global_mesh_spans_all_devices: at one
    process the group's shard total is the process's."""
    devices = distributed.process_devices("cpu", n)
    assert devices == [torch.device("cpu")] * n
    assert distributed.global_device_count(devices) == n


@pytest.mark.parametrize("procs, cards, n, want", [
    (2, 1, 2, [[0, 0], [0, 0]]),
    (2, 4, 2, [[0, 1], [2, 3]]),
    (3, 4, 2, [[0, 1], [2, 3], [0, 1]]),
    (2, 8, 4, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (3, 2, 1, [[0], [1], [0]]),
    (5, 4, 1, [[0], [1], [2], [3], [0]]),
    (1, 3, 5, [[0, 1, 2, 0, 1]]),
])
def test_card_layout(procs, cards, n, want):
    """Process I's n shards are the cards (I * n + j) % C: with n = 1 card
    I % C (one card a process), disjoint while P * n <= C, repeating past
    it."""
    got = [distributed.card_layout(pid, cards, n) for pid in range(procs)]
    assert got == want
    if n == 1:
        assert got == [[pid % cards] for pid in range(procs)]
    if procs * n <= cards:
        flat = [c for shards in got for c in shards]
        assert len(set(flat)) == len(flat)


def test_process_devices_on_cuda_follows_the_layout(monkeypatch):
    """process_devices("cuda", n) is card_layout of this process on the
    machine's card count; n = 1 and no n are process_device's card; a
    named card takes n 1 or none; n below 1 raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert distributed.process_devices("cuda", 2) == [cuda[2], cuda[3]]
    assert distributed.process_devices("cuda", 3) == [cuda[3], cuda[0], cuda[1]]
    assert distributed.process_devices("cuda") == distributed.process_devices("cuda", 1)
    assert distributed.process_devices("cuda") == [cuda[1]]
    assert distributed.process_device("cuda") == cuda[1]
    assert distributed.process_devices("cuda:3", 1) == [cuda[3]]
    with pytest.raises(ValueError, match="names one card"):
        distributed.process_devices("cuda:3", 2)
    with pytest.raises(ValueError, match="at least one device"):
        distributed.process_devices("cuda", 0)


def test_process_devices_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.process_devices("cuda", 2)


# ------------------------------------------------------------------ counts


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("name", sorted(COUNTS))
def test_count_matches_jax(data, jax_results, monkeypatch, name, d):
    spec, pack = COUNTS[name]
    monkeypatch.setenv("AQPC_PACK", pack)
    ref, jax_got = _kept(jax_results, ("count", name), lambda: (
        jax_engine.run_query(data, make_plan(jax_engine, **spec), block_size=BLOCK).match_count,
        jax_distributed.distributed_count(data, make_plan(jax_engine, **spec),
                                          block_size=BLOCK)))
    shards = []
    put = distributed.DistStepComm.put

    def spy(self, arrays):
        groups = put(self, arrays)
        shards.append(len(groups))
        return groups

    monkeypatch.setattr(distributed.DistStepComm, "put", spy)
    got = distributed.distributed_count(data, make_plan(torch_engine, **spec),
                                        devices=distributed.process_devices("cpu", d),
                                        block_size=BLOCK)
    assert got == jax_got == ref > 0
    # every step went to the process's d shards (a dictionary count may
    # resolve every block on the host, with no step)
    assert set(shards) <= {d} and (shards or name == "class_dict")


# ---------------------------------------------------------------- collects


def _written(out):
    return {f.name: f.read_bytes() for f in sorted(out.glob("*.las"))}


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("kind", sorted(COLLECTS))
def test_collect_writes_jax_bytes(data, jax_results, tmp_path_factory, kind, d):
    """-o: the count, and every LAS file byte for byte, of JAX
    distributed_collect and of JAX run_query."""
    spec = COLLECTS[kind]

    def jax_outs():
        outs = []
        for name, fn in (("engine", None), ("distributed", jax_distributed.distributed_collect)):
            out = tmp_path_factory.mktemp(f"jax_collect_{kind}_{name}")
            plan = make_plan(jax_engine, **spec, output_dir=out)
            if fn is None:
                count = jax_engine.run_query(data, plan, block_size=BLOCK).match_count
            else:
                count, _ = fn(data, plan, block_size=BLOCK, output_dir=out)
            outs.append((count, _written(out)))
        return outs

    (ref, ref_files), (jax_got, jax_files) = _kept(jax_results, ("collect", kind), jax_outs)
    out = tmp_path_factory.mktemp(f"torch_collect_{kind}_{d}")
    count, res = distributed.distributed_collect(
        data, make_plan(torch_engine, **spec, output_dir=out),
        devices=distributed.process_devices("cpu", d), block_size=BLOCK, output_dir=out)
    assert count == jax_got == ref > 0
    assert [f.name for f in res.output_files] == sorted(ref_files)
    assert _written(out) == jax_files == ref_files and len(ref_files) == 3


# ----------------------------------------------------------------- density


def _capture_states(monkeypatch, module):
    """Every density_state_out that module's run_query fills, in call order."""
    states = []
    run_query = module.run_query

    def spy(*args, **kw):
        res = run_query(*args, **kw)
        if kw.get("density_state_out") is not None:
            states.append(kw["density_state_out"])
        return res

    monkeypatch.setattr(module, "run_query", spy)
    return states


def _winners(state, scope):
    """(key, d2, file_idx, gidx) of a density state's winners, file by file
    at file scope."""
    parts = ([state["global"]] if scope == "global"
             else [state["file"][i] for i in sorted(state["file"])])
    return [tuple(np.asarray(p[f]).tolist() for f in ("key", "d2", "file_idx", "gidx"))
            for p in parts]


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("scope", ["file", "global"])
@pytest.mark.parametrize("kind", sorted(DENSITY))
def test_density_winners_match_jax(data, jax_results, tmp_path_factory, monkeypatch, kind,
                                   scope, d):
    """The count, the winners (key, d2, file, gidx) and the LAS bytes of
    JAX distributed_density and of JAX run_query."""
    spec, cell = DENSITY[kind]

    def jax_outs():
        outs = []
        with pytest.MonkeyPatch.context() as mp:
            states = _capture_states(mp, jax_engine)
            for name in ("engine", "distributed"):
                out = tmp_path_factory.mktemp(f"jax_density_{kind}_{scope}_{name}")
                plan = dataclasses.replace(make_plan(jax_engine, **spec, output_dir=out),
                                           density=JaxDensity(cell, scope))
                if name == "engine":
                    state = {}
                    count = jax_engine.run_query(data, plan, block_size=BLOCK,
                                                 density_state_out=state).match_count
                else:
                    count = jax_distributed.distributed_density(data, plan, block_size=BLOCK)
                    state = states[-1]
                outs.append((count, _winners(state, scope), _written(out)))
        return outs

    want, jax_got = _kept(jax_results, ("density", kind, scope), jax_outs)
    states = _capture_states(monkeypatch, distributed)
    out = tmp_path_factory.mktemp(f"torch_density_{kind}_{scope}_{d}")
    plan = dataclasses.replace(make_plan(torch_engine, **spec, output_dir=out),
                               density=DensityConfig(cell, scope))
    count = distributed.distributed_density(data, plan,
                                            devices=distributed.process_devices("cpu", d),
                                            block_size=BLOCK)
    (state,) = states
    got = (count, _winners(state, scope), _written(out))
    assert got == jax_got == want
    assert count > 0 and len(got[2]) == (3 if scope == "file" else 1)
