"""A real two-process run of the port's distributed queries on the CPU
(adhoc_queries_pointclouds_torch/tools/dist2.py --device cpu: two worker
processes joined in a gloo group over CPU tensors), held to the JAX
package's single-process run_query on the same data: counts in both
transports, the collected points per input file in file order, density
winners at file scope, at global scope, with no box and with exact d2 ties
across the processes, index-pruned counts, a count whose second shard
is empty, a dictionary count whose blocks each process resolves on the
host, and the gathered union of the processes' winner keys.

The gathers of the density winners and of their keys run with a 1 KB slab budget
(AQPC_ALLGATHER_SLAB_KB=1), so it walks many slabs. Every group and the
spawn have a timeout: a stuck peer fails the test instead of stalling the
suite.
"""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

import pytest

from adhoc_queries_pointclouds_tpu import engine as jax_engine
from adhoc_queries_pointclouds_tpu.models.query import DensityConfig as JaxDensity
from adhoc_queries_pointclouds_torch.tools import dist2

from test_torch_engine import make_plan

COUNTS = [f"{kind}_count_pack{pack}" for pack in "10" for kind in ("bbox", "class", "time")]
COUNTS += ["indexed_count", "one_file_count", "class_single_count", "density_keys"]
PER_FILE = ["collect", "density_file"]  # one LAS file per input file with hits
GLOBAL = ["density_global", "density_nobox", "density_ties"]  # one LAS file in all
TIMEOUT = 180.0
# the workers share the host with the other test processes: PyTorch's CPU
# ops would each start a thread per core, and those spin against each other
WORKER_THREADS = {"OMP_NUM_THREADS": "2"}


def _jax_run(q: dict, root, out):
    """The JAX engine's single-process run_query of a query spec over the
    JAX copy of the data (each engine writes its own sidecars)."""
    spec = dict(box=q.get("bounds"), cls=q.get("class"), time=q.get("time"))
    plan = make_plan(jax_engine, **spec)
    if "density" in q:
        plan = dataclasses.replace(plan, density=JaxDensity(*q["density"]))
    if q.get("out"):
        out.mkdir(parents=True)
        plan = dataclasses.replace(plan, output_dir=out)
    data = q["data"].replace(str(root / "torch"), str(root / "jax"))
    pack = os.environ.get("AQPC_PACK")
    os.environ["AQPC_PACK"] = q.get("pack", "1")
    try:
        state = {}
        res = jax_engine.run_query(data, plan, block_size=q["block"],
                                   density_state_out=state if "density" in q else None)
    finally:
        if pack is None:
            del os.environ["AQPC_PACK"]
        else:
            os.environ["AQPC_PACK"] = pack
    return res, state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(queries, the two workers' reports, {name: (JAX QueryResult, JAX
    density state)})."""
    root = tmp_path_factory.mktemp("torch_dist2")
    dist2.write_datasets(root / "torch")
    shutil.copytree(root / "torch", root / "jax")
    queries = dist2.default_queries(root / "torch", root / "out")
    env = dict(os.environ, AQPC_ALLGATHER_SLAB_KB="1", **WORKER_THREADS)
    reports = dist2.run_workers(queries, procs=2, device="cpu", timeout=TIMEOUT, env=env)
    ref = {q["name"]: _jax_run(q, root, root / "jax_out" / q["name"]) for q in queries}
    return queries, reports, ref


def _files(reports, name):
    return [f for w in reports for f in w["queries"][name]["files"]]


def test_two_real_processes_ran_every_query(run):
    queries, reports, _ = run
    assert [(w["pid"], w["procs"], w["device"]) for w in reports] == [(0, 2, "cpu"), (1, 2, "cpu")]
    names = [q["name"] for q in queries]
    assert sorted(names) == sorted(COUNTS + PER_FILE + GLOBAL)
    for w in reports:
        assert sorted(w["queries"]) == sorted(names)
        assert w["launches"] == {}  # CPU tensors run the plain versions: no kernel launch


@pytest.mark.parametrize("name", COUNTS + PER_FILE + GLOBAL)
def test_count_equals_jax_single_process(run, name):
    _, reports, ref = run
    want = ref[name][0].match_count
    assert [w["queries"][name]["count"] for w in reports] == [want, want]
    assert want > 0


@pytest.mark.parametrize("name", PER_FILE)
def test_per_file_outputs_equal_jax_single_process(run, name):
    """Each process writes its own files' hits under host{pid}/; together
    they are the JAX run's files, byte for byte: every input file's points
    in file order."""
    _, reports, ref = run
    for w in reports:
        assert all(f"/host{w['pid']}/" in f for f in w["queries"][name]["files"])
        assert w["queries"][name]["files"]
    want = [str(f) for f in ref[name][0].output_files]
    assert len(want) == 3
    assert dist2.file_digests(_files(reports, name)) == dist2.file_digests(want)


@pytest.mark.parametrize("name", GLOBAL)
def test_global_density_winners_equal_jax_single_process(run, name):
    _, reports, ref = run
    want = [str(f) for f in ref[name][0].output_files]
    assert len(want) == 1
    got = dist2.point_rows(_files(reports, name))
    assert got == dist2.point_rows(want)
    assert len(got) == ref[name][0].match_count
    # a 1 KB slab holds 18 wire rows of each of 2 processes: one process
    # holds at least half the winners, so the gather walks 3 slabs or more
    assert len(got) // 2 > 2 * (1024 // (2 * 7 * 4))


def test_density_ties_go_to_the_lower_global_file_rank(run):
    """file_2 is a byte copy of file_1: every winner of their cells ties on
    d2 and gidx, and the one-process rule keeps file_1's (the lower rank).
    file_1 is process 1's and file_2 process 0's, so process 1 writes those
    winners and process 0 only file_0's."""
    _, reports, ref = run
    by_file = Counter(ref["density_ties"][1]["global"]["file_idx"].tolist())
    assert by_file[0] > 0 and by_file[1] > 0 and by_file[2] == 0
    written = [len(dist2.point_rows(w["queries"]["density_ties"]["files"])) for w in reports]
    assert written == [by_file[0], by_file[1]]


def test_index_prunes_blocks_on_the_distributed_path(run):
    _, reports, ref = run
    skipped = [w["queries"]["indexed_count"]["index_skipped_blocks"] for w in reports]
    assert sum(skipped) > 0
    assert ref["indexed_count"][0].timer.counts["index_skipped_blocks"] == sum(skipped)


def test_a_manifest_of_one_file_leaves_a_shard_empty(run):
    """Process 1's share of a one-file manifest is empty: its run_query
    does not raise, and it joins the reduction with 0."""
    _, reports, ref = run
    want = ref["one_file_count"][0].match_count
    assert want > 0
    assert [w["queries"]["one_file_count"]["count"] for w in reports] == [want, want]


def test_single_class_blocks_count_on_the_host_in_each_process(run):
    """Every block of data_cls holds class 6 alone: under the dictionary
    transport each process adds such a block's points to its host total
    with no step (each process launches its own steps), and the reduction
    of both totals counts every point."""
    _, reports, ref = run
    want = ref["class_single_count"][0].match_count
    assert want == 2 * 20_000
    assert [w["queries"]["class_single_count"]["count"] for w in reports] == [want, want]


def test_cli_distributed_in_two_processes(run, tmp_path):
    """The CLI's --distributed --coordinator --num-processes --process-id
    in two processes: each prints the JAX single-process count over 2
    processes and 2 devices, and names the files it wrote under
    host{pid}/ of -o."""
    queries, _, ref = run
    data = next(q["data"] for q in queries if q["name"] == "collect")
    port = dist2.free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", **WORKER_THREADS,
               PYTHONPATH=os.pathsep.join(filter(None, [str(dist2.REPO),
                                                        os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "adhoc_queries_pointclouds_torch.cli", "-i", data,
         "--bounds", dist2.BOX, "--block-size", str(dist2.BLOCK), "--device", "cpu",
         "--distributed", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(pid), "-o", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=dist2.REPO)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    want = ref["collect"][0].match_count
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        lines = out.splitlines()
        assert re.fullmatch(rf"Found {want} matching points \(2 process\(es\), 2 devices, "
                            rf"[\d.]+s\)", lines[-1]), out
        shard = range(pid, 3, 2)  # input files of process pid, every one with hits
        assert lines[:-1] == [f"Wrote {tmp_path}/host{pid}/matching_points_{j}.las"
                              for j in range(len(shard))]


def test_a_failed_worker_stops_the_run(run, tmp_path):
    """Process 1's file is not a point cloud: it exits with an error while
    process 0 waits for it in the count's reduction. The run ends at once
    (gloo closes the waiting peer's reduction, else run_workers stops it)
    and raises with the failed worker's log, long before its timeout."""
    import time

    queries, _, _ = run
    src = next(q["data"] for q in queries if q["name"] == "one_file_count")
    shutil.copyfile(src, tmp_path / "file_0.last")
    (tmp_path / "file_1.last").write_bytes(b"not a point cloud" * 64)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match=r"--- worker 1:") as err:
        dist2.run_workers([{"name": "count", "data": str(tmp_path), "op": "count",
                            "bounds": dist2.BOX, "block": dist2.BLOCK}],
                          procs=2, device="cpu", timeout=TIMEOUT,
                          env=dict(os.environ, **WORKER_THREADS))
    assert time.monotonic() - t < TIMEOUT / 4
    assert "Not a LAS file" in str(err.value).split("--- worker 1:")[1]
