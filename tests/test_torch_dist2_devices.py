"""A real two-process run of the port's distributed queries with two shards
a process, on the CPU (adhoc_queries_pointclouds_torch/tools/dist2.py
--device cpu --devices 2: two worker processes in a gloo group, each
splitting its steps over two CPU shards), held to the JAX package's
single-process run_query on the same data: counts in both transports, the
collected points per input file in file order, and the global-scope
density winners. The workers run with tests/test_torch_dist2.py's
timeout and thread count.
"""

import os
import shutil

import pytest
from test_torch_dist2 import TIMEOUT, WORKER_THREADS, _jax_run

from adhoc_queries_pointclouds_torch.tools import dist2

SHARDS = 2
COUNTS = [f"{kind}_count_pack{pack}" for pack in "10" for kind in ("bbox", "class", "time")]
NAMES = COUNTS + ["collect", "density_global"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the two workers' reports, {name: (JAX QueryResult, JAX density
    state)})."""
    root = tmp_path_factory.mktemp("torch_dist2_devices")
    dist2.write_datasets(root / "torch")
    shutil.copytree(root / "torch", root / "jax")
    queries = [q for q in dist2.default_queries(root / "torch", root / "out")
               if q["name"] in NAMES]
    reports = dist2.run_workers(queries, procs=2, device="cpu", devices=SHARDS,
                                timeout=TIMEOUT, env=dict(os.environ, **WORKER_THREADS))
    ref = {q["name"]: _jax_run(q, root, root / "jax_out" / q["name"]) for q in queries}
    return reports, ref


def _files(reports, name):
    return [f for w in reports for f in w["queries"][name]["files"]]


def test_each_process_ran_on_two_shards(run):
    reports, _ = run
    assert [(w["pid"], w["procs"], w["devices"]) for w in reports] == [
        (pid, 2, ["cpu"] * SHARDS) for pid in range(2)]
    for w in reports:
        assert sorted(w["queries"]) == sorted(NAMES)
        assert w["launches"] == {}  # CPU tensors run the plain versions: no kernel launch


@pytest.mark.parametrize("name", NAMES)
def test_count_equals_jax_single_process(run, name):
    reports, ref = run
    want = ref[name][0].match_count
    assert [w["queries"][name]["count"] for w in reports] == [want, want]
    assert want > 0


def test_collect_files_equal_jax_single_process(run):
    """Each process writes its own files' hits under host{pid}/; together
    they are the JAX run's files, byte for byte."""
    reports, ref = run
    for w in reports:
        assert w["queries"]["collect"]["files"]
        assert all(f"/host{w['pid']}/" in f for f in w["queries"]["collect"]["files"])
    want = [str(f) for f in ref["collect"][0].output_files]
    assert len(want) == 3
    assert dist2.file_digests(_files(reports, "collect")) == dist2.file_digests(want)


def test_global_density_winners_equal_jax_single_process(run):
    reports, ref = run
    want = [str(f) for f in ref["density_global"][0].output_files]
    got = dist2.point_rows(_files(reports, "density_global"))
    assert got == dist2.point_rows(want)
    assert len(got) == ref["density_global"][0].match_count > 0
