"""The port imports no jax and nothing of the JAX package, and a CUDA run
without CUDA raises.

The import check runs in a subprocess: this test process has jax and the
JAX package loaded already (tests/conftest.py imports jax).
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from adhoc_queries_pointclouds_torch import engine
from adhoc_queries_pointclouds_torch.formats import synth
from adhoc_queries_pointclouds_torch.models.query import (
    BoundsQuery,
    ClassQuery,
    DensityConfig,
    QueryPlan,
    TimeRangeQuery,
)
from adhoc_queries_pointclouds_torch.utils.aabb import parse_aabb

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = "adhoc_queries_pointclouds_tpu"

_PROGRAM = r"""
import contextlib, io, pathlib, sys, tempfile
import adhoc_queries_pointclouds_torch
from adhoc_queries_pointclouds_torch import (
    cli, engine, experiments, host, index, native, postgis, serve, sinks,
)
from adhoc_queries_pointclouds_torch.formats import las, last, laz, lazer, lz4py, synth
from adhoc_queries_pointclouds_torch.models.query import (
    BoundsQuery, ClassQuery, DensityConfig, QueryPlan, TimeRangeQuery,
)
from adhoc_queries_pointclouds_torch.ops import compact, density, predicate
from adhoc_queries_pointclouds_torch.parallel import comm, distributed, pipeline, resident, step
from adhoc_queries_pointclouds_torch.tools import bboxprobe, dist2, memcheck, paperscale, soak
from adhoc_queries_pointclouds_torch.utils import timing
from adhoc_queries_pointclouds_torch.utils.aabb import parse_aabb
with tempfile.TemporaryDirectory() as d:
    synth.write_dataset(d, n_files=1, points_per_file=5000, seed=1, formats=("last", "las"),
                        point_format=3)
    plans = [
        QueryPlan(bounds=BoundsQuery(parse_aabb("-1e9;-1e9;-1e9;1e9;1e9;1e9"))),
        QueryPlan(classification=ClassQuery(4)),
        QueryPlan(time_range=TimeRangeQuery(-1.0, 2e6)),
    ]
    for pack in ("0", "1"):
        import os
        os.environ["AQPC_PACK"] = pack
        counts = [engine.run_query(pathlib.Path(d) / "last", p, device="cpu").match_count
                  for p in plans]
        assert counts[0] == counts[2] == 5000 and 0 < counts[1] < 5000, counts
        for p in plans:  # the collect path: -o and keep_hits
            out = pathlib.Path(d) / f"out_{pack}_{len(os.listdir(d))}"
            out.mkdir()
            res = engine.run_query(pathlib.Path(d) / "last", QueryPlan(
                output_dir=out, bounds=p.bounds, classification=p.classification,
                time_range=p.time_range), device="cpu", keep_hits=True)
            assert res.match_count == sum(h.count for h in res.hits) > 0
            assert [f.name for f in res.output_files] == ["matching_points_0.las"]
            # the density path: both scopes
            for scope in ("file", "global"):
                state = {}
                res = engine.run_query(pathlib.Path(d) / "last", QueryPlan(
                    density=DensityConfig(30.0, scope), bounds=p.bounds,
                    classification=p.classification, time_range=p.time_range),
                    device="cpu", block_size=2048, density_state_out=state,
                    density_grid_bounds=parse_aabb("99000;199000;-10;102000;202000;200"))
                assert 0 < res.match_count < 5000 and sorted(state) == [scope]
    # the resident path: counts, a collect, density, and the service's replies
    ds = resident.ResidentDataset.load(pathlib.Path(d) / "last", device="cpu",
                                       attrs=("position", "classification", "gps_time"))
    assert [ds.count(p) for p in plans] == counts, counts
    n, emitter = ds.collect(QueryPlan(classification=ClassQuery(4), print_points=True),
                            keep_hits=True, print_stream=open(os.devnull, "w"))
    assert n == counts[1] == sum(h.count for h in emitter.all_hits)
    assert 0 < ds.count(QueryPlan(classification=ClassQuery(4),
                                  density=DensityConfig(30.0, "file"))) < 5000
    path = str(pathlib.Path(d) / "last")
    assert serve.handle_request(ds, {"cmd": "info"}, path)["points"] == 5000
    assert serve.handle_request(ds, {"class": 4, "collect": True, "limit": 2}, path)["count"] == n
    # parallel/distributed.py in one process: a count, a collect, density
    assert [distributed.distributed_count(path, p, device="cpu") for p in plans] == counts
    out = pathlib.Path(d) / "dist_out"
    out.mkdir()
    total, res = distributed.distributed_collect(path, plans[1], device="cpu", output_dir=out)
    assert total == counts[1] and len(res.output_files) == 1
    assert 0 < distributed.distributed_density(path, QueryPlan(
        classification=ClassQuery(4), density=DensityConfig(30.0)), device="cpu") < 5000
    # the CLI's host subcommands, and one in-process experiment cell
    d = pathlib.Path(d)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        for suffix in ("last", "lazer", "laz"):
            assert cli.main(["convert", "-i", str(d / "las" / "file_0.las"),
                             "-o", str(d / f"converted.{suffix}")]) == 0
        assert cli.main(["index", "-i", str(d / "las")]) == 0
        assert cli.main(["count-points", "-i", str(d / "las")]) == 0
        experiments.synthesize_dataset(d / "exp", "doc", 1, 2000)
        assert cli.main(["experiments", "-i", str(d / "exp"), "-e", "4", "--runs", "1",
                         "--warm", "--in-process", "--formats", "last", "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[4] == "Total number of points: 5000" and lines[5].startswith("doc_building_last;")
bboxprobe.main(["--n", "4096", "--device", "cpu"])
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "adhoc_queries_pointclouds_tpu")))
"""


def test_port_imports_no_jax():
    """After counts, collects, density queries, resident queries, the
    service's replies, parallel/distributed.py's count, collect and
    density, the CLI's convert, index and count-points, an in-process
    experiment cell and the probe tool in a fresh process, sys.modules
    holds no jax, no jaxlib and nothing of the JAX package."""
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_no_import_line_names_jax_or_the_jax_package():
    """No import or from line of the port's modules or of chip_smoke.py names
    jax or the JAX package."""
    sources = sorted((ROOT / "adhoc_queries_pointclouds_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 30
    line = re.compile(rf"^\s*(import|from)\s.*\b(jax|jaxlib|{JAX_PACKAGE})\b")
    found = [f"{f.relative_to(ROOT)}:{n}: {text.strip()}"
             for f in sources
             for n, text in enumerate(f.read_text().splitlines(), 1) if line.match(text)]
    assert found == []


def test_cuda_without_cuda_raises(tmp_path, monkeypatch):
    """A run asked for on CUDA never carries on on the CPU."""
    synth.write_dataset(tmp_path, n_files=1, points_per_file=1000, seed=2, formats=("last",),
                        point_format=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for plan in (
        QueryPlan(bounds=BoundsQuery(parse_aabb("-1e9;-1e9;-1e9;1e9;1e9;1e9"))),
        QueryPlan(classification=ClassQuery(2)),
        QueryPlan(time_range=TimeRangeQuery(0.0, 1.0)),
        QueryPlan(classification=ClassQuery(2), print_points=True),
        QueryPlan(bounds=BoundsQuery(parse_aabb("0;0;0;1;1;1")), output_dir=tmp_path),
        QueryPlan(classification=ClassQuery(2), density=DensityConfig(5.0)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.run_query(tmp_path / "last", plan, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.run_query(tmp_path / "last", plan, device=torch.device("cuda", 0))


def test_distributed_cuda_without_cuda_raises(tmp_path, monkeypatch):
    """--distributed --device cuda, and parallel/distributed.py on cuda,
    raise without CUDA: no process carries on on the CPU."""
    from adhoc_queries_pointclouds_torch import cli
    from adhoc_queries_pointclouds_torch.parallel import distributed

    synth.write_dataset(tmp_path, n_files=1, points_per_file=1000, seed=2, formats=("last",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    box = "-1e9;-1e9;-1e9;1e9;1e9;1e9"
    for extra in ([], ["-o", str(tmp_path)], ["--density", "5"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["-i", str(tmp_path / "last"), "--bounds", box, "--distributed", *extra])
    plan = QueryPlan(bounds=BoundsQuery(parse_aabb(box)))
    for fn in (distributed.distributed_count, distributed.distributed_density,
               distributed.distributed_collect):
        p = plan if fn is not distributed.distributed_density else QueryPlan(
            bounds=plan.bounds, density=DensityConfig(5.0))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(tmp_path / "last", p, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.process_device("cuda")
