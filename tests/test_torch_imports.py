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
    QueryPlan,
    TimeRangeQuery,
)
from adhoc_queries_pointclouds_torch.utils.aabb import parse_aabb

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = "adhoc_queries_pointclouds_tpu"

_PROGRAM = r"""
import pathlib, sys, tempfile
import adhoc_queries_pointclouds_torch
from adhoc_queries_pointclouds_torch import cli, engine, host, index, native, sinks
from adhoc_queries_pointclouds_torch.formats import las, last, laz, lazer, lz4py, synth
from adhoc_queries_pointclouds_torch.models.query import (
    BoundsQuery, ClassQuery, QueryPlan, TimeRangeQuery,
)
from adhoc_queries_pointclouds_torch.ops import compact, predicate
from adhoc_queries_pointclouds_torch.parallel import comm, pipeline, step
from adhoc_queries_pointclouds_torch.tools import bboxprobe
from adhoc_queries_pointclouds_torch.utils import timing
from adhoc_queries_pointclouds_torch.utils.aabb import parse_aabb
with tempfile.TemporaryDirectory() as d:
    synth.write_dataset(d, n_files=1, points_per_file=5000, seed=1, formats=("last",),
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
bboxprobe.main(["--n", "4096", "--device", "cpu"])
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "adhoc_queries_pointclouds_tpu")))
"""


def test_port_imports_no_jax():
    """After counts, collects and the probe tool in a fresh process,
    sys.modules holds no jax, no jaxlib and nothing of the JAX package."""
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_no_import_line_names_jax_or_the_jax_package():
    """No import or from line of the port's modules or of chip_smoke.py names
    jax or the JAX package."""
    sources = sorted((ROOT / "adhoc_queries_pointclouds_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 25
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
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.run_query(tmp_path / "last", plan, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.run_query(tmp_path / "last", plan, device=torch.device("cuda", 0))
