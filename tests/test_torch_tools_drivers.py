"""The port's soak, memcheck and paperscale tools on the CPU at small sizes,
paperscale against the root tools/paperscale.py (its bytes and its
oracle), and each tool's refusal to run a cuda request without a card."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from adhoc_queries_pointclouds_torch.tools import memcheck, paperscale, soak

ROOT = Path(__file__).resolve().parent.parent
SOAK = ["--device", "cpu", "--points-per-file", "4000", "--files", "2", "--block-size", "8192"]


def _root_paperscale():
    """The root tools/paperscale.py (a script, not a package module)."""
    path = ROOT / "tools" / "paperscale.py"
    spec = importlib.util.spec_from_file_location("root_paperscale", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_soak_passes_on_the_cpu(capsys):
    assert soak.main(SOAK) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(line.startswith("OK ") for line in lines) == 9
    assert lines[-1].endswith(" 0 failures")


def test_soak_fails_when_one_format_miscounts(capsys, monkeypatch):
    real = soak.run_query

    def off_by_one_on_lazer(path, plan, **kw):
        res = real(path, plan, **kw)
        if Path(path).name == "lazer":
            res.match_count += 1
        return res

    monkeypatch.setattr(soak, "run_query", off_by_one_on_lazer)
    assert soak.main(SOAK) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(line.startswith("FAIL") for line in lines) == 9
    assert lines[-1].endswith(" 9 failures")


def test_memcheck_streams_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("AQPC_SPOOL_MB", "128")  # restored after memcheck sets it
    assert memcheck.main(["--device", "cpu", "--points", "60000", "--files", "3",
                          "--spool-mb", "1"]) == 0
    out = capsys.readouterr().out
    assert "collected 0.1M hits" in out and "wrote 0.1M points" in out
    assert out.strip().splitlines()[-1] == "STREAMING OK (bounded working set)"


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    root = tmp_path_factory.mktemp("paperscale")
    assert paperscale.main(["generate", "--root", str(root), "--files", "2",
                            "--pts-per-file", "50000"]) == 0
    return root


def test_paperscale_generate_writes_the_root_tools_bytes(scale, tmp_path):
    _root_paperscale().generate(tmp_path, 2, 50_000)
    ours = paperscale.file_paths(scale, 2)
    theirs = sorted((tmp_path / "last").iterdir())
    assert [p.name for p in ours] == [p.name for p in theirs] == ["file_0.last", "file_1.last"]
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(ours, theirs))


def test_paperscale_oracle_equals_the_root_tools(scale):
    want = _root_paperscale().oracle(scale, 2)
    assert paperscale.oracle(scale, 2) == want
    assert want["points"] == want["xl"] == 100_000 and 0 < want["partial"] < 100_000


def test_paperscale_run_passes_every_check(scale, tmp_path, capsys):
    report = tmp_path / "report.json"
    assert paperscale.main(["run", "--root", str(scale), "--files", "2", "--device", "cpu",
                            "--json", str(report)]) == 0
    got = json.loads(report.read_text())
    assert got["pass"] and got["backend"] == "cpu"
    for label in ("count_xl", "count_class6", "collect_xl", "collect_partial"):
        assert got[label]["ok"] and got[label]["count"] == got[label]["expect"] > 0
    assert got["collect_partial"]["count"] == got["oracle"]["partial"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("PASS on cpu")


@pytest.mark.parametrize("tool, argv", [
    (soak, ["--device", "cuda"]),
    (memcheck, ["--device", "cuda", "--points", "1000"]),
    (paperscale, ["run", "--files", "2", "--device", "cuda"]),
    (paperscale, ["all", "--files", "2", "--pts-per-file", "1000"]),
])
def test_cuda_without_a_card_fails_before_any_work(tmp_path, monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(tool, "run_query", lambda *a, **k: ran.append(a), raising=False)
    if tool is paperscale:
        argv = [*argv, "--root", str(tmp_path / "scale")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
    assert ran == [] and not (tmp_path / "scale").exists()
