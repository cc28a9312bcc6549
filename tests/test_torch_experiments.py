"""The port's experiment harness against the JAX package's, on the CPU: the
published constants, the CSV rows, the synthetic stand-in's bytes, and
cells of experiments 1 (with density), 4 and 6 through both harnesses.
Every comparison is exact."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from adhoc_queries_pointclouds_tpu import experiments as jax_exp
from adhoc_queries_pointclouds_torch import experiments as torch_exp

ROOT = Path(__file__).resolve().parent.parent


def _boxes(aabbs: dict) -> dict:
    return {d: {s: (b.min, b.max) for s, b in boxes.items()} for d, boxes in aabbs.items()}


def test_published_constants_equal_the_jax_modules():
    assert _boxes(torch_exp.AABBS) == _boxes(jax_exp.AABBS)
    for name in ("FORMATS", "DENSITIES", "CLASS_EXPERIMENTS", "TIME_RATE", "TIME_EXPERIMENTS",
                 "EXPERIMENT_DATASETS"):
        assert getattr(torch_exp, name) == getattr(jax_exp, name), name


@pytest.mark.parametrize("times, count, ncapped", [
    ([1.0, 2.0, 3.0], 42, 0),
    ([0.25], None, 0),
    ([1.0, 9.0], None, 1),
    ([0.1, 0.2, 0.3, 0.4, 0.5], 2**31 + 5, 2),
])
def test_stats_row_equals_the_jax_modules(times, count, ncapped):
    assert (torch_exp._stats_row("doc_s_full_las", times, count, ncapped)
            == jax_exp._stats_row("doc_s_full_las", times, count, ncapped))


@pytest.mark.parametrize("dataset, clustered", [("navvis3", False), ("doc", True),
                                                ("navvis3t", True)])
def test_synthesize_dataset_writes_the_jax_modules_bytes(tmp_path, dataset, clustered):
    trees = []
    for name, exp in (("jax", jax_exp), ("torch", torch_exp)):
        exp.synthesize_dataset(tmp_path / name, dataset, 2, 3_000, seed=5, clustered=clustered)
        files = sorted(p for p in (tmp_path / name).rglob("*") if p.is_file())
        trees.append([(str(p.relative_to(tmp_path / name)), p.read_bytes()) for p in files])
    assert trees[1] == trees[0]
    assert len(trees[1]) == 2 * len(torch_exp.FORMATS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_experiments")
    for dataset in ("navvis3", "doc", "navvis3t"):
        torch_exp.synthesize_dataset(root, dataset, 2, 4_000, clustered=True)
    return root


def _rows(text: str) -> list[tuple]:
    """Each row's label and its count, runs and capped columns."""
    return [(r[0], *r[4:]) for r in (line.split(";") for line in text.splitlines())]


@pytest.mark.parametrize("e", [1, 4, 6])
def test_in_process_cells_equal_the_jax_harness(root, capsys, e):
    dataset = jax_exp.EXPERIMENT_DATASETS[e]
    run = {1: "run_aabb_experiments", 4: "run_class_experiments", 6: "run_time_experiments"}[e]
    kw = dict(cold=False, in_process=True)
    if e == 1:
        kw["sizes"] = ("l",)  # full and max-density
    getattr(jax_exp, run)(root, 2, dataset, **kw)
    want = _rows(capsys.readouterr().out)
    getattr(torch_exp, run)(root, 2, dataset, device="cpu", **kw)
    got = _rows(capsys.readouterr().out)
    assert got == want
    assert len(got) == {1: 2, 4: 2, 6: 3}[e] * len(torch_exp.FORMATS)
    assert any(int(r[1]) > 0 for r in got) and all(r[2:] == ("2", "0") for r in got)


def test_subprocess_cell_on_the_cpu(root, capsys):
    """One cold-protocol cell of the port's harness: a fresh CLI process a
    run, --device cpu; its count is the JAX harness's in-process one."""
    args = ["-i", str(root), "-e", "4", "--runs", "1", "--warm", "--formats", "last"]
    assert torch_exp.main([*args, "--device", "cpu"]) == 0
    got = _rows(capsys.readouterr().out)
    jax_exp.run_class_experiments(root, 1, "doc", cold=False, in_process=True, formats=("last",))
    assert got == _rows(capsys.readouterr().out)
    assert [r[0] for r in got] == ["doc_building_last", "doc_noclass_last"]


def test_subprocess_cell_on_cuda_without_a_card_fails(root, monkeypatch):
    """A cell asked for on the card, in a process that sees no card, exits
    non-zero, and the harness raises: it never runs the cell on the CPU."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    path = root / "doc" / "last"
    with pytest.raises(RuntimeError, match=r"query failed on .* \(exit 1\)"):
        torch_exp.execute_query(path, ["--class", "6"], cold=False, device="cuda")
    proc = subprocess.run(torch_exp._query_cmd(path, ["--class", "6"], "cuda"), cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert "Found" not in proc.stdout


def test_cuda_without_a_card_raises_before_any_work(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_exp.main(["-i", str(tmp_path), "-e", "1", "--synthesize", "1000"])
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_exp.run_class_experiments(tmp_path, 1, "doc", cold=False, in_process=True)


def test_query_cmd_spawns_the_ports_cli():
    cmd = torch_exp._query_cmd(Path("d"), ["--class", "6"], "cpu")
    assert cmd[:3] == [sys.executable, "-m", "adhoc_queries_pointclouds_torch.cli"]
    assert cmd[3:] == ["-i", "d", "--optimized", "--parallel", "--device", "cpu", "--class", "6"]
    assert jax_exp._query_cmd(Path("d"), ["--class", "6"])[3:] == [
        "-i", "d", "--optimized", "--parallel", "--class", "6"]
