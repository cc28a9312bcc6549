"""The port's CLI subcommands and flags beside the query (convert, index,
count-points, the bare form, --profile, --devices, experiments, postgis)
against the JAX package's CLI, on the CPU. Every comparison is exact:
lines, and the files written byte for byte."""

import json
import re
import shutil

import pytest
import torch

from adhoc_queries_pointclouds_tpu import cli as jax_cli
from adhoc_queries_pointclouds_torch import cli as torch_cli
from adhoc_queries_pointclouds_torch.formats import synth

BOX = "100200;200300;10;101500;200800;60"
CLIS = (("jax", jax_cli), ("torch", torch_cli))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_drivers")
    synth.write_dataset(root, n_files=2, points_per_file=20_000, seed=14,
                        formats=("las", "last"), clustered=True, point_format=3)
    return root


def _run(cli, args, capsys) -> list[str]:
    assert cli.main(args) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("suffix, strict", [("last", False), ("lazer", False), ("laz", False),
                                            ("laz", True)])
def test_convert_writes_the_jax_clis_bytes(data, capsys, tmp_path, suffix, strict):
    src = data / "las" / "file_1.las"
    got = []
    for name, cli in CLIS:
        dst = tmp_path / name / f"out.{suffix}"
        dst.parent.mkdir()
        args = ["convert", "-i", str(src), "-o", str(dst), "--lazer-block-size", "7000"]
        lines = _run(cli, args + (["--strict-laz"] if strict else []), capsys)
        got.append(([line.replace(str(dst.parent), "OUT") for line in lines], dst.read_bytes()))
    assert got[1] == got[0]
    assert got[1][0] == [f"Converted {src} -> OUT/out.{suffix}"]


def test_convert_to_an_unknown_suffix_exits_1_as_jax_cli(data, capsys, tmp_path):
    args = ["convert", "-i", str(data / "las" / "file_0.las"), "-o", str(tmp_path / "out.xyz")]
    errs = []
    for _, cli in CLIS:
        assert cli.main(args) == 1
        errs.append(capsys.readouterr().err)
    assert errs[1] == errs[0] == "Unsupported conversion target .xyz\n"


@pytest.mark.parametrize("fmt", ["las", "last"])
def test_index_writes_the_jax_clis_sidecars(data, capsys, tmp_path, fmt):
    got = []
    for name, cli in CLIS:
        copy = tmp_path / name
        shutil.copytree(data / fmt, copy, ignore=shutil.ignore_patterns("*.aqpc-idx"))
        lines = _run(cli, ["index", "-i", str(copy)], capsys)
        sidecars = sorted(copy.glob("*.aqpc-idx"))
        got.append(([line.replace(str(copy), "DIR") for line in lines],
                    [(f.name, f.read_bytes()) for f in sidecars]))
    assert got[1] == got[0]
    assert len(got[1][1]) == 2 and all(line.endswith(" + gps)") for line in got[1][0])


@pytest.mark.parametrize("target", ["las", "last", "las/file_0.las"])
def test_count_points_prints_the_jax_clis_line(data, capsys, target):
    lines = [_run(cli, ["count-points", "-i", str(data / target)], capsys) for _, cli in CLIS]
    assert lines[1] == lines[0]
    assert lines[1] == [f"Total number of points: {20_000 if '/' in target else 40_000}"]


@pytest.mark.parametrize("query", [["--bounds", BOX], ["--class", "6"],
                                   ["--bounds", "-1e9;-1e9;-1e9;1e9;1e9;1e9"]])
def test_bare_and_query_forms_give_the_same_lines(data, capsys, query):
    args = ["-i", str(data / "last"), *query, "--block-size", "16384"]
    ref = _run(jax_cli, args, capsys)
    bare = _run(torch_cli, [*args, "--device", "cpu"], capsys)
    sub = _run(torch_cli, ["query", *args, "--device", "cpu"], capsys)
    assert bare[:-1] == sub[:-1] == ref[:-1]
    assert bare[-1].startswith("Searched ") and sub[-1].startswith("Searched ")


def test_profile_writes_a_trace_and_the_jax_line(data, capsys, tmp_path):
    trace_dir = tmp_path / "nested" / "trace"
    lines = _run(torch_cli, ["-i", str(data / "last"), "--bounds", BOX, "--device", "cpu",
                             "--profile", str(trace_dir)], capsys)
    assert lines[0] == f"Profiler trace written to {trace_dir}"
    assert lines[1] == "Searching 2 files..."
    events = json.loads((trace_dir / torch_cli.PROFILE_TRACE).read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # the CPU profile records no device activity
    assert not any(e.get("cat") == "kernel" for e in events)
    for category in ("cpu_op", "kernel"):
        assert torch_cli.profile_events(trace_dir, category) == [
            e for e in events if e.get("cat") == category]


@pytest.mark.parametrize("query, span, runs, last", [
    (["--bounds", BOX], "resident.readback", 3, "3 queries at "),
    # a density query collects once
    (["--bounds", BOX, "--density", "50"], "resident.density.merge", 1, "query in "),
])
def test_resident_profile_holds_the_resident_spans(data, capsys, tmp_path, query, span, runs,
                                                   last):
    """--resident --profile traces the timed queries after the warm count,
    or the collect: the --resident lines with the trace's line and the
    counters' line before "Found" (no launch on the CPU; one box operand
    table a query, each over both files), and each query's resident spans
    in the trace."""
    trace_dir = tmp_path / "trace"
    args = ["-i", str(data / "last"), *query, "--resident", "--repeat", "3", "--device", "cpu"]
    plain = _run(torch_cli, args, capsys)
    lines = _run(torch_cli, [*args, "--profile", str(trace_dir)], capsys)
    assert lines[1] == f"Profiler trace written to {trace_dir}"
    kept = [int(x) for x in re.fullmatch(
        rf"Launches: none; box operand tables {runs}, files kept (\d+), dropped (\d+)",
        lines[2]).groups()]
    assert sum(kept) == 2 * runs
    assert lines[3:-1] == plain[1:-1] and lines[-1].startswith(last)
    names = [e["name"] for e in torch_cli.profile_events(trace_dir, "cpu_op")]
    assert names.count("resident.operands") >= runs and names.count(span) >= runs


@pytest.mark.parametrize("extra", [[], ["--class", "6"]])
def test_devices_1_is_the_default(data, capsys, extra):
    query = extra or ["--bounds", BOX]
    args = ["-i", str(data / "last"), *query, "--device", "cpu"]
    plain = _run(torch_cli, args, capsys)
    one = _run(torch_cli, [*args, "--devices", "1"], capsys)
    assert one[:-1] == plain[:-1]


# --devices cases: N CPU shards print the JAX CLI's --devices N lines, and
# under --distributed its --distributed lines; 0 (alone or with
# --distributed) and more than the machine's cards exit 2
DEVICES_EXIT_2 = {
    "0": (["--device", "cpu", "--devices", "0"],
          "--devices 0: a query needs at least one device"),
    "more_than_cards": (["--device", "cuda", "--devices", "2"],
                        "--devices 2: this machine has 1 CUDA device(s)"),
    "distributed_0": (["--device", "cpu", "--distributed", "--devices", "0"],
                      "--devices 0: a query needs at least one device"),
}


@pytest.mark.parametrize("n", ["2", "8", "distributed", *DEVICES_EXIT_2])
def test_devices_other_than_1_exits_2(data, capsys, monkeypatch, tmp_path, n):
    """--devices N other than 1: N CPU shards (--device cpu) print the JAX
    CLI's lines at --devices N but the timing line, whose end names the N
    devices; --distributed --devices 8 at one process prints the JAX CLI's
    --distributed lines (-o: the files it wrote) but the timing, over 8
    devices, as JAX's global mesh of the 8 virtual devices; N of 0 (also
    under --distributed) and more than the cards exit 2 with a message and
    no output."""
    query = ["-i", str(data / "last"), "--bounds", BOX]
    if n == "distributed":
        lines = []
        for name, cli, flags in (("jax", jax_cli, []),
                                 ("torch", torch_cli, ["--device", "cpu", "--devices", "8"])):
            out = tmp_path / name
            out.mkdir()
            got = _run(cli, [*query, "--distributed", "-o", str(out), *flags], capsys)
            lines.append([line.replace(str(out), "OUT") for line in got])
        (ref, got) = lines
        assert got[:-1] == ref[:-1] == ["Wrote OUT/matching_points_0.las",
                                        "Wrote OUT/matching_points_1.las"]
        timing = r" \(1 process\(es\), 8 devices, [\d.]+s\)"
        assert re.fullmatch(r"Found \d+ matching points" + timing, ref[-1])
        assert re.fullmatch(re.escape(ref[-1].split(" (")[0]) + timing, got[-1])
        return
    if n not in DEVICES_EXIT_2:
        ref = _run(jax_cli, [*query, "--devices", n], capsys)
        got = _run(torch_cli, [*query, "--device", "cpu", "--devices", n], capsys)
        assert got[:-1] == ref[:-1] and got[-1].startswith("Searched ")
        assert got[-1].endswith(" on " + ", ".join(["cpu"] * int(n)))
        return
    flags, message = DEVICES_EXIT_2[n]
    # a machine with one card, as far as the CLI asks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert torch_cli.main([*query, *flags]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert captured.err == message + "\n"


@pytest.mark.parametrize("command", ["experiments", "postgis"])
def test_dispatched_subcommands_help_exits_0(capsys, command):
    for _, cli in CLIS:
        with pytest.raises(SystemExit) as stop:
            cli.main([command, "--help"])
        assert stop.value.code == 0
        assert capsys.readouterr().out.startswith("usage: aqpc-")


def test_profile_on_cuda_without_cuda_raises(data, tmp_path, monkeypatch):
    """--profile --device cuda never profiles a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(["-i", str(data / "last"), "--bounds", BOX, "--device", "cuda",
                        "--profile", str(tmp_path / "trace")])
    assert not (tmp_path / "trace").exists()
