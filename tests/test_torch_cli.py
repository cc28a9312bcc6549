"""The port's CLI against the JAX package's CLI, on the CPU."""

import io
import json
import re

import pytest

from adhoc_queries_pointclouds_tpu import cli as jax_cli
from adhoc_queries_pointclouds_torch import cli as torch_cli
from adhoc_queries_pointclouds_torch.formats import synth

BOXES = [
    "100200;200300;10;101500;200800;60",
    "-1e9;-1e9;-1e9;1e9;1e9;1e9",  # negative mins go through the hyphen fold
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    synth.write_dataset(root, n_files=2, points_per_file=30_000, seed=9,
                        formats=("last",), clustered=True)
    return root / "last"


def _found(out: str) -> int:
    m = re.search(r"^Found (\d+) matching points$", out, re.M)
    assert m, out
    return int(m.group(1))


@pytest.mark.parametrize("extra", [[], ["--no-index", "--stats"]])
@pytest.mark.parametrize("box", BOXES)
def test_found_line_matches_jax_cli(data, capsys, box, extra):
    args = ["-i", str(data), "--bounds", box, "--block-size", "16384", *extra]
    assert jax_cli.main(args) == 0
    ref = capsys.readouterr().out
    assert torch_cli.main([*args, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _found(out) == _found(ref) > 0
    assert out.splitlines()[0] == "Searching 2 files..."
    assert out.splitlines()[-1].startswith("Searched ")
    if "--stats" in extra:
        assert "Mpts/s" in out and "scan:" in out


@pytest.mark.parametrize("flag", [
    ["--class", "6"],
    ["--time-range", "0;1"],
    ["--density", "1.0"],
    ["--density-scope", "file"],
    ["-o", "out"],
    ["--print-points"],
    ["--resident"],
    ["--repeat", "5"],
    ["--distributed"],
    ["--profile", "trace"],
    ["--devices", "2"],
    ["serve"],
])
def test_flags_not_ported_exit_nonzero(data, capsys, tmp_path, monkeypatch, flag):
    if flag[0] in ("--resident", "--repeat"):
        # ported: the JAX CLI's lines but the timing numbers
        _same_resident_output(data, capsys, flag)
        return
    if flag[0] == "serve":
        # ported: the JAX service's replies but times and layout
        _same_serve_output(data, capsys, monkeypatch)
        return
    if flag[0] in ("-o", "--print-points"):
        # ported: exit 0 and the JAX CLI's output, line for line (but the
        # timing line), and -o writes the JAX CLI's files byte for byte
        _same_collect_output(data, capsys, tmp_path, flag)
        return
    if flag[0] in ("--density", "--density-scope"):
        # ported: --density samples the box's points; --density-scope alone
        # is the plain count, as in the JAX CLI
        _same_density_output(data, capsys, tmp_path, flag, ["--bounds", BOXES[0]])
        return
    if flag[0] == "--distributed":
        # ported: in one process, the JAX CLI's lines but the last line's
        # timing and device count
        _same_distributed_output(data, capsys, tmp_path)
        return
    if flag[0] == "--profile":
        # ported: torch.profiler's trace in DIR, then the JAX CLI's lines
        _same_profile_output(data, capsys, tmp_path)
        return
    if flag[0] == "--devices":
        # ported: each step over 2 shards (CPU ones here), the JAX CLI's
        # lines at --devices 2 but the timing line
        _same_devices_output(data, capsys)
        return
    args = ["-i", str(data), "--bounds", BOXES[0], "--device", "cpu", *flag]
    assert torch_cli.main(args) != 0
    err = capsys.readouterr().err
    if flag[0] in ("--class", "--time-range"):
        # ported: beside --bounds it is a second predicate, which the JAX
        # CLI refuses with exit 1 and its own message
        assert jax_cli.main(["-i", str(data), "--bounds", BOXES[0], *flag]) == 1
        assert err == capsys.readouterr().err != ""


def _same_devices_output(data, capsys):
    """--devices 2 over a count, a collect and density, each printing its
    points: the JAX CLI's lines but the timing line, which ends with the
    two devices."""
    for extra in ([], ["--print-points"], ["--density", "25", "--print-points"]):
        args = ["-i", str(data), "--bounds", BOXES[0], "--block-size", "16384", "--devices", "2",
                *extra]
        assert jax_cli.main(args) == 0
        ref = capsys.readouterr().out.splitlines()
        assert torch_cli.main([*args, "--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[:-1] == ref[:-1] and _found("\n".join(out)) > 0
        assert out[-1].startswith("Searched ") and out[-1].endswith(" on cpu, cpu")


def _same_profile_output(data, capsys, tmp_path):
    """--profile DIR: the JAX CLI's first line, "Profiler trace written to
    DIR", a Chrome trace in DIR, and then the lines of the same query
    without --profile (but the timing line)."""
    trace_dir = tmp_path / "trace"
    args = ["-i", str(data), "--bounds", BOXES[0], "--block-size", "16384", "--device", "cpu"]
    assert torch_cli.main(args) == 0
    plain = capsys.readouterr().out.splitlines()
    assert torch_cli.main([*args, "--profile", str(trace_dir)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"Profiler trace written to {trace_dir}"
    assert lines[1:-1] == plain[:-1] and _found("\n".join(lines)) > 0
    trace = json.loads((trace_dir / torch_cli.PROFILE_TRACE).read_text())
    assert trace["traceEvents"]


def _same_distributed_output(data, capsys, tmp_path):
    """--distributed in one process (no coordinator): a count, a collect
    with -o and density with -o give the JAX CLI's lines but the timing and
    the device count of the last one (each process of the port drives one
    device; the JAX process sees its 8-device CPU mesh), and -o writes the
    JAX CLI's files byte for byte."""
    for n, extra in enumerate(([], ["-o", "OUT"], ["--density", "25", "-o", "OUT"])):
        outs = []
        for name, cli, device in (("jax", jax_cli, []), ("torch", torch_cli, ["--device", "cpu"])):
            out_dir = tmp_path / f"{name}_{n}"
            out_dir.mkdir()
            args = ["-i", str(data), "--bounds", BOXES[0], "--block-size", "16384",
                    "--distributed", *device, *(str(out_dir) if a == "OUT" else a for a in extra)]
            assert cli.main(args) == 0
            lines = capsys.readouterr().out.replace(str(out_dir), "OUT").splitlines()
            outs.append((lines[:-1], re.sub(r"\d+ devices, [\d.]+s\)$", "", lines[-1]),
                         [f.read_bytes() for f in sorted(out_dir.glob("*.las"))]))
            if cli is torch_cli:
                assert re.search(r"\(1 process\(es\), 1 devices, [\d.]+s\)$", lines[-1])
        assert outs[1] == outs[0]
        assert _found(outs[1][1].split(" (")[0]) > 0
        # the collect names its files; density writes one and names none
        assert len(outs[1][2]) == (0, 2, 1)[n] and len(outs[1][0]) == (0, 2, 0)[n]


def _resident_lines(out: str) -> list[str]:
    """The CLI's lines with the resident path's timing numbers and its
    device-memory size (which follows each package's block layout) cut."""
    out = re.sub(r"[\d.]+ MiB in HBM, loaded in [\d.]+s", "MiB in HBM, loaded", out)
    out = re.sub(r"queries at [\d.]+ ms/query \(\d+ Mpts/s/query\)", "queries at", out)
    return out.splitlines()


def _same_resident_output(data, capsys, flag):
    """--resident, and --repeat alone (a streamed count, as in the JAX CLI)
    and with --resident: the JAX CLI's lines but the timing numbers, and
    the port's device memory of its own 4 blocks of 2^14 points."""
    runs = [flag] if flag[0] == "--resident" else [flag, ["--resident", *flag]]
    for extra in runs:
        args = ["-i", str(data), "--bounds", BOXES[0], "--block-size", "16384", *extra]
        assert jax_cli.main(args) == 0
        ref = capsys.readouterr().out
        assert torch_cli.main([*args, "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert _found(out) == _found(ref) > 0
        if "--resident" not in extra:
            assert out.splitlines()[:-1] == ref.splitlines()[:-1]
            continue
        assert _resident_lines(out) == _resident_lines(ref)
        mib = 4 * 16384 * 12 / 1048576.0  # x, y, z of 2 files x 2 blocks
        assert out.startswith(f"Resident: 60000 points, {mib:.1f} MiB in HBM, loaded in ")
        repeat = int(extra[extra.index("--repeat") + 1]) if "--repeat" in extra else 1
        assert re.search(rf"^{repeat} queries at [\d.]+ ms/query", out, re.M)


def _same_serve_output(data, capsys, monkeypatch):
    """`serve` over the same stdin lines: the JAX service's replies but the
    times and the layout fields (blocks, devices, device memory)."""
    lines = [{"cmd": "info"}, {"bounds": [100200, 200300, 10, 101500, 200800, 60]},
             {"class": 6, "collect": True, "limit": 3}, {"bounds": [1, 2]}, {"cmd": "quit"}]
    stdin = "\n".join(json.dumps(r) for r in lines) + "\nnot json\n"
    replies = []
    for cli, extra in ((jax_cli, []), (torch_cli, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        assert cli.main(["serve", "-i", str(data), "--block-size", "16384", *extra]) == 0
        replies.append([{k: v for k, v in json.loads(line).items()
                         if k not in ("ms", "load_s", "resident_mib", "blocks", "devices")}
                        for line in capsys.readouterr().out.splitlines()])
    assert replies[0] == replies[1]
    assert len(replies[1]) == len(lines) + 1  # the ready line; nothing after quit
    assert replies[1][0] == {"ready": True, "points": 60_000}
    assert replies[1][2]["count"] > 0 and len(replies[1][3]["points"]) == 3
    assert replies[1][-1] == {"bye": True}


def _same_collect_output(data, capsys, tmp_path, flag):
    outs = []
    for name, cli, extra in (("jax", jax_cli, []), ("torch", torch_cli, ["--device", "cpu"])):
        out_dir = tmp_path / name
        out_dir.mkdir()
        args = ["-i", str(data), "--bounds", BOXES[0], "--block-size", "16384", *extra]
        args += ["-o", str(out_dir)] if flag[0] == "-o" else flag
        assert cli.main(args) == 0
        lines = capsys.readouterr().out.replace(str(out_dir), "OUT").splitlines()
        assert lines[-1].startswith("Searched ")
        outs.append((lines[:-1], sorted(out_dir.glob("*.las")) if flag[0] == "-o" else []))
    (ref, ref_files), (got, got_files) = outs
    assert got == ref
    n = _found("\n".join(got))
    assert n > 0
    if flag[0] == "-o":
        assert got[1:-1] == ["Wrote OUT/matching_points_0.las", "Wrote OUT/matching_points_1.las"]
        assert [f.name for f in got_files] == [f.name for f in ref_files]
        for a, b in zip(got_files, ref_files):
            assert a.read_bytes() == b.read_bytes()
    else:
        assert sum(line.startswith("Found point: (") for line in got) == n


def _same_density_output(data, capsys, tmp_path, flags, query):
    """Both CLIs over data with the same flags: the same lines (but the
    timing line and --stats' timings), and with -o the same LAS bytes."""
    outs = []
    for name, cli, extra in (("jax", jax_cli, []), ("torch", torch_cli, ["--device", "cpu"])):
        out_dir = tmp_path / name
        out_dir.mkdir()
        args = ["-i", str(data), *query, "--block-size", "16384", *extra]
        args += [a if a != "OUT" else str(out_dir) for a in flags]
        assert cli.main(args) == 0
        lines = capsys.readouterr().out.replace(str(out_dir), "OUT").splitlines()
        assert lines[-1].startswith("Searched ")
        outs.append((lines[:-1], [f.read_bytes() for f in sorted(out_dir.glob("*.las"))]))
    assert outs[0] == outs[1]
    assert _found("\n".join(outs[1][0])) > 0
    return outs[1]


@pytest.mark.parametrize("scope", [[], ["--density-scope", "file"], ["--density-scope", "global"]],
                         ids=["default", "file", "global"])
@pytest.mark.parametrize("sink", [["-o", "OUT"], ["--print-points"], []],
                         ids=["output", "print", "count"])
def test_density_output_matches_jax_cli(data, capsys, tmp_path, sink, scope):
    lines, files = _same_density_output(data, capsys, tmp_path,
                                        ["--density", "25", *scope, *sink],
                                        ["--bounds", BOXES[0]])
    n = _found("\n".join(lines))
    plain = _found(_run_torch(data, capsys, ["--bounds", BOXES[0]]))
    assert 0 < n < plain  # the grid thins the box's points
    if sink == ["-o", "OUT"]:
        per_file = scope == ["--density-scope", "file"]
        wrote = [line for line in lines if line.startswith("Wrote ")]
        assert wrote == [f"Wrote OUT/matching_points_{j}.las" for j in range(2 if per_file else 1)]
        assert len(files) == len(wrote)
    if sink == ["--print-points"]:
        assert sum(line.startswith("Found point: (") for line in lines) == n


def _run_torch(data, capsys, query):
    assert torch_cli.main(["-i", str(data), *query, "--block-size", "16384",
                           "--device", "cpu"]) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def gps_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_gps")
    synth.write_dataset(root, n_files=2, points_per_file=30_000, seed=10,
                        formats=("last",), clustered=True, point_format=3)
    return root / "last"


# 2 files of 30k points at 200k points/s: times in [0, 0.3)
@pytest.mark.parametrize("extra", [[], ["--no-index", "--stats"]])
@pytest.mark.parametrize("query", [
    ["--class", "6"],
    ["--class", "2"],
    ["--class", "4"],
    ["--time-range", "0.05;0.2"],
    ["--time-range", "-1;0.1"],  # a negative start goes through the hyphen fold
])
def test_class_and_time_found_line_matches_jax_cli(gps_data, capsys, query, extra):
    args = ["-i", str(gps_data), *query, "--block-size", "16384", *extra]
    assert jax_cli.main(args) == 0
    ref = capsys.readouterr().out
    assert torch_cli.main([*args, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _found(out) == _found(ref)
    assert (_found(out) == 0) == (query == ["--class", "4"])
    assert out.splitlines()[0] == "Searching 2 files..."
    assert out.splitlines()[-1].startswith("Searched ")


@pytest.mark.parametrize("args", [
    ["--class", "6", "--time-range", "0;1"],
    ["--time-range", "0;1;2"],
    [],
])
def test_bad_predicates_exit_1_as_jax_cli(gps_data, capsys, args):
    argv = ["-i", str(gps_data), *args]
    assert jax_cli.main(argv) == 1
    ref = capsys.readouterr().err
    assert torch_cli.main([*argv, "--device", "cpu"]) == 1
    assert capsys.readouterr().err == ref != ""


def test_time_range_over_gps_less_data_raises_as_jax_cli(data):
    args = ["-i", str(data), "--time-range", "0;1"]
    with pytest.raises(ValueError, match="does not contain GPS times!") as want:
        jax_cli.main(args)
    with pytest.raises(ValueError) as got:
        torch_cli.main([*args, "--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("query", [["--class", "6"], ["--time-range", "0.05;0.2"]])
def test_density_without_a_box_matches_jax_cli(gps_data, capsys, tmp_path, query):
    """Class and time plans take the files' total bounds as the grid."""
    lines, files = _same_density_output(gps_data, capsys, tmp_path,
                                        ["--density", "50", "-o", "OUT"], query)
    assert len(files) == 1 and "Wrote OUT/matching_points_0.las" in lines
