"""The port's CLI against the JAX package's CLI, on the CPU."""

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
])
def test_flags_not_ported_exit_nonzero(data, capsys, tmp_path, flag):
    if flag[0] in ("-o", "--print-points"):
        # ported: exit 0 and the JAX CLI's output, line for line (but the
        # timing line), and -o writes the JAX CLI's files byte for byte
        _same_collect_output(data, capsys, tmp_path, flag)
        return
    args = ["-i", str(data), "--bounds", BOXES[0], "--device", "cpu", *flag]
    assert torch_cli.main(args) != 0
    err = capsys.readouterr().err
    if flag[0] in ("--class", "--time-range"):
        # ported: beside --bounds it is a second predicate, which the JAX
        # CLI refuses with exit 1 and its own message
        assert jax_cli.main(["-i", str(data), "--bounds", BOXES[0], *flag]) == 1
        assert err == capsys.readouterr().err != ""
    else:
        assert "not yet ported" in err


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
