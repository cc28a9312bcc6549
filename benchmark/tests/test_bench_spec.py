"""BENCHMARK.json against the limits of its format, and the harness finding
a configuration, a traffic mix and a metric that are added as new files."""

import io
import json
import re
import shutil

import pytest

from yardstick import harness, spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s and "\t" not in s


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec()


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"]), word
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(body["reduced_from_source"])
        assert c["name"] in used
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4) and one_line(w["why"])
        assert (spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    layers: dict[str, str] = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"]) and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert callable(spec.reader(m["name"]))
    for name in cells:
        c = spec.cell(name)
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and c.per_layer


def test_a_new_config_mix_and_metric_are_found(tmp_path):
    """A later change adds files and entries and edits no file: the
    harness runs the new cell, with its new metric, at a small size."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / spec.BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = spec.load_spec()
    base = json.loads((spec.BENCH_DIR / "configs" / "navvis.json").read_text())
    new = dict(base, name="tiny", points=20_000, tiles=2)
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(new))
    (tmp_path / "benchmark" / "traffic" / "class_only.json").write_text(json.dumps(
        {"cycle": [{"kind": "c", "weight": 1, "request": "class", "classes": [2]}],
         "max_rate_per_s": 100}))
    (tmp_path / "benchmark" / "metrics" / "answered.py").write_text(
        "def read(run):\n    return float(len(run.latencies_s))\n")
    bench["configs"].append({"name": "tiny", "source": "a test", "reduced": [],
                             "file": "benchmark/configs/tiny.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny.class", "config": "tiny", "traffic": "class_only",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "answered", "unit": "queries", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.class"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("tiny.class", root=tmp_path)
    assert cell.config["points"] == 20_000 and cell.mix["cycle"][0]["kind"] == "c"
    assert [m["name"] for m in cell.end_to_end][-1] == "answered"
    out, log = io.StringIO(), io.StringIO()
    assert harness.run(cell, 9, 0.3, False, device="cpu", out=out, log=log) == 0
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"] and result["metrics"]["answered"]["value"] == result["attempted"]
    assert list(result)[-1] == "checks"
    assert log.getvalue().splitlines()[-1] == "check wrong_replies 0 limit 0"
