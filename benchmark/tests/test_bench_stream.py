"""The streamed deployment (a configuration with "stream"): the files left on
disk and every request a scan of them through engine.run_query. On the CPU
at a small size: a run is correct, leaves no sidecar, and comes out not
correct with its timed path broken underneath (an answer altered where it
is produced, half of a step's blocks left out and the mean taken over the
rest, a reply that repeats the last one) or with the index switched on.
The resident cells keep their own path. The streamed path's readers on a
trace made by hand."""

import io
import json

import pytest
import torch

from yardstick import harness, spec, trace
from yardstick.harness import RunView
from yardstick.synth import Dataset

STREAM_READERS = ("open_idle_ms", "scan_idle_ms", "h2d_ms")
SHARED_READERS = ("idle_share", "host_ms", "kernels_per_query")
SEED = 2**31 + 91


def tiny(name: str, **stream):
    c = spec.cell(name)
    c.config = dict(c.config, points=40_000)  # the tiles, and so the extent, kept
    if stream:
        c.config["stream"] = dict(c.config["stream"], **stream)
    return c


def run(cell, seconds=0.5):
    out, log = io.StringIO(), io.StringIO()
    assert harness.run(cell, SEED, seconds, False, device="cpu", out=out, log=log) == 0
    return json.loads(out.getvalue().splitlines()[-1]), log.getvalue()


def test_a_small_stream_run_is_correct_and_leaves_no_sidecar():
    result, log = run(tiny("doc.stream"), 2.0)  # a cycle of ten requests or more
    assert result["correct"] is True and result["failed"] == 0, log[-800:]
    assert result["checks"] == {"wrong_replies": {"value": 0, "limit": 0},
                                "sidecar_files": {"value": 0, "limit": 0}}
    assert result["compared"]["kinds"] == 4
    assert set(result["metrics"]) == {"queries_per_s", "query_p50_ms", "query_p95_ms",
                                      "setup_s"}
    assert log.splitlines()[-1] == "check sidecar_files 0 limit 0"
    assert "fsync" in log


def test_a_scan_that_builds_a_sidecar_is_not_correct():
    """With the index on, a box scan writes its sidecar (index.py): the
    deployment is no longer brute-force, and the check says so."""
    result, log = run(tiny("doc.stream", use_index=True))
    assert result["checks"]["sidecar_files"]["value"] > 0, log[-800:]
    assert result["checks"]["wrong_replies"]["value"] == 0
    assert result["correct"] is False


def plant(monkeypatch, fault: str) -> None:
    from adhoc_queries_pointclouds_torch import engine
    from adhoc_queries_pointclouds_torch.ops import predicate

    if fault == "altered":
        real = engine.run_query

        def altered(*args, **kw):
            res = real(*args, **kw)
            res.match_count += 1
            return res

        monkeypatch.setattr(engine, "run_query", altered)
    elif fault == "half_batch":
        def halve(entry):
            def run_half(*args, **kw):
                c = entry(*args, **kw)
                half = max(c.shape[0] // 2, 1)
                mean = c[:half].to(torch.float64).mean()
                return torch.full_like(c, int(torch.round(mean)))
            return run_half

        for name in ("bbox_count_packed_kernel", "class_count_dict_kernel",
                     "bbox_count_multi_kernel", "class_count_words_kernel"):
            monkeypatch.setattr(predicate, name, halve(getattr(predicate, name)))
    elif fault == "unchanged":
        real, last = engine.run_query, []

        def stale(*args, **kw):
            now = real(*args, **kw)
            out = last[-1] if last else now
            last.append(now)
            return out

        monkeypatch.setattr(engine, "run_query", stale)


@pytest.mark.parametrize("fault", ["altered", "half_batch", "unchanged"])
def test_a_broken_streamed_path_is_not_correct(monkeypatch, fault):
    plant(monkeypatch, fault)
    result, log = run(tiny("doc.stream"))
    wrong = result["checks"]["wrong_replies"]
    assert wrong["value"] > 0 and wrong["limit"] == 0, log[-800:]
    assert result["correct"] is False


def test_the_paths_keep_apart(monkeypatch):
    """A resident cell never reaches the streamed path, and a streamed one
    never loads a resident dataset."""
    from adhoc_queries_pointclouds_torch.parallel import resident

    def refuse(*args, **kw):
        raise AssertionError("the other deployment's path was taken")

    monkeypatch.setattr(harness, "stream_answer", refuse)
    monkeypatch.setattr(harness, "drive_stream", refuse)
    result, _ = run(tiny("doc.count"), 0.3)
    assert result["correct"] and "sidecar_files" not in result["checks"]
    monkeypatch.undo()
    monkeypatch.setattr(resident.ResidentDataset, "load", refuse)
    monkeypatch.setattr(harness, "drive", refuse)
    result, _ = run(tiny("doc.stream"), 0.3)
    assert result["correct"]


def test_benchmark_json_names_the_configuration_cell_and_readers():
    bench = spec.load_spec()
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs["doc_files"]["file"] == "benchmark/configs/doc_files.json"
    assert configs["doc_files"]["reduced"] == ["points"]
    assert configs["doc_files"]["source"] != configs["doc"]["source"]
    cell = spec.cell("doc.stream")
    assert cell.chips == 1 and cell.mix == spec.cell("doc.count").mix
    assert "stream" in cell.config and "serve" not in cell.config
    assert cell.config["stream"]["use_index"] is False
    doc = spec.cell("doc.count").config
    for key in ("points", "tiles", "point_format", "scale", "offset", "tile_extent_m",
                "classes", "generator", "published_xl_box"):
        assert cell.config[key] == doc[key], key
    assert {m["name"] for m in cell.end_to_end} == {
        "queries_per_s", "query_p50_ms", "query_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {*STREAM_READERS, *SHARED_READERS}
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in STREAM_READERS:
        assert entries[name]["workloads"] == ["doc.stream"]
    assert entries["open_idle_ms"]["moves"] == "query_p50_ms"
    assert entries["scan_idle_ms"]["moves"] == entries["h2d_ms"]["moves"] == "queries_per_s"
    for name in SHARED_READERS:
        assert entries[name]["workloads"] == ["doc.count", "navvis.count", "doc.stream",
                                              "navvis.collect"]


def ev(cat, name, ts, dur, tid=7, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def events():
    """Two streamed requests (100-600 us, 700-1000 us) under the harness's
    engine.request: engine.open, then engine.scan with engine.h2d and its
    runtime copy nested, a launch; on the device two HtoD copies, a kernel
    and a DtoH copy. A decode thread's event (tid 9) is not the window's."""
    return [
        ev("user_annotation", trace.WINDOW_SPAN, 0, 1200),
        ev("user_annotation", "engine.request", 100, 500),
        ev("cpu_op", "engine.open", 110, 40),
        ev("cpu_op", "engine.scan", 200, 380),
        ev("cpu_op", "engine.h2d", 300, 100),
        ev("cuda_runtime", "cudaMemcpyAsync", 310, 80),
        ev("cuda_runtime", "cudaLaunchKernel", 450, 10, correlation=1),
        ev("cpu_op", "numpy decode", 120, 400, tid=9),
        ev("user_annotation", "engine.request", 700, 300),
        ev("cpu_op", "engine.open", 710, 20),
        ev("cpu_op", "engine.scan", 750, 240),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 320,
         "dur": 60, "pid": 0, "tid": 3},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 800,
         "dur": 40, "pid": 0, "tid": 3},
        {"ph": "X", "cat": "kernel", "name": "bbox_count_packed_kernel<true>", "ts": 460,
         "dur": 50, "pid": 0, "tid": 3, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 560,
         "dur": 5, "pid": 0, "tid": 3},
    ]


def run_view(tmp_path, evs=None):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": evs or events()}))
    ds = Dataset(files=[], columns=[], counts=[], offsets=[], scale=(0.001,) * 3, wmin=[],
                 wmax=[], point_format=0, time_rate=200_000.0)
    return RunView(kinds=["box_l", "class"], requests=[{}, {}], latencies_s=[500e-6, 300e-6],
                   window_s=1.2e-3, setup_s=1.0, dataset=ds, config={}, mix={},
                   device_kind="NVIDIA H100 80GB HBM3", trace=trace.read(path), launches={})


def test_idle_under_counts_the_nested_calls():
    """engine.scan of request 1 (200-580) is idle but for the copy
    (320-380) and the kernel (460-510): 270 us, the h2d span's and the
    runtime call's idle in it included; idle_by_host gives the scan only
    what no nested event covers."""
    tr = trace.Trace(0, 1000, [], 0, 0, {},
                     idle_spans=trace.gaps([(320, 380), (460, 510)], 0, 1000),
                     host=[(200, 580, "engine.scan"), (300, 400, "engine.h2d")])
    assert tr.idle_under("engine.scan") == pytest.approx(270e-6)
    assert tr.idle_under("engine.h2d") == pytest.approx(40e-6)
    assert tr.idle_under("engine.open") is None


def test_the_streamed_readers_on_a_hand_made_trace(tmp_path):
    """Over two requests, ms a request: open 40 + 20 us of idle; scan
    (380 - 60 - 50 - 5) + (240 - 40) us; h2d 60 + 40 us of copies (the DtoH
    copy is not one)."""
    v = run_view(tmp_path)
    got = {m: spec.reader(m)(v) for m in STREAM_READERS}
    assert got == pytest.approx({"open_idle_ms": 0.030, "scan_idle_ms": 0.2325,
                                 "h2d_ms": 0.050})
    # the decode thread's event names no idle of the window's thread
    assert "numpy decode" not in v.trace.idle_by_host
    assert spec.reader("kernels_per_query")(v) == pytest.approx(0.5)


def test_the_streamed_readers_read_nothing_without_their_events(tmp_path):
    v = run_view(tmp_path)
    v.trace = None
    assert all(spec.reader(m)(v) is None for m in STREAM_READERS)
    resident = run_view(tmp_path, [e for e in events() if not e["name"].startswith(
        ("engine.open", "engine.scan", "Memcpy HtoD"))])
    assert all(spec.reader(m)(resident) is None for m in STREAM_READERS)
