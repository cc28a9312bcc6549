"""The readers of the port's request-path spans: a trace made by hand, two
requests under the harness's serve.handle_request, the port's spans nested
in them as the port nests them (torch operators and runtime calls inside
the spans), and one device interval."""

import json

import pytest

from yardstick import spec, trace
from yardstick.harness import RunView
from yardstick.synth import Dataset

SPANS = {"parse_idle_ms": "serve.parse", "operands_idle_ms": "resident.operands",
         "count_entry_idle_ms": "predicate.count", "readback_idle_ms": "resident.readback"}
READERS = (*SPANS, "untraced_idle_ms")


def ev(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 7}
    if args:
        e["args"] = args
    return e


def events(port_spans=True):
    """Request 1 (100-370 us): the four spans, an aten::slice in
    resident.operands, the launch in predicate.count, and its kernel
    (255-320 us) running on past the span. Request 2 (500-700 us): the
    four spans, no launch. The port's spans are cpu_op events, as
    span records them; without port_spans, the parent's trace."""
    out = [
        ev("user_annotation", trace.WINDOW_SPAN, 0, 1000),
        ev("user_annotation", "serve.handle_request", 100, 270),
        ev("cpu_op", "aten::slice", 150, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 240, 10, correlation=1),
        ev("user_annotation", "serve.handle_request", 500, 200),
        {"ph": "X", "cat": "kernel", "name": "bbox_count_multi_kernel", "ts": 255, "dur": 65,
         "pid": 0, "tid": 3, "args": {"correlation": 1}},
    ]
    if port_spans:
        for name, ts, dur in (("serve.parse", 110, 20), ("resident.operands", 140, 60),
                              ("predicate.count", 210, 50), ("resident.readback", 330, 30),
                              ("serve.parse", 510, 10), ("resident.operands", 530, 30),
                              ("predicate.count", 570, 20), ("resident.readback", 600, 40)):
            out.append(ev("cpu_op", name, ts, dur))
    return out


def run_view(tmp_path, port_spans=True):
    path = tmp_path / f"trace_{port_spans}.json"
    path.write_text(json.dumps({"traceEvents": events(port_spans)}))
    tr = trace.read(path)
    ds = Dataset(files=[], columns=[], counts=[], offsets=[], scale=(0.001,) * 3, wmin=[],
                 wmax=[], point_format=0, time_rate=200_000.0)
    return RunView(kinds=["box", "box"], requests=[{}, {}], latencies_s=[270e-6, 200e-6],
                   window_s=1e-3, setup_s=1.0, dataset=ds, config={}, mix={},
                   device_kind="NVIDIA H100 80GB HBM3", trace=tr, launches={})


def test_each_reader_is_its_spans_own_idle_a_request(tmp_path):
    """Own idle of each span over two requests, in ms a request: parse 20 +
    10 us, operands 50 (60 less the slice) + 30, the count entry 35 (50 less
    the launch, less the 5 us the kernel overlaps) + 20, read-back 30 + 40;
    the rest of the requests' idle 50 + 100 stays the harness's."""
    v = run_view(tmp_path)
    got = {m: spec.reader(m)(v) for m in READERS}
    want = {"parse_idle_ms": 0.015, "operands_idle_ms": 0.040, "count_entry_idle_ms": 0.0275,
            "readback_idle_ms": 0.035, "untraced_idle_ms": 0.075}
    assert got == pytest.approx(want)
    # nested calls keep their names: the slice and the launch are not the spans'
    assert v.trace.idle_by_host["aten::slice"] == pytest.approx(10e-6)
    assert v.trace.idle_by_host["cudaLaunchKernel"] == pytest.approx(10e-6)


def test_the_spans_split_the_idle_once_named_serve_handle_request(tmp_path):
    """The four span readers and untraced_idle_ms add up to what the
    harness's serve.handle_request read with no port span (the parent)."""
    parent = spec.reader("untraced_idle_ms")(run_view(tmp_path, port_spans=False))
    assert parent == pytest.approx((185 + 200) / 2 / 1e3)
    v = run_view(tmp_path)
    assert sum(spec.reader(m)(v) for m in READERS) == pytest.approx(parent)


def test_readers_without_a_trace_or_a_span(tmp_path):
    """No trace: every reader None. A trace without the port's spans (the
    parent's program): the span readers None, untraced_idle_ms all of it."""
    v = run_view(tmp_path)
    v.trace = None
    assert all(spec.reader(m)(v) is None for m in READERS)
    parent = run_view(tmp_path, port_spans=False)
    assert all(spec.reader(m)(parent) is None for m in SPANS)
    assert spec.reader("untraced_idle_ms")(parent) > 0


def test_the_readers_are_in_benchmark_json_for_both_cells():
    entries = {m["name"]: m for m in spec.load_spec()["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "device_trace", "query_p50_ms")
        # a collect opens no count entry and reads back no counts
        collects = name not in ("readback_idle_ms", "count_entry_idle_ms")
        assert m["workloads"] == ["doc.count", "navvis.count"] + ["navvis.collect"] * collects
