"""The yardstick's arithmetic: percentiles of all requests, the rate over
the window, the interval union, the idle gaps and what the host did in
them, the trace's completeness, byte counts and rooflines."""

import json
import statistics

import pytest

from yardstick import measure, spec, trace
from yardstick.harness import RunView
from yardstick.synth import Dataset


def dataset():
    return Dataset(files=[], columns=[], counts=[100, 200, 300],
                   offsets=[(0.0, 0.0, 0.0)] * 3, scale=(0.001,) * 3,
                   wmin=[(0, 0, 0), (10, 0, 0), (20, 0, 0)],
                   wmax=[(10, 10, 10), (20, 10, 10), (30, 10, 10)],
                   point_format=0, time_rate=200_000.0)


def view(latencies, window_s, requests=None, tr=None, kind="NVIDIA H100 80GB HBM3"):
    requests = requests or [{"class": 6}] * len(latencies)
    return RunView(kinds=["k"] * len(latencies), requests=requests, latencies_s=latencies,
                   window_s=window_s, setup_s=12.5, dataset=dataset(), config={}, mix={},
                   device_kind=kind, trace=tr, launches={})


def test_percentiles_and_rate_are_over_all_requests():
    lat = [0.001] * 90 + [0.010] * 10
    v = view(lat, 2.0)
    assert spec.reader("queries_per_s")(v) == pytest.approx(50.0)
    assert spec.reader("query_p50_ms")(v) == pytest.approx(1.0)
    # the 95th percentile of all 100: between the 95th and 96th values
    assert spec.reader("query_p95_ms")(v) == pytest.approx(10.0)
    assert measure.percentile([1, 2, 3, 4], 50) == 2.5
    assert spec.reader("setup_s")(v) == 12.5


def test_spread_is_the_quartiles_over_the_median():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert measure.spread(vals) == pytest.approx((q3 - q1) / med)


def test_union_gaps_and_flatten():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace.union_length(spans) == 25
    assert trace.merged(spans) == [(0, 15), (20, 30)]
    assert trace.gaps(spans, -5, 40) == [(-5, 0), (15, 20), (30, 40)]
    assert trace.gaps([], 0, 10) == [(0, 10)]
    segs = trace.flatten([(0, 100, "outer"), (10, 20, "a"), (12, 15, "b"), (30, 40, "c")])
    assert segs == [(0, 10, "outer"), (10, 12, "a"), (12, 15, "b"), (15, 20, "a"),
                    (20, 30, "outer"), (30, 40, "c"), (40, 100, "outer")]
    idle = trace.attribute([(5, 13), (95, 120)], segs)
    assert idle == pytest.approx({"outer": 10e-6, "a": 2e-6, "b": 1e-6,
                                  "host: harness loop, outside any traced span": 20e-6})


def chrome(tmp_path, lose_kernel=False, more=0, lose_more=0):
    """A trace as torch.profiler exports it: a window span on the main
    thread, two launches and their kernels, a copy, and work outside;
    more launches of short kernels, the last lose_more of them without
    their kernel's record, and a launch at the window's end whose kernel
    runs past it."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 1000, "dur": 1000,
         "pid": 1, "tid": 7},
        {"ph": "X", "cat": "user_annotation", "name": "serve.handle_request", "ts": 1100,
         "dur": 400, "pid": 1, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1150, "dur": 10,
         "pid": 1, "tid": 7, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1300, "dur": 10,
         "pid": 1, "tid": 7, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "bbox_count_multi_kernel(int const*)", "ts": 1200,
         "dur": 100, "pid": 0, "tid": 3, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1400, "dur": 50,
         "pid": 0, "tid": 3},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "serve.handle_request", "ts": 1100,
         "dur": 400, "pid": 0, "tid": 3},
        {"ph": "X", "cat": "kernel", "name": "outside_kernel", "ts": 100, "dur": 100,
         "pid": 0, "tid": 3, "args": {"correlation": 0}},
    ]
    if not lose_kernel:
        ev.append({"ph": "X", "cat": "kernel", "name": "class_count_kernel<true>", "ts": 1320,
                   "dur": 30, "pid": 0, "tid": 3, "args": {"correlation": 2}})
    for i in range(more):
        corr = 10 + i
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": 1500 + i * 0.1, "dur": 0.05, "pid": 1, "tid": 7,
                   "args": {"correlation": corr}})
        if i < more - lose_more:
            ev.append({"ph": "X", "cat": "kernel", "name": "fill", "ts": 1500 + i * 0.1,
                       "dur": 0.05, "pid": 0, "tid": 3, "args": {"correlation": corr}})
    if more:
        ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1990,
                "dur": 5, "pid": 1, "tid": 7, "args": {"correlation": 5}},
               {"ph": "X", "cat": "kernel", "name": "late", "ts": 1998, "dur": 10,
                "pid": 0, "tid": 3, "args": {"correlation": 5}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_window_busy_and_idle(tmp_path):
    tr = trace.read(chrome(tmp_path))
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(180e-6)
    assert tr.complete and tr.launches == 2
    assert len(tr.kernels()) == 2 and tr.kernel_s("bbox_count") == pytest.approx(100e-6)
    assert tr.by_name()[0] == ("bbox_count_multi_kernel(int const*)", pytest.approx(100e-6))
    assert sum(tr.idle_by_host.values()) == pytest.approx(1e-3 - 180e-6)
    assert tr.idle_by_host == pytest.approx({
        "serve.handle_request": 200e-6, "cudaLaunchKernel": 20e-6,
        "host: harness loop, outside any traced span": 600e-6})
    v = view([0.0004], 1e-3, tr=tr)
    assert spec.reader("idle_share")(v) == pytest.approx(82.0)
    assert spec.reader("kernels_per_query")(v) == pytest.approx(2.0)
    assert spec.reader("host_ms")(v) == pytest.approx(0.4 - 0.18)


def test_a_short_trace_is_seen(tmp_path):
    tr = trace.read(chrome(tmp_path, lose_kernel=True))
    assert not tr.complete and tr.unmatched == 1


@pytest.mark.parametrize("lost, complete", [(0, True), (3, True), (4, False), (400, False)])
def test_a_few_lost_records_leave_the_trace_readable(tmp_path, lost, complete):
    """Of 3,003 launches at most 3 (a thousandth) may lack their kernel's
    record; a launch whose kernel runs past the window's end has its
    record."""
    tr = trace.read(chrome(tmp_path, more=3_000, lose_more=lost))
    assert tr.launches == 3_003 and tr.unmatched == lost
    assert tr.complete is complete


def test_bytes_and_rooflines():
    ds = dataset()
    assert measure.box_bytes([1, 1, 1, 5, 5, 5], ds) == 12 * 100
    assert measure.box_bytes([5, 1, 1, 15, 5, 5], ds) == 12 * 300
    assert measure.box_bytes([10, 1, 1, 10, 5, 5], ds) == 12 * 300  # closed boxes touch
    assert measure.box_bytes([31, 1, 1, 40, 5, 5], ds) == 0
    assert measure.scan_bytes("class", ds) == 600 and measure.scan_bytes("time", ds) == 4800
    assert measure.roofline(3.35e12, 2.0, "NVIDIA H100 80GB HBM3") == pytest.approx(50.0)
    assert measure.roofline(0, 2.0, "NVIDIA H100 80GB HBM3") is None
    assert measure.roofline(10, 0.0, "NVIDIA H100 80GB HBM3") is None
    assert measure.roofline(10, 1.0, "cpu") is None


def test_roofline_readers(tmp_path):
    tr = trace.read(chrome(tmp_path))
    reqs = [{"bounds": [1, 1, 1, 5, 5, 5]}, {"class": 6}]
    v = view([0.0002, 0.0002], 1e-3, requests=reqs, tr=tr)
    want = 100.0 * 12 * 100 / 3.35e12 / 100e-6
    assert spec.reader("bbox_count_roofline")(v) == pytest.approx(want)
    assert spec.reader("class_count_roofline")(v) == pytest.approx(
        100.0 * 600 / 3.35e12 / 30e-6)
    assert spec.reader("time_count_roofline")(v) is None  # nothing to read
    for name in ("host_ms", "kernels_per_query", "idle_share", "bbox_count_roofline"):
        assert spec.reader(name)(view([0.001], 1.0)) is None  # no trace


def test_mask_bytes_and_readers():
    """A collect's mask reads what its count reads and writes a bit a point
    of those rows; the readers count only collect and -o requests, each
    kind over its own kernel's time."""
    ds = dataset()
    assert measure.box_mask_bytes([5, 1, 1, 15, 5, 5], ds) == pytest.approx(300 * (12 + 1 / 8))
    assert measure.box_mask_bytes([31, 1, 1, 40, 5, 5], ds) == 0
    assert measure.time_mask_bytes(ds) == pytest.approx(600 * (8 + 1 / 8))
    kernels = [("void (anonymous namespace)::mask_bbox_kernel(int const*)", 40.0),
               ("void (anonymous namespace)::mask_packed_kernel<(anonymous namespace)::"
                "TimeRawTiles<true> >((anonymous namespace)::TimeRawTiles<true>)", 20.0),
               ("compact_bits_kernel(unsigned int const*)", 5.0)]
    tr = trace.Trace(0.0, 1e6, [{"cat": "kernel", "name": n, "ts": 0.0, "dur": d}
                                for n, d in kernels], 3, 0, {})
    reqs = [{"bounds": [1, 1, 1, 5, 5, 5], "collect": True, "limit": 1000},
            {"bounds": [5, 1, 1, 15, 5, 5], "output": "/out/3"},
            {"bounds": [5, 1, 1, 15, 5, 5]},  # a count: no mask
            {"time_range": [0.0, 1.0], "collect": True, "limit": 1000},
            {"time_range": [0.0, 1.0], "output": "/out/5"},
            {"time_range": [0.0, 1.0]}]
    v = view([0.001] * len(reqs), 1.0, requests=reqs, tr=tr)
    assert spec.reader("bbox_mask_roofline")(v) == pytest.approx(
        100.0 * (100 + 300) * (12 + 1 / 8) / 3.35e12 / 40e-6)
    assert spec.reader("time_mask_roofline")(v) == pytest.approx(
        100.0 * 2 * 600 * (8 + 1 / 8) / 3.35e12 / 20e-6)
    counts_only = view([0.001] * 2, 1.0, requests=reqs[2::3], tr=tr)
    assert spec.reader("bbox_mask_roofline")(counts_only) is None
    assert spec.reader("time_mask_roofline")(counts_only) is None
    for name in ("bbox_mask_roofline", "time_mask_roofline"):
        assert spec.reader(name)(view([0.001], 1.0, requests=reqs[:1])) is None  # no trace
