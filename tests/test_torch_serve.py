"""The port's JSON query service against the JAX package's, on the CPU.

The same request lines go to adhoc_queries_pointclouds_tpu.serve's
handle_request (a resident dataset on the 8-device CPU mesh) and to the
port's (device="cpu"): every reply must be equal field for field but "ms",
a wall time, and the layout fields of "info" ("blocks", "devices",
"resident_mib"), which follow each package's own layout (JAX pads the
blocks to its mesh; the port has one device). The tolerance is 0: counts,
points rounded to 6 decimals by the same code, file names, LAS bytes.

The service also runs as a subprocess, `serve --device cpu`, over stdin.

Under a torch.profiler session a count request is the spans serve.parse,
resident.operands and resident.readback (utils/timing.py span), disjoint
and in call order; with none recording, span builds no profiler record.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from adhoc_queries_pointclouds_tpu.parallel.resident import ResidentDataset as JaxResident
from adhoc_queries_pointclouds_tpu.serve import handle_request as jax_handle_request
from adhoc_queries_pointclouds_torch.formats import synth
from adhoc_queries_pointclouds_torch.parallel import resident
from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset
from adhoc_queries_pointclouds_torch.serve import handle_request
from adhoc_queries_pointclouds_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
BLOCK = 1 << 14
ATTRS = ("position", "classification", "gps_time")  # serve's rule: every file has GPS times
BOX = [100200.0, 200300.0, 10.0, 100900.0, 200900.0, 70.0]
LAYOUT = ("blocks", "devices", "resident_mib")
REQUESTS = [
    {"cmd": "info"},
    {"bounds": BOX},
    {"bounds": [-1e9, -1e9, -1e9, 1e9, 1e9, 1e9]},
    {"class": 6},
    {"class": 19},
    {"time_range": [200_000.0, 800_000.0]},
    {"bounds": BOX, "density": 100.0},
    {"class": 6, "density": 50.0},
    {"time_range": [200_000.0, 800_000.0], "density": 80.0},
    {"bounds": BOX, "collect": True, "limit": 50},
    {"class": 6, "collect": True, "limit": 3},
    {"time_range": [0.0, 1e6], "collect": True},
    # previews that a limit truncates: inside a file's block, across the
    # files, over full blocks across the files, none, and a bad limit
    {"time_range": [200_000.0, 800_000.0], "collect": True, "limit": 100},
    {"time_range": [200_000.0, 800_000.0], "collect": True, "limit": 9_500},
    {"time_range": [0.0, 1e6], "collect": True, "limit": 15_003},
    {"bounds": BOX, "collect": True, "limit": 0},
    {"bounds": BOX, "collect": True, "limit": "many"},
    {"bounds": BOX, "density": 100.0, "collect": True},
    {"bounds": [1, 2, 3]},
    {"time_range": [1.0]},
    {"class": 300},
    {"class": "six"},
    {"bounds": BOX, "density": -1.0},
    {"time_range": [5.0, 1.0]},
    {},
    {"cmd": "stats"},
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    synth.write_dataset(root, n_files=2, points_per_file=15_000, seed=41, formats=("last",),
                        point_format=3)
    return root / "last"


@pytest.fixture(scope="module")
def both(data):
    return (JaxResident.load(data, block_size=BLOCK, attrs=ATTRS),
            ResidentDataset.load(data, device="cpu", block_size=BLOCK, attrs=ATTRS))


def _comparable(reply: dict) -> dict:
    return {k: v for k, v in reply.items() if k not in ("ms",) + LAYOUT}


@pytest.mark.parametrize("req", REQUESTS, ids=[json.dumps(r) for r in REQUESTS])
def test_replies_match_jax(data, both, req):
    ref, got = both
    want = jax_handle_request(ref, dict(req), str(data))
    reply = handle_request(got, dict(req), str(data))
    assert _comparable(reply) == _comparable(want)
    assert ("ms" in reply) == ("ms" in want) == ("count" in want)
    if req.get("cmd") == "info":
        assert reply["devices"] == 1 and reply["blocks"] == got.n_blocks == 2
        assert reply["resident_mib"] == round(got.resident_bytes / 1048576.0, 1)
        assert reply["points"] == 30_000
    if req.get("collect") and "error" not in want:
        assert len(reply["points"]) == min(req.get("limit", 1000), reply["count"])


def test_output_writes_jax_bytes(data, both, tmp_path):
    """A collect with "output" and one with density: the same files, byte
    for byte, and the same reply but the directory."""
    ref, got = both
    for n, extra in enumerate(({}, {"density": 100.0}, {"collect": True, "limit": 5})):
        files = []
        for name, fn, ds in (("jax", jax_handle_request, ref), ("torch", handle_request, got)):
            out = tmp_path / f"{name}_{n}"
            out.mkdir()
            reply = fn(ds, {"bounds": BOX, "output": str(out), **extra}, str(data))
            assert [Path(f).parent for f in reply.pop("files")] == [out] * len(list(out.iterdir()))
            files.append((_comparable(reply), {f.name: f.read_bytes() for f in out.iterdir()}))
        assert files[0] == files[1]
        assert files[1][1] and files[1][0]["count"] > 0


# case -> (the request's options but "collect", what the case must show
# about the full gather's hits a file and the limit)
PREVIEWS = {
    "zero": ({"bounds": BOX, "limit": 0}, lambda n, k: n[0] > 0),
    "one": ({"bounds": BOX, "limit": 1}, lambda n, k: n[0] > 1),
    "inside_a_partial_block": ({"time_range": [200_000.0, 800_000.0], "limit": 100},
                               lambda n, k: k < n[0] < 15_000),
    "across_a_file": ({"time_range": [200_000.0, 800_000.0], "limit": 9_500},
                      lambda n, k: n[0] < k < sum(n)),
    "full_block_clipped": ({"time_range": [0.0, 1e6], "limit": 10},
                           lambda n, k: n == [15_000, 15_000]),
    "across_full_blocks": ({"time_range": [0.0, 1e6], "limit": 15_003},
                           lambda n, k: n == [15_000, 15_000]),
    "default_limit": ({"class": 6}, lambda n, k: sum(n) > 1000),
    "above_the_count": ({"class": 6, "limit": 100_000}, lambda n, k: 0 < sum(n) < k),
    "no_hits": ({"bounds": [0, 0, 0, 10, 10, 10], "limit": 5}, lambda n, k: sum(n) == 0),
    "with_output": ({"bounds": BOX, "limit": 5, "output": True}, lambda n, k: sum(n) > k),
    "density": ({"bounds": BOX, "density": 100.0, "limit": 3}, lambda n, k: sum(n) > k),
}


@pytest.mark.parametrize("case", sorted(PREVIEWS))
def test_preview_reply_is_the_full_gathers(data, both, tmp_path, monkeypatch, case):
    """A collect request through the limited collect and through the full
    gather (ResidentDataset.collect without the limit serve passes): the
    same count, points, truncated flag and LAS bytes. emit_counts counts a
    preview's min(limit, count) gathered rows; an -o or density request
    gathers every hit and leaves it alone."""
    _, ds = both
    options, shows = PREVIEWS[case]
    real = ResidentDataset.collect
    per_file = []

    def full(self, plan, limit=None, **kw):
        count, emitter = real(self, plan, **kw)
        per_file[:] = [h.count for h in emitter.all_hits]
        return count, emitter

    got = []
    for side in ("full", "limited"):
        req = dict(options, collect=True)
        if req.get("output"):
            (tmp_path / side).mkdir()
            req["output"] = str(tmp_path / side)
        resident.reset_emit_counts()
        with monkeypatch.context() as m:
            if side == "full":
                m.setattr(ResidentDataset, "collect", full)
            reply = _comparable(handle_request(ds, req, str(data)))
        files = [Path(f) for f in reply.pop("files", [])]
        got.append((reply, [(f.name, f.read_bytes()) for f in files], dict(resident.emit_counts)))
    (want, want_files, full_counts), (reply, files, counts) = got
    limit = options.get("limit", 1000)
    assert shows(per_file, limit)
    assert reply == want and files == want_files
    assert len(reply["points"]) == min(limit, reply["count"])
    assert reply["truncated"] == (reply["count"] > limit)
    assert bool(files) == ("output" in options)
    assert full_counts == {"previews": 0, "hits": 0, "gathered": 0}
    if "output" in options or "density" in options:
        assert counts == full_counts
    else:
        assert counts == {"previews": 1, "hits": reply["count"],
                          "gathered": min(limit, reply["count"])}


def test_subprocess_protocol(data, both):
    """`serve --device cpu` over stdin: the ready line, a reply for every
    request line (the JAX handler's replies but "ms" and the layout), an
    error for a line that is not JSON, and "bye" on quit."""
    ref, _ = both
    lines = [json.dumps(r) for r in REQUESTS[:6]] + ["not json", json.dumps({"cmd": "quit"})]
    proc = subprocess.run(
        [sys.executable, "-m", "adhoc_queries_pointclouds_torch.cli", "serve", "-i", str(data),
         "--block-size", str(BLOCK), "--device", "cpu"],
        input="\n".join(lines), capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    replies = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    assert len(replies) == 1 + len(lines)
    ready = replies[0]
    assert ready["ready"] is True and ready["points"] == 30_000
    assert set(ready) == {"ready", "points", "resident_mib", "load_s"}
    for req, reply in zip(REQUESTS[:6], replies[1:7]):
        assert _comparable(reply) == _comparable(jax_handle_request(ref, dict(req), str(data)))
    assert replies[7]["error"].startswith("bad json:")
    assert replies[8] == {"bye": True}


def test_serve_on_cuda_without_cuda_raises(data):
    """`serve` on CUDA with no card fails before it answers anything."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "from adhoc_queries_pointclouds_torch import cli; "
            f"sys.exit(cli.main(['serve', '-i', {str(data)!r}]))")
    proc = subprocess.run([sys.executable, "-c", code], input="", capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout == ""


# the resident count path's spans on the CPU, in call order (predicate.count
# wraps the CUDA branch of the count entries alone: tests/test_torch_cuda.py)
COUNT_SPANS = ("serve.parse", "resident.operands", "resident.readback")
SPANNED = {"box": {"bounds": BOX}, "class": {"class": 6},
           "time": {"time_range": [200_000.0, 800_000.0]}}


def _no_record(name):
    raise AssertionError(f"a profiler record was built for {name}")


def test_span_without_a_profiler_is_the_shared_no_op(data, both, monkeypatch):
    """With no profiler session, span returns one shared no-op context and
    never builds a profiler record: the factory that would raise is not
    called, by span or by a whole request."""
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _no_record)
    assert not torch.autograd._profiler_enabled()
    assert timing.span("serve.parse") is timing.span("resident.readback") is timing._OFF
    with timing.span("serve.parse"):
        pass
    ref, got = both
    for req in SPANNED.values():
        reply = handle_request(got, dict(req), str(data))
        assert _comparable(reply) == _comparable(jax_handle_request(ref, dict(req), str(data)))
    # under a session the same factory is the one span calls
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record was built for serve.parse"):
            timing.span("serve.parse")


def _trace_events(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


@pytest.mark.parametrize("kind", sorted(SPANNED))
def test_count_request_spans_in_a_profiler_trace(data, both, tmp_path, kind):
    """One count request under torch.profiler: serve.parse,
    resident.operands and resident.readback once each, disjoint and in
    that order, inside the enclosing record_function; a box request's
    resident.operands twice, its table of every file's bounds and then its
    rows; the reply is JAX's."""
    ref, got = both
    req = SPANNED[kind]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.request"):
            reply = handle_request(got, dict(req), str(data))
    assert _comparable(reply) == _comparable(jax_handle_request(ref, dict(req), str(data)))
    events = _trace_events(prof, tmp_path)
    (outer,) = [e for e in events if e["name"] == "test.request"]
    want = [name for name in COUNT_SPANS
            for _ in range(2 if kind == "box" and name == "resident.operands" else 1)]
    spanned = sorted((e["ts"], e["name"], e["dur"]) for e in events if e["name"] in COUNT_SPANS)
    assert [name for _, name, _ in spanned] == want
    spans = [(ts, ts + dur) for ts, _, dur in spanned]
    assert outer["ts"] <= spans[0][0] and spans[-1][1] <= outer["ts"] + outer["dur"]
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start
    assert not [e for e in events if e["name"] == "predicate.count"]
