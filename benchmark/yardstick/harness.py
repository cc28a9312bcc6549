"""One run of one cell: set-up, the measured window, the trace, the check.

A configuration names one of two deployments: "serve" (the dataset
resident on the card) or "stream" (the files left on disk, every query a
scan of them).

Resident: set-up makes the cell's dataset on the device from the seed and
writes it as LAST files under TMPDIR (synth.py), loads it into device
memory as `serve` does (ResidentDataset.load with serve.main's attributes
and defaults), and sends every request kind through serve.handle_request
twice, from a stream apart from the window's. A mix that collects points
(traffic.needs_files) keeps the files after the load, flushed to disk as
the streamed deployment's are: serve reads each hit's attributes from them,
as `serve -i DIR` leaves a user's dataset. The window is a closed loop
of one client: serve answers one line at a time and its user waits for
each reply, so the next request goes out when the last reply is a JSON
line (serve.main's json.dumps). Each request is timed on the host clock
from the call to that line; the count path ends in a read-back, so the
reply waits for the card. An -o request ("output": true in the mix) gets a
fresh, empty directory made before its clock starts; after its reply, and
outside its time, the header test reads its LAS files (Outputs).

Streamed: set-up writes the same files, flushes them to disk (fsync, so
that no writeback runs beside the window) and keeps them, loads nothing,
and sends every request kind through the scan twice. In the window each
request becomes a QueryPlan as cli.cmd_query builds one and runs through
engine.run_query with the configuration's "stream" settings, as `cli -i
DIR --bounds|--class ... --no-index` runs it; the reply is its count as a
JSON line, timed as above under the span engine.request. After the window
the data directory must hold the dataset's files and nothing else: a
sidecar index there (index.py) would mean the scan was not brute-force,
and counts in the check sidecar_files, whose limit is 0.

After the window: the peak of device memory is read, the program's state
is freed, and the plain reference (reference.py) answers a sample of the
window's requests drawn from the seed, every kind among them; a reply
that differs, and every error reply, counts in wrong_replies, whose limit
is 0 (PERF.md). Collect requests are checked further, each count with the
limit 0: wrong_points, a sampled preview reply whose points or truncated
flag is not the reference's; wrong_files, an -o reply whose files fail the
header test (the headers' point counts sum to the reply's count), or,
for the first KEEP_PER_KIND of each kind, set aside, the point test (each
file's points are the reference's hits of the k-th file that has any,
within half the file's scale, classes equal).

With trace, torch.profiler (host and device activity) is open from the
start of the run, so that the window's kernels are those of a young
profiler session (PERF.md: a session opened late in a process loses its
first kernel records); the readers of the per-layer metrics read the
window's part of its trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import las, synth, trace as trace_mod, traffic
from .measure import percentile
from .reference import Reference
from .spec import Cell, reader

FORBIDDEN = ("jax", "jaxlib", "flax", "adhoc_queries_pointclouds_tpu")
# the port's launch counters and their kernels' names in the trace, for the
# trace's completeness lines: the resident path's counts, the streamed
# path's packed ones, then the resident collect's masks and compaction
KERNELS = {"bbox_count_multi": "bbox_count_multi_kernel",
           "class_count_words": "class_count_kernel",
           "time_count_multi": "time_count_multi_kernel",
           "bbox_count_packed": "bbox_count_packed_kernel",
           "class_count_dict": "class_count_dict_kernel",
           "time_count_packed": "time_count_packed_kernel",
           "mask_bbox": "mask_bbox_kernel",
           "mask_time": "TimeRawTiles",  # mask_packed_kernel<TimeRawTiles<...>>
           "compact_bits": "compact_bits_kernel"}
# -o replies of each kind whose files are set aside for the point test
KEEP_PER_KIND = 4
_T_IMPORT = time.perf_counter()


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), or since this
    module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def io_counters() -> dict[str, int]:
    """This process's I/O counters (Linux /proc/self/io): wchar, the bytes
    it passed to write(), and write_bytes and cancelled_write_bytes, what
    it sent to the storage layer and what a truncation or unlink took back
    before writeback; empty where /proc cannot say."""
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in (line.split(":") for line in f if ":" in line)}
    except (OSError, ValueError):
        return {}


def smi(fields: str = "name,power.limit") -> str:
    """nvidia-smi's reading of fields on the first card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


@dataclasses.dataclass
class RunView:
    """What a metric's reader reads."""

    kinds: list[str]
    requests: list[dict]
    latencies_s: list[float]
    window_s: float
    setup_s: float
    dataset: synth.Dataset
    config: dict
    mix: dict
    device_kind: str
    trace: trace_mod.Trace | None
    launches: dict[str, int]  # the program's launch counter over the window


@dataclasses.dataclass
class Window:
    kinds: list[str]
    requests: list[dict]  # as sent: an -o request with its directory
    latencies_s: list[float]
    replies: list[str]
    window_s: float
    files_failed: set[int] = dataclasses.field(default_factory=set)  # the header test's
    kept: dict[int, Path] = dataclasses.field(default_factory=dict)  # for the point test


def files_pass_header(directory: Path, reply: dict) -> bool:
    """The header test of an -o reply: its directory holds the numbered LAS
    files that the reply names, and their headers' point counts sum to the
    reply's count."""
    files = las.numbered(directory)
    if files is None or [str(f) for f in files] != reply.get("files"):
        return False
    try:
        return sum(las.read_header(f).n for f in files) == reply.get("count")
    except ValueError:
        return False


def files_pass_points(directory: Path, hits: list[tuple]) -> bool:
    """The point test: matching_points_<k>.las holds the reference's hits of
    the k-th file that has any (Reference.file_hits), in order, each
    coordinate within half the file's scale of the reference's (the
    format quantises at its scale), each class equal."""
    files = las.numbered(directory)
    if files is None or len(files) != len(hits):
        return False
    for f, (world, cls) in zip(files, hits):
        try:
            got, got_cls, h = las.read_points(f)
        except ValueError:
            return False
        if len(got) != len(world) or not np.array_equal(got_cls, cls):
            return False
        if not (np.abs(got - world) <= 0.5 * h.scale).all():
            return False
    return True


class Outputs:
    """The directories of -o requests: each made empty under root before the
    request's clock starts. After each reply the header test; then the
    first keep of each kind are set aside for the point test after the
    window and the others deleted, so that besides those at most one
    request's files are on disk."""

    def __init__(self, root: Path, keep: int = KEEP_PER_KIND):
        self.root, self.keep = root, keep
        self.failed: set[int] = set()
        self.kept: dict[int, Path] = {}
        self._kept_of: dict[str, int] = {}

    def prepare(self, i: int, req: dict) -> tuple[dict, Path | None]:
        """The request to send: an -o request's placeholder replaced by its
        directory, made now."""
        if req.get("output") is not True:
            return req, None
        directory = self.root / str(i)
        directory.mkdir(parents=True)
        return dict(req, output=str(directory)), directory

    def settle(self, i: int, kind: str, directory: Path, reply: dict) -> None:
        if "error" not in reply and not files_pass_header(directory, reply):
            self.failed.add(i)
        if self._kept_of.get(kind, 0) < self.keep:
            self._kept_of[kind] = self._kept_of.get(kind, 0) + 1
            self.kept[i] = directory
        else:
            shutil.rmtree(directory)


def require_cards(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} card(s), the cell needs {chips}")
    return torch.device("cuda:0")


def serve_attrs(data: Path) -> tuple[str, ...]:
    """The attributes serve.main keeps resident (serve.py): GPS times too
    when every file has them."""
    from adhoc_queries_pointclouds_torch.engine import discover_files
    from adhoc_queries_pointclouds_torch.formats.las import has_gps_time, parse_las_header_file

    attrs = ["position", "classification"]
    files = discover_files(data)
    if files and all(has_gps_time(parse_las_header_file(f).point_format) for f in files):
        attrs.append("gps_time")
    return tuple(attrs)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(ds, data: Path, stream: list[tuple[str, dict]], more, seconds: float,
          traced: bool, outputs: Outputs) -> Window:
    """The closed loop: requests of stream (extended by more(n) if the
    window outlasts it) through serve.handle_request until seconds have
    passed; -o requests' directories from outputs, their header test under
    the harness's span bench.files."""
    from adhoc_queries_pointclouds_torch.serve import handle_request

    span = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())
    lat, replies, sent = [], [], []
    with span(trace_mod.WINDOW_SPAN):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        t1 = t_start
        i = 0
        while t1 < deadline:
            if i == len(stream):
                stream.extend(more(max(len(stream), 1024)))
            kind, req = stream[i]
            req, directory = outputs.prepare(i, req)
            t0 = time.perf_counter()
            with span("serve.handle_request"):
                reply = handle_request(ds, req, str(data))
                line = json.dumps(reply)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            replies.append(line)
            sent.append(req)
            if directory is not None:
                with span("bench.files"):
                    outputs.settle(i, kind, directory, reply)
            i += 1
    return Window([k for k, _ in stream[:i]], sent, lat, replies, t1 - t_start,
                  outputs.failed, outputs.kept)


def stream_answer(data: Path, device: torch.device, settings: dict):
    """The streamed deployment's answer to one request: its QueryPlan as
    cli.cmd_query builds one, run by engine.run_query with the
    configuration's "stream" settings (cli -i DIR ... --no-index), the
    reply as serve's: the count, or the error."""
    from adhoc_queries_pointclouds_torch import engine
    from adhoc_queries_pointclouds_torch.models.query import (BoundsQuery, ClassQuery,
                                                              QueryPlan, TimeRangeQuery)
    from adhoc_queries_pointclouds_torch.utils.aabb import AABB

    kwargs = {"block_size": int(settings["block_size"]), "workers": int(settings["workers"]),
              "prefetch": int(settings["prefetch"]), "use_index": bool(settings["use_index"])}

    def answer(req: dict) -> dict:
        t0 = time.perf_counter()
        try:
            if "bounds" in req:
                v = [float(x) for x in req["bounds"]]
                plan = QueryPlan(bounds=BoundsQuery(AABB(tuple(v[:3]), tuple(v[3:]))))
            elif "class" in req:
                plan = QueryPlan(classification=ClassQuery(int(req["class"])))
            else:
                t = [float(x) for x in req["time_range"]]
                plan = QueryPlan(time_range=TimeRangeQuery(t[0], t[1]))
            res = engine.run_query(data, plan, device=device, devices=[device], **kwargs)
        except Exception as e:  # as serve: the error is the reply
            return {"error": f"{type(e).__name__}: {e}"}
        return {"count": res.match_count, "ms": round((time.perf_counter() - t0) * 1e3, 2)}

    return answer


def drive_stream(answer, stream: list[tuple[str, dict]], more, seconds: float,
                 traced: bool) -> Window:
    """drive's closed loop over the streamed deployment: each request
    through answer, under the span engine.request."""
    span = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())
    lat, replies = [], []
    with span(trace_mod.WINDOW_SPAN):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        t1 = t_start
        i = 0
        while t1 < deadline:
            if i == len(stream):
                stream.extend(more(max(len(stream), 1024)))
            req = stream[i][1]
            t0 = time.perf_counter()
            with span("engine.request"):
                line = json.dumps(answer(req))
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            replies.append(line)
            i += 1
    return Window([k for k, _ in stream[:i]], [r for _, r in stream[:i]], lat, replies,
                  t1 - t_start)


def sample(window: Window, mix: dict, seed: int) -> list[int]:
    """Indices of the replies to compare: up to compare_per_kind of each
    kind, drawn from the seed."""
    rng = traffic.rng_for(seed, 3)
    per_kind = int(mix.get("compare_per_kind", 32))
    out = []
    for kind in sorted(set(window.kinds)):
        idx = [i for i, k in enumerate(window.kinds) if k == kind]
        out += sorted(rng.choice(idx, size=min(per_kind, len(idx)), replace=False).tolist())
    return sorted(out)


def wrong_replies(window: Window, picked: list[int], answers: dict[int, dict]) -> int:
    """Error replies anywhere in the window, and sampled replies whose
    count is not the reference's."""
    wrong = sum('"error"' in line for line in window.replies)
    for i in picked:
        reply = json.loads(window.replies[i])
        if "error" not in reply and reply.get("count") != answers[i]["count"]:
            wrong += 1
    return wrong


def wrong_points(window: Window, picked: list[int], answers: dict[int, dict]) -> int:
    """Sampled preview replies whose points or truncated flag are not the
    reference's, exactly (error replies are wrong_replies')."""
    wrong = 0
    for i in picked:
        if "points" not in answers[i]:
            continue
        reply = json.loads(window.replies[i])
        if "error" not in reply and (reply.get("points") != answers[i]["points"]
                                     or reply.get("truncated") != answers[i]["truncated"]):
            wrong += 1
    return wrong


def checks(window: Window, picked: list[int], answers: dict[int, dict],
           sidecars: int | None = None, files: int | None = None) -> dict[str, dict]:
    """Each number compared, beside its limit (PERF.md). answers: the
    reference's replies (Reference.reply); sidecars: the files a streamed
    run left in its data directory beside the dataset's; files: the -o
    replies whose files failed a test (Run.check)."""
    out = {"wrong_replies": {"value": wrong_replies(window, picked, answers), "limit": 0}}
    if any("points" in answers[i] for i in picked):
        out["wrong_points"] = {"value": wrong_points(window, picked, answers), "limit": 0}
    if files is not None:
        out["wrong_files"] = {"value": files, "limit": 0}
    if sidecars is not None:
        out["sidecar_files"] = {"value": sidecars, "limit": 0}
    return out


def is_correct(compared: dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())


class Run:
    """One run of a cell, kept apart in steps so that the control
    (control.py) can drive the same set-up and window."""

    def __init__(self, cell: Cell, seed: int, seconds: float, device: torch.device,
                 traced: bool = False):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.traced = device, traced
        self.tmp = Path(tempfile.mkdtemp(prefix="bench-"))
        self.data = self.tmp / "data"
        self.data.mkdir()
        self.prof = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def close(self) -> None:
        if self.prof is not None:
            self.prof.stop()
            self.prof = None
        shutil.rmtree(self.tmp, ignore_errors=True)

    def setup(self, imported_s: float = 0.0) -> None:
        """The dataset, the resident load (a streamed configuration:
        _setup_stream instead), the warm-up and the window's requests
        (enough for max_rate_per_s). imported_s: the process's age when the
        harness began, its interpreter and torch imported."""
        start_s = process_age_s()
        t = time.perf_counter()
        from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset
        from adhoc_queries_pointclouds_torch.serve import handle_request

        phases = {"python and torch": imported_s, "cards and profiler": start_s - imported_s,
                  "import": time.perf_counter() - t}
        t = time.perf_counter()
        self.dataset = synth.make_dataset(self.cell.config, self.seed, self.data, self.device)
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        phases["dataset"] = time.perf_counter() - t
        self.phases = phases
        if "stream" in self.cell.config:
            self._setup_stream()
            return

        keep_files = traffic.needs_files(self.cell.mix)
        if keep_files:
            self._flush()
        t = time.perf_counter()
        serve_cfg = self.cell.config["serve"]
        self.ds = ResidentDataset.load(
            self.data, devices=[self.device], attrs=serve_attrs(self.data),
            block_size=int(serve_cfg["block_size"]), workers=int(serve_cfg["workers"]))
        sync(self.device)
        if not keep_files:
            for f in self.dataset.files:  # the host keeps the columns (synth.py)
                f.unlink()
        phases["load"] = time.perf_counter() - t
        t = time.perf_counter()
        warm = Outputs(self.tmp / "warm-up", keep=0)
        for j, (kind, req) in enumerate(traffic.warmup(self.cell.mix, self.cell.config,
                                                        self.seed)):
            req, directory = warm.prepare(j, req)
            reply = handle_request(self.ds, req, str(self.data))
            if "error" in reply:
                raise RuntimeError(f"warm-up request {req} failed: {reply['error']}")
            if directory is not None:
                warm.settle(j, kind, directory, reply)
        sync(self.device)
        phases["warm-up"] = time.perf_counter() - t
        self._requests()

    def _flush(self) -> None:
        """The dataset's files flushed to disk (fsync), so that no writeback
        of them runs beside the window."""
        t = time.perf_counter()
        for f in self.dataset.files:
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        self.phases["fsync"] = time.perf_counter() - t

    def _setup_stream(self) -> None:
        """The streamed deployment's set-up: the files flushed to disk and
        kept, nothing loaded, every request kind scanned twice."""
        phases = self.phases
        self._flush()
        t = time.perf_counter()
        self.answer = stream_answer(self.data, self.device, self.cell.config["stream"])
        phases["import"] += time.perf_counter() - t
        t = time.perf_counter()
        for _, req in traffic.warmup(self.cell.mix, self.cell.config, self.seed):
            reply = self.answer(req)
            if "error" in reply:
                raise RuntimeError(f"warm-up request {req} failed: {reply['error']}")
        sync(self.device)
        phases["warm-up"] = time.perf_counter() - t
        self._requests()

    def _requests(self) -> None:
        """The window's requests, enough for max_rate_per_s."""
        t = time.perf_counter()
        self.gen = traffic.Generator(self.cell.mix, self.cell.config, self.seed)
        rate = float(self.cell.mix.get("max_rate_per_s", 1000))
        self.stream = self.gen.take(max(int(rate * self.seconds), 64))
        gc.collect()  # set-up's garbage, so that no collection of it falls in the window
        self.phases["requests"] = time.perf_counter() - t

    def window(self) -> Window:
        from adhoc_queries_pointclouds_torch.ops import predicate

        before = dict(predicate.launches)
        if "stream" in self.cell.config:
            self.win = drive_stream(self.answer, self.stream, self.gen.take, self.seconds,
                                    self.traced)
        else:
            self.win = drive(self.ds, self.data, self.stream, self.gen.take, self.seconds,
                             self.traced, Outputs(self.tmp / "out"))
        sync(self.device)
        self.launches = {k: v - before.get(k, 0) for k, v in predicate.launches.items()
                         if v - before.get(k, 0)}
        return self.win

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def read_trace(self) -> trace_mod.Trace | None:
        """Stop the profiler and read the window's part of its trace; None
        off the card."""
        if self.prof is None:
            return None
        sync(self.device)
        self.prof.stop()
        prof, self.prof = self.prof, None
        if self.device.type != "cuda":
            return None
        path = self.tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        tr = trace_mod.read(path)
        path.unlink()
        return tr

    def sidecars(self) -> int | None:
        """Files in a streamed run's data directory that are not the
        dataset's (a sidecar index: index.py index_path); None for a
        resident run."""
        if "stream" not in self.cell.config:
            return None
        return len(set(self.data.iterdir()) - set(self.dataset.files))

    def free_program(self) -> None:
        self.ds = None  # the resident dataset; a streamed run holds none
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, dtype=torch.float64, files: bool = True
              ) -> tuple[list[int], dict[int, dict], int | None]:
        """The sample, the reference's replies to it (in dtype) and, with
        files, the -o replies whose files failed the header test in the
        window or the point test now (None where the window sent no -o
        request)."""
        picked = sample(self.win, self.cell.mix, self.seed)
        ref = Reference(self.dataset, self.device, dtype)
        try:
            answers = {i: ref.reply(self.win.requests[i]) for i in picked}
            if not files or not any(r.get("output") for r in self.win.requests):
                return picked, answers, None
            failed = set(self.win.files_failed)
            failed |= {i for i, d in self.win.kept.items()
                       if not files_pass_points(d, ref.file_hits(self.win.requests[i]))}
            return picked, answers, len(failed)
        finally:
            del ref
            if self.device.type == "cuda":
                torch.cuda.empty_cache()


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _device_info(device: torch.device, peak: int, tr) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": device_kind(device), "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def run(cell: Cell, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        out=sys.stdout, log=sys.stderr) -> int:
    """One run: the result's JSON line on out, the checks as the last lines
    of log. Returns the exit code."""
    imported_s = process_age_s()
    io_start = io_counters()
    dev = require_cards(cell.chips) if device == "cuda" else torch.device(device)
    r = Run(cell, seed, seconds, dev, traced)
    try:
        r.setup(imported_s)
        setup_s = process_age_s()
        win = r.window()
        if dev.type == "cuda":  # after the window, so that set-up waits for no nvidia-smi
            print("card: " + smi("name,power.limit,clocks.sm,clocks.mem,temperature.gpu,"
                                 "power.draw"), file=log)
        peak = r.memory_peak()
        tr = r.read_trace()
        r.free_program()
        picked, ans, files = r.check()
        compared = checks(win, picked, ans, r.sidecars(), files)
        dataset = r.dataset
        launches = r.launches
    finally:
        r.close()

    if tr is not None:
        print(f"trace: {tr.launches} kernel launches in the window, {tr.unmatched} without "
              f"their kernel's record (at most {trace_mod.LOST_SHARE:.1%} may lack one)",
              file=log)
        for entry, kernel in KERNELS.items():
            events = len(tr.kernels(kernel))
            if events or launches.get(entry, 0):
                print(f"trace: {entry}: {events} kernel events, "
                      f"{launches.get(entry, 0)} launches counted by the port", file=log)
        if not tr.complete:
            print("trace: short, so no metric is read from it", file=log)
            tr = None
    view = RunView(win.kinds, win.requests, win.latencies_s, win.window_s, setup_s, dataset,
                   cell.config, cell.mix, device_kind(dev), tr, launches)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"], cell.root)(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=log)
        return 4
    errors = sum('"error"' in line for line in win.replies)
    result = {
        "correct": is_correct(compared),
        "attempted": len(win.replies),
        "failed": errors,
        "metrics": metrics,
        "device": _device_info(dev, peak, tr if traced else None),
    }
    if traced and tr is not None:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.by_name()[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(tr.idle_by_host.items(),
                                                    key=lambda kv: -kv[1])[:10]],
        }
    result["compared"] = {"replies": len(picked), "kinds": len(set(win.kinds)),
                          "file_sets": len(win.kept)}
    result["checks"] = compared
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in r.phases.items()), file=log)
    io_end = io_counters()
    print("io: " + ", ".join(f"{k} {io_end[k] - io_start.get(k, 0)} B" for k in
                             ("wchar", "write_bytes", "cancelled_write_bytes") if k in io_end)
          + " in this run's process", file=log)
    for kind in sorted(set(win.kinds)):
        lat = [x for k, x in zip(win.kinds, win.latencies_s) if k == kind]
        print(f"kind {kind}: {len(lat)} requests, p50 {percentile(lat, 50) * 1e3:.4f} ms, "
              f"p95 {percentile(lat, 95) * 1e3:.4f} ms", file=log)
    print(f"compared {len(picked)} replies of {len(set(win.kinds))} kinds with the reference"
          + (f", the files of {len(win.kept)} -o replies point by point" if win.kept else ""),
          file=log)
    for name, c in compared.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    log.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
