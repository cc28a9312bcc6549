"""The plain reference against the program's plain CPU path, for every
kind of request the mixes send (counts, collect previews and -o files),
and its float32 control, which has to differ."""

import json

import pytest
import torch

from yardstick import harness, spec, synth, traffic
from yardstick.reference import Reference

MIXES = {"count_box": "doc", "count_time": "navvis"}


def small(config_name: str, points=200_000) -> dict:
    """The configuration with fewer points; its tiles, and so its extent,
    kept."""
    config = json.loads((spec.BENCH_DIR / "configs" / f"{config_name}.json").read_text())
    return dict(config, points=points)


def mix(name: str) -> dict:
    return json.loads((spec.BENCH_DIR / "traffic" / f"{name}.json").read_text())


@pytest.fixture(scope="module", params=["doc", "navvis"])
def loaded(request, tmp_path_factory):
    """A small dataset of each configuration (navvis's with GPS times) and
    the program's resident load of it on the CPU."""
    from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset

    config = small(request.param)
    root = tmp_path_factory.mktemp(request.param)
    data = synth.make_dataset(config, 2**31 + 3, root, "cpu")
    attrs = ("position", "classification") + (("gps_time",) if synth.has_gps(
        config["point_format"]) else ())
    ds = ResidentDataset.load(root, device="cpu", attrs=attrs)
    return config, data, ds, root


def mix_of(config: dict) -> dict:
    return mix({v: k for k, v in MIXES.items()}[config["name"]])


def test_reference_agrees_with_the_program(loaded):
    from adhoc_queries_pointclouds_torch.serve import handle_request

    config, data, ds, root = loaded
    m = mix_of(config)
    ref = Reference(data, "cpu")
    reqs = traffic.Generator(m, config, 11).take(3 * len(m["cycle"]) * 4)
    seen = set()
    for kind, req in reqs:
        reply = handle_request(ds, req, str(root))
        assert reply.get("count") == ref.answer(req), (kind, req, reply)
        seen.add(kind)
    assert seen == {k["kind"] for k in m["cycle"]}


def test_extra_cases(loaded):
    """Classes present and absent, the whole extent, an empty box, and for
    GPS times a window over every point and one over none."""
    from adhoc_queries_pointclouds_torch.serve import handle_request

    config, data, ds, root = loaded
    ref = Reference(data, "cpu")
    lo, hi = traffic.extent(config)
    reqs = [{"class": 2}, {"class": 19},
            {"bounds": [lo[0] - 1, lo[1] - 1, lo[2] - 1, hi[0] + 1, hi[1] + 1, hi[2] + 1]},
            {"bounds": [lo[0] + 0.0005, lo[1] + 0.0005, lo[2] - 1, lo[0] + 0.0015,
                        lo[1] + 0.0015, lo[2]]}]
    if data.point_format == 1:
        reqs += [{"time_range": [-1.0, 1e9]}, {"time_range": [1e8, 1e9]}]
    answers = [ref.answer(r) for r in reqs]
    assert answers[1] == 0 and answers[2] == data.total_points
    if data.point_format == 1:
        assert answers[4:] == [data.total_points, 0]
    for req, want in zip(reqs, answers):
        assert handle_request(ds, req, str(root))["count"] == want, req


def test_float32_control_differs(tmp_path):
    """The control, the reference one precision below, gives other answers
    than the float64 reference on some of doc's boxes. (navvis's boxes lie
    within float32's reach; its GPS times pass it over the whole line
    only, which the card's control test reads.)"""
    config = small("doc")
    data = synth.make_dataset(config, 2**31 + 4, tmp_path, "cpu")
    hi = Reference(data, "cpu")
    lo = Reference(data, "cpu", torch.float32)
    reqs = [r for k, r in traffic.Generator(mix("count_box"), config, 12).take(60)
            if "class" not in r]
    off = sum(hi.answer(r) != lo.answer(r) for r in reqs)
    assert off >= len(reqs) // 10, off


def test_the_control_is_not_correct_by_the_harness():
    """control.py's float32 control, scored by the harness's own
    comparison, comes out not correct where the program is correct (doc
    at a small size, on the CPU)."""
    import control

    cell = spec.cell("doc.count")
    cell.config = dict(cell.config, points=80_000)
    got = control.readings(cell, 2**31 + 21, 0.4, True, torch.device("cpu"))
    assert got["program_correct"] is True and got["program_wrong"] == 0, got
    assert got["control_correct"] is False and got["control_wrong"] > 0, got


@pytest.fixture(scope="module")
def navvis(tmp_path_factory):
    """navvis at a small size, its files kept, and the program's resident
    load of it on the CPU, as a collect cell's set-up leaves them."""
    from adhoc_queries_pointclouds_torch.parallel.resident import ResidentDataset

    config = small("navvis")
    root = tmp_path_factory.mktemp("navvis_collect")
    data = synth.make_dataset(config, 2**31 + 5, root, "cpu")
    ds = ResidentDataset.load(root, device="cpu",
                              attrs=("position", "classification", "gps_time"))
    return config, data, ds, root


def collect_requests(config: dict) -> list[tuple[str, dict]]:
    """Three cycles of the collect mix, and extra cases: a preview cut at 5
    and one that holds every hit, one with no hit, and class previews and
    extracts."""
    lo, hi = traffic.extent(config)
    extra = [{"time_range": [1.0, 1.0004], "collect": True, "limit": 5},
             {"time_range": [1.0, 1.0004], "collect": True, "limit": 10_000},
             {"time_range": [1e8, 1e9], "collect": True, "limit": 1000},
             {"time_range": [1e8, 1e9], "output": True},
             {"bounds": [lo[0] - 1, lo[1] - 1, lo[2] - 1, hi[0] + 1, hi[1] + 1, hi[2] + 1],
              "output": True},
             {"class": 5, "collect": True, "limit": 1000}, {"class": 6, "output": True}]
    return traffic.Generator(mix("collect"), config, 13).take(36) + [("extra", r) for r in extra]


def test_collect_replies_agree_with_the_program(navvis, tmp_path):
    """The reference's counts, previews and per-file hits against the
    program's collect and -o replies through serve.handle_request, for box,
    time and class requests: the previews exactly, the LAS files by the
    harness's header and point tests."""
    from adhoc_queries_pointclouds_torch.serve import handle_request

    config, data, ds, root = navvis
    ref = Reference(data, "cpu")
    outputs = harness.Outputs(tmp_path / "out", keep=0)
    kinds, files_met, truncated = set(), set(), set()
    for i, (kind, req) in enumerate(collect_requests(config)):
        sent, directory = outputs.prepare(i, req)
        reply = json.loads(json.dumps(handle_request(ds, sent, str(root))))
        want = ref.reply(sent)
        assert reply["count"] == want["count"], (kind, req, reply)
        if req.get("collect"):
            assert (reply["points"], reply["truncated"]) == (want["points"], want["truncated"])
            truncated.add(want["truncated"])
        else:
            hits = ref.file_hits(sent)
            assert harness.files_pass_header(directory, reply), (kind, req)
            assert harness.files_pass_points(directory, hits), (kind, req)
            assert sum(len(w) for w, _ in hits) == want["count"]
            files_met.add(len(hits))
            outputs.settle(i, kind, directory, reply)
        kinds.add(kind)
    assert kinds == {k["kind"] for k in mix("collect")["cycle"]} | {"extra"}
    assert truncated == {True, False} and 0 in files_met and max(files_met) >= 2
    assert not outputs.failed and not any((tmp_path / "out").iterdir())


def test_the_collect_control_is_not_correct_by_the_harness():
    """On navvis.collect the float32 control's counts are exact, and its
    preview points, rounded to 6 decimals from float32 coordinates, are
    not the float64 reference's: not correct by wrong_points."""
    import control

    cell = spec.cell("navvis.collect")
    cell.config = dict(cell.config, points=200_000)
    got = control.readings(cell, 2**31 + 22, 0.6, True, torch.device("cpu"))
    assert got["program_correct"] is True, got
    assert set(got["program_checks"].values()) == {0}, got
    assert set(got["program_checks"]) == {"wrong_replies", "wrong_points", "wrong_files"}
    assert got["control_correct"] is False and got["control_checks"]["wrong_points"] > 0, got
    assert 0 < got["control_largest_point_gap_m"] < 1e-4, got
