"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: an answer altered where it is produced,
half of the batch (the resident blocks) left out and the mean taken over
the rest, and a step that returns its state unchanged (a reply that
repeats the last one). There is no exchange between cards in a one-card
cell. A collect cell's faults are in its answers: a preview point altered,
a preview in another order, its truncated flag flipped, a point dropped
from a LAS file, two files' numbering swapped, a header's point count off
by one. The harness's look for a card is skipped: the run is on the CPU,
at a small size."""

import dataclasses
import io
import json
import os

import pytest
import torch

from yardstick import harness, spec

FAULTS = ["none", "altered", "half_batch", "unchanged"]


def tiny(name: str):
    c = spec.cell(name)
    c.config = dict(c.config, points=40_000)  # the tiles, and so the extent, kept
    return c


def plant(monkeypatch, fault: str) -> None:
    from adhoc_queries_pointclouds_torch.ops import predicate
    from adhoc_queries_pointclouds_torch.parallel import resident

    ds_cls = resident.ResidentDataset
    if fault == "altered":
        count = ds_cls.count
        monkeypatch.setattr(ds_cls, "count", lambda self, plan: count(self, plan) + 1)
    elif fault == "half_batch":
        def halve(entry):
            def run(*args, **kw):
                c = entry(*args, **kw)
                half = max(c.shape[0] // 2, 1)
                mean = c[:half].to(torch.float64).mean()
                return torch.full_like(c, int(torch.round(mean)))
            return run

        for kind, entry in list(resident._COUNTS.items()):
            monkeypatch.setitem(resident._COUNTS, kind, halve(entry))
        monkeypatch.setattr(predicate, "class_count_words_kernel",
                            halve(predicate.class_count_words_kernel))
    elif fault == "unchanged":
        count, last = ds_cls.count, []

        def stale(self, plan):
            now = count(self, plan)
            out = last[-1] if last else now
            last.append(now)
            return out

        monkeypatch.setattr(ds_cls, "count", stale)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["doc.count", "navvis.count"])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    out, log = io.StringIO(), io.StringIO()
    assert harness.run(tiny(cell), 2**31 + 77, 0.4, False, device="cpu", out=out, log=log) == 0
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"] is (fault == "none"), (result["checks"], log.getvalue()[-500:])
    wrong = result["checks"]["wrong_replies"]
    assert (wrong["value"] == 0) is (fault == "none") and wrong["limit"] == 0


# a collect cell's faults, each where its answer is produced, and the check
# that has to catch it
COLLECT_FAULTS = {"none": None, "point_altered": "wrong_points",
                  "preview_reordered": "wrong_points", "truncated_flipped": "wrong_points",
                  "las_point_dropped": "wrong_files", "files_swapped": "wrong_files",
                  "header_off_by_one": "wrong_files"}


def plant_collect(monkeypatch, fault: str) -> list:
    """The fault planted in serve's reply or the LAS writer; returns a list
    that gains an entry each time the fault changed something."""
    from adhoc_queries_pointclouds_torch import serve
    from adhoc_queries_pointclouds_torch.formats import las as las_mod

    hits = []
    handle = serve.handle_request
    if fault in ("point_altered", "preview_reordered", "truncated_flipped", "files_swapped"):
        def broken(ds, req, input_path):
            reply = handle(ds, req, input_path)
            pts = reply.get("points")
            if fault == "point_altered" and pts:
                pts[-1][0] += 1e-6
            elif fault == "preview_reordered" and pts and pts[::-1] != pts:
                pts.reverse()
            elif fault == "truncated_flipped" and "truncated" in reply:
                reply["truncated"] = not reply["truncated"]
            elif fault == "files_swapped" and len(reply.get("files", [])) >= 2:
                a, b = reply["files"][:2]
                os.rename(a, a + ".swap")
                os.rename(b, a)
                os.rename(a + ".swap", b)
            else:
                return reply
            hits.append(req)
            return reply

        monkeypatch.setattr(serve, "handle_request", broken)
    elif fault == "las_point_dropped":
        write = las_mod.write_las_chunked

        def dropped(path, chunks, n, pmin, pmax, **kw):
            if n < 2:
                return write(path, chunks, n, pmin, pmax, **kw)
            hits.append(path)
            first = [True]

            def rest():
                for pos, cls, col, inten in chunks:
                    if first[0]:
                        first[0] = False
                        pos, cls, col, inten = pos[1:], cls[1:], col[1:], inten[1:]
                    yield pos, cls, col, inten

            return write(path, rest(), n - 1, pmin, pmax, **kw)

        monkeypatch.setattr(las_mod, "write_las_chunked", dropped)
    elif fault == "header_off_by_one":
        make = las_mod.make_writeback_header

        def off(n, *args, **kw):
            hits.append(n)
            return dataclasses.replace(make(n, *args, **kw), point_count=n + 1)

        monkeypatch.setattr(las_mod, "make_writeback_header", off)
    return hits


@pytest.mark.parametrize("fault", COLLECT_FAULTS)
def test_a_broken_collect_path_is_not_correct(monkeypatch, fault):
    """navvis.collect on the CPU, small: each fault in a preview or in the
    -o files reads not correct, by the check that covers it, and the
    checks of the others stay at 0."""
    hits = plant_collect(monkeypatch, fault)
    cell = spec.cell("navvis.collect")
    cell.config = dict(cell.config, points=200_000)  # the tiles, and so the extent, kept
    out, log = io.StringIO(), io.StringIO()
    assert harness.run(cell, 2**31 + 78, 1.0, False, device="cpu", out=out, log=log) == 0
    result = json.loads(out.getvalue().splitlines()[-1])
    assert set(result["checks"]) == {"wrong_replies", "wrong_points", "wrong_files"}
    assert result["correct"] is (fault == "none"), (result["checks"], log.getvalue()[-500:])
    caught = COLLECT_FAULTS[fault]
    for name, c in result["checks"].items():
        assert c["limit"] == 0 and (c["value"] > 0) is (name == caught), (name, result["checks"])
    assert bool(hits) is (fault != "none")


@pytest.mark.parametrize("cell, kept", [("doc.count", False), ("navvis.count", False),
                                        ("navvis.collect", True)])
def test_the_files_stay_only_where_the_mix_collects(cell, kept):
    """A resident set-up deletes the dataset's files after the load unless
    the mix collects points, whose attributes serve reads from them."""
    r = harness.Run(tiny(cell), 2**31 + 79, 0.1, torch.device("cpu"))
    try:
        r.setup()
        assert [f.exists() for f in r.dataset.files] == [kept] * len(r.dataset.files)
        assert ("fsync" in r.phases) is kept
    finally:
        r.close()
