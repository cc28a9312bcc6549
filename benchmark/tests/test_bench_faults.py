"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: an answer altered where it is produced,
half of the batch (the resident blocks) left out and the mean taken over
the rest, and a step that returns its state unchanged (a reply that
repeats the last one). There is no exchange between cards in a one-card
cell. The harness's look for a card is skipped: the run is on the CPU, at
a small size."""

import io
import json

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
