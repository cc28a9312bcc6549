"""On the card: each cell at a small size through the whole harness, and
its float32 control, which the harness's own comparison has to find not
correct where the program is correct. Skipped without a card (the `card`
fixture decides)."""

import io
import json
import subprocess
import sys

import pytest

import control
from yardstick import harness, spec

CELLS = ["doc.count", "navvis.count", "doc.stream", "navvis.collect"]
# the control's size: doc's coordinates are past float32 at any size;
# navvis's boxes are not, and its GPS times only over the whole line;
# navvis's preview points, rounded to 6 decimals, at any size
CONTROL_POINTS = {"doc.count": 4 * 1_000_000, "navvis.count": None,
                  "doc.stream": 4 * 1_000_000, "navvis.collect": 4 * 1_000_000}


def small(name: str, points: int | None = 4 * 1_000_000):
    c = spec.cell(name)
    if points is not None:  # the tiles, and so the extent, kept
        c.config = dict(c.config, points=points)
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card_is_correct(card, name):
    out, log = io.StringIO(), io.StringIO()
    assert harness.run(small(name), 2**31 + 11, 1.0, False, out=out, log=log) == 0
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"], log.getvalue()[-2000:]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {m["name"] for m in small(name).end_to_end}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_every_per_layer_metric(card, name):
    """The cell at its own size as the check starts it, in a process of its
    own: a profiler session in a process that had one before can lose
    kernel records, and the harness then reads no metric from its trace."""
    proc = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", name,
                           "--seed", str(2**31 + 12), "--seconds", "2", "--trace", "1"],
                          capture_output=True, text=True, cwd=spec.ROOT, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"], proc.stderr[-2000:]
    assert set(result["metrics"]) == {m["name"] for m in spec.cell(name).per_layer}
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"] and result["breakdown"]["idle_gaps"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(card, name):
    """The control has to fail one of the cell's checks: navvis.collect's
    counts are exact in float32 at 4 M points, its preview points are not."""
    got = control.readings(small(name, CONTROL_POINTS[name]), 2**31 + 21, 1.0, True, card)
    assert got["program_correct"] is True and set(got["program_checks"].values()) == {0}, got
    assert got["control_correct"] is False and max(got["control_checks"].values()) > 0, got
