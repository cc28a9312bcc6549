"""The request generator: the same seed gives the same stream, every cycle
holds its kinds' weights, every box and time request is distinct, boxes
keep their published shape with their edges half a unit above the grid,
and time windows keep their share of the span. The collect options a kind
carries are copied into its requests and draw nothing from the seed, so
the count mixes give the requests they gave before the options existed."""

import hashlib
import json
import math
from collections import Counter

import pytest

from yardstick import spec, traffic

MIXES = {"count_box": "doc", "count_time": "navvis"}
ALL_MIXES = {**MIXES, "collect": "navvis"}


def mix_and_config(name: str):
    m = json.loads((spec.BENCH_DIR / "traffic" / f"{name}.json").read_text())
    config = json.loads((spec.BENCH_DIR / "configs" / f"{ALL_MIXES[name]}.json").read_text())
    return m, config


@pytest.mark.parametrize("name", ALL_MIXES)
def test_same_seed_same_stream(name):
    m, config = mix_and_config(name)
    a = traffic.Generator(m, config, 2**31 + 7).take(500)
    assert a == traffic.Generator(m, config, 2**31 + 7).take(500)
    assert a != traffic.Generator(m, config, 2**31 + 8).take(500)


@pytest.mark.parametrize("name", ALL_MIXES)
def test_cycles_hold_the_weights_and_requests_are_distinct(name):
    m, config = mix_and_config(name)
    gen = traffic.Generator(m, config, 5)
    period = sum(int(k["weight"]) for k in m["cycle"])
    stream = gen.take(7 * period) + gen.take(20_000)
    weights = {k["kind"]: int(k["weight"]) for k in m["cycle"]}
    for c in range(7):
        assert Counter(k for k, _ in stream[c * period:(c + 1) * period]) == weights
    keys = [json.dumps(r, sort_keys=True) for _, r in stream if "class" not in r]
    assert len(keys) == len(set(keys))
    warm = {json.dumps(r, sort_keys=True) for _, r in traffic.warmup(m, config, 5)}
    assert not warm & set(keys)


def test_the_extent_is_the_published_xl_box():
    for name in set(MIXES.values()):
        config = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())
        xl, scale = config["published_xl_box"], config["scale"][0]
        lo, hi = traffic.extent(config)
        assert list(lo) == xl[:3] == config["offset"]
        width = round((xl[3] - xl[0]) / config["tiles"] / scale) * scale
        assert config["tile_extent_m"][0] == pytest.approx(width, abs=1e-9)
        assert hi[0] == pytest.approx(xl[3], abs=config["tiles"] * scale)
        for a in (1, 2):
            assert config["tile_extent_m"][a] == pytest.approx(xl[a + 3] - xl[a], abs=1e-9)
        # the mix's XL box is the dataset's bounds
        m = json.loads((spec.BENCH_DIR / "traffic" / f"{dict(map(reversed, MIXES.items()))[name]}.json").read_text())
        assert {k["kind"]: k for k in m["cycle"]}["box_xl"]["box"] == xl


@pytest.mark.parametrize("name", ALL_MIXES)
def test_boxes_keep_their_shape_on_the_grid(name):
    m, config = mix_and_config(name)
    lo, hi = traffic.extent(config)
    scale = config["scale"][0]
    half = 0.5 * scale
    kinds = {k["kind"]: k for k in m["cycle"]}
    boxes = [(k, r["bounds"]) for k, r in traffic.Generator(m, config, 9).take(4_000)
             if "bounds" in r]
    assert len(boxes) > 1_000
    for kind, b in boxes:
        k = kinds[kind]
        pub, grid = k["box"], k["grid_m"]
        for a in range(3):
            assert b[a + 3] - b[a] == pytest.approx(pub[a + 3] - pub[a], abs=1e-6), (kind, b)
            for edge in (b[a], b[a + 3]):  # off the points' lattice by half a unit
                units = (edge - half - lo[a]) / scale
                assert abs(units - round(units)) < 1e-3, (kind, b)
        assert b[2] == pytest.approx(pub[2] + half) and b[5] == pytest.approx(pub[5] + half)
        for a in range(2):
            if "shift_m" in k:
                steps = (b[a] - half - pub[a]) / grid
                assert abs(steps) <= k["shift_m"] / grid + 1e-6, (kind, b)
            else:
                steps = (b[a] - half - lo[a]) / grid
                assert lo[a] <= b[a] and b[a + 3] <= hi[a] + half, (kind, b)
            assert abs(steps - round(steps)) < 1e-6, (kind, b)


def test_time_windows_keep_their_share_off_the_points():
    m, config = mix_and_config("count_time")
    rate = config["generator"]["time_rate"]
    total = config["points"]
    span = total / rate
    kinds = {k["kind"]: k for k in m["cycle"]}
    seen = Counter()
    for kind, req in traffic.Generator(m, config, 3).take(3_000):
        if "time_range" not in req:
            continue
        seen[kind] += 1
        k = kinds[kind]
        t0, t1 = req["time_range"]
        assert (t1 - t0) * rate == pytest.approx(round(total * k["share"]), abs=1e-3)
        shift = k.get("shift_s", 0.0)
        assert -shift - 1 / rate <= t0 and t1 <= span + shift + 1 / rate, (kind, req)
        for t in (t0, t1):
            assert abs(t * rate - 0.75 - round(t * rate - 0.75)) < 1e-3
    assert set(seen) == {"time_s", "time_l", "time_xl"}
    assert math.isclose(kinds["time_xl"]["share"], 1.0)


# sha256 of json.dumps([take(700) + take(300), warmup]) of a fresh
# Generator, its first 16 hex digits, before the collect options existed
COUNT_STREAMS = [("count_box", 0, "36e95c09aa6b46ec"),
                 ("count_box", 2**31 + 7, "4f0bc7e32442e480"),
                 ("count_box", 2**33 + 5, "b4a44a5303855a4a"),
                 ("count_time", 0, "00384876a33fc52c"),
                 ("count_time", 2**31 + 7, "abc380b01dcbf3ca"),
                 ("count_time", 2**33 + 5, "dfe08cbca77a6a34")]


@pytest.mark.parametrize("name, seed, digest", COUNT_STREAMS)
def test_count_streams_are_as_before(name, seed, digest):
    m, config = mix_and_config(name)
    gen = traffic.Generator(m, config, seed)
    stream = gen.take(700) + gen.take(300)
    got = json.dumps([stream, traffic.warmup(m, config, seed)])
    assert hashlib.sha256(got.encode()).hexdigest()[:16] == digest
    assert not any(set(r) & set(traffic.OPTIONS) for _, r in stream)


def test_collect_options_are_copied_and_draw_nothing():
    """Each kind's options are in each of its requests, as the mix gives
    them; without them the same seed gives the same predicates; the time
    kinds keep their share, placed as count_time places them."""
    m, config = mix_and_config("collect")
    kinds = {k["kind"]: k for k in m["cycle"]}
    stream = traffic.Generator(m, config, 2**31 + 9).take(1_200)
    bare = dict(m, cycle=[{k: v for k, v in kind.items() if k not in traffic.OPTIONS}
                          for kind in m["cycle"]])
    plain = traffic.Generator(bare, config, 2**31 + 9).take(1_200)
    assert [k for k, _ in stream] == [k for k, _ in plain]
    rate, total = config["generator"]["time_rate"], config["points"]
    for (kind, req), (_, pred) in zip(stream, plain):
        options = {k: kinds[kind][k] for k in traffic.OPTIONS if k in kinds[kind]}
        assert req == dict(pred, **options) and options
        if "time_range" in req:
            t0, t1 = req["time_range"]
            assert (t1 - t0) * rate == pytest.approx(round(total * kinds[kind]["share"]), abs=1e-3)
            assert 0 <= t0 and t1 <= total / rate + 1 / rate
    assert {k for k, r in stream if r.get("collect")} == {"preview_s", "preview_time"}
    assert {r["limit"] for _, r in stream if r.get("collect")} == {1000}
    assert {k for k, r in stream if r.get("output") is True} == {"extract_l", "extract_time"}
    assert traffic.needs_files(m)
    assert not any(traffic.needs_files(mix_and_config(n)[0]) for n in MIXES)
