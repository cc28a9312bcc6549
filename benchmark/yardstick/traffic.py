"""The one request generator: a traffic mix's data file in, `serve` request
objects out, drawn from the seed.

A mix (traffic/<mix>.json) lists request kinds in a "cycle", each with a
whole-number weight: every cycle of sum(weights) requests holds exactly
that many of each kind, in an order shuffled from the seed, so every seed
offers the same mix of work in another order. Kinds:

  box      {"bounds": [...]}: the published box "box" (x0, y0, z0, x1,
           y1, z1, world metres), its shape and z kept. Its position in x
           and y is drawn on the grid_m grid of the dataset's extent:
           anywhere that the box lies inside the extent, or, with
           shift_m, at most shift_m from where it was published (the XL
           box, which is the whole extent)
  class    {"class": c}, c drawn from classes
  time     {"time_range": [t0, t1]}: a window of share of the GPS span,
           its start drawn on the points' time grid so that it lies in the
           span, or, with shift_s, up to shift_s seconds beyond it (the
           whole line); its edges at (k + 0.75) / time_rate s,
           where no point's time lies (synth.py)

A kind may also carry serve's collect options, copied into each of its
requests unchanged: "collect": true with "limit": K (a preview of the
first K hits in the reply), or "output": true, a placeholder that the
harness replaces at send time with a fresh, empty directory for the LAS
files (harness.py Outputs). They draw nothing from the seed, so a kind's
positions do not depend on them.

Box edges sit half a unit of the scale above the grid (z above the
published value), so no point lies on an edge. Every box and time request of a stream is distinct (a class
request cannot be: a class is one of a few codes).

The extent is the configuration's tile layout, not the data, so the
requests depend on the seed and the configuration alone.
"""

from __future__ import annotations

import math

import numpy as np

STREAM_WINDOW = 1
STREAM_WARMUP = 2
OPTIONS = ("collect", "limit", "output")  # serve's collect options a kind may carry


def rng_for(seed: int, *words: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed & 0xFFFFFFFFFFFFFFFF, *words]))


def needs_files(mix: dict) -> bool:
    """Whether the mix collects points: serve then reads the hits'
    attributes from the dataset's files, which have to stay."""
    return any(k.get("collect") or k.get("output") for k in mix["cycle"])


def extent(config: dict) -> tuple[tuple[float, float, float], tuple[float, float, float]]:
    """(min, max) world corners of the configuration's tile layout."""
    ox, oy, oz = (float(v) for v in config["offset"])
    ex, ey, ez = (float(v) for v in config["tile_extent_m"])
    return (ox, oy, oz), (ox + int(config["tiles"]) * ex, oy + ey, oz + ez)


class Generator:
    """Requests of one mix over one configuration, from one seed. Each
    take draws its kinds' requests in bulk, one batch a kind."""

    def __init__(self, mix: dict, config: dict, seed: int, stream: int = STREAM_WINDOW):
        self.kinds = mix["cycle"]
        self.config = config
        self.rng = rng_for(seed, stream)
        self.seen: dict[str, set] = {k["kind"]: set() for k in self.kinds}
        self.cycle = np.array([i for i, k in enumerate(self.kinds) for _ in range(int(k["weight"]))])
        self.lo, self.hi = extent(config)
        self.half = 0.5 * float(config["scale"][0])
        self.rate = float(config["generator"].get("time_rate", 200_000.0))

    def take(self, n: int) -> list[tuple[str, dict]]:
        """The next n (kind name, request) pairs: whole cycles, each in an
        order of its own, cut at n."""
        cycles = -(-n // len(self.cycle))
        order = self.rng.permuted(np.tile(self.cycle, (cycles, 1)), axis=1).ravel()[:n]
        out: list = [None] * n
        for i, kind in enumerate(self.kinds):
            at = np.flatnonzero(order == i)
            for j, req in zip(at.tolist(), self._requests(kind, len(at))):
                out[j] = (kind["kind"], req)
        return out

    def _distinct(self, kind: dict, m: int, draw) -> np.ndarray:
        """m rows of draw(k) -> (k, w) int64 keys that no earlier request of
        this kind had, nor one another."""
        seen = self.seen[kind["kind"]]
        rows: list = []
        for _ in range(1000):
            if len(rows) == m:
                return np.array(rows, np.int64).reshape(m, -1)
            for key in map(tuple, draw(m - len(rows)).tolist()):
                if key not in seen:
                    seen.add(key)
                    rows.append(key)
        raise RuntimeError(f"kind {kind['kind']}: no distinct request left")

    def _requests(self, kind: dict, m: int) -> list[dict]:
        options = {k: kind[k] for k in OPTIONS if k in kind}
        return [dict(r, **options) for r in self._predicates(kind, m)]

    def _predicates(self, kind: dict, m: int) -> list[dict]:
        what = kind["request"]
        if what == "box":
            return [{"bounds": b} for b in self._boxes(kind, m)]
        if what == "class":
            classes = np.asarray(kind["classes"], np.int64)
            return [{"class": c} for c in classes[self.rng.integers(len(classes), size=m)].tolist()]
        if what == "time":
            return [{"time_range": t} for t in self._times(kind, m)]
        raise ValueError(f"unknown request kind {what!r}")

    def _boxes(self, kind: dict, m: int) -> list[list[float]]:
        """The published box at m distinct grid positions in x and y."""
        box = [float(v) for v in kind["box"]]
        grid = float(kind["grid_m"])
        rng = self.rng
        if "shift_m" in kind:  # near where it was published
            k = int(round(float(kind["shift_m"]) / grid))
            base = np.array(box[:2])
            lo_k, hi_k = np.array([-k, -k]), np.array([k, k])
        else:  # anywhere inside the extent
            base = np.array(self.lo[:2])
            room = [(self.hi[a] - self.lo[a]) - (box[a + 3] - box[a]) for a in range(2)]
            if min(room) < 0:
                raise ValueError(f"kind {kind['kind']}: the box is larger than the extent")
            lo_k = np.zeros(2, np.int64)
            hi_k = np.array([math.floor(r / grid + 1e-9) for r in room])

        def draw(n):
            return rng.integers(lo_k, hi_k + 1, size=(n, 2))

        steps = self._distinct(kind, m, draw)
        x0 = base[0] + steps[:, 0] * grid + self.half
        y0 = base[1] + steps[:, 1] * grid + self.half
        w, h = box[3] - box[0], box[4] - box[1]
        z0 = np.full(m, box[2] + self.half)
        z1 = np.full(m, box[5] + self.half)
        return np.stack([x0, y0, z0, x0 + w, y0 + h, z1], axis=1).tolist()

    def _times(self, kind: dict, m: int) -> list[list[float]]:
        total = int(self.config["points"])  # the span in points, 1 / rate s each
        length = max(int(round(total * float(kind["share"]))), 1)
        shift = int(round(float(kind.get("shift_s", 0.0)) * self.rate))

        def draw(n):
            return self.rng.integers(-shift, total - length + shift + 1, size=(n, 1))

        start = self._distinct(kind, m, draw)[:, 0]
        return np.stack([(start + 0.75) / self.rate,
                         (start + length + 0.75) / self.rate], axis=1).tolist()


def warmup(mix: dict, config: dict, seed: int, per_kind: int = 2) -> list[tuple[str, dict]]:
    """per_kind requests of every kind, from a stream apart from the
    window's, so that the window's requests are all new to the program."""
    gen = Generator(mix, config, seed, STREAM_WARMUP)
    out, need = [], {k["kind"]: per_kind for k in mix["cycle"]}
    while any(need.values()):
        for name, req in gen.take(len(gen.cycle)):
            if need[name]:
                need[name] -= 1
                out.append((name, req))
    return out
