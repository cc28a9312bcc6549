"""Times of the two density kernels at three grids, for one source tree.

    python -m adhoc_queries_pointclouds_torch.tools.density_bench
    python adhoc_queries_pointclouds_torch/tools/density_bench.py --root OTHER_TREE

Both passes of the density step, density_leaders (the table's clearing
inside its window) and density_candidates, raw and packed at (20, 20, 20),
run at chip_smoke.py phase 3's shape: K = 4 full blocks of 2^21 points,
every row a predicate hit, uniform over 2^20 x 2^20 x 2^17 units at scale
0.001 (1048.576 x 1048.576 x 131.072 m), on three grids:

  contended  30 m cells:  35 x 35 x 5 = 6,125 cells, about 340 points a cell
  main       10 m cells:  105 x 105 x 14 = 154,350 cells, about 13
  sparse     4.1 m cells: 256 x 256 x 32 = 2^21 cells, about one

and, raw only, the contended and main grids with each block's points in
cell order (z, y, x), as a file written in scan or tile order holds them:
there a thread's consecutive points, and a warp's, share cells. The
leaders table is sized as the tree's engine sizes it for a full block.
Each case is first held against the plain versions (the candidates' mask,
counts and chunk counts exactly; the leaders too where the tree can decode
its table), then timed with kernel_timer.KernelTimer, median and least of
--runs: the calls (the host's enqueue inside the window) and their device
work alone. One line per grid and transport: the times, and the bound, the
larger of the bytes at 3.35 TB/s (coordinates and mask bits in, the leaders
at 8 bytes an occupied cell out of pass 1 and into pass 2, the candidates'
bits out) and 60 operations a point and pass at 67 T/s. The last line is
one JSON object with every number and the card's name and power limit.
chip_smoke.py phase 3 holds and times its three grids with grid_case.

--root imports the package from another checkout of the repository (run the
tool as a file then, not with -m, so that no package is loaded before the
path is set), so two versions of the kernels can be timed in turns in one
call on one card (each process builds its tree's kernels). --against
OTHER_TREE --pairs N does that (in_turns.py): N pairs of runs, the first
of a pair alternating between the two trees, then one line per case with
each tree's median of its runs' medians, its least run and the pairs the
--root tree won, both passes and readings; the last line is one JSON
object with those numbers. --match builds
the tree's csrc/density.cu with AQPC_DENSITY_MATCH=1, where that tree has
the variant: lanes of equal key grouped by __match_any_sync at every point
of both passes, one table access a group (in both trees with --against).
It needs a CUDA device.

    python adhoc_queries_pointclouds_torch/tools/density_bench.py \
        --against .bench_data/parent --pairs 10
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

if __package__:
    from .in_turns import in_turns
    from .kernel_timer import KernelTimer
else:  # run as a file: its own directory is on sys.path, the --root tree is not yet
    from in_turns import in_turns
    from kernel_timer import KernelTimer

K, B = 4, 1 << 21
# residual bits of x, y, z above base 0: the grid's extent in units
BITS = (20, 20, 17)
SCALE, OFFSET = (0.001,) * 3, (0.0,) * 3
EXTENT = tuple((1 << b) * 0.001 for b in BITS)
CELLS = {"contended": 30.0, "main": 10.0, "sparse": 4.1}
PACKED_WIDTHS = (20, 20, 20)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_POINT = 60  # at least, per pass: three axes' cell search and d2


def grid_tables(dev, cell: float, zmax: float = EXTENT[2]) -> dict:
    """tables_to_device of the grid over [0, EXTENT] (z up to zmax) at `cell`."""
    from adhoc_queries_pointclouds_torch.ops import density as D
    from adhoc_queries_pointclouds_torch.utils.aabb import AABB

    grid = D.GridSpec3D.create(AABB((0.0, 0.0, 0.0), (EXTENT[0], EXTENT[1], zmax)), cell)
    return D.tables_to_device(grid.file_tables(SCALE, OFFSET), dev)


def residuals(gen, dev) -> list:
    """(K, B) int64 uniform residuals of BITS bits: the points' coordinates."""
    import torch

    return [torch.randint(0, 1 << w, (K, B), dtype=torch.int64, device=dev, generator=gen)
            for w in BITS]


def planes_of(r, w: int):
    """(K, B) int64 residuals in [0, 2^w) -> their (K, row width) u8 plane
    stack (byte planes, then bit planes in little bit order)."""
    import torch

    k_blocks, block_size = r.shape
    parts = [((r >> (8 * p)) & 0xFF).to(torch.uint8) for p in range(w // 8)]
    weights = 1 << torch.arange(8, dtype=torch.int64, device=r.device)
    for q in range(w % 8):
        bit = (r >> (8 * (w // 8) + q)) & 1
        parts.append((bit.view(k_blocks, block_size // 8, 8) * weights).sum(-1).to(torch.uint8))
    return torch.cat(parts, 1) if parts else torch.empty((k_blocks, 0), dtype=torch.uint8,
                                                         device=r.device)


def cell_order(res: list, cell: float) -> list:
    """Each block's points of res sorted by their cell of a grid of `cell`
    m cells at scale 0.001 (z, then y, then x), as int32."""
    import torch

    units = round(cell / 0.001)
    key = ((res[2] // units) << 40) + ((res[1] // units) << 20) + res[0] // units
    order = torch.argsort(key, dim=1)
    return [torch.gather(r, 1, order).to(torch.int32) for r in res]


def engine_slots(D, hits: int, tables: dict) -> int:
    """Table slots a block as the tree's engine sizes them for `hits` hits."""
    if hasattr(D, "grid_cells"):
        return D.table_slots(hits, D.grid_cells(tables))
    return D.table_slots(hits)  # a tree that sizes the table by the hits alone


def bound(point_bytes: float, occupied: int, second: bool) -> tuple[float, str]:
    """(ms, "bytes" or "operations") of one pass over K full blocks:
    point_bytes a point of coordinates and 1/8 of mask in, the leaders (8
    bytes an occupied cell) out of pass 1 or into pass 2, 1/8 a point of
    candidates out of pass 2."""
    nbytes = (point_bytes + (2 if second else 1) / 8) * K * B + 8 * occupied
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = OPS_PER_POINT * K * B / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def grid_case(D, P, timer, tables, points, kw, plain_points, rows, nv, point_bytes) -> dict:
    """Both passes of one case over K blocks of B points: held against the
    plain versions over plain_points (the same points as int32 columns),
    then timed, the table sized as the tree's engine sizes it. Raises if a
    pass disagrees. The row: slots, table bytes, occupied cells, and for
    "leaders" and "candidates" the call's median and least ("_ms",
    "_min_ms"), the device work's ("_device_ms", "_device_min_ms") and the
    bound ("_bound_ms", "_bound_by")."""
    import torch

    mask = P.pack_mask_bits(rows)
    slots = engine_slots(D, int(mask.counts.max()), tables)
    want_leaders = D.density_leaders_plain(*plain_points, rows, nv, tables)
    want = P.pack_mask_bits(D.density_candidates_plain(*plain_points, rows, nv, tables))
    occupied = sum(len(keys) for keys, _ in want_leaders)
    table = D.density_leaders(points, mask.bits, nv, tables, B, slots=slots, **kw)
    got = D.density_candidates(points, mask.bits, nv, tables, table, B, **kw)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("the candidates are not the plain version's")
    if hasattr(D, "table_leaders"):
        for (gk, gv), (wk, wv) in zip(D.table_leaders(table, K, D.grid_cells(tables)),
                                      want_leaders):
            if not (torch.equal(gk, wk) and torch.equal(gv, wv.view(torch.int32))):
                raise RuntimeError("the leaders are not the plain version's")
    row = {"slots": slots, "table_bytes": table.numel() * table.element_size(),
           "occupied_cells": occupied}
    passes = {
        "leaders": lambda: D.density_leaders(points, mask.bits, nv, tables, B, slots=slots, **kw),
        "candidates": lambda: D.density_candidates(points, mask.bits, nv, tables, table, B, **kw),
    }
    for name, fn in passes.items():
        row[f"{name}_ms"], row[f"{name}_min_ms"] = timer.times(fn)
        row[f"{name}_device_ms"], row[f"{name}_device_min_ms"] = timer.times(fn, device=True)
        row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bound(point_bytes, occupied,
                                                                 name == "candidates")
    return row


def describe(row: dict) -> str:
    """grid_case's row as one line of text."""
    out = f"{row['slots']} slots a block ({row['table_bytes'] / 1e6:.1f} MB in all)"
    for name in ("leaders", "candidates"):
        out += (f"; {name} {row[f'{name}_ms']:.4f} ms (least {row[f'{name}_min_ms']:.4f}), "
                f"device {row[f'{name}_device_ms']:.4f} (least "
                f"{row[f'{name}_device_min_ms']:.4f}), bound {row[f'{name}_bound_ms']:.4f} by "
                f"{row[f'{name}_bound_by']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose adhoc_queries_pointclouds_torch is timed")
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--match", action="store_true",
                    help="build csrc/density.cu with AQPC_DENSITY_MATCH=1")
    ap.add_argument("--against", help="second checkout: time both trees in turns")
    ap.add_argument("--pairs", type=int, default=10, help="pairs of runs with --against")
    args = ap.parse_args(argv)
    if args.against:
        in_turns(Path(__file__).resolve(), args.root, args.against, args.pairs,
                 ["--runs", str(args.runs), "--seed", str(args.seed)]
                 + (["--match"] if args.match else []),
                 ("grid", "order", "transport"),
                 ("leaders_device_ms", "leaders_ms", "candidates_device_ms", "candidates_ms"))
        return 0
    sys.path.insert(0, args.root)

    import torch

    from adhoc_queries_pointclouds_torch import _build
    from adhoc_queries_pointclouds_torch.ops import density as D
    from adhoc_queries_pointclouds_torch.ops import predicate as P

    if args.match:  # before the first launch builds the library
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DAQPC_DENSITY_MATCH=1")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this tool times kernels on a card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    timer = KernelTimer(dev, args.runs)
    res = residuals(gen, dev)
    raw = [r.to(torch.int32) for r in res]
    planes = [planes_of(r, w) for r, w in zip(res, PACKED_WIDTHS)]
    packed = dict(bases=torch.zeros((K, 3), dtype=torch.int32, device=dev), widths=PACKED_WIDTHS)
    rows = torch.ones((K, B), dtype=torch.bool, device=dev)
    nv = torch.full((K,), B, dtype=torch.int32, device=dev)

    variant = ", AQPC_DENSITY_MATCH=1" if args.match else ""
    print(f"tree {args.root}{variant}; card {card}; K={K}, B={B}, every row a hit, "
          f"median and least of {args.runs} runs")
    out = []
    cases = [(grid, cell, "random") for grid, cell in CELLS.items()]
    cases += [(grid, CELLS[grid], "cell") for grid in ("contended", "main")]
    for grid, cell, order in cases:
        t = grid_tables(dev, cell)
        points_raw = raw if order == "random" else cell_order(res, cell)
        transports = [("raw", points_raw, {}, 12.0)]
        if order == "random":
            transports.append(("packed", planes, packed, sum(PACKED_WIDTHS) / 8))
        for transport, points, kw, point_bytes in transports:
            try:
                row = grid_case(D, P, timer, t, points, kw, points_raw, rows, nv, point_bytes)
            except RuntimeError as e:
                raise RuntimeError(f"{grid} grid, {order} order, {transport}: {e}") from None
            out.append({"grid": grid, "cell_m": cell, "order": order, "transport": transport,
                        **row})
            print(f"  {grid} grid ({cell} m, {row['occupied_cells']} occupied cells), {order} "
                  f"order, {transport}: {describe(row)}")
    print(json.dumps({"tree": args.root, "match": args.match, "card": card, "runs": args.runs,
                      "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
